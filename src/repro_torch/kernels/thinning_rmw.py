"""CUDA ``thinning_rmw``: bind and launch ``csrc/thinning_rmw.cu``.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.thinning_rmw``
and, in its keyed form, the row gather and the counter-RNG uniforms that
the JAX package leaves to XLA around it (see the note at the top of the
CUDA source for its numerics, design and bound).  ``KERNEL`` builds it with
``nvcc`` at first use (``kernels/_build.py``); nothing is built or loaded
when the module is imported.

Two entries launch the same kernel template:

* ``thinning_rmw_cuda`` — gathered rows and ``u`` in, 9 outputs out;
* ``thinning_rmw_keyed_cuda`` — the state tables and the events' keys in;
  the kernel reads the rows at the keys, draws the uniforms and writes the
  decisions (and, with ``write_back=True``, the updated rows, in place).

The fast step's fold after the decisions is a kernel of its own,
``csrc/segment_fold.cu`` (``FOLD_KERNEL``, entry ``segment_fold_cuda``):
it folds the block's persisted contributions into the rows the block
touches, in place, in two launches (the block's lanes ranked by row, then
one warp a row).

``launches``, ``keyed_launches`` and ``fold_launches`` count the launches
of each entry; a run can reset them and read them back to show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ref import POLICIES
from repro_torch.kernels.threefry import as_key

launches = 0            # thinning_rmw_cuda launches since the last reset
keyed_launches = 0      # thinning_rmw_keyed_cuda launches
fold_launches = 0       # segment_fold_cuda's kernel launches (2 a call)


def _bind(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.thinning_rmw_launch
    fn.restype = I
    fn.argtypes = [P] * 19 + [I] * 4 + [F] * 6 + [P]
    fn = lib.thinning_rmw_keyed_launch
    fn.restype = I
    fn.argtypes = [P] * 16 + [I] * 6 + [F] * 6 + [ctypes.c_uint32] * 2 + [P]


KERNEL = CudaKernel("thinning_rmw", ("-fmad=false", "-ftz=true",
                                     "-prec-div=true", "-prec-sqrt=true"),
                    _bind)


def _bind_fold(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.segment_fold_launch
    fn.restype = I
    fn.argtypes = [P] * 15 + [I] * 2 + [ctypes.c_float, P]


FOLD_KERNEL = CudaKernel("segment_fold", ("-fmad=false", "-prec-div=true"),
                         _bind_fold)


def _check(name, x, device, shape, dtype=torch.float32):
    if x.device != device or x.dtype != dtype \
            or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"thinning_rmw: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {tuple(x.shape)} "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


def _check_params(device, policy, T, mu_tau_index, entry):
    if device.type != "cuda":
        raise ValueError(f"{entry} takes CUDA tensors, got {device}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    if policy == "pp_vr" and not 0 <= mu_tau_index < T:
        raise ValueError(f"mu_tau_index {mu_tau_index} outside [0, {T})")


@functools.lru_cache(maxsize=64)
def _scalars(h, budget, alpha, fixed_rate, min_p):
    """The host-side constants, rounded once to float32."""
    f = lambda x: float(np.float32(x))
    return (f(-1.0 / h), f(1.0 / h), f(budget), f(-alpha), f(fixed_rate),
            f(min_p))


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _raise_on(err, entry="thinning_rmw"):
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def thinning_rmw_cuda(taus, last_t, v_f, agg_flat, q, t, u, valid, v_full,
                      last_t_full, *, h: float, budget: float,
                      alpha: float = 0.0, policy: str = "pp",
                      fixed_rate: float = 0.1, mu_tau_index: int = 2,
                      min_p: float = 1e-6):
    """Launch the kernel on gathered rows (CUDA tensors; same contract as
    ``repro_torch.kernels.ref.thinning_rmw_ref``; ``valid`` as float 0/1).
    Returns (new_last_t, new_v_f, new_agg_flat, z, p, features, lam,
    new_v_full, new_last_t_full) with ``z`` bool."""
    global launches
    device = last_t.device
    B, T = last_t.shape[0], taus.shape[0]
    _check_params(device, policy, T, mu_tau_index, "thinning_rmw_cuda")
    _check("taus", taus, device, (T,))
    for name, x in (("last_t", last_t), ("v_f", v_f), ("q", q), ("t", t),
                    ("u", u), ("valid", valid), ("v_full", v_full),
                    ("last_t_full", last_t_full)):
        _check(name, x, device, (B,))
    _check("agg_flat", agg_flat, device, (B, 3 * T))
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=device)
    new_last_t, new_v_f, p, lam = f32(B), f32(B), f32(B), f32(B)
    new_v_full, new_last_t_full = f32(B), f32(B)
    new_agg, feats = f32(B, 3 * T), f32(B, 4 * T)
    z = torch.empty((B,), dtype=torch.bool, device=device)   # one byte, 0/1
    if B:
        fn = KERNEL.lib().thinning_rmw_launch
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(_ptr(x) for x in (
                taus, last_t, v_f, agg_flat, q, t, u, valid, v_full,
                last_t_full, new_last_t, new_v_f, new_agg, z, p, feats, lam,
                new_v_full, new_last_t_full)),
                B, T, POLICIES.index(policy), int(mu_tau_index),
                *_scalars(h, budget, alpha, fixed_rate, min_p),
                ctypes.c_void_p(stream))
        _raise_on(err)
        launches += 1
    return (new_last_t, new_v_f, new_agg, z, p, feats, lam,
            new_v_full, new_last_t_full)


def thinning_rmw_keyed_cuda(taus, state, key, q, t, valid, rng, ent=None, *,
                            write_back: bool = False, lanes=None, out=None,
                            h: float, budget: float, alpha: float = 0.0,
                            policy: str = "pp", fixed_rate: float = 0.1,
                            mu_tau_index: int = 2, min_p: float = 1e-6):
    """Launch the keyed kernel (CUDA tensors; the contract of
    ``repro_torch.kernels.ref.thinning_rmw_keyed_ref``).

    ``state``: the five state columns (a ``ProfileState``); ``key``/``ent``
    int64 [L]; ``q``/``t`` float32 [L]; ``valid`` bool [L]; ``lanes``
    int64 [C] or None; ``out``: ``(z, p, features, lam)`` of L rows, for
    ``write_back=True``.  Keys must lie in [0, N): the kernel does not
    check them.  Returns ``(z, p, features, lam)``, or ``out``.
    """
    global keyed_launches
    device = key.device
    last_t, v_f, agg, v_full, last_t_full = state
    N, T, L = last_t.shape[0], taus.shape[0], key.shape[0]
    _check_params(device, policy, T, mu_tau_index,
                  "thinning_rmw_keyed_cuda")
    ent = key if ent is None else ent
    checks = [("taus", taus, (T,), torch.float32),
              ("state.agg", agg, (N, T, 3), torch.float32),
              ("key", key, (L,), torch.int64), ("ent", ent, (L,), torch.int64),
              ("q", q, (L,), torch.float32), ("t", t, (L,), torch.float32),
              ("valid", valid, (L,), torch.bool)]
    checks += [(f"state.{n}", x, (N,), torch.float32) for n, x in (
        ("last_t", last_t), ("v_f", v_f), ("v_full", v_full),
        ("last_t_full", last_t_full))]
    if write_back:
        if out is None:
            raise ValueError("write_back=True needs out=(z, p, features, "
                             "lam)")
        checks += [(f"out[{i}]", x, shape, dt) for i, (x, shape, dt) in
                   enumerate(zip(out, ((L,), (L,), (L, 4 * T), (L,)),
                                 (torch.bool, torch.float32, torch.float32,
                                  torch.float32)))]
        if lanes is not None:
            checks.append(("lanes", lanes, (lanes.shape[0],), torch.int64))
    elif lanes is not None or out is not None:
        raise ValueError("lanes= and out= are for write_back=True")
    for name, x, shape, dtype in checks:
        _check(name, x, device, shape, dtype)
    if not write_back:
        out = (torch.empty((L,), dtype=torch.bool, device=device),
               torch.empty((L,), dtype=torch.float32, device=device),
               torch.empty((L, 4 * T), dtype=torch.float32, device=device),
               torch.empty((L,), dtype=torch.float32, device=device))
    n_rows = L if lanes is None else lanes.shape[0]
    if n_rows:
        k0, k1 = as_key(rng)
        fn = KERNEL.lib().thinning_rmw_keyed_launch
        z, p, feats, lam = out
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(_ptr(x) for x in (
                taus, last_t, v_f, agg, v_full, last_t_full, key, ent, lanes,
                q, t, valid, z, p, feats, lam)),
                n_rows, L, T, POLICIES.index(policy), int(mu_tau_index),
                int(write_back), *_scalars(h, budget, alpha, fixed_rate,
                                           min_p),
                k0, k1, ctypes.c_void_p(stream))
        _raise_on(err)
        keyed_launches += 1
    return out


def segment_fold_cuda(taus, state, key, q, t, valid, z, p, *, h: float):
    """Fold a fast block's persisted contributions into ``state`` in place
    (CUDA tensors; the contract of
    ``repro_torch.kernels.ref.segment_fold_ref``).

    ``state``: the five state columns (a ``ProfileState``); ``key`` int64
    [B] (valid keys in [0, N): the kernel does not check them); ``q``,
    ``t``, ``p`` float32 [B]; ``valid``, ``z`` bool [B].  Scratch is O(B):
    the lanes in (row, lane) order, their rows and their rows' lane
    counts.  Two launches, none for an empty block.
    """
    global fold_launches
    device = key.device
    last_t, v_f, agg, v_full, last_t_full = state
    N, T, B = last_t.shape[0], taus.shape[0], key.shape[0]
    if device.type != "cuda":
        raise ValueError(f"segment_fold_cuda takes CUDA tensors, got "
                         f"{device}")
    if N >= 2 ** 31:
        raise ValueError(f"segment_fold_cuda: {N} rows; rows must fit in "
                         f"31 bits")
    checks = [("taus", taus, (T,), torch.float32),
              ("state.agg", agg, (N, T, 3), torch.float32),
              ("key", key, (B,), torch.int64),
              ("q", q, (B,), torch.float32), ("t", t, (B,), torch.float32),
              ("p", p, (B,), torch.float32),
              ("valid", valid, (B,), torch.bool), ("z", z, (B,), torch.bool)]
    checks += [(f"state.{n}", x, (N,), torch.float32) for n, x in (
        ("last_t", last_t), ("v_f", v_f), ("v_full", v_full),
        ("last_t_full", last_t_full))]
    for name, x, shape, dtype in checks:
        _check(name, x, device, shape, dtype)
    if not B:
        return
    order = torch.empty((3, B), dtype=torch.int32, device=device)
    fn = FOLD_KERNEL.lib().segment_fold_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(_ptr(x) for x in (
            taus, last_t, v_f, agg, v_full, last_t_full, key, q, t, valid, z,
            p, order[0], order[1], order[2])),
            B, T, float(np.float32(h)), ctypes.c_void_p(stream))
    _raise_on(err, "segment_fold")
    fold_launches += 2

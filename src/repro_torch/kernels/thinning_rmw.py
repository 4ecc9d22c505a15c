"""CUDA ``thinning_rmw``: build, bind and launch ``csrc/thinning_rmw.cu``.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.thinning_rmw``
(see the note at the top of the CUDA source for its numerics, design and
bound).  It is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C entry point, loaded with ``ctypes`` at first use and cached
by a hash of the source and the flags under ``build/repro_torch/`` at the
root of the checkout.  Nothing is built or loaded when the module is
imported.

``launches`` counts kernel launches made through ``thinning_rmw_cuda``; a
run can reset it and read it back to show that its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from repro_torch.kernels.ref import POLICIES

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "thinning_rmw.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-ftz=true", "-prec-div=true",
              "-prec-sqrt=true", "-shared", "-Xcompiler", "-fPIC")

launches = 0            # kernel launches since the last reset
build_seconds = None    # wall time of this process's nvcc run (None: cached)
build_log = ""          # nvcc's output (ptxas register/spill report)

_lock = threading.Lock()
_lib = None


BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("thinning_rmw needs nvcc to build its CUDA kernel")


def build() -> pathlib.Path:
    """Compile the kernel library if no build of this source exists yet."""
    global build_seconds, build_log
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"thinning_rmw-{digest[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    build_log = res.stdout + res.stderr
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.thinning_rmw_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 19
                           + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                           + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            _lib = lib
        return _lib


def _check(name, x, device, shape):
    if x.device != device or x.dtype != torch.float32 \
            or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"thinning_rmw: {name} must be a contiguous float32 tensor of "
            f"shape {shape} on {device}; got {tuple(x.shape)} "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


def thinning_rmw_cuda(taus, last_t, v_f, agg_flat, q, t, u, valid, v_full,
                      last_t_full, *, h: float, budget: float,
                      alpha: float = 0.0, policy: str = "pp",
                      fixed_rate: float = 0.1, mu_tau_index: int = 2,
                      min_p: float = 1e-6):
    """Launch the kernel on CUDA tensors (same contract as
    ``repro_torch.kernels.ref.thinning_rmw_ref``; ``valid`` as float 0/1).
    Returns (new_last_t, new_v_f, new_agg_flat, z, p, features, lam,
    new_v_full, new_last_t_full) with ``z`` bool."""
    global launches
    device = last_t.device
    if device.type != "cuda":
        raise ValueError(f"thinning_rmw_cuda takes CUDA tensors, got {device}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    B, T = last_t.shape[0], taus.shape[0]
    if policy == "pp_vr" and not 0 <= mu_tau_index < T:
        raise ValueError(f"mu_tau_index {mu_tau_index} outside [0, {T})")
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
        fn = _load().thinning_rmw_launch
        ptr = lambda x: ctypes.c_void_p(x.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(ptr(x) for x in (
                taus, last_t, v_f, agg_flat, q, t, u, valid, v_full,
                last_t_full, new_last_t, new_v_f, new_agg, z, p, feats, lam,
                new_v_full, new_last_t_full)),
                B, T, POLICIES.index(policy),
                float(np.float32(-1.0 / h)), float(np.float32(1.0 / h)),
                float(np.float32(budget)), float(np.float32(-alpha)),
                float(np.float32(fixed_rate)), int(mu_tau_index),
                float(np.float32(min_p)), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"thinning_rmw launch failed: CUDA error {err}")
        launches += 1
    return (new_last_t, new_v_f, new_agg, z, p, feats, lam,
            new_v_full, new_last_t_full)

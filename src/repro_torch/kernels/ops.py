"""Public wrappers of the port's kernels (PyTorch).

The counterparts of ``repro.kernels.ops``: ``thinning_rmw`` (the fused
decision + update over gathered rows), ``decay_scan`` (the prefill
recurrence of the RG-LRU and of Mamba-2's chunk states) and
``flash_attention`` (the attention prefill of every family); and
``thinning_rmw_keyed``, the same fused pass read from the state at the
events' keys, with the counter-RNG uniforms drawn in the kernel and, in
exact mode, the rows written back — the one decision + update call that
``core/engine.py`` routes both execution modes through; and
``segment_fold``, fast mode's fold of a block's persisted contributions
into the rows it touches.  Dispatch follows the
tensors, not a flag: CUDA tensors go to the hand-written kernels
(``kernels/thinning_rmw.py``, ``decay_scan.py``, ``flash_attention.py``),
CPU tensors to the plain versions (``kernels/ref.py``).  There is no
fallback from one to the other — a CUDA tensor reaches the kernel or the
call raises.  Nothing is padded: the kernels mask their ragged edges.

``decay_scan`` and ``flash_attention`` are differentiable: where a
gradient is wanted (grad mode on and an input that requires one) they run
through ``torch.autograd.Function``s whose backward is the backward kernel
on the card (``decay_scan_bwd``, ``flash_attention_bwd``) and the plain
backward (``ref.decay_scan_bwd_ref``, ``ref.attention_bwd_ref``) on the
CPU (for attention only where the op runs on the CPU: a DTensor or the
dry-run's fake tensors; a plain CPU tensor takes ``ref.chunked_attention``
under autograd, the JAX models' order); the attention forward then also
writes the rows' log-sum-exp, in the same launch.  Without one (serving runs under ``inference_mode``) they are
the plain calls: no log-sum-exp, no saved tensors, no extra launch.

Two contracts every caller of ``thinning_rmw`` inherits from the reference:

* **Full-stream control column.**  ``v_full`` / ``last_t_full`` advance on
  every valid event, the persisted columns only on ``z``.  Decision-only
  callers may omit them (fresh rows); callers that persist state must
  scatter both returned columns back.
* **Functional RMW.**  ``thinning_rmw`` reads gathered rows and returns
  new rows; it never writes its inputs.  ``thinning_rmw_keyed`` with
  ``write_back=True`` is the one call that updates the state in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decay_scan as _ds
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import thinning_rmw as _tr
from repro_torch.kernels.ref import FRESH_SENTINEL, POLICIES


def thinning_rmw(taus, last_t, v_f, agg_flat, q, t, u, valid,
                 v_full=None, last_t_full=None, *,
                 h: float, budget: float, alpha: float = 0.0,
                 policy: str = "pp", fixed_rate: float = 0.1,
                 mu_tau_index: int = 2, min_p: float = 1e-6):
    """Fused persistence-path RMW decision + update over gathered rows.

    ``policy`` selects the inclusion rule ('pp', 'pp_vr', 'full', 'fixed',
    'unfiltered').  Returns (new_last_t, new_v_f, new_agg_flat, z, p,
    features, lam, new_v_full, new_last_t_full).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    kw = dict(h=h, budget=budget, alpha=alpha, policy=policy,
              fixed_rate=fixed_rate, mu_tau_index=mu_tau_index, min_p=min_p)
    if v_full is None:
        v_full = torch.zeros_like(last_t)
    if last_t_full is None:
        last_t_full = torch.full_like(last_t, FRESH_SENTINEL)
    args = (taus, last_t, v_f, agg_flat, q, t, u, valid, v_full, last_t_full)
    device = last_t.device
    if device.type == "cuda":
        return _tr.thinning_rmw_cuda(*args, **kw)
    if device.type == "cpu":
        return ref.thinning_rmw_ref(*args, **kw)
    raise ValueError(f"thinning_rmw has no implementation for {device}")


def thinning_rmw_keyed(taus, state, key, q, t, valid, rng, ent=None, *,
                       write_back: bool = False, lanes=None, out=None,
                       h: float, budget: float, alpha: float = 0.0,
                       policy: str = "pp", fixed_rate: float = 0.1,
                       mu_tau_index: int = 2, min_p: float = 1e-6):
    """The fused pass over the state rows at the events' keys.

    ``state`` a ``ProfileState``; ``key``/``ent`` int64 [L] (``ent``, the
    counter-RNG entity, defaults to ``key``); ``q``/``t`` float32 [L];
    ``valid`` bool [L]; ``rng`` a key.  Decision only: returns ``(z, p,
    features, lam)``.  ``write_back=True`` (active keys distinct): row
    ``i`` is event ``lanes[i]`` (``>= L``: empty), the updated rows are
    written into ``state`` and the decisions into slot ``lanes[i]`` of
    ``out = (z, p, features, lam)``.  See
    ``repro_torch.kernels.ref.thinning_rmw_keyed_ref`` for the contract.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    if write_back and out is None:
        raise ValueError("write_back=True needs out=(z, p, features, lam)")
    if not write_back and (lanes is not None or out is not None):
        raise ValueError("lanes= and out= are for write_back=True")
    kw = dict(write_back=write_back, lanes=lanes, out=out, h=h,
              budget=budget, alpha=alpha, policy=policy,
              fixed_rate=fixed_rate, mu_tau_index=mu_tau_index, min_p=min_p)
    args = (taus, state, key, q, t, valid, rng, ent)
    if key.device.type == "cuda":
        return _tr.thinning_rmw_keyed_cuda(*args, **kw)
    if key.device.type == "cpu":
        return ref.thinning_rmw_keyed_ref(*args, **kw)
    raise ValueError(f"thinning_rmw_keyed has no implementation for "
                     f"{key.device}")


def segment_fold(taus, state, key, q, t, valid, z, p, *, h: float) -> None:
    """Fold a fast block's persisted contributions into ``state``, in place.

    ``state`` a ``ProfileState``; ``key`` int64 [B]; ``q``/``t`` float32
    [B]; ``valid`` bool [B]; ``z``/``p`` the decision stage's outputs for
    the same lanes.  Only the rows of the block's valid keys change; see
    ``repro_torch.kernels.ref.segment_fold_ref`` for the contract.
    """
    args = (taus, state, key, q, t, valid, z, p)
    if key.device.type == "cuda":
        return _tr.segment_fold_cuda(*args, h=h)
    if key.device.type == "cpu":
        return ref.segment_fold_ref(*args, h=h)
    raise ValueError(f"segment_fold has no implementation for {key.device}")


# ------------------------------------------------- custom ops (torch.library)
# decay_scan and flash_attention, forward and backward, are registered as
# ``torch.library`` custom ops, so that the rest of torch sees each kernel
# as one opaque operation: ``register_fake`` gives its output shapes
# (FakeTensorMode: the dry-run runs the real step with no storage), a FLOP
# formula counts its work (``torch.utils.flop_counter``), and a sharding
# rule lets it take DTensors (``register_sharding``): attention is
# shardable over batch and heads (each rank's keys are its own), the scan
# over channels.  Each op's body dispatches on the tensors' device, as
# before: the CUDA kernel on the card, the plain version on the CPU.  No
# step of the port hands these ops DTensors: the train and serve steps run
# the model on each rank's plain local tensors (its heads and channels
# under tensor parallelism), so the sharding rules act only where a caller
# shards the ops' inputs itself (``chip_smoke.py`` phase 13 and the tests
# hold them against the plain calls).
from torch import Tensor                                    # noqa: E402


@torch.library.custom_op("repro_torch::decay_scan", mutates_args=())
def _decay_scan_op(a: Tensor, u: Tensor, h0: Optional[Tensor]) -> Tensor:
    if a.device.type == "cuda":
        return _ds.decay_scan_cuda(a, u, h0)
    if a.device.type == "cpu":
        _ds.check_args(a, u, h0)
        return ref.decay_scan_ref(a, u, h0)
    raise ValueError(f"decay_scan has no implementation for {a.device}")


@_decay_scan_op.register_fake
def _(a, u, h0):
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::decay_scan_bwd", mutates_args=())
def _decay_scan_bwd_op(a: Tensor, h: Tensor, g: Tensor,
                       h0: Optional[Tensor]) -> Tuple[Tensor, Tensor,
                                                      Tensor]:
    """(da, du, dh0); dh0 is empty [0] without ``h0``."""
    if a.device.type == "cuda":
        da, du, dh0 = _ds.decay_scan_bwd_cuda(a, h, g, h0)
    else:
        da, du, dh0 = ref.decay_scan_bwd_ref(a, h, g, h0)
    return da, du, dh0 if dh0 is not None else a.new_empty(0)


@_decay_scan_bwd_op.register_fake
def _(a, h, g, h0):
    return (torch.empty_like(a), torch.empty_like(a),
            torch.empty_like(h0) if h0 is not None else a.new_empty(0))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        window: int, softcap: float,
                        return_lse: bool) -> Tuple[Tensor, Tensor]:
    """(out [B, H, Sq, D], the rows' log-sum-exp [B, H, Sq] float32, or
    [B, H, 0] without ``return_lse``)."""
    if q.device.type == "cuda":
        out = _fa.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       return_lse=return_lse)
    elif q.device.type == "cpu":
        _fa.check_args(q, k, v, window=window, softcap=softcap)
        out = ref.attention_ref(q, k, v, causal=causal, window=window,
                                softcap=softcap, return_lse=return_lse)
    else:
        raise ValueError(f"flash_attention has no implementation for "
                         f"{q.device}")
    if return_lse:
        return out
    return out, q.new_empty(q.shape[:2] + (0,), dtype=torch.float32)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, return_lse):
    B, H, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (B, H, Sq if return_lse else 0), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                            lse: Tensor, do: Tensor, causal: bool,
                            window: int, softcap: float
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cuda":
        return tuple(_fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw))
    return tuple(ref.attention_bwd_ref(q, k, v, o, lse, do, **kw))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a mask keeps: query i (aligned to the last
    keys) sees keys j <= i + Skv - Sq when causal, and the last ``window``
    of them when windowed."""
    if not causal and window <= 0:
        return Sq * Skv
    import numpy as np
    end = np.arange(Sq, dtype=np.int64) + (Skv - Sq) + 1   # past the last
    hi = np.minimum(Skv, end) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, end - window) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo).sum())


def _attention_flops(q_shape, k_shape, causal, window, products: int):
    B, H, Sq, D = q_shape
    return 2 * products * B * H * D * attended_pairs(Sq, k_shape[2], causal,
                                                     window)


def _register_analysis() -> None:
    """FLOP formulas and DTensor sharding rules for the four ops (both
    APIs exist in the torch versions the port runs on)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    ops = torch.ops.repro_torch

    @register_flop_formula(ops.flash_attention)
    def _(q, k, v, causal, window, softcap, return_lse, *a, **kw):
        return _attention_flops(q, k, causal, window, 2)   # Q K^T, P V

    @register_flop_formula(ops.flash_attention_bwd)
    def _(q, k, v, o, lse, do, causal, window, softcap, *a, **kw):
        # S = Q K^T again, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q
        return _attention_flops(q, k, causal, window, 5)

    @register_flop_formula(ops.decay_scan)
    def _(a, u, h0, *args, **kw):
        return 2 * a[0] * a[1]                 # a h + u a step a channel

    @register_flop_formula(ops.decay_scan_bwd)
    def _(a, h, g, h0, *args, **kw):
        return 3 * a[0] * a[1]                 # the carry's a c + g, da

    @register_sharding(ops.flash_attention.default)
    def _(q, k, v, causal, window, softcap, return_lse):
        scalars = [None] * 4
        out = [([Replicate(), Replicate()],
                [Replicate(), Replicate(), Replicate()] + scalars)]
        # batch, and heads (a query head's KV head stays on its rank when
        # both head counts divide over the mesh dim)
        for d in (0, 1):
            out.append(([Shard(d), Shard(d)],
                        [Shard(d), Shard(d), Shard(d)] + scalars))
        return out

    @register_sharding(ops.flash_attention_bwd.default)
    def _(q, k, v, o, lse, do, causal, window, softcap):
        scalars = [None] * 3
        out = [([Replicate()] * 3, [Replicate()] * 6 + scalars)]
        for d in (0, 1):
            out.append(([Shard(d)] * 3, [Shard(d)] * 6 + scalars))
        return out

    @register_sharding(ops.decay_scan.default)
    def _(a, u, h0):
        rep = ([Replicate()], [Replicate(), Replicate(),
                               Replicate() if h0 is not None else None])
        chan = ([Shard(1)], [Shard(1), Shard(1),
                             Shard(0) if h0 is not None else None])
        return [rep, chan]

    @register_sharding(ops.decay_scan_bwd.default)
    def _(a, h, g, h0):
        has = h0 is not None
        rep = ([Replicate()] * 3, [Replicate()] * 3
               + [Replicate() if has else None])
        chan = ([Shard(1), Shard(1), Shard(0) if has else Replicate()],
                [Shard(1)] * 3 + [Shard(0) if has else None])
        return [rep, chan]


_register_analysis()


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


class _DecayScan(torch.autograd.Function):
    """``decay_scan`` with its backward kernel (plain loop on the CPU)."""

    @staticmethod
    def forward(ctx, a, u, h0):
        h = _decay_scan_op(a, u, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, du, dh0 = _decay_scan_bwd_op(a, h, g.contiguous(), h0)
        return da, du, dh0 if h0 is not None else None


def decay_scan(a, u, h0=None):
    """h[t] = a[t]*h[t-1] + u[t].  a, u: [T, C] float32; h0: [C] or None.
    Differentiable in a, u and h0."""
    if _wants_grad(a, u, h0):
        return _DecayScan.apply(a, u, h0)
    return _decay_scan_op(a, u, h0)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward kernels (the plain
    FlashAttention-2 backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _flash_attention_op(q, k, v, causal, window, softcap,
                                       True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _flash_attention_bwd_op(q, k, v, out, lse, do.contiguous(),
                                        *ctx.masks)
        return (*grads, None, None, None)


def _plain_cpu(x) -> bool:
    """A CPU tensor that holds values: not a DTensor (its op carries the
    sharding rules) and not a fake one (the dry-run counts the op)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return x.device.type == "cpu" and type(x) is not DTensor \
        and not isinstance(x, FakeTensor)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_chunk: int = 1024,
                    kv_chunk: int = 1024):
    """q: [B,H,Sq,D]; k, v: [B,Kh,Skv,D] -> [B,H,Sq,D] (float32 or
    bfloat16).  Differentiable in q, k and v.

    On CPU tensors this is ``ref.chunked_attention`` (blocks of
    ``q_chunk`` queries and ``kv_chunk`` keys, the JAX models' order),
    differentiated by autograd as ``jax.grad`` differentiates the
    reference; the chunk sizes mean nothing to the kernel."""
    if _plain_cpu(q):
        _fa.check_args(q, k, v, window=window, softcap=softcap)
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _flash_attention_op(q, k, v, causal, window, softcap, False)[0]

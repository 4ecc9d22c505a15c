"""Public wrappers of the port's three kernels (PyTorch).

The counterparts of ``repro.kernels.ops``: ``thinning_rmw`` (the fused
decision + update over gathered rows), ``decay_scan`` (the prefill
recurrence of the RG-LRU and of Mamba-2's chunk states) and
``flash_attention`` (the attention prefill of every family); and
``thinning_rmw_keyed``, the same fused pass read from the state at the
events' keys, with the counter-RNG uniforms drawn in the kernel and, in
exact mode, the rows written back — the one decision + update call that
``core/engine.py`` routes both execution modes through.  Dispatch follows the
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
CPU; the attention forward then also writes the rows' log-sum-exp, in the
same launch.  Without one (serving runs under ``inference_mode``) they are
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


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def _scan_forward(a, u, h0):
    if a.device.type == "cuda":
        return _ds.decay_scan_cuda(a, u, h0)
    if a.device.type == "cpu":
        _ds.check_args(a, u, h0)
        return ref.decay_scan_ref(a, u, h0)
    raise ValueError(f"decay_scan has no implementation for {a.device}")


class _DecayScan(torch.autograd.Function):
    """``decay_scan`` with its backward kernel (plain loop on the CPU)."""

    @staticmethod
    def forward(ctx, a, u, h0):
        h = _scan_forward(a, u, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        g = g.contiguous()
        if a.device.type == "cuda":
            return _ds.decay_scan_bwd_cuda(a, h, g, h0)
        return ref.decay_scan_bwd_ref(a, h, g, h0)


def decay_scan(a, u, h0=None):
    """h[t] = a[t]*h[t-1] + u[t].  a, u: [T, C] float32; h0: [C] or None.
    Differentiable in a, u and h0."""
    if _wants_grad(a, u, h0):
        return _DecayScan.apply(a, u, h0)
    return _scan_forward(a, u, h0)


def _attention_forward(q, k, v, causal, window, softcap, return_lse):
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        return_lse=return_lse)
    if q.device.type == "cpu":
        _fa.check_args(q, k, v, window=window, softcap=softcap)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, return_lse=return_lse)
    raise ValueError(f"flash_attention has no implementation for "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward kernels (the plain
    FlashAttention-2 backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _attention_forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cuda":
            grads = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                 **ctx.masks)
        else:
            grads = ref.attention_bwd_ref(q, k, v, out, lse, do, **ctx.masks)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [B,H,Sq,D]; k, v: [B,Kh,Skv,D] -> [B,H,Sq,D] (float32 or
    bfloat16).  Differentiable in q, k and v."""
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _attention_forward(q, k, v, causal, window, softcap, False)

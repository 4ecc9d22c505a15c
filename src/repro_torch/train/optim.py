"""Optimizers (PyTorch port of ``repro.train.optim``): the warmup-cosine
schedule, global-norm clipping, AdamW over float32 master weights and
Adafactor with factored second moments.

Every function takes and returns trees in the JAX layout (dicts, lists,
tuples of tensors; ``models.common.tree_map``), and computes what the JAX
function computes, op for op in float32: AdamW is the reference's
``(mu / c1) / (sqrt(nu / c2) + eps)``, not ``torch.optim.AdamW``, whose
rounding differs.  Unlike the reference, the updates run **in place**
(``clip_by_global_norm`` scales the gradients it is given;
``adamw_update`` writes the master weights and moments it is given,
``adafactor_update`` the parameters and factored moments): a 2.9B-
parameter model's float32 state does not fit twice on one card.  Each
returns the same objects, so callers read like the JAX ones.  Adafactor is
the memory posture of the 1T MoE: factored second moments are
O(rows + cols) a matrix.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed import collectives
from repro_torch.models.common import tree_leaves, tree_map


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (lr is 0 at step 0), then a cosine down to
    ``min_ratio`` of the peak; a float32 0-d tensor on ``step``'s
    device."""
    step = step.float()
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in JAX's order.  A sharded leaf's (a DTensor's) sum is reduced
    over the mesh first (``distributed.collectives.whole``), so the norm
    is a plain tensor, the same on every rank."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        if isinstance(sq, DTensor):
            sq = collectives.whole(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_scale(grads, max_norm: float):
    """(the scale that brings the global norm to at most ``max_norm``,
    the norm)."""
    gnorm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9),
                       max=1.0), gnorm


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradients in place so their global norm is at most
    ``max_norm``.  Returns (grads, norm before clipping)."""
    scale, gnorm = clip_scale(grads, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


# ------------------------------------------------------------------ AdamW
class AdamWState(NamedTuple):
    mu: Any       # fp32, like params
    nu: Any       # fp32, like params


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, master, *, lr, beta1: float,
                 beta2: float, eps: float, weight_decay: float,
                 step: torch.Tensor):
    """One AdamW step over float32 master params, in place.  Returns
    (master, state): the same tensors, updated."""
    t = step.float() + 1.0
    c1 = 1.0 - torch.pow(beta1, t)
    c2 = 1.0 - torch.pow(beta2, t)
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                            tree_leaves(state.nu), tree_leaves(master)):
        g = g.float()
        tmp = g * (1 - beta1)                       # mu = b1 mu + (1-b1) g
        mu.mul_(beta1).add_(tmp)
        torch.mul(g, 1 - beta2, out=tmp)            # nu = b2 nu + (1-b2) g g
        tmp.mul_(g)
        nu.mul_(beta2).add_(tmp)
        torch.div(nu, c2, out=tmp)                  # sqrt(nu / c2) + eps
        tmp.sqrt_().add_(eps)
        upd = torch.div(mu, c1).div_(tmp)           # (mu / c1) / that
        torch.mul(p, weight_decay, out=tmp)         # p -= lr (upd + wd p)
        tmp.add_(upd).mul_(lr)
        p.sub_(tmp)
        del tmp, upd
    return master, state


# --------------------------------------------------------------- Adafactor
class AdafactorState(NamedTuple):
    v_row: Any    # factored second moment (rows) or full v for <2D params
    v_col: Any


def _factored(p) -> bool:
    """Judged on the leaf as held: a stack of norm vectors [L, D] is a
    matrix, factored across its layers, as in the reference."""
    return p.dim() >= 2


def adafactor_init(params) -> AdafactorState:
    def row(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def col(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(v_row=tree_map(row, params),
                          v_col=tree_map(col, params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, *, lr,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0, weight_decay: float = 0.0,
                     step: torch.Tensor = None, grad_scale=None):
    """Factored RMS update (Shazeer & Stern) in float32, written into the
    params (their dtype) and the moments in place.  Returns (params,
    state).

    ``grad_scale``: the global-norm clip's scale (a 0-d tensor in the
    gradients' dtype), applied here in float32 instead of by
    ``clip_by_global_norm``.  That is where XLA rounds in the reference's
    fused step: it multiplies a bfloat16 gradient by the bfloat16 scale in
    float32 and feeds the product to the update unrounded.  The update
    clip divides once by the product of its two denominators, as XLA
    rewrites ``u / a / b``."""
    t = step.float() + 1.0
    beta2 = 1.0 - torch.pow(t, -decay)
    for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.v_row),
                            tree_leaves(state.v_col), tree_leaves(params)):
        g32 = g.float()
        if grad_scale is not None:
            g32 = g32 * grad_scale.float()
        g2 = g32 * g32 + eps
        if _factored(p):
            vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
            # u = g / sqrt(v_hat), v_hat = outer(v_row, v_col) / mean(v_row)
            v_hat = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True
                                                  )[..., None], eps))
            denom = torch.clamp_min(torch.sqrt(v_hat), eps)
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            denom = torch.clamp_min(torch.sqrt(vr), eps)
        u = g32 / denom
        # update clipping (RMS(u) <= clip_threshold)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = g32 / (denom * torch.clamp_min(rms_u / clip_threshold, 1.0))
        p32 = p.float()
        p32 = p32 - lr * (u + weight_decay * p32)
        p.copy_(p32.to(p.dtype))
    return params, state

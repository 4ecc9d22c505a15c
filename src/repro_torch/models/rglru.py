"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427), PyTorch.

The counterpart of ``repro.models.rglru``.  The recurrence
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a diagonal
first-order linear recurrence: the prefill runs it through
``ops.decay_scan`` (the hand-written CUDA kernel on the card) where the JAX
package runs ``jax.lax.associative_scan``; decode keeps O(1) state and
takes one step in plain torch.

As in the reference, the gate branch goes through GELU twice
(``gate = gelu(x w_y)``, then ``gelu(gate) * h``), and both GELUs are
``jax.nn.gelu``'s tanh approximation.

Under a tensor-parallel context whose rules split ``ff`` over ``"model"``
the rank holds its channels: its columns of ``w_y`` / ``w_x``, its conv
channels, gates and decay, its rows of ``w_a`` / ``w_i`` (each gate's
product is summed over the ranks and reduce-scattered back to the rank's
channels) and of ``w_out`` (the block's output summed); the scan runs on
``width / model`` channels, and a decode state holds the rank's channels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Spec, causal_conv, gelu, shard

_C = 8.0  # RG-LRU recurrence-gate temperature


def rglru_specs(cfg) -> dict:
    D = cfg.d_model
    R = cfg.rglru_expand * D
    return {
        "w_y": Spec((D, R), ("embed", "ff")),        # gate branch
        "w_x": Spec((D, R), ("embed", "ff")),        # recurrent branch
        "conv_w": Spec((cfg.rglru_conv_width, R), (None, "ff"), "normal",
                       fan_in=cfg.rglru_conv_width),
        "conv_b": Spec((R,), ("ff",), "zeros"),
        "w_a": Spec((R, R), ("ff", "ff")),           # recurrence gate
        "b_a": Spec((R,), ("ff",), "zeros"),
        "w_i": Spec((R, R), ("ff", "ff")),           # input gate
        "b_i": Spec((R,), ("ff",), "zeros"),
        "lam": Spec((R,), ("ff",), "rglru_a"),       # learnable decay logits
        "w_out": Spec((R, D), ("ff", "embed"), fan_in=R),
    }


def _gate_in(xr, w, local):
    """xr [.., R(/model)] by w [R(/model), R]: the rank's channels of the
    product, its rows' partial sums reduce-scattered where split."""
    z = common.row_matmul(xr, w, local)
    if local:
        z = collectives.reduce_scatter_to_model(z, dctx.model_group(),
                                                -1).to(xr.dtype)
    return z


def _gates(p, xr, dtype, local=False):
    """(a, u), both float32: the decay and the recurrence input."""
    r = torch.sigmoid(_gate_in(xr, p["w_a"].to(dtype), local)
                      + p["b_a"].to(dtype))
    i = torch.sigmoid(_gate_in(xr, p["w_i"].to(dtype), local)
                      + p["b_i"].to(dtype))
    log_a = -_C * F.softplus(-p["lam"].float()) * r.float()  # log a_t <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, mult * i.float() * xr.float()


def is_local(cfg) -> bool:
    """Whether the block runs on the rank's channels (the rules split
    ``ff`` over ``"model"``)."""
    return dctx.is_local("ff", cfg.rglru_expand * cfg.d_model)


class RGLRUState(NamedTuple):
    conv: torch.Tensor  # [B, W-1, R]
    h: torch.Tensor     # [B, R] fp32


def rglru_block(p, x: torch.Tensor, cfg, return_state: bool = False):
    """Prefill.  x: [B, S, D] -> [B, S, D] (+ final RGLRUState).

    The recurrence runs as one ``decay_scan`` over ``[S, B*R]``: the batch
    is folded into the channels, so a prefill launches one scan per block.
    """
    local = is_local(cfg)
    dtype_in = x.dtype
    x = common.region_in(x, local)
    dt = x.dtype
    B, S, _ = x.shape
    gate = gelu(common.col_matmul(x, p["w_y"].to(dt), local))
    xr_pre = common.col_matmul(x, p["w_x"].to(dt), local)
    xr = causal_conv(xr_pre, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xr = shard(xr, "batch", "seq", "ff")
    a, u = _gates(p, xr, dt, local)
    R = a.shape[-1]
    fold = lambda t: t.transpose(0, 1).reshape(S, B * R).contiguous()
    h = ops.decay_scan(fold(a), fold(u)).reshape(S, B, R).transpose(0, 1)
    y = (gelu(gate).float() * h).to(dt)
    out = common.region_out(common.row_matmul(y, p["w_out"].to(dt), local),
                            local, dt)
    if return_state:
        W = cfg.rglru_conv_width
        # the last W-1 inputs of the conv, zeros before the first token
        conv = F.pad(xr_pre, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
        return out, RGLRUState(conv=conv.to(dtype_in).contiguous(),
                               h=h[:, -1].clone())
    return out


def rglru_init_state(cfg, batch: int, dtype, device) -> RGLRUState:
    R = cfg.rglru_expand * cfg.d_model
    R = len(range(R)[dctx.local_slice("ff", R)])
    return RGLRUState(
        conv=torch.zeros((batch, cfg.rglru_conv_width - 1, R), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, R), dtype=torch.float32, device=device))


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState, cfg):
    """x: [B, 1, D] -> ([B, 1, D], state); the state holds the rank's
    channels under a split ``ff``."""
    local = is_local(cfg)
    xt = common.region_in(x, local)[:, 0]
    dt = xt.dtype
    gate = gelu(common.col_matmul(xt, p["w_y"].to(dt), local))
    xr = common.col_matmul(xt, p["w_x"].to(dt), local)
    hist = torch.cat([state.conv.to(dt), xr[:, None]], dim=1)
    xr = torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(dt)) \
        + p["conv_b"].to(dt)
    a, u = _gates(p, xr[:, None], dt, local)
    h = a[:, 0] * state.h + u[:, 0]
    y = (gelu(gate).float() * h).to(dt)
    out = common.region_out(common.row_matmul(y, p["w_out"].to(dt), local),
                            local, dt)
    return out[:, None], RGLRUState(conv=hist[:, 1:].to(state.conv.dtype),
                                    h=h)

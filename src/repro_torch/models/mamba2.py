"""Mamba-2 (state-space duality / SSD) blocks, arXiv:2405.21060 (PyTorch).

The counterpart of ``repro.models.mamba2``.  The chunked SSD prefill has
an intra-chunk "attention-like" quadratic term, the chunk states, and the
inter-chunk recurrence h_{c+1} = decay_c * h_c + S_c: a diagonal
first-order linear recurrence over chunks, the same one the RG-LRU runs
over time.  The port runs it as one ``ops.decay_scan`` over
``[nC, B*H*N*P]`` (the hand-written CUDA kernel on the card) where the JAX
package runs ``lax.scan``; the quadratic term and the chunk states stay
plain torch products, as they stay outside any Pallas kernel in the
reference.  Casts to the compute dtype happen where the reference's do, so
the bfloat16 path rounds where JAX's does.  Decode keeps O(1) state and
takes one step in plain torch.

Under a tensor-parallel context whose rules split the SSD ``heads`` and
the inner width (``ff``) over ``"model"``, the rank runs its heads: its
columns of ``w_z`` / ``w_x`` / ``w_dt``, the whole ``w_B`` / ``w_C``
(every head reads them), the conv over its channels and B / C, the gated
norm over its channels with the sum of squares summed over the ranks,
``decay_scan`` over its heads' channels and its rows of ``w_out`` (the
output summed).  A decode state holds the rank's heads and conv
channels (``local_conv_state`` takes them from a whole one).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Spec, shard


def ssd_specs(cfg) -> dict:
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    H = d_inner // cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = d_inner + 2 * G * N
    return {
        "w_z": Spec((D, d_inner), ("embed", "ff")),
        "w_x": Spec((D, d_inner), ("embed", "ff")),
        "w_B": Spec((D, G * N), ("embed", None)),
        "w_C": Spec((D, G * N), ("embed", None)),
        "w_dt": Spec((D, H), ("embed", "heads")),
        "conv_w": Spec((cfg.ssm_conv_width, conv_ch), (None, "ff"), "normal",
                       fan_in=cfg.ssm_conv_width),
        "conv_b": Spec((conv_ch,), ("ff",), "zeros"),
        "dt_bias": Spec((H,), ("heads",), "ssm_dt"),
        "A_log": Spec((H,), ("heads",), "ssm_a"),
        "D_skip": Spec((H,), ("heads",), "ones"),
        "norm": Spec((d_inner,), ("ff",), "ones"),
        "w_out": Spec((d_inner, D), ("ff", "embed"), fan_in=d_inner),
    }


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < m <= i} dA[m] for i >= j else -inf.  dA: [..., Q]."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


class SSMState(NamedTuple):
    conv: torch.Tensor  # [B, W-1, conv_ch] trailing inputs
    h: torch.Tensor     # [B, H, N, P] fp32 SSM state


def is_local(cfg) -> bool:
    """Whether the block runs on the rank's heads (the rules split both
    the heads and the inner width over ``"model"``)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return dctx.is_local("heads", d_inner // cfg.ssm_head_dim) \
        and dctx.is_local("ff", d_inner)


def _conv_channels(cfg, device) -> torch.Tensor:
    """The conv channels the rank uses: its inner channels, then every
    B and C channel."""
    d_inner = cfg.ssm_expand * cfg.d_model
    sl = dctx.local_slice("ff", d_inner)
    GN2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return torch.cat([torch.arange(sl.start, sl.stop, device=device),
                      torch.arange(d_inner, d_inner + GN2, device=device)])


def _tp_params(p, cfg, local: bool):
    """The rank's parameters: every head reads the whole ``w_B``, ``w_C``
    and the conv (split over mixed channels, so gathered and cut to the
    rank's channels); their gradients are summed."""
    if not local:
        return p
    p = dict(p)
    for k in ("w_B", "w_C"):
        p[k] = common.region_param(p[k])
    idx = _conv_channels(cfg, p["conv_w"].device)
    for k, dim in (("conv_w", 1), ("conv_b", 0)):
        w = common.whole_param(p[k], "ff", dim, _conv_len(cfg))
        p[k] = w.index_select(dim, idx)
    return p


def _conv_len(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_groups * cfg.ssm_state


def local_conv_state(conv: torch.Tensor, cfg) -> torch.Tensor:
    """A whole decode conv state [B, W-1, conv_ch] -> the rank's channels
    (as is where the block runs whole)."""
    if not is_local(cfg) or conv.shape[-1] != _conv_len(cfg):
        return conv
    return conv.index_select(2, _conv_channels(cfg, conv.device))


def ssd_block(p, x: torch.Tensor, cfg, return_state: bool = False):
    """Prefill SSD.  x: [B, S, D] -> [B, S, D] (+ final SSMState).

    S must be a multiple of ``min(ssm_chunk, S)``, as in the reference:
    nothing is padded.
    """
    local = is_local(cfg)
    dtype = x.dtype
    x = common.region_in(x, local)
    p = _tp_params(p, cfg, local)
    B, S, _ = x.shape
    P = cfg.ssm_head_dim
    d_inner = p["w_x"].shape[-1]             # the rank's inner channels
    H = d_inner // P
    G, N = cfg.ssm_groups, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"ssd_block: sequence length {S} is not a multiple "
                         f"of the chunk {Q}")
    nC = S // Q

    z, xc, Bm, Cm, dt = (common.col_matmul(x, p[k].to(dtype), local)
                         for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))

    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out = F.silu(common.causal_conv(conv_in, p["conv_w"].to(dtype),
                                         p["conv_b"].to(dtype)))
    xc, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                       # [H]
    dA = dt * A                                              # [B,S,H]

    xh = shard(xc.reshape(B, S, H, P), "batch", None, "heads", None)
    rep = H // G                     # broadcast groups over heads
    Bg = Bm.reshape(B, nC, Q, G, N)
    Cg = Cm.reshape(B, nC, Q, G, N)
    Bq = Bg.repeat_interleave(rep, dim=3)                    # [B,nC,Q,H,N]
    Cq = Cg.repeat_interleave(rep, dim=3)
    xq = xh.reshape(B, nC, Q, H, P)
    dtq = dt.reshape(B, nC, Q, H)
    dAq = dA.reshape(B, nC, Q, H)

    # ---- intra-chunk (quadratic): float32 scores of the compute-dtype
    # inputs, computed once per group (every head of a group has the same)
    L = torch.exp(_segsum(dAq.permute(0, 1, 3, 2)))         # [B,nC,H,Q,Q]
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cg.float(), Bg.float())
    M = scores.repeat_interleave(rep, dim=2) * L
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M.to(dtype),
                           dtq.to(dtype)[..., None] * xq)

    # ---- chunk states: S_c = sum_j exp(dA_end - cs_j) dt_j B_j x_j^T
    cs = torch.cumsum(dAq, dim=2)                            # [B,nC,Q,H]
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    Sc = torch.einsum("bcqhn,bcqhp->bchnp",
                      (decay_to_end * dtq).to(dtype)[..., None] * Bq, xq)

    # ---- inter-chunk recurrence: one decay_scan over [nC, B*H*N*P].  The
    # scan's states are inclusive; the reference's h_prior is exclusive
    # (h_prior[0] = 0, h_prior[c] = h[c-1]), and its final state h[nC-1].
    chunk_decay = torch.exp(cs[:, :, -1, :])                 # [B,nC,H]
    a = chunk_decay.permute(1, 0, 2)[..., None, None].expand(
        nC, B, H, N, P).reshape(nC, -1).contiguous()
    u = Sc.float().permute(1, 0, 2, 3, 4).reshape(nC, -1).contiguous()
    h = ops.decay_scan(a, u).view(nC, B, H, N, P)
    h_final = h[-1].clone()
    h_prior = torch.cat([torch.zeros_like(h[:1]), h[:-1]]).permute(
        1, 0, 2, 3, 4)                                       # [B,nC,H,N,P]

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cq,
                           h_prior.to(dtype)) \
        * torch.exp(cs).to(dtype)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + p["D_skip"].to(dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, d_inner)
    y = _gated_norm(y * F.silu(z), p["norm"], cfg.norm_eps, local)
    out = common.region_out(common.row_matmul(y, p["w_out"].to(dtype),
                                              local), local, dtype)
    if return_state:
        W = cfg.ssm_conv_width
        # the last W-1 inputs of the conv, zeros before the first token
        conv = F.pad(conv_in, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
        return out, SSMState(conv=conv.to(dtype).contiguous(), h=h_final)
    return out


def _gated_norm(y, gamma, eps, local):
    return common.sharded_rms_norm(y, gamma, eps) if local else \
        common.rms_norm(y, gamma, eps)


def ssd_init_state(cfg, batch: int, dtype, device) -> SSMState:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, H, cfg.ssm_state, cfg.ssm_head_dim),
                      dtype=torch.float32, device=device))


def ssd_decode_step(p, x: torch.Tensor, state: SSMState, cfg):
    """Single-token SSD step.  x: [B, 1, D] -> ([B, 1, D], state)."""
    local = is_local(cfg)
    xt = common.region_in(x, local)[:, 0]
    dtype = xt.dtype
    p = _tp_params(p, cfg, local)
    B = x.shape[0]
    P = cfg.ssm_head_dim
    d_inner = p["w_x"].shape[-1]             # the rank's inner channels
    H = d_inner // P
    G, N = cfg.ssm_groups, cfg.ssm_state
    state = SSMState(conv=local_conv_state(state.conv, cfg), h=state.h)

    z, xc, Bm, Cm, dt = (common.col_matmul(xt, p[k].to(dtype), local)
                         for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))

    conv_in = torch.cat([xc, Bm, Cm], dim=-1)                  # [B, C]
    hist = torch.cat([state.conv, conv_in[:, None].to(state.conv.dtype)],
                     dim=1)                                    # [B, W, C]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist.to(dtype),
                                   p["conv_w"].to(dtype))
                      + p["conv_b"].to(dtype))
    xc, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                     # [B, H]

    xh = xc.reshape(B, H, P).float()
    rep = H // G
    Bh = Bm.reshape(B, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B, G, N).repeat_interleave(rep, dim=1).float()

    h = dA[..., None, None] * state.h \
        + (dt[..., None] * Bh)[..., None] * xh[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + p["D_skip"].float()[None, :, None] * xh
    y = y.reshape(B, d_inner).to(dtype)
    y = _gated_norm(y * F.silu(z), p["norm"], cfg.norm_eps, local)
    out = common.region_out(common.row_matmul(y, p["w_out"].to(dtype),
                                              local), local, dtype)
    return out[:, None], SSMState(conv=hist[:, 1:], h=h)

"""Feed-forward blocks (PyTorch): the gated SwiGLU MLP, the ungated GELU
MLP, and the sort-based mixture of experts.

The counterpart of ``repro.models.ffn``.  The MoE keeps the reference's
dropless-with-capacity formulation: a float32 router (padding experts
masked out of its softmax), top-k renormalised, the Switch/GShard aux loss
and the router z-loss; the k choices of every token are sorted by expert
id (a stable sort, as ``jnp.argsort``) and the first ``cap`` of each
expert are gathered into an [E, cap, D] block (the rest are dropped);
each expert's SwiGLU is three batched products; the outputs come back to
token order weighted by their gates.  The combine places each choice's
weighted output by the inverse of the sort and sums a token's k choices,
which is the reference's scatter-add without its float atomics on the
card.  ``models/moe_ep.py`` runs the same routing and dispatch with the
experts spread over ranks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import common
from repro_torch.models.common import Spec

NEG_INF = -1e30


def mlp_specs(d_model: int, d_ff: int, use_bias: bool = False,
              gated: bool = True) -> dict:
    s = {"w_up": Spec((d_model, d_ff)),
         "w_down": Spec((d_ff, d_model))}
    if gated:
        s["w_gate"] = Spec((d_model, d_ff))
    if use_bias:
        s["b_up"] = Spec((d_ff,), "zeros")
        s["b_down"] = Spec((d_model,), "zeros")
        if gated:
            s["b_gate"] = Spec((d_ff,), "zeros")
    return s


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D], in x's dtype."""
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    if "b_up" in p:
        u = u + p["b_up"].to(x.dtype)
    if "w_gate" in p:       # SwiGLU
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        if "b_gate" in p:
            g = g + p["b_gate"].to(x.dtype)
        h = common.swiglu(g, u)
    else:                       # ungated GELU (hubert / wav2vec2 family)
        h = common.gelu(u)
    out = torch.matmul(h, p["w_down"].to(x.dtype))
    if "b_down" in p:
        out = out + p["b_down"].to(x.dtype)
    return out


# ------------------------------------------------------------------------ MoE
def moe_specs(d_model: int, moe_d_ff: int, num_experts_padded: int,
              num_shared: int = 0) -> dict:
    E = num_experts_padded
    s = {"router": Spec((d_model, E), fan_in=d_model),
         "w_gate": Spec((E, d_model, moe_d_ff), fan_in=d_model),
         "w_up": Spec((E, d_model, moe_d_ff), fan_in=d_model),
         "w_down": Spec((E, moe_d_ff, d_model), fan_in=moe_d_ff)}
    if num_shared > 0:
        s["shared"] = mlp_specs(d_model, num_shared * moe_d_ff)
        s["shared_gate"] = Spec((d_model, 1), "zeros")
    return s


def route(xf: torch.Tensor, router_w: torch.Tensor, num_experts: int,
          top_k: int):
    """The router: xf [T, D] -> (gate weights [T, k] renormalised, expert
    ids [T, k], aux loss, z loss).  Experts at or past ``num_experts``
    (the padding) get -1e30 logits, so no token picks one."""
    logits = torch.matmul(xf.float(), router_w.float())
    E_pad = logits.shape[-1]
    if E_pad > num_experts:
        logits[:, num_experts:] = NEG_INF
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; so does a stable
    # descending sort
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, eid = top.values[:, :top_k], top.indices[:, :top_k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss (Switch/GShard) + router z-loss; the expert
    # counts are whole numbers, exact in float32 in any order
    me = probs.mean(0)
    ce = torch.zeros(E_pad, dtype=probs.dtype, device=probs.device)
    ce.index_add_(0, eid.reshape(-1), torch.ones_like(gate_w).reshape(-1))
    ce = ce / eid.numel()
    aux = num_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gate_w, eid, aux, z


def sort_slots(eid: torch.Tensor, cap: int):
    """The sort-based dispatch order of the flattened choices [T * k]:
    ``order`` (a stable argsort by expert id), the sorted expert ids, each
    sorted choice's slot within its expert, and ``keep`` (slot < cap)."""
    flat_e = eid.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(flat_e.numel(), device=eid.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start
    return order, sorted_e, rank, rank < cap


def experts_swiglu(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: xe [E, C, D] -> [E, C, D]."""
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    u = torch.bmm(xe, w_up.to(xe.dtype))
    return torch.bmm(common.swiglu(g, u), w_down.to(xe.dtype))


def combine(rows, keep, order, gate_w, top_k: int) -> torch.Tensor:
    """rows [T * k, D]: each sorted choice's expert output (anything where
    dropped) -> [T, D], each token's kept outputs times their gates,
    summed over its k choices."""
    w_flat = gate_w.reshape(-1)[order]
    contrib = torch.where(keep[:, None],
                          rows * w_flat[:, None].to(rows.dtype), 0)
    placed = torch.empty_like(contrib)
    placed[order] = contrib
    return placed.view(-1, top_k, rows.shape[-1]).sum(1)


def shared_expert(p, x) -> torch.Tensor:
    """The shared expert under its float32 sigmoid gate: x [B, S, D] ->
    [B, S, D]."""
    sg = torch.sigmoid(torch.matmul(x.float(), p["shared_gate"].float()))
    return mlp(p["shared"], x) * sg.to(x.dtype)


def capacity(T: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert: ceil(T k / E * cf) rounded up to 256, at least
    256 (the reference rounds so the capacity dim can co-shard with the
    data axis)."""
    cap = int(math.ceil(T * top_k / num_experts * capacity_factor))
    return max(256, -(-cap // 256) * 256)


def moe(p, x: torch.Tensor, *, num_experts: int, top_k: int,
        capacity_factor: float = 1.25,
        deterministic_capacity: Optional[int] = None):
    """Mixture-of-experts block.  x: [B, S, D] -> (y, metrics).

    ``num_experts`` is the logical expert count (the parameters may hold
    more: the padding, masked out of routing).  ``metrics`` holds
    ``moe_aux_loss``, ``moe_z_loss`` and ``moe_drop_frac`` (the share of
    the T * k choices past their expert's capacity) as 0-d tensors.
    """
    B, S, D = x.shape
    E_pad = p["router"].shape[1]
    T = B * S
    xf = x.reshape(T, D)
    gate_w, eid, aux, z = route(xf, p["router"], num_experts, top_k)
    cap = deterministic_capacity if deterministic_capacity is not None \
        else capacity(T, top_k, num_experts, capacity_factor)
    order, sorted_e, rank, keep = sort_slots(eid, cap)
    n = E_pad * cap
    dest = torch.where(keep, sorted_e * cap + rank, n)   # n: dropped
    # one spare row takes every dropped choice and is cut off
    buf = x.new_zeros(n + 1, D)
    buf[dest] = xf[order // top_k]
    ye = experts_swiglu(buf[:n].view(E_pad, cap, D), p["w_gate"],
                        p["w_up"], p["w_down"]).reshape(n, D)
    y = combine(ye[torch.clamp_max(dest, n - 1)], keep, order, gate_w,
                top_k)
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + shared_expert(p, x)
    metrics = {"moe_aux_loss": aux, "moe_z_loss": z,
               "moe_drop_frac": 1.0 - keep.float().mean()}
    return y, metrics

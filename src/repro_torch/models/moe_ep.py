"""Expert-parallel MoE with explicit all-to-all dispatch (PyTorch).

The counterpart of ``repro.models.moe_ep``, one process a mesh device:
the JAX function runs its body inside ``shard_map`` over the mesh, and
here every rank of a ``torch.distributed`` ``DeviceMesh``
(``launch.mesh.make_model_mesh``, read from ``distributed.context`` when
not given) runs that body on its own share.

Ownership, as the reference's: every rank calls ``moe_ep`` with the same
whole ``x`` [B, S, D] (as every rank of the sharded engine gets the whole
stream); rank (d, m) owns batch block d over ``"data"`` and sequence
chunk m over ``"model"``, routes only its own ``tc`` tokens, and holds
the experts ``[m E_loc, (m + 1) E_loc)``, ``E_loc = E_pad / M``
(``local_experts`` cuts them out of the full tree as views).  Dispatch is
a [M, E_loc, cap, D] buffer, one block per peer on the ``"model"`` dim,
with ``cap = max(8, ceil(tc k / E_pad * cf))`` rounded up to 8; one
``all_to_all`` takes the blocks to their experts and one brings the
outputs back.  The shared expert runs on the rank's own chunk; the chunks
are then gathered so every rank returns the whole ``y``, and the aux and
z losses and the drop fraction are averaged over the ranks.

Without a mesh, without a ``"model"`` dim, or where B, S or E_pad does
not divide over the mesh, it falls back to the dense ``ffn.moe``, as the
reference does (that needs the full tree).  The decode keeps the dense
path (``models/backbone.decode_block``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
from repro_torch.models import ffn

MODEL_AXIS, DATA_AXIS = "model", "data"
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

__all__ = ["moe_ep", "local_experts", "ep_capacity"]


def ep_capacity(tc: int, top_k: int, E_pad: int,
                capacity_factor: float) -> int:
    """Slots a (rank, expert) pair: ceil(tc k / E_pad * cf) rounded up to
    8, at least 8."""
    cap = int(math.ceil(tc * top_k / E_pad * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _model_rank(mesh) -> Tuple[int, int]:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(MODEL_AXIS)), mesh.get_local_rank(MODEL_AXIS)


def local_experts(p, mesh) -> dict:
    """The rank's share of a full MoE tree (``ffn.moe_specs``): the expert
    leaves cut to the rank's ``E_pad / M`` experts on the ``"model"`` dim
    (views, no copy); the router and the shared expert whole."""
    M, m = _model_rank(mesh)
    E_pad = p["router"].shape[1]
    if E_pad % M:
        raise ValueError(f"{E_pad} experts do not divide over {M} ranks")
    E_loc = E_pad // M
    out = {k: p[k] for k in ("router", "shared", "shared_gate") if k in p}
    for k in EXPERT_LEAVES:
        if p[k].shape[0] != E_pad:
            raise ValueError(f"{k} holds {p[k].shape[0]} experts, not the "
                             f"full {E_pad}")
        out[k] = p[k][m * E_loc:(m + 1) * E_loc]
    return out


def _owned_chunk_moe(xc, router_w, w_gate, w_up, w_down, *,
                     num_experts: int, top_k: int, cap: int, group, M: int):
    """The EP body for one rank's owned chunk.  xc: [tc, D]; w_*: the
    rank's [E_loc, ...] experts."""
    tc, D = xc.shape
    E_loc = w_gate.shape[0]
    gate_w, eid, aux, z = ffn.route(xc, router_w, num_experts, top_k)
    order, sorted_e, rank, keep = ffn.sort_slots(eid, cap)
    # expert e = shard * E_loc + local, so the [M, E_loc, cap] buffer is
    # expert-major: choice -> e * cap + slot; n takes the dropped ones
    n = M * E_loc * cap
    dest = torch.where(keep, sorted_e * cap + rank, n)
    buf = xc.new_zeros(n + 1, D)
    buf[dest] = xc[order // top_k]

    # EP exchange out: each expert receives its tokens from every peer
    recv = collectives.all_to_all(buf[:n].view(M, E_loc, cap, D), group)
    xe = recv.transpose(0, 1).reshape(E_loc, M * cap, D)
    ye = ffn.experts_swiglu(xe, w_gate, w_up, w_down)

    # EP exchange back: the outputs return to the tokens' owners
    back = ye.view(E_loc, M, cap, D).transpose(0, 1).contiguous()
    ret = collectives.all_to_all(back, group).reshape(n, D)
    y = ffn.combine(ret[torch.clamp_max(dest, n - 1)], keep, order, gate_w,
                    top_k)
    drop = 1.0 - keep.float().mean()
    return y, aux, z, drop


def moe_ep(p, x: torch.Tensor, *, num_experts: int, top_k: int,
           capacity_factor: float = 1.25, mesh=None):
    """Drop-in replacement for ``ffn.moe`` with explicit EP all-to-all.
    x: [B, S, D], the same on every rank -> (y [B, S, D], metrics), the
    same on every rank.  ``p`` is the full tree (``ffn.moe_specs``) or the
    rank's share of it (``local_experts``)."""
    mesh = mesh if mesh is not None else dctx.get_mesh()
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    B, S, D = x.shape
    E_pad = p["router"].shape[1]
    sizes = {a: mesh.size(names.index(a)) for a in names}
    n_data, M = sizes.get(DATA_AXIS, 1), sizes.get(MODEL_AXIS, 1)
    if MODEL_AXIS not in names or B % n_data or S % M or E_pad % M:
        if p["w_gate"].shape[0] != E_pad:
            raise ValueError("moe_ep falls back to the dense ffn.moe here, "
                             "which needs the full expert tree")
        return ffn.moe(p, x, num_experts=num_experts, top_k=top_k,
                       capacity_factor=capacity_factor)
    if p["w_gate"].shape[0] != E_pad // M:
        p = local_experts(p, mesh)
    _, m = _model_rank(mesh)
    d = mesh.get_local_rank(DATA_AXIS) if DATA_AXIS in names else 0
    b_loc, s_loc = B // n_data, S // M
    tc = b_loc * s_loc
    cap = ep_capacity(tc, top_k, E_pad, capacity_factor)

    xb = x[d * b_loc:(d + 1) * b_loc, m * s_loc:(m + 1) * s_loc]
    y, aux, z, drop = _owned_chunk_moe(
        xb.reshape(tc, D), p["router"], p["w_gate"], p["w_up"],
        p["w_down"], num_experts=num_experts, top_k=top_k, cap=cap,
        group=mesh.get_group(MODEL_AXIS), M=M)
    y = y.reshape(b_loc, s_loc, D)
    if "shared" in p:
        y = y + ffn.shared_expert(p, xb)

    groups = [mesh.get_group(a) for a in (DATA_AXIS, MODEL_AXIS)
              if a in names]
    y = collectives.gather_cat(y, groups[-1], dim=1)
    if len(groups) == 2:
        y = collectives.gather_cat(y, groups[0], dim=0)
    aux, z, drop = collectives.mean_over(torch.stack([aux, z, drop]),
                                         groups).unbind()
    return y, {"moe_aux_loss": aux, "moe_z_loss": z, "moe_drop_frac": drop}

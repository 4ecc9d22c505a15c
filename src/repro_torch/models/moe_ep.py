"""Expert-parallel MoE with explicit all-to-all dispatch (PyTorch).

The counterpart of ``repro.models.moe_ep``, one process a mesh device:
the JAX function runs its body inside ``shard_map`` over the mesh, and
here every rank of a ``torch.distributed`` ``DeviceMesh`` runs that body
on its own share.

Ownership, as the reference's: rank (d, m) owns batch block d over the
data axes (``"pod"``, ``"data"``) and sequence chunk m over ``"model"``,
routes only its own ``tc`` tokens, and holds the experts ``[m E_loc,
(m + 1) E_loc)``, ``E_loc = E_pad / M``.  Dispatch is a [M, E_loc, cap,
D] buffer, one block per peer on the ``"model"`` dim, with ``cap =
max(8, ceil(tc k / E_pad * cf))`` rounded up to 8; one ``all_to_all``
takes the blocks to their experts and one brings the outputs back.  The
chunks are gathered over ``"model"``, and the aux and z losses and the
drop fraction are averaged over every rank's chunk.

Two ways in:

* Called with a mesh (``mesh=`` or ``distributed.context.mesh_context``,
  e.g. ``launch.mesh.make_model_mesh`` inside a ``run_ranks`` rank):
  every rank passes the same whole ``x`` [B, S, D] and gets the whole
  ``y``; ``p`` is the full tree or the rank's share (``local_experts``);
  the shared expert runs on the rank's chunk, gathered with the rest.
* Inside a train or serve step under a mesh with a ``"model"`` axis (the
  step's ``batch_context`` / ``tp_context``; ``moe_impl="ep_a2a"``): the
  rank holds its batch rows already (the data axes split the batch) and
  its ``"model"`` shard of the MoE tree, which the step's gather kept:
  its experts, its router columns (gathered whole here) and its columns
  of the shared expert, which runs tensor-parallel on the whole rows as
  the reference's GSPMD runs ``mlp(p["shared"], x)``.  It returns the
  rank's rows, as the block of the residual stream it is.

Where the mesh has no ``"model"`` dim, or B (over the data axes), S or
E_pad does not divide, it falls back as the reference does: to the dense
``ffn.moe`` on the whole tree, or in a step to the step's expert-parallel
``ffn.moe(sizes=)`` (there too where the step left the batch's rows whole
on every rank, as it does where they do not divide over the data axes).
The decode keeps ``ffn.moe``
(``models/backbone.decode_block``).

It is differentiable, as the reference is through its ``shard_map``: each
all-to-all's backward is the reverse all-to-all (the same exchange, which
is its own inverse), the gather of the chunks gives each rank its chunk's
gradient, and the mean of the losses hands each chunk its share of the
loss's gradient.  With a mesh given, the whole ``x``, the router and the
shared expert enter every rank alike, so their gradients are summed over
the mesh in the backward, and each rank's experts' over the ``"data"``
dim: every rank then holds the single-program gradient of what it holds.
Inside a step the data axes' sums are the step's (each rank
differentiates its share of the loss): ``x``'s and the router's
gradients are summed over ``"model"`` only, and the losses' mean sums
its gradient over the data axes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.models import common, ffn

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


def local_experts(p, mesh, E_pad: Optional[int] = None) -> dict:
    """The rank's share of a MoE tree (``ffn.moe_specs``): the expert
    leaves cut to the rank's ``E_pad / M`` experts on the ``"model"`` dim
    (views, no copy), a leaf that holds just those already (a step's
    ``"model"`` shard) kept as it is; the router and the shared expert as
    given.  ``E_pad``: the whole expert count (default: the router's
    columns, the router whole)."""
    M, m = _model_rank(mesh)
    E_pad = p["router"].shape[1] if E_pad is None else E_pad
    if E_pad % M:
        raise ValueError(f"{E_pad} experts do not divide over {M} ranks")
    E_loc = E_pad // M
    out = {k: p[k] for k in ("router", "shared", "shared_gate") if k in p}
    for k in EXPERT_LEAVES:
        n = p[k].shape[0]
        if n == E_loc:
            out[k] = p[k]
        elif n == E_pad:
            out[k] = p[k][m * E_loc:(m + 1) * E_loc]
        else:
            raise ValueError(f"{k} holds {n} experts, neither the full "
                             f"{E_pad} nor a rank's {E_loc}")
    return out


class _AllToAll(torch.autograd.Function):
    """``collectives.all_to_all``; its backward sends each gradient block
    back where its block came from, which is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives.all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_to_all(g.contiguous(), ctx.group), None


class _GatherCat(torch.autograd.Function):
    """``collectives.gather_cat``; every rank computes alike from the whole
    result, so a rank's gradient is its own chunk of the result's."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = torch.distributed.get_rank(group)
        return collectives.gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _MeanOver(torch.autograd.Function):
    """``collectives.mean_over``; a rank's share of the mean's gradient is
    1/n of it, summed first over ``sum_grad`` (the groups whose ranks
    differentiate shares of the loss, where the mean's other ranks
    differentiate the same loss)."""

    @staticmethod
    def forward(ctx, x, groups, sum_grad=()):
        ctx.n, ctx.sum_grad = 1, list(sum_grad)
        for g in groups:
            ctx.n *= torch.distributed.get_world_size(g)
        return collectives.mean_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = collectives.sum_over(g.contiguous(), ctx.sum_grad)
        return g / ctx.n, None, None


class _SumGradOver(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``groups``: an
    input every rank holds alike and uses a part of."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.sum_over(g.contiguous(), ctx.groups), None


def _shared_in(x, groups):
    if not groups or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _SumGradOver.apply(x, groups)


def _shared_tree(t, groups):
    if isinstance(t, torch.Tensor):
        return _shared_in(t, groups)
    if isinstance(t, dict):
        return {k: _shared_tree(v, groups) for k, v in t.items()}
    return t        # a frozen serving tree takes no gradient


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
    recv = _AllToAll.apply(buf[:n].view(M, E_loc, cap, D), group)
    xe = recv.transpose(0, 1).reshape(E_loc, M * cap, D)
    ye = ffn.experts_swiglu(xe, w_gate, w_up, w_down)

    # EP exchange back: the outputs return to the tokens' owners
    back = ye.view(E_loc, M, cap, D).transpose(0, 1).contiguous()
    ret = _AllToAll.apply(back, group).reshape(n, D)
    y = ffn.combine(ret[torch.clamp_max(dest, n - 1)], keep, order, gate_w,
                    top_k)
    drop = 1.0 - keep.float().mean()
    return y, aux, z, drop


def moe_ep(p, x: torch.Tensor, *, num_experts: int, top_k: int,
           capacity_factor: float = 1.25, mesh=None,
           sizes: Optional[ffn.MoESizes] = None):
    """Drop-in replacement for ``ffn.moe`` with explicit EP all-to-all.
    x: [B, S, D] -> (y [B, S, D], metrics).  With a mesh (``mesh`` or the
    installed ``mesh_context``) ``x`` and ``y`` are whole and the same on
    every rank, and ``p`` is the full tree or the rank's share of it
    (``local_experts``); without one, inside a train or serve step under
    a mesh, they are the rank's rows of the step's batch and ``p`` the
    step's ``"model"`` shard (``sizes``: the block's whole sizes, as
    ``ffn.moe`` takes them)."""
    if mesh is None and dctx.get_mesh() is None \
            and dctx.step_mesh() is not None:
        return _moe_ep_step(p, x, num_experts=num_experts, top_k=top_k,
                            capacity_factor=capacity_factor, sizes=sizes)
    mesh = mesh if mesh is not None else dctx.get_mesh()
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    B, S, D = x.shape
    E_pad = p["router"].shape[1]
    axes = {a: mesh.size(names.index(a)) for a in names}
    n_data, M = axes.get(DATA_AXIS, 1), axes.get(MODEL_AXIS, 1)
    if MODEL_AXIS not in names or B % n_data or S % M or E_pad % M:
        if p["w_gate"].shape[0] != E_pad:
            raise ValueError("moe_ep falls back to the dense ffn.moe here, "
                             "which needs the full expert tree")
        return ffn.moe(p, x, num_experts=num_experts, top_k=top_k,
                       capacity_factor=capacity_factor)
    if p["w_gate"].shape[0] != E_pad // M:
        p = local_experts(p, mesh)
    groups = [mesh.get_group(a) for a in (DATA_AXIS, MODEL_AXIS)
              if a in names]
    # gradients: what every rank holds alike sums over the mesh, each
    # rank's experts over the data dim (backward only; the forward is the
    # identity)
    if torch.is_grad_enabled():
        x = _shared_in(x, groups)
        p = {k: (_shared_in(v, groups[:-1]) if k in EXPERT_LEAVES else
                 _shared_tree(v, groups)) for k, v in p.items()}
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

    y = _GatherCat.apply(y, groups[-1], 1)
    if len(groups) == 2:
        y = _GatherCat.apply(y, groups[0], 0)
    aux, z, drop = _MeanOver.apply(torch.stack([aux, z, drop]),
                                   groups).unbind()
    y = dctx.shard(y, "batch", "seq", None)
    return y, {"moe_aux_loss": aux, "moe_z_loss": z, "moe_drop_frac": drop}


def _moe_ep_step(p, h, *, num_experts: int, top_k: int,
                 capacity_factor: float, sizes: Optional[ffn.MoESizes]):
    """``moe_ep`` inside a train or serve step: ``h`` the rank's rows
    (under ``seq_parallel`` its share of them), ``p`` its ``"model"``
    shard; the mesh is the step's (``distributed.context.step_mesh``)."""
    mesh = dctx.step_mesh()
    E_pad = p["router"].shape[1] if sizes is None else sizes.experts
    kw = dict(num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    axes = mesh_sizes(mesh)
    if MODEL_AXIS not in axes:
        return ffn.moe(p, h, sizes=sizes, **kw)
    M = axes[MODEL_AXIS]
    n_data = math.prod(axes[a] for a in ("pod", DATA_AXIS) if a in axes)
    split = dctx.batch_split()
    rows = 1 if split is None else split.size
    x = common.region_in(h, False)          # the rows whole
    B, S, D = x.shape
    if rows != n_data or S % M or E_pad % M:
        # B over the data axes does not divide, so the step left the rows
        # whole on every rank: the step's expert-parallel ffn.moe
        return ffn.moe(p, h, sizes=sizes, **kw)
    p = local_experts(p, mesh, E_pad)
    names = tuple(mesh.mesh_dim_names)
    ep_group = mesh.get_group(names.index(MODEL_AXIS))
    # each rank routes its own chunk: the router's and x's gradients are
    # partial, summed over "model"
    group = ep_group if M > 1 else None
    router = p["router"]
    router = collectives.gather_model(router, group, 1, sum_grad=True) \
        if router.shape[1] < E_pad else \
        collectives.copy_to_model(router, group)
    xr = collectives.copy_to_model(x, group)
    m = _model_rank(mesh)[1]
    s_loc = S // M
    cap = ep_capacity(B * s_loc, top_k, E_pad, capacity_factor)
    y, aux, z, drop = _owned_chunk_moe(
        xr[:, m * s_loc:(m + 1) * s_loc].reshape(-1, D), router,
        p["w_gate"], p["w_up"], p["w_down"], num_experts=num_experts,
        top_k=top_k, cap=cap, group=ep_group, M=M)
    y = y.reshape(B, s_loc, D)
    if M > 1:
        y = _GatherCat.apply(y, ep_group, 1)
    data = dctx.data_groups()
    aux, z, drop = _MeanOver.apply(torch.stack([aux, z, drop]),
                                   data + [ep_group], data).unbind()
    if "shared" in p:
        # the reference's ``mlp(p["shared"], x)`` over the whole rows, its
        # ``ff`` split over "model" where the rules split it
        F = sizes.shared_d_ff if sizes is not None \
            else p["shared"]["w_up"].shape[1]
        local = dctx.is_local("ff", F)
        sh = ffn.mlp_partial(p["shared"], x, local, sp=False)
        if local:
            sh = collectives.reduce_from_model(sh, dctx.model_group())
        sg = torch.sigmoid(torch.matmul(x.float(),
                                        p["shared_gate"].float()))
        y = y + sh.to(x.dtype) * sg.to(x.dtype)
    y = common.region_out(y, False)
    return y, {"moe_aux_loss": aux, "moe_z_loss": z, "moe_drop_frac": drop}

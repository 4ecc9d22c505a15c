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
experts spread over ranks by all-to-alls.

Under a tensor-parallel context the MLP splits its hidden width over
``"model"`` (``mlp(d_ff=)``), and the MoE block (``moe(sizes=)``) splits
as GSPMD partitions the reference's: where the rules put ``"experts"`` on
``"model"`` each rank holds ``E_pad / M`` whole experts, else where they
put ``"ff"`` there each holds its columns of every expert (column- then
row-parallel, as the MLP).  Every rank routes the whole rows alike (the
experts' logits gathered), dispatches only the choices its experts or
columns serve, and sums its tokens' partial outputs in float32; one
all-reduce over ``"model"`` (under ``seq_parallel`` a reduce-scatter)
adds the ranks' sums and the shared expert's, rounded once: a decode
step moves its rows' logits and output, no weight.  Where a
batch is split over data ranks (``distributed.context.data_groups``), the
routing statistics, the capacity and each expert's slot numbers are the
whole batch's, as in the reference's one program, and the [E, cap, D]
buffer's capacity is split over ``"data"`` as the reference's rules
split it: each data rank runs its block of every expert's slots, the
choices sent there and back by all-to-all.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed import context as dctx
from repro_torch.models import common
from repro_torch.models.common import Spec, shard

NEG_INF = -1e30


def mlp_specs(d_model: int, d_ff: int, use_bias: bool = False,
              gated: bool = True) -> dict:
    s = {"w_up": Spec((d_model, d_ff), ("embed", "ff")),
         "w_down": Spec((d_ff, d_model), ("ff", "embed"))}
    if gated:
        s["w_gate"] = Spec((d_model, d_ff), ("embed", "ff"))
    if use_bias:
        s["b_up"] = Spec((d_ff,), ("ff",), "zeros")
        s["b_down"] = Spec((d_model,), ("embed",), "zeros")
        if gated:
            s["b_gate"] = Spec((d_ff,), ("ff",), "zeros")
    return s


def mlp(p, x: torch.Tensor, *, d_ff: Optional[int] = None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D], in x's dtype.

    With ``d_ff`` (the whole hidden width) the MLP is a block of the
    residual stream under the installed tensor-parallel context: where
    the rules split ``ff`` over ``"model"`` the rank holds its columns of
    ``w_up`` / ``w_gate`` and rows of ``w_down`` (column- then
    row-parallel) and the partial outputs are summed
    (``common.region_out``).  Without it the weights are taken as they
    are."""
    local = d_ff is not None and dctx.is_local("ff", d_ff)
    if d_ff is not None:
        x = common.region_in(x, local)
    dt = x.dtype
    out = mlp_partial(p, x, local)
    if d_ff is not None:
        out = common.region_out(out, local, dt)
    if "b_down" in p:
        b = p["b_down"] if d_ff is None else common.row_param(p["b_down"])
        out = out + b.to(out.dtype)
    return shard(out, "batch", "seq", None)


def mlp_partial(p, x: torch.Tensor, local: bool,
                sp: Optional[bool] = None, f: bool = True) -> torch.Tensor:
    """The MLP's output before its bias: where ``local``, the rank's
    partial sum over its ``ff`` columns (float32 from bfloat16 inputs,
    ``common.row_matmul``), its input's gradient summed over ``"model"``
    (``common.col_matmul``; ``sp``: whether ``x`` holds the rank's rows;
    ``f=False``: the caller's input carries Megatron's f already)."""
    dt = x.dtype
    u = common.col_matmul(x, p["w_up"].to(dt), local and f, sp)
    if "b_up" in p:
        u = u + p["b_up"].to(dt)
    if "w_gate" in p:       # SwiGLU
        g = common.col_matmul(x, p["w_gate"].to(dt), local and f, sp)
        if "b_gate" in p:
            g = g + p["b_gate"].to(dt)
        g = shard(g, "batch", "seq", "ff")
        h = common.swiglu(g, u)
    else:                       # ungated GELU (hubert / wav2vec2 family)
        h = common.gelu(shard(u, "batch", "seq", "ff"))
    return common.row_matmul(h, p["w_down"].to(dt), local)


# ------------------------------------------------------------------------ MoE
def moe_specs(d_model: int, moe_d_ff: int, num_experts_padded: int,
              num_shared: int = 0) -> dict:
    E = num_experts_padded
    s = {"router": Spec((d_model, E), ("embed", "experts"), fan_in=d_model),
         "w_gate": Spec((E, d_model, moe_d_ff), ("experts", "embed", "ff"),
                        fan_in=d_model),
         "w_up": Spec((E, d_model, moe_d_ff), ("experts", "embed", "ff"),
                      fan_in=d_model),
         "w_down": Spec((E, moe_d_ff, d_model), ("experts", "ff", "embed"),
                        fan_in=moe_d_ff)}
    if num_shared > 0:
        s["shared"] = mlp_specs(d_model, num_shared * moe_d_ff)
        s["shared_gate"] = Spec((d_model, 1), ("embed", None), "zeros")
    return s


class MoESizes(NamedTuple):
    """A MoE block's whole sizes: the padded expert count, each expert's
    hidden width and the shared expert's (0: none)."""
    experts: int
    d_ff: int
    shared_d_ff: int = 0


def moe_sizes(cfg) -> MoESizes:
    return MoESizes(cfg.num_experts_padded, cfg.moe_d_ff,
                    cfg.num_shared_experts * cfg.moe_d_ff)


def moe_split(sizes: MoESizes) -> Optional[str]:
    """Which dim of the expert weights the installed tensor-parallel rules
    split over ``"model"`` (``pspec_for``'s choice for ``("experts",
    "embed", "ff")``): ``"experts"`` (each rank ``E_pad / M`` whole
    experts), ``"ff"`` (each rank its columns of every expert), or None
    (the block runs whole on every rank, its parameters gathered)."""
    if dctx.is_local("experts", sizes.experts):
        return "experts"
    if dctx.is_local("ff", sizes.d_ff):
        return "ff"
    return None


def router_logits(xf: torch.Tensor, router_w: torch.Tensor,
                  num_experts: int, group=None) -> torch.Tensor:
    """The float32 router logits [T, E_pad], the padding experts (at or
    past ``num_experts``) at -1e30 so that no token picks one.  With
    ``group`` the router holds the rank's columns (its experts): each
    rank computes its experts' logits and they are gathered, so a
    step moves the tokens' logits and no router weight (``xf`` is then
    rank-local compute's input, its gradient summed over the ranks by the
    caller; the gathered logits' gradient is the rank's columns': every
    rank routes alike from them)."""
    logits = torch.matmul(xf.float(), router_w.float())
    if group is not None:
        logits = collectives.gather_model(logits, group, 1)
    if logits.shape[-1] > num_experts:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= num_experts
        logits = torch.where(pad, NEG_INF, logits)
    return logits


def _top_k(logits: torch.Tensor, top_k: int):
    """(probabilities, gate weights [T, k] renormalised, expert ids)."""
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; so does a stable
    # descending sort
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, eid = top.values[:, :top_k], top.indices[:, :top_k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, eid


def _choice_counts(eid: torch.Tensor, E_pad: int) -> torch.Tensor:
    """How many of the choices ``eid`` pick each expert (float32 whole
    numbers, exact in any order)."""
    ce = torch.zeros(E_pad, dtype=torch.float32, device=eid.device)
    ce.index_add_(0, eid.reshape(-1), torch.ones(
        eid.numel(), dtype=torch.float32, device=eid.device))
    return ce


def route(xf: torch.Tensor, router_w: torch.Tensor, num_experts: int,
          top_k: int):
    """The router of a batch this rank holds whole: xf [T, D] -> (gate
    weights [T, k] renormalised, expert ids [T, k], aux loss, z loss).
    Experts at or past ``num_experts`` (the padding) get -1e30 logits, so
    no token picks one."""
    return route_over(router_logits(xf, router_w, num_experts),
                      num_experts, top_k, [])


def route_over(logits: torch.Tensor, num_experts: int, top_k: int,
               groups: list):
    """The routing from the router's logits [T, E_pad] (``router_logits``)
    of a batch whose rows the ranks of ``groups`` split in equal shares
    (none: this rank holds them all): (gate weights, expert ids, aux
    loss, z loss).  The losses are the whole batch's, as the reference
    computes them in one program: every expert's summed probabilities
    and choice counts and the summed squared log-sum-exps are summed over
    the ranks.  The float sums feed this rank's compute again, so their
    gradient is summed over the ranks too (``collectives.
    sum_in_region``): each rank differentiates its share of the loss."""
    probs, gate_w, eid = _top_k(logits, top_k)
    E_pad = logits.shape[-1]
    sums = torch.cat([probs.sum(0), _choice_counts(eid, E_pad), torch.sum(
        torch.logsumexp(logits, dim=-1) ** 2)[None]])
    T = logits.shape[0]
    for g in groups:
        sums = collectives.sum_in_region(sums, g)
        T *= g.size()
    me, ce = sums[:E_pad] / T, sums[E_pad:2 * E_pad] / (T * top_k)
    aux = num_experts * torch.sum(me * ce)
    return gate_w, eid, aux, sums[-1] / T


def sort_slots(eid: torch.Tensor, cap: int,
               offset: Optional[torch.Tensor] = None):
    """The sort-based dispatch order of the flattened choices [T * k]:
    ``order`` (a stable argsort by expert id), the sorted expert ids, each
    sorted choice's slot within its expert, and ``keep`` (slot < cap).
    ``offset`` [E_pad] (int64): each expert's slots taken before these
    choices (by the ranks before this one in a split batch), so that the
    slots continue the whole batch's stable order."""
    flat_e = eid.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(flat_e.numel(), device=eid.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start
    if offset is not None:
        rank = rank + offset[sorted_e]
    return order, sorted_e, rank, rank < cap


def experts_swiglu(xe, w_gate, w_up, w_down,
                   partial: bool = False) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: xe [E, C, D] -> [E, C, D].
    ``partial``: the weights are the rank's ``ff`` columns (rows of
    ``w_down``), and the result its float32 partial sum
    (``common.row_bmm``)."""
    g = torch.bmm(xe, w_gate.to(xe.dtype))
    u = torch.bmm(xe, w_up.to(xe.dtype))
    h = common.swiglu(g, u)
    if partial:
        return common.row_bmm(h, w_down.to(xe.dtype))
    return torch.bmm(h, w_down.to(xe.dtype))


def _placed(rows, keep, order, gate_w):
    """Each sorted choice's output times its gate (0 where not kept), back
    in the choices' order [T * k, D]."""
    w_flat = gate_w.reshape(-1)[order]
    contrib = torch.where(keep[:, None],
                          rows * w_flat[:, None].to(rows.dtype), 0)
    placed = torch.empty_like(contrib)
    placed[order] = contrib
    return placed


def combine(rows, keep, order, gate_w, top_k: int) -> torch.Tensor:
    """rows [T * k, D]: each sorted choice's expert output (anything where
    dropped) -> [T, D], each token's kept outputs times their gates,
    summed over its k choices."""
    return _placed(rows, keep, order, gate_w).view(
        -1, top_k, rows.shape[-1]).sum(1)


def combine_partial(rows, mine, order, gate_w, top_k: int) -> torch.Tensor:
    """``combine`` over the choices ``mine`` (those this rank's experts or
    columns served), each token's sum in float32, not rounded: the rank's
    partial output [T, D], which the ranks' sum completes."""
    return _placed(rows, mine, order, gate_w).view(
        -1, top_k, rows.shape[-1]).float().sum(1)


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
        deterministic_capacity: Optional[int] = None,
        sizes: Optional[MoESizes] = None):
    """Mixture-of-experts block.  x: [B, S, D] -> (y, metrics).

    ``num_experts`` is the logical expert count (the parameters may hold
    more: the padding, masked out of routing).  ``metrics`` holds
    ``moe_aux_loss``, ``moe_z_loss`` and ``moe_drop_frac`` (the share of
    the T * k choices past their expert's capacity) as 0-d tensors.

    With ``sizes`` (the block's whole sizes, ``moe_sizes``) the MoE is a
    block of the residual stream under the installed tensor-parallel
    context (``x`` the rank's rows under ``seq_parallel``, as ``y`` is):
    its expert leaves are the rank's shards where the rules split them
    (``moe_split``), and so are the router's columns and the shared
    expert's ``ff``.  Every rank routes the whole rows alike (each
    computes its experts' logits, which are gathered: no router weight
    moves); the dispatch input and the gates enter the rank's compute
    through Megatron's f (their gradient summed over ``"model"``), while
    the router's path through the aux and z losses, the same on every
    rank, is not summed.  Without ``sizes`` the weights are taken whole.
    Under a batch split over data ranks the routing is the whole
    batch's (``route_over``), and each data rank runs the experts on its
    block of their slots where the step's rules split the buffer's
    capacity (``_expert_rows``)."""
    split = moe_split(sizes) if sizes is not None else None
    group = dctx.model_group() if split is not None else None
    if sizes is not None:
        xin, x = x, common.region_in(x, False)     # the rows whole
    B, S, D = x.shape
    dt = x.dtype
    T = B * S
    xf = x.reshape(T, D)
    E_pad = sizes.experts if sizes is not None else p["router"].shape[1]
    # the input of the rank's own compute (its experts' logits, the
    # dispatch, the shared expert's columns): Megatron's f, its gradient
    # summed over "model" once
    xl = collectives.copy_to_model(xf, group)
    gate_w, order, sorted_e, rank, keep, cap, every, metrics = \
        _route_slots(p["router"], xf, xl, num_experts, top_k,
                     capacity_factor, deterministic_capacity,
                     group if split == "experts" else None)

    # the rank's experts (all of them, or their columns) take the choices
    # they serve
    if split == "experts":
        E_loc = p["w_gate"].shape[0]
        e0 = dctx.model_rank() * E_loc
        mine = keep & (sorted_e >= e0) & (sorted_e < e0 + E_loc)
    else:
        E_loc, e0, mine = E_pad, 0, keep
    rows = _expert_rows(p, xl[order // top_k], sorted_e - e0, rank, mine,
                        cap, every, e0, split == "ff")
    if split is None:
        y = combine(rows, keep, order, gate_w, top_k).reshape(B, S, D)
        if "shared" in p:
            y = y + shared_expert(p, x)
        if sizes is not None:
            y = common.region_out(y, False)
        return shard(y, "batch", None, None), metrics

    # the rank's partial outputs summed in float32 with the shared
    # expert's, over the ranks, rounded once
    out = combine_partial(rows, mine, order,
                          collectives.copy_to_model(gate_w, group), top_k)
    shared_local = "shared" in p and dctx.is_local("ff", sizes.shared_d_ff)
    if shared_local:
        sg = collectives.copy_to_model(torch.sigmoid(torch.matmul(
            xf.float(), p["shared_gate"].float())), group)
        part = mlp_partial(p["shared"], xl.view(B, S, D), True, sp=False,
                           f=False).reshape(T, D)
        out = out + part.float() * sg
    y = common.region_out(out.view(B, S, D), True, dt)
    if "shared" in p and not shared_local:
        # the shared expert whole on every rank, on the rank's rows
        rp = common.row_param
        y = y + shared_expert({"shared": common.tree_map(rp, p["shared"]),
                               "shared_gate": rp(p["shared_gate"])}, xin)
    return shard(y, "batch", None, None), metrics


def _route_slots(router_w, xf, xl, num_experts: int, top_k: int,
                 capacity_factor: float,
                 deterministic_capacity: Optional[int], group):
    """The routing of the whole rows ``xf`` and each choice's slot:
    (gate weights, the choices' sort order, sorted expert ids, slots,
    keep, capacity, every rank's choice counts [n, E_pad] in the batch
    split's order, metrics).  ``group``: the router holds the rank's
    experts' columns (``router_logits`` on ``xl``, the rows as the rank's
    own compute takes them).  Under a batch split over data ranks the
    statistics, the capacity and the slots are the whole batch's
    (``route_over``; each expert's slots continue from the ranks before,
    and keeps its first ``cap``)."""
    groups = dctx.data_groups()
    logits = router_logits(xf if group is None else xl, router_w,
                           num_experts, group)
    gate_w, eid, aux, z = route_over(logits, num_experts, top_k, groups)
    every = _choice_counts(eid, logits.shape[-1])[None]
    for g in reversed(groups):      # the minor dim first: rank order
        every = collectives.all_gather_model(every, g, 0)
    T = xf.shape[0] * every.shape[0]
    cap = deterministic_capacity if deterministic_capacity is not None \
        else capacity(T, top_k, num_experts, capacity_factor)
    before = every[:dctx.batch_split().index if groups else 0].sum(0)
    order, sorted_e, rank, keep = sort_slots(eid, cap, before.long())
    drop = 1.0 - torch.clamp_max(every.sum(0), cap).sum() / (T * top_k)
    return gate_w, order, sorted_e, rank, keep, cap, every, {
        "moe_aux_loss": aux, "moe_z_loss": z, "moe_drop_frac": drop}


def _expert_rows(p, src, e, slot, mine, cap: int, every, e0: int,
                 partial: bool) -> torch.Tensor:
    """Each sorted choice's expert output [T * k, D] (anything where not
    ``mine``): ``src`` the choices' inputs in sorted order, ``e`` their
    expert among the rank's ``E_loc`` (from expert ``e0`` on), ``slot``
    their slot in it, ``every`` each batch-split rank's choice counts
    [n, E_pad].  The [E_loc, cap, D] buffer is the reference's:
    where its rules put the ``capacity`` dim on a data dim that splits
    the batch (``distributed.context.capacity_split``), each of that
    dim's ranks holds its block of ``cap / n`` slots, and the choices go
    to the rank whose block holds their slot and come back by two
    exchanges of rows (all-to-all)."""
    E_loc, D = p["w_gate"].shape[0], src.shape[-1]
    # the slots run over the split batch only where the routing does
    cs = dctx.capacity_split(cap) if every.shape[0] > 1 else None
    if cs is None:
        n_rows = E_loc * cap
        dest = torch.where(mine, e * cap + slot, n_rows)
        buf = src.new_zeros(n_rows + 1, D)
        buf[dest] = src
        ye = _experts(p, buf[:n_rows].view(E_loc, cap, D), partial)
        return ye.reshape(n_rows, D)[torch.clamp_max(dest, n_rows - 1)]
    c = cap // cs.size
    owner = torch.where(mine, slot // c, cs.size)
    idx = torch.argsort(owner, stable=True)
    send, recv, at = _exchange_plan(owner, every, e0, E_loc, cs, c)
    idx = idx[:sum(send)]
    got = collectives.exchange_rows(src[idx], send, recv, cs.group)
    buf = src.new_zeros(E_loc * c, D)
    buf[at] = got
    ye = _experts(p, buf.view(E_loc, c, D), partial).reshape(E_loc * c, D)
    back = collectives.exchange_rows(ye[at], recv, send, cs.group)
    rows = back.new_zeros(src.shape[0], D)
    rows[idx] = back
    return rows


def _experts(p, xe, partial: bool) -> torch.Tensor:
    xe = shard(xe, "experts", "capacity", None)
    ye = experts_swiglu(xe, p["w_gate"], p["w_up"], p["w_down"],
                        partial=partial)
    return shard(ye, "experts", "capacity", None)


def _exchange_plan(owner, every, e0: int, E_loc: int, cs, c: int):
    """The exchange of ``_expert_rows`` over ``cs`` (a
    ``CapacitySplit``): how many of this rank's choices go to each of its
    ranks (``owner``: the rank whose block holds a choice's slot, ``cs.
    size`` for none), how many each sends here, and where each row that
    arrives goes in this rank's [E_loc * c] rows.  A rank's choices of an
    expert hold the consecutive slots after those of the batch-split
    ranks before it (``every``), and arrive ordered by expert and slot,
    so the counts and places follow from ``every`` on every rank alike.
    Under ``FakeTensorMode`` (the dry-run), where no count is known, each
    rank sends an equal share of its choices of the rank's experts to
    each block."""
    n = cs.size
    if torch._subclasses.fake_tensor.is_fake(every):
        q = owner.shape[0] * E_loc // (every.shape[1] * n)
        return [q] * n, [q] * n, torch.arange(
            n * q, device=owner.device) % (E_loc * c)
    every = every[:, e0:e0 + E_loc].long()
    before = torch.cumsum(every, 0) - every
    lo = torch.clamp(before[cs.members], cs.index * c, (cs.index + 1) * c)
    hi = torch.clamp((before + every)[cs.members], cs.index * c,
                     (cs.index + 1) * c)
    ln = (hi - lo).reshape(-1)
    start = (lo - cs.index * c + torch.arange(
        E_loc, device=lo.device) * c).reshape(-1)
    first = torch.cumsum(ln, 0) - ln
    seg = torch.repeat_interleave(torch.arange(ln.numel(),
                                               device=ln.device), ln)
    at = start[seg] + torch.arange(seg.numel(), device=ln.device) \
        - first[seg]
    send = torch.bincount(owner, minlength=n + 1)[:n]
    return send.tolist(), (hi - lo).sum(1).tolist(), at

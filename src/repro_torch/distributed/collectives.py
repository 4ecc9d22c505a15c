"""The collectives of the sharded feature engine and of the
expert-parallel MoE (PyTorch).

The JAX engine runs its shards inside one ``shard_map`` program, and XLA
inserts the few collectives the mesh half needs; here each shard is a
process and these functions are those collectives, each one named for
what it moves.  None runs on the decision or update path: a rank steps
its own rows with no communication, as the paper's workers do (§5.3).

Under gloo the collectives move host tensors (several ranks may share a
card, and gloo's CUDA support is partial); under NCCL they move CUDA
tensors on the rank's device.  ``comm_device`` picks by
``dist.get_backend(group)``.  Results come back on the input's device.

Every gather *places* values by owner or column; nothing is summed except
the write count, so floats (−0.0 included) cross the mesh bit for bit.

``all_to_all``, ``gather_cat`` and ``mean_over`` serve ``models/moe_ep.py``
(the JAX ``lax.all_to_all``, the gather of ``shard_map``'s output and
``lax.pmean``); ``all_to_all_calls`` counts the all-to-alls.

The tensor-parallel collectives (the last section) run over the mesh's
``"model"`` group as functional collectives (``_c10d_functional``): on
fake tensors (the dry-run) they move no byte and read no value, and
``launch.hlo_analysis`` counts them; under gloo a CUDA tensor is staged
through the host, where gloo's collectives work.  Sums of bfloat16 run in
float32 and are rounded once.  ``copy_to_model`` / ``reduce_from_model``
are Megatron's pair (identity forward and all-reduce backward before a
column-parallel product; all-reduce forward and identity backward after a
row-parallel one), ``gather_model`` / ``scatter_model`` /
``reduce_scatter_model`` move one dim, and ``combine_softmax`` merges the
ranks' partial attention over a ``kv_seq``-sharded cache by log-sum-exp.
``tp_bytes`` counts each kind's payload bytes since the last reset.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import StepInfo

__all__ = ["comm_device", "write_count", "gather_blocks",
           "stream_order_info", "place_owned", "gather_rows",
           "scatter_rows", "broadcast_object", "barrier", "all_to_all",
           "gather_cat", "mean_over"]

all_to_all_calls = 0    # all_to_all calls since the last reset


def comm_device(group, like: torch.device) -> torch.device:
    """Where a collective's tensors live: the host under gloo, the rank's
    own device otherwise."""
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else like


def _send(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` on the collective's device, contiguous; bool as uint8."""
    x = x.to(comm_device(group, x.device))
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous()


def _recv(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def _global(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    return dist.get_global_rank(group, rank)


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    xs = _send(x, group)
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, xs, group=group)
    return parts


def write_count(writes: torch.Tensor, group) -> torch.Tensor:
    """The mesh's write count: ``writes`` (a scalar or per-block counts)
    summed over the ranks (the JAX step's scalar all-reduce)."""
    xs = _send(writes, group).clone()
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=group)
    return _recv(xs, writes)


def gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``[n_blocks, B, ...]`` column, side by side in rank
    order: ``[n_blocks, n * B, ...]`` — the JAX engine's global block
    layout, where shard ``s`` owns columns ``[s*B, (s+1)*B)``."""
    parts = _all_gather(x, group)
    return _recv(torch.cat(parts, dim=1), x)


def stream_order_info(info: StepInfo, slot: np.ndarray, group) -> StepInfo:
    """A rank's ``[n_blocks, B]`` StepInfo -> the whole stream's, in
    stream order, on every rank: each field's columns are gathered
    (``gather_blocks``) and each event is read from its flat ``slot``;
    ``writes`` is the mesh's total."""
    idx = None

    def flat(x):
        nonlocal idx
        g = gather_blocks(x, group)
        g = g.reshape((-1,) + tuple(g.shape[2:]))
        if idx is None:
            idx = torch.from_numpy(np.asarray(slot, np.int64)).to(g.device)
        return g[idx]

    return StepInfo(z=flat(info.z), p=flat(info.p),
                    lam_hat=flat(info.lam_hat), features=flat(info.features),
                    writes=write_count(info.writes.sum(), group)
                    .to(torch.int32))


def place_owned(x: torch.Tensor, owner: np.ndarray, group) -> torch.Tensor:
    """Rows computed on their owners, placed: every rank passes ``x``
    ``[K, ...]`` (meaningful where ``owner == rank``) and gets back row
    ``i`` of rank ``owner[i]``'s ``x``, for every ``i``."""
    parts = torch.stack(_all_gather(x, group))
    own = torch.from_numpy(np.asarray(owner, np.int64)).to(parts.device)
    rows = torch.arange(x.shape[0], device=parts.device)
    return _recv(parts[own, rows], x)


def gather_rows(x: torch.Tensor, group, dst: int = 0
                ) -> Optional[np.ndarray]:
    """Every rank's ``[E_local, ...]`` rows concatenated in rank order —
    the flat ``shard * E_local + local`` layout — as a host array on rank
    ``dst`` (``None`` on the others)."""
    xs = _send(x, group)
    me = dist.get_rank(group)
    parts = ([torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
             if me == dst else None)
    dist.gather(xs, parts, dst=_global(group, dst), group=group)
    if me != dst:
        return None
    return _recv(torch.cat(parts), x.cpu()).numpy()


def scatter_rows(full: Optional[np.ndarray], like: torch.Tensor, group,
                 src: int = 0) -> torch.Tensor:
    """The inverse of ``gather_rows``: rank ``src`` holds the flat
    ``[n * E_local, ...]`` host array and every rank gets its ``[E_local,
    ...]`` slice, shaped and typed like ``like``, on ``like``'s device."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    out = _send(torch.empty_like(like), group)
    parts = None
    if me == src:
        t = torch.as_tensor(np.ascontiguousarray(full)).to(like.dtype)
        if t.shape[0] != n * like.shape[0] or t.shape[1:] != like.shape[1:]:
            raise ValueError(f"cannot scatter {tuple(t.shape)} rows over "
                             f"{n} ranks of {tuple(like.shape)}")
        parts = [_send(p, group) for p in t.chunk(n)]
    dist.scatter(out, parts, src=_global(group, src), group=group)
    return _recv(out, like)


def broadcast_object(obj, group, src: int = 0):
    """A picklable host object from rank ``src`` to every rank."""
    box = [obj]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else None)
    dist.broadcast_object_list(box, src=_global(group, src), group=group,
                               device=dev)
    return box[0]


def barrier(group) -> None:
    """Every rank of ``group`` reaches this point before any leaves it."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group,
                     device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...] over a group of n ranks: block j goes to group rank
    j, and block i of the result came from group rank i (the JAX
    ``lax.all_to_all`` with split and concat axis 0)."""
    global all_to_all_calls
    xs = _send(x, group)
    if xs.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all: {xs.shape[0]} blocks over "
                         f"{dist.get_world_size(group)} ranks")
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    all_to_all_calls += 1
    return _recv(out, x)


def gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group rank order,
    on every rank."""
    return _recv(torch.cat(_all_gather(x, group), dim=dim), x)


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over the ranks of the product of ``groups`` (over each
    group in turn)."""
    xs = _send(x, groups[0]).clone()
    for g in groups:
        xs = _send(xs, g)
        dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=g)
    return _recv(xs, x)


def mean_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` averaged over the ranks of the product of ``groups`` (summed
    over each group in turn: the JAX ``lax.pmean`` over several axes)."""
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return sum_over(x, groups) / n


def _host_twin(mesh):
    """The CPU twin of a CUDA mesh whose groups run gloo (made once, kept
    on the mesh); None for any other mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh.device_type != "cuda" or dist.get_backend(
            mesh.get_group(0)) != "gloo":
        return None
    twin = mesh.__dict__.get("_host_twin")
    if twin is None:
        twin = DeviceMesh("cpu", mesh.mesh,
                          mesh_dim_names=mesh.mesh_dim_names)
        mesh.__dict__["_host_twin"] = twin
    return twin


def _on_host(x, twin):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().cpu(), twin, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def local_part(x, placements) -> torch.Tensor:
    """This rank's local tensor of the DTensor ``x`` redistributed to
    ``placements`` (one a mesh dim), as a plain tensor; staged through
    the host where ``whole`` is."""
    placements = list(placements)
    if list(x.placements) == placements:
        return x.to_local()
    twin = _host_twin(x.device_mesh)
    if twin is None:
        return x.redistribute(x.device_mesh, placements).to_local()
    return _on_host(x, twin).redistribute(twin, placements).to_local().to(
        x.to_local().device)


def whole(x) -> torch.Tensor:
    """A DTensor's whole value on every rank (``full_tensor``: shards
    gathered, partial sums reduced), as a plain tensor.

    Under gloo with CUDA tensors the collective is staged through the
    host, over a CPU twin of the mesh: there the functional all-gather
    that ``full_tensor`` issues kills the rank (SIGSEGV; torch 2.11 +
    CUDA 12.8 on an H100), while the host's works.  DTensor's other
    redistributions (reduce-scatter, all-reduce, local chunks) run on the
    card under gloo as they are."""
    twin = _host_twin(x.device_mesh)
    if twin is None:
        return x.full_tensor()
    return _on_host(x, twin).full_tensor().to(x.to_local().device)


# ------------------------------------------------ tensor parallelism
tp_bytes: dict = {}    # kind -> payload bytes of the TP collectives


def _count(kind: str, x: torch.Tensor) -> None:
    tp_bytes[kind] = tp_bytes.get(kind, 0) + x.numel() * x.element_size()


def _funcol(name: str, x: torch.Tensor, group, *args) -> torch.Tensor:
    """One functional collective of ``group`` on ``x``: staged through the
    host under gloo with a CUDA tensor, on ``x``'s device otherwise."""
    stage = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    xs = (x.cpu() if stage else x).contiguous()
    f = torch.ops._c10d_functional
    out = f.wait_tensor(getattr(f, name)(xs, *args, group.group_name))
    return out.to(x.device) if stage else out


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def all_reduce_model(x: torch.Tensor, group, op: str = "sum"
                     ) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``group``, on every
    rank."""
    _count("all-reduce", x)
    return _funcol("all_reduce", _wide(x), group, op).to(x.dtype)


def all_gather_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group rank order."""
    _count("all-gather", x)
    n = group.size()
    y = _funcol("all_gather_into_tensor", x.movedim(dim, 0), group, n)
    return y.movedim(0, dim)


def reduce_scatter_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group``, this rank keeping its contiguous chunk
    of ``dim``."""
    _count("reduce-scatter", x)
    n = group.size()
    y = _funcol("reduce_scatter_tensor", _wide(x).movedim(dim, 0), group,
                "sum", n)
    return y.movedim(0, dim).to(x.dtype)


def all_to_all_rows(x: torch.Tensor, send: List[int], recv: List[int],
                    group) -> torch.Tensor:
    """Rows of ``x`` [sum(send), ...] to the ranks of ``group``: the
    first ``send[0]`` to group rank 0, the next ``send[1]`` to rank 1 and
    so on; the result holds ``recv[i]`` rows from rank i, in rank
    order."""
    _count("all-to-all", x)
    stage = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    xs = (x.cpu() if stage else x).contiguous()
    f = torch.ops._c10d_functional
    out = f.wait_tensor(f.all_to_all_single(xs, list(recv), list(send),
                                            group.group_name))
    return out.to(x.device) if stage else out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = group.size(), dist.get_rank(group)
    m = x.shape[dim] // n
    return x.narrow(dim, r * m, m)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_model(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_model(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_model(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_model(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grad):
        ctx.group, ctx.dim, ctx.sum_grad = group, dim, sum_grad
        return all_gather_model(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            return reduce_scatter_model(g, ctx.group, ctx.dim), None, \
                None, None
        return _chunk(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_model(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_model(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_model(g, ctx.group, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return all_to_all_rows(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g, ctx.recv, ctx.send, ctx.group), None, \
            None, None


def exchange_rows(x: torch.Tensor, send: List[int], recv: List[int],
                  group) -> torch.Tensor:
    """``all_to_all_rows``, differentiable: the gradient goes back by the
    reverse exchange."""
    return _Exchange.apply(x, send, recv, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``group``
    (a replicated input of rank-local compute)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the ranks' partial sums ``x`` summed over ``group``;
    the gradient passes as it is (every rank holds the same)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_in_region(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` whose result feeds rank-local compute again
    (a norm's statistics over sharded channels): all-reduce both ways."""
    return x if group is None else _SumBoth.apply(x, group)


def gather_model(x: torch.Tensor, group, dim: int,
                 sum_grad: bool = False) -> torch.Tensor:
    """The ranks' chunks of ``dim`` gathered whole.  The gradient is this
    rank's chunk of it (the whole feeds the same compute on every rank),
    or with ``sum_grad`` the chunk of its sum over ``group`` (the whole
    feeds rank-local compute)."""
    return x if group is None else _Gather.apply(x, group, dim, sum_grad)


def scatter_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk of ``dim`` (of a tensor every rank
    holds whole); the gradient gathered."""
    return x if group is None else _Scatter.apply(x, group, dim)


def reduce_scatter_to_model(x: torch.Tensor, group, dim: int
                            ) -> torch.Tensor:
    """The ranks' partial sums ``x`` summed, this rank keeping its chunk
    of ``dim``; the gradient gathered."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def combine_softmax(o: torch.Tensor, lse: torch.Tensor, group
                    ) -> torch.Tensor:
    """Attention over keys split between the ranks of ``group``: each rank
    passes its keys' normalised output ``o`` [..., D] and their rows'
    log-sum-exp ``lse`` [...] (float32); every rank gets the output over
    all keys, each rank's ``o`` weighted by ``exp(lse_r - lse)``.  Moves
    the rows' statistics and one output, never a key."""
    every = all_gather_model(lse[None], group, 0)          # [n, ...]
    total = torch.logsumexp(every, dim=0)
    w = torch.exp(lse - total)
    return all_reduce_model(o * w[..., None], group)

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


def mean_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` averaged over the ranks of the product of ``groups`` (summed
    over each group in turn: the JAX ``lax.pmean`` over several axes)."""
    xs = _send(x, groups[0]).clone()
    n = 1
    for g in groups:
        xs = _send(xs, g)
        dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=g)
        n *= dist.get_world_size(g)
    return _recv(xs, x) / n

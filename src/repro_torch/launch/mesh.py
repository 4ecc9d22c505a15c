"""Process meshes (PyTorch): the production meshes of the dry-run and of
training, the sharded feature engine's data mesh and the model mesh of the
expert-parallel MoE.

The counterpart of ``repro.launch.mesh``: ``make_production_mesh`` builds
the reference's (16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod",
"data", "model")`` meshes, so that every sharding rule resolves as it does
in JAX; ``make_shard_mesh`` is what ``jax.make_mesh((n,), ("data",))`` is to
the JAX engine, and ``make_model_mesh`` what ``jax.make_mesh((data,
model), ("data", "model"))`` is to the JAX ``moe_ep``.  Each process is one
device of the mesh — a rank of a ``torch.distributed`` process group — and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
group's ranks with the JAX dim names, rank ``i`` at the row-major position
``i`` as ``jax.make_mesh`` lays devices out.

Topology: on H100 nodes of 8 GPUs joined by NVLink, a 16-wide ``model``
dim spans two NVLink domains, so half of every tensor-parallel collective
crosses the nodes' network; the reference placed ``model`` on the TPU's
fast ring.  No H100-shaped mesh is defined: the reference has none.

The group is built *before* the mesh, with the backend the caller means:
``DeviceMesh`` would otherwise pick NCCL for CUDA, which refuses two ranks
on one card.  Several ranks may share a card under ``backend="gloo"``
(the collectives then move host tensors; ``distributed.collectives``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_shard_mesh", "make_model_mesh", "shard_of_mesh",
           "make_mesh", "make_production_mesh", "make_mesh_named",
           "mesh_axis_sizes", "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def _rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` unless one
    is named; raises without a GPU unless the CPU is asked for."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh pins each rank to a CUDA device and none is "
            "available; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _init_group(world: int, backend, device, init_method,
                timeout_s: float) -> torch.device:
    """Build (or check) the default process group of ``world`` ranks with
    this process as rank ``RANK``, pin the rank's device and return it."""
    rank = _env_int("RANK") or 0
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is outside a world of {world}")
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        if dev.type != "cuda" or local_world > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one CUDA device a rank: {local_world} local "
                f"ranks on {torch.cuda.device_count()} card(s); use "
                f"backend='gloo' to share a card")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise ValueError(
                f"the default process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {world}")
        if dist.get_backend() != backend:
            raise ValueError(f"the default process group runs "
                             f"{dist.get_backend()}, not {backend}")
    else:
        timeout = datetime.timedelta(seconds=float(timeout_s))
        kw = dict(backend=backend, world_size=world, rank=rank,
                  timeout=timeout)
        if dev.type == "cuda" and backend == "nccl":
            kw["device_id"] = dev
        if init_method is None and world == 1 \
                and "MASTER_ADDR" not in os.environ:
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = init_method or "env://"
        dist.init_process_group(**kw)
    return dev


def make_shard_mesh(n: Optional[int] = None, *, backend: Optional[str] =
                    None, device=None, init_method: Optional[str] = None,
                    timeout_s: float = 60.0) -> DeviceMesh:
    """A 1-D ``DeviceMesh`` named ``("data",)`` over ``n`` ranks, one
    shard each; this process is rank ``RANK``.

    ``n``: the world size; read from torchrun's ``WORLD_SIZE`` when not
    given (``RANK`` and ``LOCAL_RANK`` come from the environment too,
    default 0).  A 1-rank mesh needs no environment at all.

    ``device``: the rank's device, pinned with ``torch.cuda.set_device``;
    default ``cuda:{LOCAL_RANK % device_count}``.  ``device="cpu"`` runs
    the rank on the CPU.

    ``backend``: ``"nccl"`` for CUDA and ``"gloo"`` for the CPU unless
    named.  NCCL refuses two ranks on one card, so more local ranks than
    cards need ``backend="gloo"`` (checked here, before any collective).

    ``init_method``: the rendezvous (default ``env://``: ``MASTER_ADDR``
    and ``MASTER_PORT``; a 1-rank group without them uses an in-process
    store).  The group times out after ``timeout_s``, so a dead rank fails
    its peers' collectives instead of hanging them.

    When the default process group already exists (a caller built it),
    the mesh is made over it and ``n``/``backend``/``init_method`` must
    agree with it.
    """
    world = int(n) if n is not None else _env_int("WORLD_SIZE")
    if world is None:
        raise ValueError("make_shard_mesh needs n or torchrun's WORLD_SIZE")
    dev = _init_group(world, backend, device, init_method, timeout_s)
    return DeviceMesh(dev.type, torch.arange(world),
                      mesh_dim_names=(DATA_AXIS,))


def make_model_mesh(model: Optional[int] = None, data: int = 1, *,
                    backend: Optional[str] = None, device=None,
                    init_method: Optional[str] = None,
                    timeout_s: float = 60.0) -> DeviceMesh:
    """The mesh of the expert-parallel MoE over ``data * model`` ranks: 1-D
    ``("model",)`` when ``data == 1``, else 2-D ``("data", "model")`` with
    rank ``d * model + m`` at coordinates (d, m), as ``jax.make_mesh``
    lays devices out.  ``model`` defaults to ``WORLD_SIZE // data``; the
    group, the rank's device and the rest of the arguments are as
    ``make_shard_mesh``'s (an existing default group is reused when it
    agrees)."""
    if model is None:
        world = _env_int("WORLD_SIZE")
        if world is None or world % data:
            raise ValueError(f"make_model_mesh needs model, or a "
                             f"WORLD_SIZE that {data} data rows divide")
        model = world // data
    world = int(model) * int(data)
    dev = _init_group(world, backend, device, init_method, timeout_s)
    if data == 1:
        return DeviceMesh(dev.type, torch.arange(world),
                          mesh_dim_names=(MODEL_AXIS,))
    return DeviceMesh(dev.type, torch.arange(world).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard_of_mesh(mesh, data_axes: Tuple[str, ...] = (DATA_AXIS,)
                  ) -> Tuple[int, int, object]:
    """``(n_shards, shard, group)`` of this rank on ``mesh``: the data
    axes' sizes multiplied, this rank's coordinates on them flattened
    row-major, and the process group the collectives run on.

    Several data axes may be any dims of a larger mesh (``("pod",
    "data")`` of a ``("pod", "data", "model")`` mesh), as JAX's engine
    takes them, in the mesh's order.  The group is then the ranks that
    share this rank's coordinates on every other dim: one coset of the
    data dims.  A group ranks its members by global rank, so each coset's
    ranks, in shard order, must rise (a ``ValueError`` otherwise).
    ``dist.new_group`` is collective, so every rank creates every coset's
    group, in one fixed order, on its first call for a mesh and data axes,
    and keeps its own (later calls reuse it); the ranks of the other dims
    hold replicas of the same shards.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_shard_mesh), not "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in data_axes if a not in names]
    if missing:
        raise ValueError(f"data axes {missing} are not dims of the mesh "
                         f"{names}")
    n, shard = 1, 0
    for a in data_axes:
        size = mesh.size(names.index(a))
        shard = shard * size + mesh.get_local_rank(a)
        n *= size
    if len(data_axes) == 1:
        return n, shard, mesh.get_group(data_axes[0])
    dims = [names.index(a) for a in data_axes]
    if dims != sorted(set(dims)):
        raise ValueError(f"data axes {tuple(data_axes)} must be distinct "
                         f"dims of the mesh {names}, in its order")
    others = [i for i in range(len(names)) if i not in dims]
    cosets = mesh.mesh.permute(others + dims).reshape(-1, n).tolist()
    if any(r != sorted(r) for r in cosets):
        raise ValueError(f"data axes {tuple(data_axes)} of the mesh {names}: "
                         f"a coset's ranks must rise in shard order, got "
                         f"{cosets}")
    cache = mesh.__dict__.setdefault("_data_groups", {})
    if tuple(dims) not in cache:
        if n == dist.get_world_size():
            cache[tuple(dims)] = dist.group.WORLD
        else:
            for ranks in cosets:
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    cache[tuple(dims)] = g
    group = cache[tuple(dims)]
    return n, shard, group


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group that the caller built (gloo or NCCL for a run, the fake backend
    for the dry-run), rank ``i`` at row-major position ``i``.
    ``device_type`` defaults to ``"cuda"`` where a card is present, else
    ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh builds on the default process group: "
                           "call torch.distributed.init_process_group "
                           "(or make_shard_mesh) first")
    world = 1
    for n in shape:
        world *= int(n)
    if world != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {world} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(
        tuple(int(n) for n in shape)), mesh_dim_names=tuple(axes))


MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``."""
    shape = MESH_SHAPES["multi" if multi_pod else "single"]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh_named(name: str, *, device_type: Optional[str] = None
                    ) -> DeviceMesh:
    if name in ("single", "single_pod", "16x16"):
        return make_production_mesh(multi_pod=False, device_type=device_type)
    if name in ("multi", "multi_pod", "2x16x16"):
        return make_production_mesh(multi_pod=True, device_type=device_type)
    raise ValueError(name)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))

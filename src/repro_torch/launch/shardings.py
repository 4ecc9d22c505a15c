"""Sharded stand-ins for the dry-run, and the same placements for a run
(PyTorch port of ``repro.launch.shardings``).

``param_sds``, ``train_state_sds``, ``batch_sds``, ``rng_sds`` and
``decode_state_sds`` build the runtime trees (``TrainState``, the decode
state, the batch dict) as DTensors whose local shards live on the
``meta`` device: every leaf carries its global shape, dtype and the
placements the installed rule table gives it (``distributed.context``),
and nothing is allocated.  They resolve under ``mesh_context(mesh,
rules)``, as the reference's do under its mesh context; ``mesh`` is a
``DeviceMesh`` (on the fake process group for the dry-run).

``init_train_state``, ``distribute_train_state`` and ``distribute_batch``
place real tensors the same way: fresh weights, or a single-process
``TrainState`` (or batch) that every rank holds whole, become the rank's
shards, so the train step runs under the mesh (``train.trainer``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import shapes as shape_lib
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import context as dctx
from repro_torch.models import backbone, common
from repro_torch.models.common import Spec, tree_map
from repro_torch.train import trainer
from repro_torch.train.compression import SyncState
from repro_torch.train.optim import AdafactorState, AdamWState

DTYPES = trainer.DTYPES
_LEAF_DEVICE = contextvars.ContextVar("repro_torch_sds_device",
                                      default="meta")


@contextlib.contextmanager
def leaf_device(device: str):
    """Build the stand-ins' shards on ``device`` inside the block (the
    dry-run: ``"cpu"`` under ``FakeTensorMode``, where an empty tensor is a
    fake one)."""
    tok = _LEAF_DEVICE.set(device)
    try:
        yield
    finally:
        _LEAF_DEVICE.reset(tok)


def _sds(shape, dtype, mesh, entries) -> DTensor:
    """A DTensor of ``shape`` and ``dtype`` with the placements of the
    mesh-axis ``entries`` (``context.pspec_for``), its shard on ``meta``
    (or ``leaf_device``'s device)."""
    shape = torch.Size(int(n) for n in shape)
    placements = dctx.entries_to_placements(mesh, entries)
    with _disable_current_modes():      # plain integers, even when faked
        local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                         placements)
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=_LEAF_DEVICE.get()), mesh,
        placements, run_check=False, shape=shape, stride=stride)


def _replicated(shape, dtype, mesh) -> DTensor:
    return _sds(shape, dtype, mesh, (None,) * len(shape))


# ------------------------------------------------------------------ params
def param_sds(run: RunConfig, mesh, dtype=None):
    """Sharded param stand-ins in the JAX layout (``backbone.train_specs``),
    resolved under the active rule table."""
    dtype = dtype or DTYPES[run.train.param_dtype]
    return common.map_specs(lambda s: _sds(s.shape, dtype, mesh, s.pspec()),
                      backbone.train_specs(run.model))


def _fp32_like(tree, mesh):
    return tree_map(lambda s: _sds(s.shape, torch.float32, mesh,
                                   placement_entries(s)), tree)


def placement_entries(x: DTensor) -> tuple:
    """The per-dim mesh-axis entries of a DTensor's placements (the
    inverse of ``context.entries_to_placements``)."""
    names = list(x.device_mesh.mesh_dim_names)
    per_dim = [[] for _ in range(x.dim())]
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            per_dim[pl.dim].append(names[i])
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in per_dim)


def _factored_entries(s: Spec):
    """(v_row's, v_col's) shapes and mesh-axis entries for Adafactor's
    factored moments of ``s``, axis-consistent with the parameter."""
    axes = s.logical_axes()
    if len(s.shape) >= 2:
        row = (s.shape[:-1], dctx.pspec_for(s.shape[:-1], axes[:-1]))
        shp = s.shape[:-2] + s.shape[-1:]
        col_axes = axes[:-2] + axes[-1:]
        col = (shp, dctx.pspec_for(shp, col_axes))
    else:
        row = (s.shape, s.pspec())
        col = ((), ())
    return row, col


def _factored_sds(run: RunConfig, mesh):
    """Adafactor v_row/v_col stand-ins with axis-consistent placements."""
    specs = backbone.train_specs(run.model)
    return tuple(common.map_specs(
        lambda s, i=i: _sds(*_factored_entries(s)[i][:1], torch.float32,
                            mesh, _factored_entries(s)[i][1]), specs)
        for i in (0, 1))


def _uses_master(tcfg) -> bool:
    return (tcfg.optimizer == "adamw" and tcfg.master_weights
            and DTYPES[tcfg.param_dtype] != torch.float32)


def train_state_sds(run: RunConfig, mesh) -> trainer.TrainState:
    tcfg = run.train
    params = common.trainable(param_sds(run, mesh))
    master = _fp32_like(params, mesh) if _uses_master(tcfg) else None
    if tcfg.optimizer == "adamw":
        opt = AdamWState(mu=_fp32_like(params, mesh),
                         nu=_fp32_like(params, mesh))
    else:
        vr, vc = _factored_sds(run, mesh)
        opt = AdafactorState(v_row=vr, v_col=vc)
    sync = SyncState(err=_fp32_like(params, mesh)) if tcfg.thinned_sync \
        else None
    return trainer.TrainState(step=_replicated((), torch.int32, mesh),
                              params=params, master=master, opt=opt,
                              sync=sync)


# ------------------------------------------------------------------- batch
def _batch_entries(run: RunConfig, shape: shape_lib.ShapeSpec) -> dict:
    specs = shape_lib.input_specs(run.model, shape)
    axes = shape_lib.batch_axes(run.model, shape)
    return {k: (s, dctx.pspec_for(s.shape, backbone.parse_axes(axes[k])))
            for k, s in specs.items()}


def batch_sds(run: RunConfig, shape: shape_lib.ShapeSpec, mesh) -> dict:
    return {k: _sds(s.shape, s.dtype, mesh, e)
            for k, (s, e) in _batch_entries(run, shape).items()}


def rng_sds(mesh) -> DTensor:
    """The step's key: two uint32 words, replicated."""
    return _replicated((2,), torch.uint32, mesh)


# ------------------------------------------------------------------ decode
def decode_state_sds(run: RunConfig, mesh, shape: shape_lib.ShapeSpec,
                     dtype=torch.bfloat16) -> backbone.DecodeState:
    """The decode state of ``shape``'s batch and context, one cache entry a
    layer (``backbone.init_decode_state`` on ``meta``), each leaf placed
    by ``backbone.decode_state_axes``."""
    mcfg = run.model
    state = backbone.init_decode_state(mcfg, shape.global_batch,
                                       shape.seq_len, dtype, "meta")
    axes = backbone.decode_state_axes(mcfg)

    def place(x, a):
        return _sds(x.shape, x.dtype, mesh,
                    dctx.pspec_for(x.shape, backbone.parse_axes(a)))
    layers = tuple(tree_map(place, c, a)
                   for c, a in zip(state.layers, axes.layers))
    return backbone.DecodeState(pos=shape.seq_len - 1, layers=layers,
                                max_len=shape.seq_len)


# ---------------------------------------------------------- real tensors
def _place(x: torch.Tensor, mesh, entries) -> DTensor:
    """This rank's shard of ``x`` (every rank holds it whole: no
    collective), in storage of its own: a shard of dim 0 is a view of
    ``x`` and would keep the whole tensor alive."""
    return own_storage(distribute_tensor(
        x.detach(), mesh, dctx.entries_to_placements(mesh, entries),
        src_data_rank=None))


def own_storage(d: DTensor) -> DTensor:
    """``d`` with its local shard copied where it is a view of a larger
    storage (``distribute_tensor`` chunks the whole tensor)."""
    local = d.to_local()
    if local.untyped_storage().nbytes() <= local.numel() \
            * local.element_size():
        return d
    return DTensor.from_local(local.clone(), d.device_mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute_train_state(state: trainer.TrainState, run: RunConfig,
                           mesh) -> trainer.TrainState:
    """The rank's shards of a whole ``TrainState`` (every rank passes the
    same one), placed as ``train_state_sds`` places them: parameters (as
    trainable leaves), master copy, moments and sync buffers by the
    parameters' logical axes, Adafactor's factored moments as
    ``_factored_sds``.  The step counter stays a plain tensor."""
    specs = common.tree_leaves_specs(backbone.train_specs(run.model))

    def by_spec(tree, pick=None):
        if tree is None:
            return None
        leaves = common.tree_leaves(tree)
        out = []
        for x, s in zip(leaves, specs):
            entries = s.pspec() if pick is None else \
                _factored_entries(s)[pick][1]
            out.append(_place(x, mesh, entries))
        return common.tree_unflatten(tree, out)

    params = common.trainable(by_spec(state.params))
    if isinstance(state.opt, AdafactorState):
        opt = AdafactorState(v_row=by_spec(state.opt.v_row, 0),
                             v_col=by_spec(state.opt.v_col, 1))
    else:
        opt = AdamWState(mu=by_spec(state.opt.mu), nu=by_spec(state.opt.nu))
    sync = None if state.sync is None else \
        SyncState(err=by_spec(state.sync.err))
    return trainer.TrainState(step=state.step, params=params,
                              master=by_spec(state.master), opt=opt,
                              sync=sync)


def init_train_state(run: RunConfig, gen: torch.Generator, mesh,
                     device=None) -> trainer.TrainState:
    """``trainer.init_train_state`` placed on ``mesh``: the weights drawn
    whole from ``gen`` (the same draws), each rank keeping its shards;
    the master copy, moments and sync buffers made from the shards, so no
    rank ever holds the whole float32 state."""
    tcfg = run.train
    specs = common.tree_leaves_specs(backbone.train_specs(run.model))
    whole = backbone.init_train_params(run.model, gen,
                                       DTYPES[tcfg.param_dtype], device)
    params = common.tree_unflatten(whole, [
        _place(x, mesh, s.pspec()) for x, s in
        zip(common.tree_leaves(whole), specs)])
    del whole
    params = common.trainable(params)
    f32 = lambda t: tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, requires_grad=False), t)
    master = tree_map(lambda p: p.detach().float(), params) \
        if _uses_master(tcfg) else None
    if tcfg.optimizer == "adamw":
        opt = AdamWState(mu=f32(params), nu=f32(params))
    else:
        def factored(i):
            return common.tree_unflatten(params, [
                _place(torch.zeros(shape, dtype=torch.float32,
                                   device=p.to_local().device), mesh, e)
                for p, s in zip(common.tree_leaves(params), specs)
                for shape, e in (_factored_entries(s)[i],)])
        opt = AdafactorState(v_row=factored(0), v_col=factored(1))
    sync = SyncState(err=f32(params)) if tcfg.thinned_sync else None
    return trainer.TrainState(
        step=torch.zeros((), dtype=torch.int32,
                         device=common.tree_leaves(params)[0].to_local(
                         ).device),
        params=params, master=master, opt=opt, sync=sync)


def distribute_batch(batch: dict, run: RunConfig, mesh,
                     kind: str = "train") -> dict:
    """A whole batch (the same on every rank) as DTensors sharded over the
    data axes (``batch_axes``)."""
    shape = shape_lib.ShapeSpec("run", 0, 0, kind)
    axes = shape_lib.batch_axes(run.model, shape)
    return {k: _place(x, mesh, dctx.pspec_for(
                x.shape, backbone.parse_axes(axes[k])))
            for k, x in batch.items()}


def argument_bytes(*trees) -> int:
    """The local shard bytes of every DTensor (or tensor) leaf of
    ``trees``: a device's argument size."""
    total = 0
    for t in trees:
        for x in common.tree_leaves(t):
            if isinstance(x, DTensor):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
    return total

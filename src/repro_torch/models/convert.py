"""Carry a JAX parameter tree over to the port's model.

``from_jax_params`` takes the tree that ``repro.models.backbone.init_params``
returns, with every leaf already converted to a numpy array (this module
imports nothing of JAX), and returns the port's ``Params``.  Every leaf
keeps its JAX shape, so the carry-over is a copy, never a transpose; the
prefix layers, then the stacked ``groups`` leaves unstacked over their
leading axis, then the suffix layers make the port's one list of layers,
in execution order.  Unstacking gives every leaf its per-layer shape: the
expert leaves [n_groups, E, D, F] become [E, D, F] and the cross layers'
scalar gates [n_groups] become 0-d; a pattern of several kinds (the vision
family's four ``attn`` and one ``cross``) is walked position by position
within each group.

``from_jax_train_params`` keeps the JAX layout instead (the training
path's: ``backbone.train_specs``), as a trainable tree, and
``from_jax_train_state`` carries a whole JAX ``TrainState`` (step,
params, master copy, AdamW or Adafactor state, sync state) across.
bfloat16 leaves (``ml_dtypes`` arrays) are carried exactly through
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import common
from repro_torch.models.backbone import layer_plan, model_specs, train_specs
from repro_torch.models.common import Params, Spec


def to_tensor(value, device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor
    of the same dtype and values."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def _leaf(spec: Spec, value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"JAX leaf of shape {arr.shape} where the port "
                         f"expects {spec.shape}")
    return to_tensor(arr, device)


def _tree(spec, value, device):
    if isinstance(spec, Spec):
        return _leaf(spec, value, device)
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(value):
            raise ValueError(f"JAX sequence of {len(value)} where the port "
                             f"expects {len(spec)}")
        return type(spec)(_tree(s, v, device) for s, v in zip(spec, value))
    if set(spec) != set(value):
        raise ValueError(f"JAX subtree keys {sorted(value)} where the port "
                         f"expects {sorted(spec)}")
    return {k: _tree(spec[k], value[k], device) for k in spec}


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def from_jax_params(cfg, params_np, device=None) -> Params:
    """The JAX tree ``{embed, prefix, groups, suffix, final_norm[, head]}``
    (numpy leaves) as the port's ``{embed, layers, final_norm[, head]}``,
    on ``device`` (``cuda:0`` unless named, like every entry point)."""
    device = resolve_device(device)
    plan = layer_plan(cfg)
    got = tuple(len(params_np[k]) for k in ("prefix", "groups", "suffix"))
    want = (len(plan.prefix), len(plan.pattern) if plan.n_groups else 0,
            len(plan.suffix))
    if got != want:
        raise ValueError(f"JAX tree of {got} (prefix layers, group stacks, "
                         f"suffix layers) where the port's plan has {want}")
    layers = list(params_np["prefix"])
    layers += [_index(params_np["groups"][i], g)
               for g in range(plan.n_groups)
               for i in range(len(plan.pattern))]
    layers += list(params_np["suffix"])
    specs = model_specs(cfg)
    if ("head" in specs) != ("head" in params_np):
        raise ValueError("the JAX tree and the port's plan disagree on an "
                         "untied head")
    tree = {
        "embed": _tree(specs["embed"], params_np["embed"], device),
        "layers": [_tree(s, v, device)
                   for s, v in zip(specs["layers"], layers)],
        "final_norm": _leaf(specs["final_norm"], params_np["final_norm"],
                            device)}
    if "head" in specs:
        tree["head"] = _leaf(specs["head"], params_np["head"], device)
    return Params(tree)


def from_jax_train_params(cfg, params_np, device=None) -> dict:
    """The JAX tree (numpy leaves) in its own layout (``train_specs``),
    shapes checked, as a trainable tree on ``device``."""
    return common.trainable(_tree(train_specs(cfg), params_np,
                                  resolve_device(device)))


def from_jax_train_state(run, state_np, device=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) as the port's ``train.trainer.TrainState`` on ``device``.
    The optimizer and sync states keep their JAX names and shapes."""
    from repro_torch.train import compression, optim
    from repro_torch.train.trainer import TrainState

    device = resolve_device(device)
    cfg = run.model
    conv = lambda t: common.tree_map(lambda x: to_tensor(x, device), t)
    opt = state_np.opt
    if run.train.optimizer == "adamw":
        opt = optim.AdamWState(mu=conv(opt.mu), nu=conv(opt.nu))
    else:
        opt = optim.AdafactorState(v_row=conv(opt.v_row),
                                   v_col=conv(opt.v_col))
    master = None if state_np.master is None else conv(state_np.master)
    sync = None if state_np.sync is None else \
        compression.SyncState(err=conv(state_np.sync.err))
    step = torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                        device=device)
    return TrainState(step=step,
                      params=from_jax_train_params(cfg, state_np.params,
                                                   device),
                      master=master, opt=opt, sync=sync)

"""Carry a JAX parameter tree over to the port's model.

``from_jax_params`` takes the tree that ``repro.models.backbone.init_params``
returns, with every leaf already converted to a numpy array (this module
imports nothing of JAX), and returns the port's ``Params``.  Every leaf
keeps its JAX shape, so the carry-over is a copy, never a transpose; the
prefix layers, then the stacked ``groups`` leaves unstacked over their
leading axis, then the suffix layers make the port's one list of layers,
in execution order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.backbone import layer_plan, model_specs
from repro_torch.models.common import Params, Spec


def _leaf(spec: Spec, value, device) -> torch.Tensor:
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"JAX leaf of shape {arr.shape} where the port "
                         f"expects {spec.shape}")
    return torch.tensor(arr, device=device)


def _tree(spec, value, device):
    if isinstance(spec, Spec):
        return _leaf(spec, value, device)
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

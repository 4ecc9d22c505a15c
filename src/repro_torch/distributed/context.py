"""Process-global mesh / sharding-rule context (PyTorch port of
``repro.distributed.context``).

Model code annotates activations with *logical* axis names (``shard``);
the launcher installs a ``torch.distributed`` ``DeviceMesh`` and a rule
table (``distributed.sharding.make_rules``) mapping logical names to mesh
axes.  Outside a mesh context every annotation is a no-op, so the same
model code runs in one process and over a mesh unchanged.  ``pspec_for``
resolves a tensor's logical axes to one mesh-axis entry per dim (a name,
a tuple of names, or None), exactly as the reference's ``PartitionSpec``;
``placements_for`` turns those entries into DTensor placements, and
``shard`` redistributes a DTensor to them (the counterpart of
``with_sharding_constraint``).  Code that spreads its own work reads the
mesh as well: ``models.moe_ep`` puts its experts on the mesh's ``"model"``
dim.  The context is per thread, as the reference's.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import mesh_sizes

__all__ = ["set_mesh", "get_mesh", "get_rules", "mesh_context",
           "resolve_axis", "pspec_for", "placements_for", "shard"]

_STATE = threading.local()


def set_mesh(mesh: Optional[DeviceMesh], rules: Optional[dict] = None
             ) -> None:
    _STATE.mesh, _STATE.rules = mesh, rules


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_STATE, "mesh", None)


def get_rules() -> Optional[dict]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh, rules: Optional[dict] = None):
    """Install ``mesh`` (and the rule table ``rules``; without one the
    annotations stay no-ops) for the block; the previous ones come back
    after."""
    prev = (get_mesh(), get_rules())
    set_mesh(mesh, rules)
    try:
        yield mesh
    finally:
        set_mesh(*prev)


def _first_fit(mesh, rules, logical, size: int, used: Optional[set]):
    if logical is None or rules is None or mesh is None:
        return None
    sizes = mesh_sizes(mesh)
    for cand in rules.get(logical, [()]):
        if not cand:
            return None
        if any(ax not in sizes or (used is not None and ax in used)
               for ax in cand):
            continue  # an axis this mesh lacks, or one already taken
        prod = 1
        for ax in cand:
            prod *= sizes[ax]
        if size % prod == 0:
            if used is not None:
                used.update(cand)
            return tuple(cand) if len(cand) > 1 else cand[0]
    return None


def resolve_axis(logical: Optional[str], size: int) -> Optional[object]:
    """Pick the first candidate mesh-axis (or axis tuple) that divides size.

    rules[logical] is a preference list like [('model',), ('data', 'model'),
    ()]; an empty tuple means replicate.  Returns a mesh-axis entry.
    """
    return _first_fit(get_mesh(), get_rules(), logical, size, None)


def _resolve_consuming(logical: Optional[str], size: int, used: set):
    """First-fit resolution that skips candidates whose mesh axes are taken.

    A tensor may name each mesh axis at most once; tensors whose logical
    axes *both* prefer the same mesh axis (e.g. kv_heads and head_dim ->
    'model') get the first dim that fits, and the later dim falls through
    to its next candidate (often replication).
    """
    return _first_fit(get_mesh(), get_rules(), logical, size, used)


def _pspec(mesh, rules, shape, logical_axes) -> tuple:
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, the "
                         f"logical axes {tuple(logical_axes)} name "
                         f"{len(logical_axes)}")
    used: set = set()
    return tuple(_first_fit(mesh, rules, a, int(d), used)
                 for d, a in zip(shape, logical_axes))


def pspec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]]
              ) -> tuple:
    """One mesh-axis entry per dim of ``shape`` under the installed mesh
    and rules: a mesh axis name, a tuple of names (one dim over several
    mesh axes, major to minor), or None (replicated)."""
    return _pspec(get_mesh(), get_rules(), shape, logical_axes)


def entries_to_placements(mesh: DeviceMesh, entries) -> list:
    """DTensor placements of per-dim mesh-axis entries: ``Shard(d)`` on
    each mesh dim that tensor dim d names, ``Replicate()`` elsewhere.  A
    tuple shards its dim over several mesh dims, the first the major one,
    which is DTensor's order when the tuple follows the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {axes} of dim {d} do not follow "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def placements_for(mesh: DeviceMesh, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]],
                   rules: Optional[dict] = None) -> list:
    """The DTensor placements (one a mesh dim) of a tensor of ``shape``
    with ``logical_axes`` on ``mesh``, under ``rules`` (default: the
    installed rule table)."""
    rules = get_rules() if rules is None else rules
    return entries_to_placements(mesh, _pspec(mesh, rules, shape,
                                              logical_axes))


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: under a mesh and rules a
    DTensor is redistributed to the placements they give (what
    ``with_sharding_constraint`` asks of XLA); otherwise, or for a plain
    tensor, ``x`` comes back as it is.

    The port's train and serve steps run the model on gathered plain
    tensors with no mesh installed (``train.trainer``, ``serving.engine``),
    so on every path of the port these calls return ``x`` unchanged: they
    mark where the reference constrains its activations, and act once a
    step runs the model on DTensor activations."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements_for(mesh, x.shape, logical_axes, rules)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)

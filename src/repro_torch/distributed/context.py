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
mesh as well: ``models.moe_ep`` called under ``mesh_context`` puts its
experts on the mesh's ``"model"`` dim, every rank passing the whole
batch.  The context is per thread, as the reference's.

Tensor parallelism has a context of its own (``tp_context``): the train
and serve steps install it around the model, which then runs on plain
tensors, each rank on its shard of every product the rules split over
``"model"`` (``local_slice`` says which slice of a logical axis is the
rank's; a MoE block's experts or their ``ff`` columns too), with the
collectives of ``distributed.collectives`` where GSPMD would put them.
Beside it the steps install ``batch_context``: the mesh the step runs
over and its dims that split the batch's rows, so that what the single
program computes over the whole batch (the MoE routing's statistics and
capacity) is summed over the ranks that split it (``data_groups``), and
``moe_ep`` finds the step's ``"model"`` axis (``step_mesh``).  Under the
``seq_parallel`` rules ``shard`` is where the residual stream's sequence
is scattered over ``"model"`` (``collectives.scatter_model``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import mesh_sizes

__all__ = ["set_mesh", "get_mesh", "get_rules", "mesh_context",
           "resolve_axis", "pspec_for", "placements_for", "shard",
           "tp_context", "tp_state", "model_size", "model_rank",
           "model_group", "split_model_dim", "local_slice", "is_local",
           "seq_parallel",
           "sequence", "sp_active", "recompute_context", "batch_context",
           "BatchSplit", "batch_split", "data_groups", "step_mesh",
           "CapacitySplit", "capacity_split"]

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
    ``with_sharding_constraint`` asks of XLA).

    A plain tensor comes back as it is, with one exception: under a
    tensor-parallel context whose rules shard ``"seq"`` over ``"model"``
    (``make_rules(seq_parallel=True)``), the residual stream ``("batch",
    "seq", None)`` at the step's whole sequence length (``tp_state``'s
    ``seq_len``) is scattered to the rank's rows, the backward gathering
    them (Megatron's sequence parallelism: each block gathers the rows on
    entry and reduce-scatters its output).  Inside a block the
    annotations of tensor-parallel activations stay no-ops: the rank
    holds its heads or channels there, as the weights' placements give."""
    from torch.distributed.tensor import DTensor
    st = tp_state()
    if st is not None and not isinstance(x, DTensor):
        if tuple(logical_axes) == ("batch", "seq", None) \
                and st.seq_len is not None and x.shape[1] == st.seq_len \
                and seq_parallel(st.seq_len):
            from repro_torch.distributed import collectives
            return collectives.scatter_model(x, model_group(), 1)
        return x
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None or not isinstance(x, DTensor):
        return x
    want = placements_for(mesh, x.shape, logical_axes, rules)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ------------------------------------------------ tensor parallelism
class TPState:
    """The installed tensor-parallel context: the mesh, its rule table and
    the step's whole sequence length (for ``shard``'s scatter)."""

    def __init__(self, mesh: DeviceMesh, rules: dict):
        self.mesh, self.rules, self.seq_len = mesh, rules, None
        names = tuple(mesh.mesh_dim_names or ())
        self.model_dim = names.index("model") if "model" in names else None

    @property
    def size(self) -> int:
        return 1 if self.model_dim is None else \
            int(self.mesh.mesh.shape[self.model_dim])


def tp_state() -> Optional[TPState]:
    """The installed tensor-parallel context, or None (also where the mesh
    has no ``"model"`` axis, or one of size 1)."""
    st = getattr(_STATE, "tp", None)
    return st if st is not None and st.size > 1 else None


@contextlib.contextmanager
def tp_context(mesh: Optional[DeviceMesh], rules: Optional[dict]):
    """Run the block's model code tensor-parallel over ``mesh``'s
    ``"model"`` axis under ``rules`` (nothing changes without either)."""
    prev = getattr(_STATE, "tp", None)
    _STATE.tp = None if mesh is None or rules is None else \
        TPState(mesh, rules)
    try:
        yield _STATE.tp
    finally:
        _STATE.tp = prev


@contextlib.contextmanager
def _reinstall(st, bs):
    prev = getattr(_STATE, "tp", None), getattr(_STATE, "batch", None)
    _STATE.tp, _STATE.batch = st, bs
    try:
        yield
    finally:
        _STATE.tp, _STATE.batch = prev


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute in the
    backward (which may run on autograd's device thread) sees the
    tensor-parallel and batch contexts that the forward saw."""
    st = getattr(_STATE, "tp", None)
    bs = getattr(_STATE, "batch", None)
    return contextlib.nullcontext(), _reinstall(st, bs)


def split_model_dim(mesh) -> Optional[int]:
    """The index of ``mesh``'s ``"model"`` dim where it splits (size > 1),
    else None."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return None
    i = names.index("model")
    return i if mesh.mesh.shape[i] > 1 else None


def model_size() -> int:
    st = tp_state()
    return 1 if st is None else st.size


def model_rank() -> int:
    """This rank's coordinate on the ``"model"`` axis (0 without TP)."""
    st = tp_state()
    if st is None:
        return 0
    return int(st.mesh.get_coordinate()[st.model_dim])


def model_group():
    """The process group of this rank's ``"model"`` axis (None without
    TP)."""
    st = tp_state()
    return None if st is None else st.mesh.get_group(st.model_dim)


def local_slice(logical: Optional[str], size: int) -> slice:
    """The rank's slice of a dim of ``size`` named ``logical``: its
    contiguous shard where the rules resolve the dim to ``"model"``
    (``pspec_for``'s choice for a tensor whose earlier dims do not take
    ``"model"``), else the whole dim."""
    st = tp_state()
    if st is None or _first_fit(st.mesh, st.rules, logical, size,
                                None) != "model":
        return slice(0, size)
    n = size // st.size
    r = model_rank()
    return slice(r * n, (r + 1) * n)


def is_local(logical: Optional[str], size: int) -> bool:
    """Whether a dim of ``size`` named ``logical`` is split over
    ``"model"`` (``local_slice`` is a part)."""
    sl = local_slice(logical, size)
    return sl.stop - sl.start < size


def seq_parallel(seq_len: int) -> bool:
    """Whether the residual stream of ``seq_len`` rows is sequence-sharded
    over ``"model"`` (the ``seq_parallel`` rules, rows that divide)."""
    return is_local("seq", seq_len)


@contextlib.contextmanager
def sequence(seq_len: int):
    """The step's whole sequence length for ``shard``'s scatter (and
    ``sp_active``), inside the block: a new context, so that a recompute
    that captured the old one (``recompute_context``) keeps it."""
    prev = getattr(_STATE, "tp", None)
    if prev is None:
        yield
        return
    st = TPState(prev.mesh, prev.rules)
    st.seq_len = seq_len
    _STATE.tp = st
    try:
        yield
    finally:
        _STATE.tp = prev


def sp_active() -> bool:
    """Whether the residual stream is sequence-sharded now: the
    ``seq_parallel`` rules and a step's length that divides."""
    st = tp_state()
    return st is not None and st.seq_len is not None \
        and seq_parallel(st.seq_len)


# ------------------------------------------------ the batch's split
class BatchSplit:
    """The installed batch context: the mesh a step runs over, its dims
    that split the batch's rows (major to minor, as DTensor orders a dim
    sharded over several mesh dims) and the step's rule table (None:
    none installed)."""

    def __init__(self, mesh: DeviceMesh, dims: Sequence[int],
                 rules: Optional[dict] = None):
        self.mesh, self.dims, self.rules = mesh, tuple(dims), rules

    @property
    def size(self) -> int:
        """How many ranks split the rows."""
        n = 1
        for d in self.dims:
            n *= int(self.mesh.mesh.shape[d])
        return n

    @property
    def index(self) -> int:
        """This rank's block of rows: its coordinates on the split dims,
        major to minor."""
        coord = self.mesh.get_coordinate()
        i = 0
        for d in self.dims:
            i = i * int(self.mesh.mesh.shape[d]) + int(coord[d])
        return i

    @property
    def groups(self) -> list:
        """The split dims' process groups, major to minor."""
        return [self.mesh.get_group(d) for d in self.dims]


@contextlib.contextmanager
def batch_context(mesh: Optional[DeviceMesh], dims: Sequence[int] = (),
                  rules: Optional[dict] = None):
    """Run the block's model code on the rows of a batch that ``mesh``'s
    dims ``dims`` split (none: every rank holds the whole batch), under
    the step's ``rules``; nothing is installed without a mesh."""
    prev = getattr(_STATE, "batch", None)
    _STATE.batch = None if mesh is None else BatchSplit(mesh, dims, rules)
    try:
        yield _STATE.batch
    finally:
        _STATE.batch = prev


def batch_split() -> Optional[BatchSplit]:
    """The installed batch context where more than one rank splits the
    rows, else None."""
    bs = getattr(_STATE, "batch", None)
    return bs if bs is not None and bs.size > 1 else None


def data_groups() -> list:
    """The process groups of the ranks that split the step's batch, major
    to minor (empty where no rank splits it)."""
    bs = batch_split()
    return [] if bs is None else bs.groups


class CapacitySplit(NamedTuple):
    """The data ranks that split a MoE dispatch buffer's ``capacity`` dim:
    their group (of this rank's coordinates on the other mesh dims), how
    many there are, this rank's block, and the batch-split blocks (in
    ``BatchSplit.index`` order) of the group's ranks, by group rank."""
    group: object
    size: int
    index: int
    members: list


def capacity_split(cap: int) -> Optional[CapacitySplit]:
    """Where the step's rules put a MoE buffer's ``capacity`` dim of
    ``cap`` slots on one mesh dim that splits the batch (the reference's
    ``"capacity": [("data",), ()]``, co-sharded with the rows), that
    dim's split, else None (every rank holds all ``cap`` slots)."""
    bs = batch_split()
    if bs is None:
        return None
    axis = _first_fit(bs.mesh, bs.rules, "capacity", cap, None)
    names = tuple(bs.mesh.mesh_dim_names or ())
    if not isinstance(axis, str) or names.index(axis) not in bs.dims:
        return None
    d = names.index(axis)
    n = int(bs.mesh.mesh.shape[d])
    if n == 1:
        return None
    stride = 1
    for e in bs.dims[bs.dims.index(d) + 1:]:
        stride *= int(bs.mesh.mesh.shape[e])
    j = int(bs.mesh.get_coordinate()[d])
    base = bs.index - j * stride
    return CapacitySplit(bs.mesh.get_group(d), n, j,
                         [base + i * stride for i in range(n)])


def step_mesh() -> Optional[DeviceMesh]:
    """The mesh the installed train or serve step runs over (its batch
    context's, else its tensor-parallel context's), or None."""
    bs = getattr(_STATE, "batch", None)
    if bs is not None:
        return bs.mesh
    st = getattr(_STATE, "tp", None)
    return None if st is None else st.mesh

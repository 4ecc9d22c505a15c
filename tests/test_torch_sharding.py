"""repro_torch's sharding rules (``distributed/sharding.py``,
``distributed/context.py``), shapes (``configs/shapes.py``) and sharded
stand-ins (``launch/shardings.py``) against the JAX package's, on the
production meshes.

For every config x shape x mesh ((16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``) x rule table (``fsdp=True``,
the train table; ``False``, the serve one; and the train table with
``seq_parallel`` and ``expert_data_shard``), exactly:

* every leaf of the train state (parameters, AdamW's moments or
  Adafactor's factored ones, the master copy and the sync buffers where
  the run has them), the batch inputs and, for a decode cell, the decode
  state get the mesh-axis entries that JAX's ``pspec_for`` gives them.
  JAX resolves under a duck mesh (``axis_names`` and an empty
  ``devices`` array of the mesh's shape, which is all ``pspec_for``
  reads); the port under a ``DeviceMesh`` on the fake process group of
  the mesh's world size, in this process;
* each leaf's per-device shard shape equals ``NamedSharding(
  AbstractMesh, spec).shard_shape``;
* the per-device argument bytes (``launch.shardings.argument_bytes`` over
  ``train_state_sds`` + ``batch_sds`` + ``rng_sds``) equal the sum of
  JAX's shard bytes over the same trees, to the byte;
* ``applicable``, ``count_params`` and ``active_params`` equal JAX's.

The port keeps one decode-cache entry a layer where JAX stacks a pattern
position's layers: a stacked JAX leaf's entries, without the leading
``"layers"`` one (never sharded), are each of its layers'.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import torch.distributed as dist                              # noqa: E402
from jax.sharding import AbstractMesh                         # noqa: E402

from repro.configs import shapes as jshapes                   # noqa: E402
from repro.configs.base import ARCH_IDS                       # noqa: E402
from repro.configs.base import load_config as jax_config      # noqa: E402
from repro.distributed import context as jdctx                # noqa: E402
from repro.distributed import sharding as jsharding           # noqa: E402
from repro.launch import shardings as jshardings              # noqa: E402
from repro.models import backbone as jbackbone                # noqa: E402
from repro_torch.configs import shapes                        # noqa: E402
from repro_torch.configs.base import load_config              # noqa: E402
from repro_torch.distributed import context as dctx           # noqa: E402
from repro_torch.distributed import sharding                  # noqa: E402
from repro_torch.launch import shardings                      # noqa: E402
from repro_torch.launch.mesh import MESH_SHAPES, make_mesh    # noqa: E402
from repro_torch.models import backbone                       # noqa: E402
from repro_torch.models.common import tree_leaves             # noqa: E402

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake process group the meshes stand on, torn down after the
    module (other modules build real groups in this process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    state = {"world": None}

    def mesh(name):
        world = int(np.prod(MESH_SHAPES[name]))
        if state["world"] != world:
            if dist.is_initialized():
                dist.destroy_process_group()
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            state["world"] = world
        return make_mesh(MESH_SHAPES[name], AXES[name], device_type="cpu")

    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


class _jax_rules:
    """JAX's context with a duck mesh of the mesh ``name``'s shape and
    ``rules`` installed; yields the ``AbstractMesh`` of that shape."""

    def __init__(self, name, rules):
        self.name, self.rules = name, rules

    def __enter__(self):
        duck = types.SimpleNamespace(axis_names=AXES[self.name],
                                     devices=np.empty(MESH_SHAPES[self.name],
                                                      object))
        jdctx.set_mesh(duck, self.rules)
        return AbstractMesh(MESH_SHAPES[self.name], AXES[self.name])

    def __exit__(self, *exc):
        jdctx.set_mesh(None, None)
        return False


def _jax_leaves(tree):
    return [x for x in jax.tree.leaves(tree)
            if isinstance(x, jax.ShapeDtypeStruct)]


def _entries(x) -> tuple:
    return shardings.placement_entries(x)


def _check_leaves(got, want, what):
    """Port DTensor leaves against JAX ShapeDtypeStructs: shapes, dtypes'
    sizes, mesh-axis entries and shard shapes.  Returns (port bytes, JAX
    bytes) over the leaves."""
    assert len(got) == len(want), what
    got_bytes = want_bytes = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), (what, i)
        assert g.element_size() == np.dtype(w.dtype).itemsize, (what, i)
        assert _entries(g) == tuple(w.sharding.spec) + (None,) * (
            len(w.shape) - len(w.sharding.spec)), (what, i, w.sharding.spec)
        shard = w.sharding.shard_shape(w.shape)
        assert tuple(g.to_local().shape) == tuple(shard), (what, i)
        got_bytes += g.to_local().numel() * g.element_size()
        want_bytes += int(np.prod(shard)) * np.dtype(w.dtype).itemsize
    return got_bytes, want_bytes


def _jax_decode_per_layer(jstate, cfg):
    """JAX's stacked decode state as one entry a layer, in the port's
    order (prefix, then group by group the pattern, then suffix), each a
    list of (shape, entries) of its leaves."""
    plan = jbackbone.layer_plan(cfg)
    out = []

    def leaves(t, stacked):
        res = []
        for x in _jax_leaves(t):
            spec = tuple(x.sharding.spec) + (None,) * (
                len(x.shape) - len(x.sharding.spec))
            if stacked:
                assert spec[0] is None
                res.append((tuple(x.shape[1:]), spec[1:]))
            else:
                res.append((tuple(x.shape), spec))
        return res
    out += [leaves(c, False) for c in jstate.prefix]
    for _ in range(plan.n_groups):
        out += [leaves(c, True) for c in jstate.groups]
    out += [leaves(c, False) for c in jstate.suffix]
    return out


@pytest.mark.parametrize("rules_kw", [
    dict(fsdp=True), dict(fsdp=False),
    dict(fsdp=True, seq_parallel=True, expert_data_shard=True)],
    ids=["train_rules", "serve_rules", "sp_rules"])
@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("shape_name", jshapes.SHAPE_ORDER)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_jax(arch, shape_name, mesh_name, rules_kw,
                              fake_group):
    mesh = fake_group(mesh_name)
    run, jrun = load_config(arch), jax_config(arch)
    shape, jshape = shapes.SHAPES[shape_name], jshapes.SHAPES[shape_name]
    assert shapes.applicable(run.model, shape) == \
        jshapes.applicable(jrun.model, jshape)
    assert backbone.count_params(run.model) == \
        jbackbone.count_params(jrun.model)
    assert backbone.active_params(run.model) == \
        jbackbone.active_params(jrun.model)

    rules = sharding.make_rules(**rules_kw)
    jrules = jsharding.make_rules(**rules_kw)
    assert rules == jrules
    with _jax_rules(mesh_name, jrules) as amesh:
        jstate = jshardings.train_state_sds(jrun, amesh)
        jbatch = jshardings.batch_sds(jrun, jshape, amesh)
        jrng = jshardings.rng_sds(amesh)
        jdec = jshardings.decode_state_sds(jrun, amesh, jshape) \
            if shape.kind == "decode" and \
            jshapes.applicable(jrun.model, jshape)[0] else None
    with dctx.mesh_context(mesh, rules):
        state = shardings.train_state_sds(run, mesh)
        batch = shardings.batch_sds(run, shape, mesh)
        rng = shardings.rng_sds(mesh)
        dec = shardings.decode_state_sds(run, mesh, shape) \
            if jdec is not None else None

    got = want = 0
    for field in ("step", "params", "master", "opt", "sync"):
        g, w = _check_leaves(tree_leaves(getattr(state, field)),
                             _jax_leaves(getattr(jstate, field)), field)
        got, want = got + g, want + w
    assert sorted(batch) == sorted(jbatch)
    g, w = _check_leaves([batch[k] for k in sorted(batch)],
                         [jbatch[k] for k in sorted(jbatch)], "batch")
    got, want = got + g, want + w
    g, w = _check_leaves([rng], [jrng], "rng")
    got, want = got + g, want + w
    assert got == want
    assert shardings.argument_bytes(state, batch, rng) == want

    if dec is not None:
        per_layer = _jax_decode_per_layer(jdec, jrun.model)
        assert len(per_layer) == len(dec.layers)
        for i, (c, w) in enumerate(zip(dec.layers, per_layer)):
            leaves = tree_leaves(c)
            assert [(tuple(x.shape), _entries(x)) for x in leaves] == w, i


def test_rule_resolution_falls_back_as_jax():
    """The rules' fallbacks on a (16, 16) duck mesh, leaf by leaf as JAX:
    SmolLM's 15 heads and 5 KV heads replicate on ``model`` while its
    ``ff`` and ``vocab`` dims shard; Command-R+'s 8 KV heads leave
    ``model`` to ``head_dim``; a dim that takes ``model`` first keeps it
    from a later dim."""
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16), object))
    rules = sharding.make_rules(fsdp=True)
    cases = [((960, 15, 64), ("embed", "heads", None)),
             ((960, 5, 64), ("embed", "kv_heads", None)),
             ((960, 2560), ("embed", "ff")),
             ((49152, 960), ("vocab", "embed")),
             ((12288, 8, 128), ("embed", "kv_heads", "head_dim")),
             ((8, 128), ("kv_heads", "head_dim")),
             ((256, 128), ("ff", "ff")),
             ((64, 4096, 1), ("batch", "seq", None))]
    dctx.set_mesh(duck, rules)
    jdctx.set_mesh(duck, rules)
    try:
        for shp, axes in cases:
            want = tuple(jdctx.pspec_for(shp, axes))
            want += (None,) * (len(shp) - len(want))
            assert dctx.pspec_for(shp, axes) == want, (shp, axes)
            for a, d in zip(axes, shp):
                assert dctx.resolve_axis(a, d) == jdctx.resolve_axis(a, d)
    finally:
        dctx.set_mesh(None)
        jdctx.set_mesh(None, None)
    assert dctx.pspec_for((15, 64), ("heads", None)) == (None, None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_axes_match_jax(arch):
    """``input_specs`` and ``batch_axes`` for every shape, the spec trees'
    logical axes leaf by leaf, and ``decode_state_axes`` per layer."""
    run, jrun = load_config(arch), jax_config(arch)
    for name in jshapes.SHAPE_ORDER:
        got = shapes.input_specs(run.model, shapes.SHAPES[name])
        want = jshapes.input_specs(jrun.model, jshapes.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "meta"
            assert got[k].element_size() == np.dtype(want[k].dtype).itemsize
        assert shapes.batch_axes(run.model, shapes.SHAPES[name]) == \
            jshapes.batch_axes(jrun.model, jshapes.SHAPES[name])
    from repro.models.common import is_spec
    from repro_torch.models.common import tree_leaves_specs
    got = tree_leaves_specs(backbone.train_specs(run.model))
    want = jax.tree.leaves(jbackbone.model_specs(jrun.model),
                           is_leaf=is_spec)
    assert [(tuple(s.shape), s.logical_axes()) for s in got] == \
        [(tuple(s.shape), tuple(s.axes)) for s in want]
    jaxes = jbackbone.decode_state_axes(jrun.model)
    plan = jbackbone.layer_plan(jrun.model)
    per_layer = list(jaxes.prefix) + list(jaxes.groups) * plan.n_groups \
        + list(jaxes.suffix)
    got_axes = backbone.decode_state_axes(run.model).layers
    assert len(got_axes) == len(per_layer)
    for g, w in zip(got_axes, per_layer):
        strip = [backbone.parse_axes(a) for a in jax.tree.leaves(w)]
        strip = [a[1:] if a and a[0] == "layers" else a for a in strip]
        assert [backbone.parse_axes(a) for a in g] == strip

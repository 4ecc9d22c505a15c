"""repro_torch's training under a mesh: the train step over gloo CPU ranks
(one process a mesh device, ``distributed.spawn.run_ranks``) with its
state placed by the train rules (``distribute_train_state`` under
``mesh_context(mesh, make_rules(fsdp=True))``), and the expert-parallel
MoE's backward.

Each mesh spawns once (a module fixture) and runs every case there: the
smoke configs in float32, three steps from one JAX-initialised state, on
2 ranks (``("data",)``), 4 ranks (``("data",)``) and 2 x 2 ranks
(``("data", "model")``).  The batch of 4 rows is sharded over the data
axes; a 2-row micro-batch does not divide over 4 ranks and is replicated
there, as the batch rule's fallback gives.

Tolerances, with their reasons:

* Against the single-process JAX trainer: ``test_torch_train.
  test_three_steps_track_jax``'s bounds (the loss within 1e-4, the grad
  norm within 1e-3, lr within 1e-6, the parameters within 1e-3 of their
  move, the sync's volume equal), for the cases it holds (the HT sync
  with stragglers on a 2-way accumulation parts from JAX in one process
  too: ROADMAP queue 3).
* Against the port's own single-process step: the loss within 1e-5, the
  grad norm within 1e-3, the parameters within 1e-4 of their move (L2),
  the sync's volume equal.  A rank sums its share of every gradient and
  the shares are summed across ranks, where one process sums the whole
  batch at once: float32 rounding of a few ulps (2^-24 each) in every
  sum, carried through the layers' backward (measured: losses equal to
  1e-7).  On the 2 x 2 mesh the "model" axis splits SmolLM's ``ff`` and
  vocab and RecurrentGemma's channels (tensor parallelism): those products
  sum in another order in the forward too.  Each step alone, from one
  process's state before it, parts from one process by 2e-6 to 5.2e-5 of
  that step's move; chained, AdamW's ``sign``-like update of entries whose
  gradient is near its rounding and the HT sync's draws near their
  thresholds carry that to 1.2e-4 to 1.7e-4 of the move in three cases,
  where the data split alone reaches 6.5e-5 (``tests/torch_tp_gaps.py``
  prints them).  That mesh is therefore held to one process step by
  step, each step from one process's state, at the same bounds; its
  chained steps are held to the JAX trainer above.  The next step's
  gradient is more sensitive than its loss, as
  in ``test_torch_train`` (hence its 1e-3): Adafactor's parameters 1.4e-7
  apart after two steps give grad norms 4.0e-5 apart at the third.
  AdamW's ``sign``-like update moves entries whose gradient is ~0 by
  ~lr, hence an L2 bound on the parameters.
* The thinned sync under the mesh: bit-equal to one process (every rank
  thins the gathered leaf with the whole leaf's uniforms).
* ``moe_ep``'s gradients against the dense ``ffn.moe``'s: rtol = atol =
  1e-5 normwise, the forward's bound (``test_torch_moe_ep``): the
  experts see their tokens in another order and the chunks' gradients
  are summed over the ranks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.spawn import run_ranks  # noqa: E402

TIMEOUT_S = 120.0
MESHES = {"data2": (2,), "data4": (4,), "data2x2": (2, 2)}
# name -> (arch, optimizer, grad_accum, straggler mask, sync mode)
CASES = {
    "adamw-1": ("smollm-360m", "adamw", 1, None, None),
    "adamw-2-keep0": ("smollm-360m", "adamw", 2, (True, False), None),
    "adamw-1-sync_ht": ("smollm-360m", "adamw", 1, None, "ht"),
    "adafactor-1": ("smollm-360m", "adafactor", 1, None, None),
    "adamw-2-keep0-sync_ht": ("smollm-360m", "adamw", 2, (True, False),
                              "ht"),
    "hybrid-adamw-1": ("recurrentgemma-2b", "adamw", 1, None, None),
    "moe-adamw-1": ("qwen2-moe-a2.7b", "adamw", 1, None, None),
}
# the cases test_three_steps_track_jax holds in one process, and the MoE
# model at the default aux weight 0.01: on the data meshes its routing
# statistics are the whole batch's, as in JAX's one program
JAX_CASES = ("adamw-1", "adamw-2-keep0", "adamw-1-sync_ht", "adafactor-1",
             "moe-adamw-1")
E, D, F, K = 8, 32, 16, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_run(arch, opt, accum, sync):
    """The port's smoke run in float32, as test_torch_train's (lr 1e-2,
    warmup 1, a float32 accumulator)."""
    from repro_torch.configs import base
    run = base.load_smoke_config(arch)
    tcfg = dataclasses.replace(
        run.train, param_dtype="float32", compute_dtype="float32",
        learning_rate=1e-2, warmup_steps=1, optimizer=opt, grad_accum=accum,
        master_weights=True, thinned_sync=sync is not None)
    return dataclasses.replace(run, train=tcfg)


def token_batch(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                   dtype=torch.int32)}


class _sync_mode:
    """Both packages' trainers build ``ThinnedSyncConfig(budget=,
    alpha=)`` with the default mode 'ht'; build it in ``mode`` inside the
    block (nothing changes for ``mode=None``)."""

    def __init__(self, mode, *modules):
        self.mode, self.modules = mode, modules

    def __enter__(self):
        import functools
        self.saved = [m.ThinnedSyncConfig for m in self.modules]
        if self.mode:
            for m, cls in zip(self.modules, self.saved):
                m.ThinnedSyncConfig = functools.partial(cls, mode=self.mode)

    def __exit__(self, *exc):
        for m, cls in zip(self.modules, self.saved):
            m.ThinnedSyncConfig = cls
        return False


def _np_state(state):
    """A whole TrainState with numpy leaves (``from_jax_train_state``
    takes it back)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda x: x.detach().numpy().copy()
                    if isinstance(x, torch.Tensor) else x, state)


def _three_steps(run, state, keep, mesh=None, first=0, steps=3,
                 before=None):
    """``steps`` steps from ``state`` (a whole TrainState), step ``i`` on
    the batch 100 + i from ``first``, under ``mesh`` when given: each
    step's metrics and the final parameters, whole, as numpy.  One
    process appends its state before each step to ``before``."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.kernels.threefry import prng_key
    from repro_torch.launch import shardings
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer

    step = trainer.make_train_step(run, total_steps=20)
    mask = None if keep is None else torch.tensor(keep)
    metrics = []
    with dctx.mesh_context(mesh, sharding.make_rules(fsdp=True)) \
            if mesh is not None else _nothing():
        if mesh is not None:
            state = shardings.distribute_train_state(state, run, mesh)
        for i in range(first, first + steps):
            if before is not None:
                before.append(_np_state(state))
            batch = token_batch(run.model, 100 + i)
            if mesh is not None:
                batch = shardings.distribute_batch(batch, run, mesh)
            state, m = step(state, batch, prng_key(i), micro_keep=mask)
            metrics.append({k: float(v) for k, v in m.items()})
        params = [p.full_tensor() if mesh is not None else p
                  for p in tree_leaves(state.params)]
    return metrics, [p.detach().numpy() for p in params]


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _mesh_cases(mesh, shape, states):
    """On every rank: each case's three steps on a ``shape`` mesh; on 2
    ranks the MoE faults' cases too (``_split_moe``, ``_ep_step``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import from_jax_train_state

    names = ("data",) if len(shape) == 1 else ("data", "model")
    m = make_mesh(shape, names, device_type="cpu")
    out = {}
    from repro_torch.train import compression
    for name, (arch, opt, accum, keep, sync) in CASES.items():
        run = smoke_run(arch, opt, accum, sync)
        state = from_jax_train_state(run, states[name], device="cpu")
        with _sync_mode(sync, compression):
            out[name] = _three_steps(run, state, keep, m)
    if shape == (2,):
        out["split_moe"] = _split_moe(m)
        out["ep_step"] = _ep_step()
    return out


def _each_step_cases(mesh, shape, befores):
    """On every rank: each case's step i alone on a ``shape`` mesh, from
    one process's state before it (``befores[case][i]``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.train import compression

    m = make_mesh(shape, ("data", "model"), device_type="cpu")
    out = {}
    for name, (arch, opt, accum, keep, sync) in CASES.items():
        run = smoke_run(arch, opt, accum, sync)
        with _sync_mode(sync, compression):
            out[name] = [_three_steps(
                run, from_jax_train_state(run, st, device="cpu"), keep, m,
                first=i, steps=1) for i, st in enumerate(befores[name])]
    return out


def _init_states():
    """Every case's JAX-initialised state (numpy leaves)."""
    import jax

    from repro.configs.base import load_smoke_config as jax_smoke
    from repro.train import trainer as jtrainer
    out = {}
    for name, (arch, opt, accum, keep, sync) in CASES.items():
        run = smoke_run(arch, opt, accum, sync)
        jrun = jax_smoke(arch)
        jrun = dataclasses.replace(jrun, train=dataclasses.replace(
            jrun.train, **dataclasses.asdict(run.train)))
        out[name] = (jrun, jax.tree.map(
            np.asarray, jtrainer.init_train_state(jrun,
                                                  jax.random.PRNGKey(0))))
    return out


@pytest.fixture(scope="module")
def states():
    return _init_states()


@pytest.fixture(scope="module")
def single(states):
    """The port's single-process three steps, a case each: (metrics, the
    final parameters, the whole state before each step)."""
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.train import compression
    out = {}
    for name, (arch, opt, accum, keep, sync) in CASES.items():
        run = smoke_run(arch, opt, accum, sync)
        state = from_jax_train_state(run, states[name][1], device="cpu")
        before = []
        with _sync_mode(sync, compression):
            out[name] = _three_steps(run, state, keep, before=before) + (
                before,)
    return out


@pytest.fixture(scope="module")
def meshes(states):
    np_states = {k: v[1] for k, v in states.items()}
    out = {}
    for name, shape in MESHES.items():
        ranks = run_ranks(_mesh_cases, int(np.prod(shape)), shape,
                          np_states, device="cpu", timeout_s=TIMEOUT_S)
        for r in ranks[1:]:     # every rank ends with the same whole state
            for case in CASES:
                for a, b in zip(r[case][1], ranks[0][case][1]):
                    assert np.array_equal(a, b)
        out[name] = ranks[0]
    return out


@pytest.fixture(scope="module")
def tp_steps(single):
    """The meshes with a "model" axis: each case's steps one at a time,
    each from one process's state before it."""
    befores = {name: single[name][2] for name in CASES}
    return {name: run_ranks(_each_step_cases, int(np.prod(shape)), shape,
                            befores, device="cpu", timeout_s=TIMEOUT_S)[0]
            for name, shape in MESHES.items() if len(shape) > 1}


@pytest.fixture(scope="module")
def jax_runs(states):
    """JAX's single-process three steps, a case each."""
    import jax
    import jax.numpy as jnp

    from repro.train import compression as jcomp
    from repro.train import trainer as jtrainer
    out = {}
    for name in JAX_CASES:
        arch, opt, accum, keep, sync = CASES[name]
        jrun, jstate = states[name]
        with _sync_mode(sync, jcomp):
            jstate = jax.tree.map(jnp.asarray, jstate)
            jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
            metrics = []
            for i in range(3):
                b = {k: jnp.asarray(v.numpy()) for k, v in
                     token_batch(jrun.model, 100 + i).items()}
                jstate, m = jstep(jstate, b, jax.random.PRNGKey(i),
                                  None if keep is None else jnp.asarray(keep))
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = (metrics, [np.asarray(x) for x in
                                   jax.tree.leaves(jstate.params)])
    return out


def _parted(got, want, init) -> float:
    """The parameters' L2 distance from ``want`` over the distance
    ``want`` moved from ``init``."""
    def l2(xs):
        return float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                                 for x in xs)))
    moved = l2([b - a for a, b in zip(init, want)])
    return l2([np.asarray(a, np.float64) - b
               for a, b in zip(got, want)]) / moved


def _init_params(states, case):
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(states[case][1].params)]


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_steps_track_jax(mesh, case, meshes, jax_runs, states):
    """The mesh's three steps against the single-process JAX trainer at
    ``test_three_steps_track_jax``'s bounds."""
    (got_m, got_p), (want_m, want_p) = meshes[mesh][case], jax_runs[case]
    for g, w in zip(got_m, want_m):
        for k, rtol in (("loss", 1e-4), ("grad_norm", 1e-3), ("lr", 1e-6)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-9,
                                       err_msg=k)
        if "sync_volume_fraction" in w:
            assert g["sync_volume_fraction"] == w["sync_volume_fraction"]
    parted = _parted(got_p, want_p, _init_params(states, case))
    assert 0 < parted <= 1e-3, parted


def _metrics_track(got_m, want_m, grad_rtol=1e-3):
    for g, w in zip(got_m, want_m, strict=True):
        for k, rtol in (("loss", 1e-5), ("grad_norm", grad_rtol),
                        ("lr", 1e-6)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-9,
                                       err_msg=k)
        if "sync_volume_fraction" in w:
            assert g["sync_volume_fraction"] == w["sync_volume_fraction"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_steps_track_one_process(mesh, case, meshes, tp_steps, single,
                                      states):
    """The mesh's three steps against the port's own single-process steps
    at the float32 bounds of the module docstring: chained on the data
    meshes; on a mesh with a "model" axis each step alone, from one
    process's state before it (the module docstring says why)."""
    want_m, want_p, _ = single[case]
    if mesh not in tp_steps:
        got_m, got_p = meshes[mesh][case]
        _metrics_track(got_m, want_m)
        assert _parted(got_p, want_p, _init_params(states, case)) <= 1e-4
        return
    _each_step_tracks(tp_steps[mesh][case], single[case])


def _each_step_tracks(each, one, grad_rtol=1e-3, update_rtol=1e-4):
    """Each step alone (``each``: a step's metrics and parameters after
    it, from one process's state before it) against one process's steps
    (``one``: their metrics, the final parameters and the state before
    each step), at the bounds of the module docstring (the grad norm's
    and the update's may be given)."""
    from repro_torch.models.common import tree_leaves
    want_m, want_p, before = one
    params = [[np.asarray(x) for x in tree_leaves(b.params)]
              for b in before] + [want_p]
    for i, (got_m, got_p) in enumerate(each):
        _metrics_track(got_m, want_m[i:i + 1], grad_rtol)
        if all(np.array_equal(a, b) for a, b in zip(params[i], params[i + 1])):
            # step 0's lr is 0: nothing moves
            assert all(np.array_equal(a, b) for a, b in zip(got_p,
                                                            params[i + 1]))
        else:
            assert _parted(got_p, params[i + 1], params[i]) <= update_rtol, i


# --------------------------------------------------- the sync's blocks
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # sizes that straddle blocks of 1024 and shard over 2 x 2 ranks
    return {"a": f(64, 48), "b": [f(6, 40, 20)], "c": f(96)}


def _sync_on_mesh(mesh, seed):
    """On every rank: the thinned sync of a seeded gradient tree sharded
    over a (2, 2) mesh, gathered whole; the mesh's placements are the
    rules' for made-up logical axes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.kernels.threefry import prng_key
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import compression

    m = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = sharding.make_rules(fsdp=True)
    axes = {(64, 48): ("embed", "ff"), (6, 40, 20): ("layers", "embed",
                                                     "ff"),
            (96,): ("ff",)}
    grads = tree_map(lambda x: distribute_tensor(
        torch.tensor(x), m, dctx.placements_for(m, x.shape, axes[x.shape],
                                                rules)), _grad_tree(seed))
    err = compression.init_state(grads)
    out = []
    for mode in ("ht", "ef"):
        cfg = compression.ThinnedSyncConfig(mode=mode)
        synced, new, met = compression.thin_gradients(grads, err, prng_key(
            seed), cfg)
        out.append(([x.full_tensor().numpy() for x in tree_leaves(synced)],
                    [x.full_tensor().numpy() for x in tree_leaves(new.err)],
                    float(met["sync_volume_fraction"]),
                    [tuple(x.placements) != tuple(y.placements)
                     for x, y in zip(tree_leaves(synced),
                                     tree_leaves(grads))]))
    return out


def test_thinned_sync_under_mesh_keeps_the_same_blocks():
    """The thinned sync of sharded gradients keeps the same blocks and
    writes the same bits as one process (HT and error-feedback modes),
    and hands each leaf back with its gradient's placements."""
    from repro_torch.kernels.threefry import prng_key
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import compression

    ranks = run_ranks(_sync_on_mesh, 4, 7, device="cpu",
                      timeout_s=TIMEOUT_S)
    grads = tree_map(torch.tensor, _grad_tree(7))
    err = compression.init_state(grads)
    for mode, got in zip(("ht", "ef"), ranks[0]):
        synced, new, met = compression.thin_gradients(
            grads, err, prng_key(7), compression.ThinnedSyncConfig(
                mode=mode))
        for a, b in zip(got[0], tree_leaves(synced)):
            assert np.array_equal(a, b.numpy())
            assert np.array_equal(a != 0, b.numpy() != 0)
        for a, b in zip(got[1], tree_leaves(new.err)):
            assert np.array_equal(a, b.numpy())
        assert got[2] == float(met["sync_volume_fraction"])
        assert 0 < got[2] < 1
        assert not any(got[3])
    for r in ranks[1:]:
        for a, b in zip(r, ranks[0]):
            assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))


# ------------------------------------------------------- moe_ep backward
def _moe_data(seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F),
         "w_down": w(E, F, D),
         "shared": {"w_up": w(D, 2 * F), "w_gate": w(D, 2 * F),
                    "w_down": w(2 * F, D)},
         "shared_gate": w(D, 1)}
    x = rng.standard_normal((4, 16, D)).astype(np.float32)
    r = rng.standard_normal((4, 16, D)).astype(np.float32)
    return p, x, r


def _named_leaves(tree, path=""):
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _is_expert(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down") \
        and "/shared/" not in path and "/mlp/" not in path


def _moe_grads(p_np, x_np, r_np, fn):
    """The loss sum(y r) + 0.1 z of ``fn`` (an MoE call) and the
    gradients of x and of every leaf of the tree, by path."""
    from repro_torch.models.common import tree_map
    p = tree_map(lambda a: torch.tensor(a).requires_grad_(True), p_np)
    x = torch.tensor(x_np).requires_grad_(True)
    y, met = fn(p, x)
    loss = torch.sum(y * torch.tensor(r_np)) + 0.1 * met["moe_z_loss"]
    loss.backward()
    return float(loss.detach()), x.grad.numpy(), {
        k: q.grad.numpy() for k, q in _named_leaves(p)}


def _smoke_moe(ep: bool):
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.models import backbone
    run = load_smoke_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(run.model, capacity_factor=8.0,
                              moe_impl="ep_a2a" if ep else "spmd")
    params = backbone.init_train_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)), dtype=torch.int32)
    return cfg, params, {"tokens": tokens}


def _moe_ranks(mesh, p_np, x_np, r_np):
    """On every rank: ``moe_ep``'s loss and gradients on a 4-rank
    ``("model",)`` mesh and a 2 x 2 ``("data", "model")`` one, and a
    smoke Qwen2-MoE's ``train_loss`` gradients through ``moe_ep`` on the
    4-rank one."""
    from repro_torch.distributed.context import mesh_context
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import backbone, moe_ep

    out = {}
    for name, (model, data) in {"model4": (4, 1), "data2x2": (2, 2)}.items():
        m = make_model_mesh(model, data, device="cpu")
        out[name] = _moe_grads(p_np, x_np, r_np, lambda p, x: moe_ep.moe_ep(
            p, x, num_experts=E, top_k=K, capacity_factor=8.0, mesh=m))
    cfg, params, batch = _smoke_moe(ep=True)
    with mesh_context(make_model_mesh(4, 1, device="cpu")):
        loss, _ = backbone.train_loss(params, cfg, batch,
                                      compute_dtype=torch.float32,
                                      moe_aux_weight=0.0)
        loss.backward()
    out["train_loss"] = (float(loss), {k: q.grad.numpy() for k, q in
                                       _named_leaves(params)})
    return out


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_moe_ep_backward_matches_dense():
    """``moe_ep``'s backward on 4 gloo ranks (4-way ``"model"``, and 2 x 2
    with ``"data"``) against the dense ``ffn.moe``'s gradients: the loss,
    x's gradient and every leaf's, at 1e-5.  The aux loss is left out:
    moe_ep averages it per chunk, where the dense one is a product of
    global means (test_torch_moe_ep).  Each rank holds its own experts'
    gradients (the rows of the full leaf it owns; the other rows stay 0)
    and the router's, the shared expert's and x's whole.  Then a smoke
    Qwen2-MoE's ``train_loss`` through ``moe_impl="ep_a2a"`` on the 4
    ranks (capacity factor 8: nothing drops; aux weight 0) against the
    dense model's: the loss at 1e-5 and every gradient leaf at 1e-4
    normwise (its experts' summed over the ranks that own them), the
    chained layers adding to the MoE's own 1e-5."""
    from repro_torch.models import backbone, ffn

    p, x, r = _moe_data()
    ranks = run_ranks(_moe_ranks, 4, p, x, r, device="cpu",
                      timeout_s=TIMEOUT_S)
    want = _moe_grads(p, x, r, lambda q, xx: ffn.moe(
        q, xx, num_experts=E, top_k=K, capacity_factor=8.0))
    for name, M in (("model4", 4), ("data2x2", 2)):
        for rank, got in enumerate(ranks):
            loss, gx, gp = got[name]
            np.testing.assert_allclose(loss, want[0], rtol=1e-5)
            assert _close(gx, want[1], 1e-5)
            m, E_loc = rank % M, E // M
            rows = np.arange(m * E_loc, (m + 1) * E_loc)
            for k, w in want[2].items():
                if _is_expert(k):
                    assert _close(gp[k][rows], w[rows], 1e-5), (name, k)
                    assert not np.delete(gp[k], rows, axis=0).any()
                else:
                    assert _close(gp[k], w, 1e-5), (name, k)

    cfg, params, batch = _smoke_moe(ep=False)
    loss, _ = backbone.train_loss(params, cfg, batch,
                                  compute_dtype=torch.float32,
                                  moe_aux_weight=0.0)
    loss.backward()
    dense = {k: q.grad.numpy() for k, q in _named_leaves(params)}
    for got in ranks:
        np.testing.assert_allclose(got["train_loss"][0], float(loss.detach()),
                                   rtol=1e-5)
    for k, w in dense.items():
        g = sum(r["train_loss"][1][k] for r in ranks) if _is_expert(k) \
            else ranks[0]["train_loss"][1][k]
        assert _close(g, w, 1e-4), k


# ------------------------------------- MoE over a split batch, in a step
SPLIT_CAP = 12          # slots an expert: 64 tokens x 2 choices overflow it
SPLIT_WEIGHTS = (0.1, 0.1)      # the loss's weights of aux and z


def _split_loss(y, met, r, share):
    """A rank's share of the loss sum(y r) + 0.1 aux + 0.1 z over the
    whole batch: its rows' products, and its token share of the
    losses (which every rank computes whole)."""
    wa, wz = SPLIT_WEIGHTS
    return torch.sum(y * r) + share * (wa * met["moe_aux_loss"]
                                       + wz * met["moe_z_loss"])


def _split_moe(mesh):
    """On each of the 2 ranks of a ``("data",)`` mesh: ``ffn.moe`` on the
    rank's half of ``_moe_data``'s batch at ``SPLIT_CAP`` slots (choices
    drop), with the batch context (the ranks that split the batch: the
    single program's routing), again with the rules beside it (the
    reference's ``capacity`` on ``"data"``: each rank runs its block of
    every expert's slots) and without it (each rank routing its half
    alone, the fault); each time y, the metrics and the gradients of the
    rank's share of the loss by x and the router, every rank's gathered
    in rank order."""
    import torch.distributed as dist

    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.models import ffn
    from repro_torch.models.common import tree_map

    p_np, x_np, r_np = _moe_data()
    rules = sharding.make_rules()
    n, i = dist.get_world_size(), dist.get_rank()
    rows = slice(i * 4 // n, (i + 1) * 4 // n)
    out = {}
    for label, ctx in (("split", dctx.batch_context(mesh, (0,))),
                       ("capacity", dctx.batch_context(mesh, (0,), rules)),
                       ("alone", _nothing())):
        p = tree_map(lambda a: torch.tensor(a).requires_grad_(True), p_np)
        x = torch.tensor(x_np[rows]).requires_grad_(True)
        with ctx:
            y, met = ffn.moe(p, x, num_experts=E - 2, top_k=K,
                             deterministic_capacity=SPLIT_CAP)
            cut = dctx.capacity_split(SPLIT_CAP) is not None
        _split_loss(y, met, torch.tensor(r_np[rows]), 1 / n).backward()
        mine = (y.detach().numpy(), {k: float(v) for k, v in met.items()},
                x.grad.numpy(), p["router"].grad.numpy(), cut)
        every = [None] * n
        dist.all_gather_object(every, mine)
        out[label] = every
    return out


def _step_grads(run, state, batch, mesh):
    """One train step of ``state`` on ``batch`` under ``mesh`` with the
    train rules: its metrics and the gradients (whole, float32) as the
    step takes them from the parameters."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch import shardings
    from repro_torch.train import trainer

    grads = {}
    orig = trainer._take_grads

    def spy(leaves, acc_dtype):
        grads["g"] = [p.grad.full_tensor().numpy().copy() for p in leaves]
        return orig(leaves, acc_dtype)
    with dctx.mesh_context(mesh, sharding.make_rules(fsdp=True)):
        st = shardings.distribute_train_state(state, run, mesh)
        step = trainer.make_train_step(run, total_steps=20)
        trainer._take_grads = spy
        try:
            _, met = step(st, shardings.distribute_batch(batch, run, mesh))
        finally:
            trainer._take_grads = orig
    return {k: float(v) for k, v in met.items()}, grads["g"]


def _ep_step(shape=(1, 2)):
    """On each rank of a ``("data", "model")`` mesh of ``shape``: a smoke
    Qwen2-MoE with ``moe_impl="ep_a2a"`` (capacity factor 1.25: the 8-slot
    floor drops choices), its train step's loss and gradients, and the
    same loss by ``moe_ep`` called with the mesh (``mesh_context``: every
    rank the whole batch and tree, JAX's ``moe_ep`` ownership) with its
    gradients, the expert leaves' summed over the ``"model"`` ranks (each
    holds its experts', summed over ``"data"``)."""
    import torch.distributed as dist

    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import backbone
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import trainer

    m = make_mesh(shape, ("data", "model"), device_type="cpu")
    run = smoke_run("qwen2-moe-a2.7b", "adamw", 1, None)
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, moe_impl="ep_a2a"))
    params = backbone.init_train_params(
        run.model, torch.Generator().manual_seed(6), device="cpu")
    batch = token_batch(run.model, 100)
    state = trainer.TrainState(torch.zeros((), dtype=torch.int32), params,
                               tree_map(lambda q: q.detach().clone(),
                                        params),
                               trainer.optim.adamw_init(params), None)
    met, grads = _step_grads(run, state, batch, m)
    params = tree_map(lambda q: q.detach().clone().requires_grad_(True),
                      params)
    with dctx.mesh_context(m):
        loss, want_met = backbone.train_loss(params, run.model, batch,
                                             compute_dtype=torch.float32)
        loss.backward()
    want = []
    for (path, _), q in zip(_named_leaves(params), tree_leaves(params)):
        g = q.grad.clone()
        if _is_expert(path):
            dist.all_reduce(g, group=m.get_group(1))
        want.append(g.numpy())
    with torch.no_grad():       # the dense ffn.moe, one process
        _, dense = backbone.train_loss(params, run.model, batch,
                                       compute_dtype=torch.float32)
    return (met, grads, {k: float(v) for k, v in want_met.items()}, want,
            float(dense["moe_aux_loss"]))


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_moe_routes_the_whole_split_batch(meshes):
    """Fault A: ``ffn.moe`` on a batch split over 2 data ranks, with the
    batch context, is JAX's ``ffn.moe`` on the whole batch (one program):
    y, the aux and z losses and the drop fraction (choices drop at
    ``SPLIT_CAP`` slots), and the gradients of the loss by x and the
    router (the ranks' shares summed), at 1e-5 normwise (float32 sums of
    the ranks' statistics and the ranks' gradient shares in another
    order; the drop fraction to the same count of kept choices).  Each
    rank routing its half alone (no context, what the port did before)
    parts from it by more than 1e-3 in the aux loss and the drops."""
    import jax
    import jax.numpy as jnp

    from repro.models import ffn as jffn

    p, x, r = _moe_data()

    def jloss(xx, router):
        q = {**jax.tree.map(jnp.asarray, p), "router": router}
        y, met = jffn.moe(q, xx, num_experts=E - 2, top_k=K,
                          deterministic_capacity=SPLIT_CAP)
        wa, wz = SPLIT_WEIGHTS
        return (jnp.sum(y * r) + wa * met["moe_aux_loss"]
                + wz * met["moe_z_loss"]), (y, met)
    (_, (jy, jm)), (jgx, jgr) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jnp.asarray(p["router"]))
    jm = {k: float(v) for k, v in jm.items()}
    assert jm["moe_drop_frac"] > 0.05
    ranks = meshes["data2"]["split_moe"]
    # the buffer's capacity split over the ranks where the rules are given
    assert [e[4] for e in ranks["capacity"]] == [True, True]
    assert not any(e[4] for e in ranks["split"])
    for split in (ranks["split"], ranks["capacity"]):
        y = np.concatenate([e[0] for e in split])
        gx = np.concatenate([e[2] for e in split])
        gr = sum(e[3] for e in split)
        assert _normwise(y, jy) <= 1e-5
        assert _normwise(gx, jgx) <= 1e-5
        assert _normwise(gr, jgr) <= 1e-5
        for e in split:
            for k in ("moe_aux_loss", "moe_z_loss"):
                np.testing.assert_allclose(e[1][k], jm[k], rtol=1e-5,
                                           err_msg=k)
            # the same count of kept choices of the 64 x 2
            assert abs(e[1]["moe_drop_frac"] - jm["moe_drop_frac"]) \
                < 0.5 / (64 * K)
    alone = ranks["alone"]
    assert max(abs(e[1]["moe_aux_loss"] - jm["moe_aux_loss"])
               for e in alone) > 1e-3
    assert max(abs(e[1]["moe_drop_frac"] - jm["moe_drop_frac"])
               for e in alone) > 1e-3


def test_ep_a2a_runs_moe_ep_on_the_model_axis(meshes):
    """Fault B: a train step of ``moe_impl="ep_a2a"`` on a ("data",
    "model") = (1, 2) mesh runs ``moe_ep`` over the ``"model"`` axis, as
    JAX's does under a mesh (``check_ep_step``; ``test_torch_tp`` runs
    the (2, 2) mesh, whose data ranks split the batch)."""
    check_ep_step(meshes["data2"]["ep_step"])


def check_ep_step(ep):
    """``_ep_step``'s step against ``moe_ep`` called with the mesh: the
    loss, aux loss and drop fraction (JAX's ``moe_ep`` ownership: each
    rank routes its batch block's share of the sequence, 8-slot
    capacities, per-chunk statistics averaged) within 1e-5, and the
    gradients within 2^-16 of each leaf's largest entry (Qwen2-MoE's
    float32 bound, ``test_torch_tp``).  The dense ``ffn.moe``, which the
    step ran before, parts from it in the aux loss by more than 1e-4."""
    met, grads, want_met, want, dense_aux = ep
    for k in ("loss", "moe_aux_loss", "moe_z_loss", "moe_drop_frac"):
        np.testing.assert_allclose(met[k], want_met[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert met["moe_drop_frac"] > 0
    assert abs(dense_aux - met["moe_aux_loss"]) > 1e-4
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _normwise(g, w) <= 2.0 ** -16, (i, w.shape,
                                               _normwise(g, w))


# ------------------------------------------------- the kernels' rules
def _kernels_on_mesh(mesh, q, k, v, a, u, h0):
    """On every rank of 2: flash_attention and decay_scan, forward and
    backward, on DTensors sharded as their sharding rules allow
    (attention over batch or heads, the scan over channels), gathered
    whole, with the placements the outputs and gradients came back in."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    m = make_mesh((2,), ("data",), device_type="cpu")
    out = {}
    for name, d in (("batch", 0), ("heads", 1)):
        xs = [distribute_tensor(torch.tensor(x), m, [Shard(d)],
                                src_data_rank=None).requires_grad_(True)
              for x in (q, k, v)]
        o = ops.flash_attention(*xs, causal=True)
        o.sum().backward()
        out[name] = ([o.full_tensor().detach().numpy()]
                     + [x.grad.full_tensor().numpy() for x in xs],
                     [tuple(o.placements)] + [tuple(x.grad.placements)
                                              for x in xs])
    xs = [distribute_tensor(torch.tensor(x), m, [Shard(dim)],
                            src_data_rank=None).requires_grad_(True)
          for x, dim in ((a, 1), (u, 1), (h0, 0))]
    h = ops.decay_scan(*xs)
    (h * h).sum().backward()
    out["scan"] = ([h.full_tensor().detach().numpy()]
                   + [x.grad.full_tensor().numpy() for x in xs],
                   [tuple(h.placements)] + [tuple(x.grad.placements)
                                            for x in xs])
    return out


def test_kernel_ops_take_dtensors():
    """The kernels' ``torch.library`` ops under their DTensor sharding
    rules, on 2 gloo ranks: attention sharded over batch and over heads
    (4 query heads, 2 KV heads), the scan over channels (with h0), forward
    and backward, each the plain single-process result bit for bit (each
    rank computes its own rows, heads or channels whole), and every
    output and gradient sharded as its input was (no collective ran)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (12, 6)).astype(np.float32)
    u = rng.standard_normal((12, 6)).astype(np.float32)
    h0 = rng.standard_normal(6).astype(np.float32)
    got = run_ranks(_kernels_on_mesh, 2, q, k, v, a, u, h0, device="cpu",
                    timeout_s=TIMEOUT_S)[0]

    # the op as a DTensor call runs it (a plain CPU tensor takes
    # ref.chunked_attention instead)
    xs = [torch.tensor(x).requires_grad_(True) for x in (q, k, v)]
    o = ops._FlashAttention.apply(*xs, True, 0, 0.0)
    o.sum().backward()
    want = [o.detach().numpy()] + [x.grad.numpy() for x in xs]
    for name, d in (("batch", 0), ("heads", 1)):
        for g, w in zip(got[name][0], want):
            assert np.array_equal(g, w), name
        assert all(p == (torch.distributed.tensor.Shard(d),)
                   for p in got[name][1]), (name, got[name][1])
    xs = [torch.tensor(x).requires_grad_(True) for x in (a, u, h0)]
    h = ops.decay_scan(*xs)
    (h * h).sum().backward()
    for g, w in zip(got["scan"][0], [h.detach().numpy()]
                    + [x.grad.numpy() for x in xs]):
        assert np.array_equal(g, w)
    Shard = torch.distributed.tensor.Shard
    assert got["scan"][1] == [(Shard(1),), (Shard(1),), (Shard(1),),
                              (Shard(0),)]

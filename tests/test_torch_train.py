"""repro_torch's training half: optimizers, thinned sync, the step, resume
and the CLI, on the CPU, against the JAX package where both compute the
same thing.

Tolerances, with their reasons:

* Optimizer functions on identical float32 trees (JAX layout, a stacked
  group included): 1e-6 normwise per leaf (max |got - want| over max
  |want|): the same op sequence, float32 rounding differing only where
  torch's and XLA's ``sqrt`` / ``pow`` do (by an ulp).
* ``_thin_one`` with the same uniforms: the same kept blocks, values
  within 1e-6 relative.
* Three ``make_train_step`` steps from one carried-over state: each
  step's loss within 1e-4 relative and gradient norm within 1e-3 (the
  gradients agree to ~1e-4 normwise, and the entries that the previous
  update moved by ~lr * sign(g), below, change the next gradient) and lr
  within 1e-6; the parameters' distance from
  JAX's within 1e-3 of the distance they moved (L2 over all leaves).
  AdamW moves a weight by about lr * sign(g), so an entry whose gradient
  is ~0 in both packages (agreeing to 1e-4 normwise, test_torch_grad.py)
  may move in opposite directions: elementwise equality would fail on
  those few entries however right the step is.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs.base import load_smoke_config as jax_smoke  # noqa: E402
from repro.train import compression as jcomp                  # noqa: E402
from repro.train import optim as joptim                       # noqa: E402
from repro.train import trainer as jtrainer                   # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import base                          # noqa: E402
from repro_torch.kernels.threefry import prng_key             # noqa: E402
from repro_torch.launch import train as train_cli             # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map   # noqa: E402
from repro_torch.models.convert import (from_jax_train_state,  # noqa: E402
                                        to_tensor)
from repro_torch.train import compression, optim, trainer     # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's many small ops: under the
    suite's parallel workers torch's thread pool costs more than it
    gives.  The count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def np_tree(seed, scale=1.0):
    """A small parameter-like tree in the JAX layout: a prefix list, a
    stacked group (a [3, 8] norm stack and [3, 8, 5] matrices), a 1-D
    leaf and a 0-d gate."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"embed": {"tok": f(11, 8)},
            "prefix": [{"w": f(8, 6), "b": f(6)}],
            "groups": ({"ln": f(3, 8), "w": f(3, 8, 5), "g": f(3)},),
            "suffix": [],
            "final_norm": f(8)}


def to_torch(tree):
    return tree_map(lambda x: to_tensor(x, "cpu"), tree)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(got, want, tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert normwise(_np(a), b) <= tol


# ------------------------------------------------------------- optimizers
def test_warmup_cosine_matches_jax_and_starts_at_zero():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(optim.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                        **kw))
        want = float(joptim.warmup_cosine(jnp.asarray(s, jnp.int32), **kw))
        assert abs(got - want) <= 1e-6 * 3e-4, s
    assert float(optim.warmup_cosine(torch.tensor(0), **kw)) == 0.0


def test_global_norm_and_clip_match_jax():
    g = np_tree(1, scale=2.0)
    assert abs(float(optim.global_norm(to_torch(g)))
               - float(joptim.global_norm(to_jax(g)))) <= 1e-5
    for max_norm in (1.0, 1e3):
        tg = to_torch(g)
        got, gn = optim.clip_by_global_norm(tg, max_norm)
        want, jn = joptim.clip_by_global_norm(to_jax(g), max_norm)
        assert abs(float(gn) - float(jn)) <= 1e-5
        assert_trees_close(got, want, 1e-6)
        assert got is tg                      # in place


def test_adamw_steps_match_jax():
    params = np_tree(2)
    tm = to_torch(params)
    ts = optim.adamw_init(tm)
    jm, js = to_jax(params), joptim.adamw_init(to_jax(params))
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
    for step in range(4):
        g = np_tree(10 + step, scale=0.1)
        lr = 1e-2 * (step + 1)
        tm, ts = optim.adamw_update(to_torch(g), ts, tm, lr=torch.tensor(lr),
                                    step=torch.tensor(step), **kw)
        jm, js = joptim.adamw_update(to_jax(g), js, jm, lr=jnp.float32(lr),
                                     step=jnp.asarray(step, jnp.int32), **kw)
    assert_trees_close(tm, jm, 1e-6)
    assert_trees_close(ts.mu, js.mu, 1e-6)
    assert_trees_close(ts.nu, js.nu, 1e-6)


def test_adafactor_steps_match_jax_over_stacked_leaves():
    """The stacked [3, 8] norm leaf is factored across its layers and the
    update clip spans the whole stack, as in the reference."""
    params = np_tree(3)
    tp = to_torch(params)
    ts = optim.adafactor_init(tp)
    jp, js = to_jax(params), joptim.adafactor_init(to_jax(params))
    assert tuple(ts.v_row["groups"][0]["ln"].shape) == (3,)
    assert tuple(ts.v_col["groups"][0]["ln"].shape) == (8,)
    for step in range(4):
        g = np_tree(20 + step, scale=0.1)
        tp, ts = optim.adafactor_update(to_torch(g), ts, tp,
                                        lr=torch.tensor(1e-2),
                                        weight_decay=0.1,
                                        step=torch.tensor(step))
        jp, js = joptim.adafactor_update(to_jax(g), js, jp,
                                         lr=jnp.float32(1e-2),
                                         weight_decay=0.1,
                                         step=jnp.asarray(step, jnp.int32))
    assert_trees_close(tp, jp, 1e-6)
    assert_trees_close(ts.v_row, js.v_row, 1e-6)
    assert_trees_close(ts.v_col, js.v_col, 1e-6)


# --------------------------------------------------------- thinned sync
@pytest.mark.parametrize("mode", ["ht", "ef"])
def test_thin_one_matches_jax_with_the_same_uniforms(mode):
    rng = np.random.default_rng(4)
    cfg_t = compression.ThinnedSyncConfig(budget=0.3, alpha=2.0, block=64,
                                          mode=mode)
    cfg_j = jcomp.ThinnedSyncConfig(budget=0.3, alpha=2.0, block=64,
                                    mode=mode)
    g = (rng.normal(size=(37, 50)) * rng.uniform(0.1, 3, (37, 1))
         ).astype(np.float32)
    err = (0.1 * rng.normal(size=g.shape)).astype(np.float32)
    nb = -(-g.size // 64)
    u = rng.random(nb).astype(np.float32)
    s, ne, kept, n = compression._thin_one(torch.tensor(g), torch.tensor(err),
                                           torch.tensor(u), cfg_t)
    js, jne, jkept, jn = jcomp._thin_one(jnp.asarray(g), jnp.asarray(err),
                                         jnp.asarray(u), cfg_j)
    assert int(kept) == int(jkept) and n == jn
    assert 0 < int(kept) < nb
    np.testing.assert_allclose(_np(s), js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ne), jne, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["ht", "ef"])
def test_thin_gradients_tracks_jax(mode):
    """``thin_gradients`` against JAX's on the same tree, error buffers and
    key: the same uniforms (jax 0.9's split and uniform), so the same
    blocks kept, and the same synced values and buffers within 1e-5
    relative (p passes through the blocks' std and the sigmoid, whose
    float32 roundings differ by an ulp or two between torch and XLA, and
    HT's 1/p carries that into the synced values)."""
    cfg = compression.ThinnedSyncConfig(budget=0.3, alpha=1.5, block=64,
                                        mode=mode)
    cfg_j = jcomp.ThinnedSyncConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(70, 33)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32),
         "c": [rng.normal(size=(4, 64)).astype(np.float32) * 3.0]}
    err = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.1).astype(
        np.float32), g)
    tg = jax.tree.map(torch.from_numpy, g)
    st = compression.SyncState(err=jax.tree.map(torch.from_numpy, err))
    for seed in (7,):
        s, ne, met = compression.thin_gradients(tg, st, prng_key(seed), cfg)
        js, jne, jmet = jcomp.thin_gradients(
            jax.tree.map(jnp.asarray, g),
            jcomp.SyncState(err=jax.tree.map(jnp.asarray, err)),
            jax.random.PRNGKey(seed), cfg_j)
        assert float(met["sync_volume_fraction"]) == float(
            jmet["sync_volume_fraction"])
        for a, b in zip(tree_leaves(s) + tree_leaves(ne.err),
                        jax.tree.leaves(js) + jax.tree.leaves(jne.err)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_thinned_sync_unbiased_and_budgeted():
    """The reference test's check on the port: E[synced] ~= g over many
    keys (HT is exactly unbiased per block), and the synced share of
    blocks near the budget."""
    cfg = compression.ThinnedSyncConfig(budget=0.4, alpha=1.0, block=64)
    rng = np.random.default_rng(2)
    g = {"w": torch.tensor(rng.normal(size=(64, 64)), dtype=torch.float32),
         "b": torch.tensor(rng.normal(size=(37,)), dtype=torch.float32)}
    st = compression.init_state(g)
    acc = tree_map(torch.zeros_like, g)
    R = 400
    fracs = []
    for r in range(R):
        s, _, met = compression.thin_gradients(g, st, prng_key(r), cfg)
        acc = tree_map(lambda a, x: a + x / R, acc, s)
        fracs.append(float(met["sync_volume_fraction"]))
    err = float(optim.global_norm(tree_map(lambda a, b: a - b, acc, g))
                / optim.global_norm(g))
    assert err < 0.15, err
    assert 0.25 < np.mean(fracs) < 0.6, np.mean(fracs)


def test_ht_plus_ef_diverges():
    """The documented negative result on the port's ``_thin_one``: feeding
    the HT (expansive) compressor's residual back as error feedback
    explodes the buffer, which is why mode 'ht' returns a zero buffer."""
    cfg = compression.ThinnedSyncConfig(budget=0.3, alpha=0.0, block=32,
                                        mode="ht")
    g = torch.ones(128)
    err = torch.zeros(128)
    gen = torch.Generator().manual_seed(0)
    norms = []
    for _ in range(30):
        g32 = g + err                      # the unsound composition
        s, new_err, _, _ = compression._thin_one(
            g32, torch.zeros(128), torch.rand(4, generator=gen), cfg)
        assert float(new_err.abs().max()) == 0.0
        err = g32 - s
        norms.append(float(torch.linalg.norm(err)))
    assert norms[-1] > 100 * max(norms[0], 1.0), norms[::10]


# ------------------------------------------------------------- the step
def smoke_run(arch="smollm-360m", **tkw):
    """The port's smoke run in float32 (lr 1e-2, warmup 5), as the
    reference's trainer tests use."""
    run = base.load_smoke_config(arch)
    tkw = {"warmup_steps": 5, **tkw}
    tcfg = dataclasses.replace(
        run.train, param_dtype="float32", compute_dtype="float32",
        learning_rate=1e-2, **tkw)
    return dataclasses.replace(run, train=tcfg)


def token_batch(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                   dtype=torch.int32)}


@pytest.mark.parametrize("opt,accum", [("adamw", 1), ("adamw", 2),
                                       ("adafactor", 1)])
def test_loss_decreases(opt, accum):
    run = smoke_run(optimizer=opt, grad_accum=accum,
                    master_weights=(opt == "adamw"))
    state = trainer.init_train_state(run, torch.Generator().manual_seed(0),
                                     device="cpu")
    step = trainer.make_train_step(run, total_steps=100)
    batch = token_batch(run.model, 0)   # overfit one batch
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    assert int(state.step) == 30


def test_straggler_reweighted_accum_unbiased(monkeypatch):
    """Dropping microbatches with the HT weight keeps the expected
    gradient: over the four masks that drop one of four microbatches, the
    mean accumulated gradient equals the full-participation one."""
    run = smoke_run(grad_accum=4)
    seen = []
    clip = optim.clip_by_global_norm
    monkeypatch.setattr(optim, "clip_by_global_norm",
                        lambda g, n: (seen.append([x.clone() for x in
                                                   tree_leaves(g)]),
                                      clip(g, n))[1])
    batch = token_batch(run.model, 1, B=8)
    step = trainer.make_train_step(run, total_steps=100)
    for mask in [[True] * 4] + [[j != i for j in range(4)]
                                for i in range(4)]:
        state = trainer.init_train_state(
            run, torch.Generator().manual_seed(0), device="cpu")
        _, m = step(state, batch, micro_keep=torch.tensor(mask))
        assert np.isfinite(float(m["grad_norm"]))
    full, masked = seen[0], seen[1:]
    for i, g in enumerate(full):
        mean = sum(ms[i] for ms in masked) / 4
        assert float((mean - g).abs().max()) <= 1e-5 * max(
            float(g.abs().max()), 1e-6)


def jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


# a bfloat16 gradient accumulator (Adafactor without master weights, as in
# Kimi-K2's train=): the roundings the port makes that XLA, keeping excess
# precision through bf16 casts, may skip; each at most 2^-9 relative
# (bfloat16 keeps 8 fraction bits, rounding to nearest).  With n
# micro-batches the port rounds each product w * g and each partial sum
# (2 n), and clip_by_global_norm's scale and product (2): the gradient
# handed to the optimizer differs from XLA's by at most (2 n + 2) 2^-9
# relative, normwise while the micro-batch gradients do not cancel (they
# are gradients of one model on like batches).  That bounds the grad norm.
# (The port now rounds where XLA's compiled step does: the accumulation
# rounds w * g and each sum as XLA does, and the clip's product stays
# float32 inside Adafactor, optim.adafactor_update; the bound is the same.)
# Adafactor's update u = g / sqrt(v_hat), with v_hat a mean of g^2, then
# clipped by RMS(u): the errors of g and of sqrt(v_hat) add, so a step's
# update differs by at most twice that, normwise.
def bf16_acc_bounds(n_micro):
    grad = (2 * n_micro + 2) * 2.0 ** -9
    return grad, 2 * grad


# the chained gap that the xfail case below records (from its own run: the
# parameters' distance from JAX over the distance they moved, after 3
# steps).  Each step alone tracks JAX
# (test_ht_sync_with_stragglers_step_tracks_jax); JAX against itself, with
# step 1's parameters moved by the port's one-step gap in a random
# direction, parts by more than the bound too
# (test_chained_gap_is_jax_own_sensitivity).  The one-step gap is the
# kept micro-batch's gradient (1.3e-5 of its largest entry, in the
# attention's q/k weights and the embedding, where the two packages'
# float32 backward passes sum in different orders); the sync keeps the
# same blocks and, on the same gradients, agrees to 5e-7.
HT_2WAY_GAP = ("HT sync on a 2-way accumulation with a straggler mask, 3 "
               "chained steps: the parameters part by 1.8e-3 of their move "
               "(bound 1e-3; without the sync 6.2e-5), the CPU attention in "
               "JAX's chunked order too; step 1 alone agrees to 2.2e-5 of "
               "its update, and JAX moved by that gap parts from itself by "
               "1.0e-3 to 2.0e-3")


def _three_steps_cases():
    return [
        pytest.param("smollm-360m", "adamw", 2, (True, False), None, True,
                     id="smollm-360m-adamw-2-keep0"),
        pytest.param("smollm-360m", "adafactor", 1, None, None, True,
                     id="smollm-360m-adafactor-1-None"),
        pytest.param("qwen2-moe-a2.7b", "adamw", 2, (True, True), None,
                     True, id="qwen2-moe-a2.7b-adamw-2-keep2"),
        pytest.param("smollm-360m", "adamw", 1, None, "ht", True,
                     id="smollm-360m-adamw-1-sync_ht"),
        pytest.param("smollm-360m", "adamw", 2, (True, False), "ht", True,
                     id="smollm-360m-adamw-2-keep0-sync_ht",
                     marks=pytest.mark.xfail(strict=True,
                                             reason=HT_2WAY_GAP)),
        pytest.param("smollm-360m", "adamw", 1, None, "ef", True,
                     id="smollm-360m-adamw-1-sync_ef"),
        pytest.param("smollm-360m", "adafactor", 2, None, None, False,
                     id="smollm-360m-adafactor-2-bf16_acc"),
    ]


def _sync_mode(monkeypatch, mode):
    """Both trainers build ``ThinnedSyncConfig(budget=, alpha=)`` with the
    default mode 'ht'; run them in ``mode`` instead."""
    for mod in (compression, jcomp):
        monkeypatch.setattr(mod, "ThinnedSyncConfig", functools.partial(
            mod.ThinnedSyncConfig, mode=mode))


def _both_runs(arch, opt, accum, master, sync, monkeypatch):
    """The port's smoke run and JAX's with the same train fields."""
    if sync:
        _sync_mode(monkeypatch, sync)
    run = smoke_run(arch, optimizer=opt, grad_accum=accum,
                    master_weights=master, warmup_steps=1,
                    thinned_sync=sync is not None)
    jrun = jax_smoke(arch)
    jrun = dataclasses.replace(jrun, train=dataclasses.replace(
        jrun.train, **dataclasses.asdict(run.train)))
    return run, jrun


def _l2(tree) -> float:
    return float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2.0)
                             for x in tree)))


def _l2_gap(got, want) -> float:
    """L2 of got - want over all leaves, over L2 of want."""
    return _l2([np.asarray(a, np.float64) - b
                for a, b in zip(got, want)]) / _l2(want)


def _chained(run, jrun, keep):
    """Three steps of each package on the same batches from one
    JAX-initialised state carried over, each package chaining its own
    states.  Returns each step's metrics as (port, JAX) pairs, both step
    counts after, and the parameters' L2 distance from JAX's over the
    distance JAX's moved."""
    jstate = jtrainer.init_train_state(jrun, jax.random.PRNGKey(0))
    init = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    state = from_jax_train_state(run, jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
    step = trainer.make_train_step(run, total_steps=20)
    mask = None if keep is None else torch.tensor(keep)
    metrics = []
    for i in range(3):
        batch = token_batch(run.model, 100 + i)
        state, m = step(state, batch, prng_key(i), micro_keep=mask)
        jstate, jm = jstep(jstate, jax_batch(batch), jax.random.PRNGKey(i),
                           None if keep is None else jnp.asarray(keep))
        metrics.append({k: (float(m[k]), float(jm[k])) for k in jm
                        if k in m})
    got = [_np(p) for p in tree_leaves(state.params)]
    want = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    moved = _l2([b - a for a, b in zip(init, want)])
    return (metrics, (int(state.step), int(jstate.step)),
            _l2([a - b for a, b in zip(got, want)]) / moved)


@pytest.mark.parametrize("arch,opt,accum,keep,sync,master",
                         _three_steps_cases())
def test_three_steps_track_jax(arch, opt, accum, keep, sync, master,
                               monkeypatch):
    """From one JAX-initialised state carried over, three steps of each
    package on the same batches (a straggler mask on a 2-way
    accumulation): losses, grad norms and lr agree, and the parameters
    stay within 1e-3 of the distance they moved (module docstring).  With
    the thinned sync (HT and error-feedback modes) both draw their
    uniforms from step i's key (``prng_key(i)``, JAX's ``PRNGKey(i)``), so
    they keep the same blocks and the same bounds hold.  Where the
    accumulator is float32 (``master_weights=True``, which Adafactor reads
    only for that) these are the bounds; the bfloat16 accumulator's case
    is held at ``bf16_acc_bounds`` (derived above).  One case fails its
    bound by the gap its xfail reason gives."""
    run, jrun = _both_runs(arch, opt, accum, master, sync, monkeypatch)
    g_rtol, p_rtol = (1e-3, 1e-3) if master else bf16_acc_bounds(accum)
    metrics, steps, parted = _chained(run, jrun, keep)
    for m in metrics:
        for k, rtol in (("loss", 1e-4), ("grad_norm", g_rtol), ("lr", 1e-6)):
            np.testing.assert_allclose(*m[k], rtol=rtol, atol=1e-9,
                                       err_msg=k)
        if sync:
            got, want = m["sync_volume_fraction"]
            assert got == want
    assert steps == (3, 3)
    assert 0 < parted <= p_rtol, parted


def _each_step(run, jrun, keep):
    """Three steps, each started in both packages from JAX's state before
    it, so that what is held is the step itself.  Returns, for each step,
    the (port, JAX) loss and grad norm, both step counts, the port's
    update's L2 gap from JAX's over the size of JAX's (None at step 0,
    whose lr is 0), and each optimizer-moment field's L2 gap (None where
    the leaves' shapes differ)."""
    jstate = jtrainer.init_train_state(jrun, jax.random.PRNGKey(0))
    jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
    step = trainer.make_train_step(run, total_steps=20)
    mask = None if keep is None else torch.tensor(keep)
    out = []
    for i in range(3):
        batch = token_batch(run.model, 100 + i)
        before = [np.asarray(x).copy() for x in jax.tree.leaves(jstate.params)]
        state = from_jax_train_state(run, jax.tree.map(np.asarray, jstate),
                                     device="cpu")
        state, m = step(state, batch, prng_key(i), micro_keep=mask)
        jstate, jm = jstep(jstate, jax_batch(batch), jax.random.PRNGKey(i),
                           None if keep is None else jnp.asarray(keep))
        got = [_np(p) - b for p, b in zip(tree_leaves(state.params), before)]
        want = [np.asarray(x) - b
                for x, b in zip(jax.tree.leaves(jstate.params), before)]
        moments = {}
        for name, want_v in jstate.opt._asdict().items():
            got_v = [_np(x) for x in tree_leaves(getattr(state.opt, name))]
            want_v = [np.asarray(x) for x in jax.tree.leaves(want_v)]
            same = [a.shape for a in got_v] == [b.shape for b in want_v]
            moments[name] = _l2_gap(got_v, want_v) if same else None
        out.append({k: (float(m[k]), float(jm[k]))
                    for k in ("loss", "grad_norm")} |
                   {"steps": (int(state.step), int(jstate.step)),
                    "update": _l2_gap(got, want) if i else None,
                    "moments": moments})
    return out


def _assert_each_step(records, g_rtol, u_rtol, v_rtol):
    for i, r in enumerate(records):
        np.testing.assert_allclose(*r["loss"], rtol=1e-4)
        np.testing.assert_allclose(*r["grad_norm"], rtol=g_rtol)
        assert r["steps"] == (i + 1, i + 1)
        assert i == 0 or r["update"] <= u_rtol, (i, r["update"])
        for name, gap in r["moments"].items():
            assert gap is not None and gap <= v_rtol, (i, name, gap)


@pytest.mark.parametrize("accum", [2])
def test_bf16_accumulator_step_tracks_jax(accum, monkeypatch):
    """The bfloat16 accumulator (Adafactor without master weights, as in
    Kimi-K2's train=), one step at a time from JAX's state, at
    ``bf16_acc_bounds`` (derived above): the loss within 1e-4 (computed
    before any bfloat16 rounding), the grad norm within (2 n + 2) 2^-9,
    the parameter update within twice that of JAX's update, L2 over all
    leaves, and the factored second moments the step writes within twice
    the grad norm's bound: v_row and v_col are means of g^2 (each
    element's error doubles when squared) added to the carried moments,
    which both packages start from alike."""
    run, jrun = _both_runs("smollm-360m", "adafactor", accum, False, None,
                           monkeypatch)
    g_rtol, u_rtol = bf16_acc_bounds(accum)
    _assert_each_step(_each_step(run, jrun, None), g_rtol, u_rtol,
                      2 * g_rtol)


def test_ht_sync_with_stragglers_step_tracks_jax(monkeypatch):
    """The HT thinned sync on a 2-way accumulation with a straggler mask
    (HT's 1/p on top of the straggler reweighting), one step at a time
    from JAX's state, at the three-step test's float32 bounds: the loss
    within 1e-4, the grad norm within 1e-3, the update within 1e-3 of
    JAX's, and AdamW's moments within 2e-3 (nu is a sum of g^2, whose
    error doubles)."""
    run, jrun = _both_runs("smollm-360m", "adamw", 2, True, "ht",
                           monkeypatch)
    _assert_each_step(_each_step(run, jrun, (True, False)), 1e-3, 1e-3,
                      2e-3)


# the two chained cases that parted from JAX (the bf16 accumulator's is
# repaired), as (opt, accum, master, sync, keep) of _both_runs and _chained
GAP_CASES = {"bf16_acc": ("adafactor", 2, False, None, None),
             "sync_ht_2way": ("adamw", 2, True, "ht", (True, False))}


def _jax_parted(run, jrun, keep, gap, seeds=(0, 1, 2)):
    """JAX's own three chained steps, with step 1's parameters moved by
    ``gap`` of its update in a seeded random direction, against JAX's
    unmoved run: the parameters' L2 distance over the distance they
    moved, one a seed."""
    jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
    jkeep = None if keep is None else jnp.asarray(keep)

    def chain(seed):
        jstate = jtrainer.init_train_state(jrun, jax.random.PRNGKey(0))
        init = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
        for i in range(3):
            before = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
            jstate, _ = jstep(jstate, jax_batch(token_batch(run.model,
                                                            100 + i)),
                              jax.random.PRNGKey(i), jkeep)
            if i == 1 and seed is not None:
                after = [np.asarray(x) for x in
                         jax.tree.leaves(jstate.params)]
                size = _l2([a - b for a, b in zip(after, before)])
                rng = np.random.default_rng(seed)
                d = [rng.standard_normal(a.shape) for a in after]
                scale = gap * size / _l2(d)
                moved = [jnp.asarray((a + scale * x).astype(a.dtype))
                         for a, x in zip(after, d)]
                jstate = jstate._replace(params=jax.tree.unflatten(
                    jax.tree.structure(jstate.params), moved))
        return init, [np.asarray(x) for x in jax.tree.leaves(jstate.params)]

    init, base = chain(None)
    moved = _l2([b - a for a, b in zip(init, base)])
    return [_l2([a - b for a, b in zip(chain(s)[1], base)]) / moved
            for s in seeds]


@pytest.mark.parametrize("case", list(GAP_CASES))
def test_chained_gap_is_jax_own_sensitivity(case, monkeypatch):
    """The witness that the chain amplifies what one step leaves.  The
    port's step 1, from JAX's state, differs from JAX's update by a gap g
    (inside its bound); JAX's own three steps, with step 1's parameters
    moved by g of its update in each of three seeded random directions,
    part from JAX's unmoved run by more than g, on average.  For the case
    that still fails its three-step bound (the HT sync's xfail), they part
    by more than that bound too: the bound cannot hold a chained run at
    that g.  The bf16 accumulator's gap shrank from 1.5e-3 to 1.8e-4 once
    the port rounded where XLA does (``optim.adafactor_update``): JAX
    moved by that g stays inside the three-step bound, as the port's
    chained case now does."""
    opt, accum, master, sync, keep = GAP_CASES[case]
    run, jrun = _both_runs("smollm-360m", opt, accum, master, sync,
                           monkeypatch)
    p_rtol = 1e-3 if master else bf16_acc_bounds(accum)[1]
    gap = _each_step(run, jrun, keep)[1]["update"]
    assert 0 < gap <= p_rtol
    parted = _jax_parted(run, jrun, keep, gap)
    assert np.mean(parted) > gap, (gap, parted)
    if case == "sync_ht_2way":
        assert np.mean(parted) > p_rtol, (gap, parted)
    else:
        assert np.mean(parted) <= p_rtol, (gap, parted)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """bfloat16 params with a float32 master copy, 2-way accumulation and
    the thinned sync (its state, and step i's key ``prng_key(i)`` as the
    CLI passes it): three steps straight through, against two steps, a
    checkpoint, a restore into a fresh state and the third step;
    bitwise."""
    run = smoke_run("recurrentgemma-2b", grad_accum=2, thinned_sync=True)
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, param_dtype="bfloat16"))
    batches = [token_batch(run.model, 200 + i) for i in range(3)]
    step = trainer.make_train_step(run, total_steps=20)

    def fresh():
        return trainer.init_train_state(
            run, torch.Generator().manual_seed(0), device="cpu")

    state = fresh()
    assert state.master is not None and state.sync is not None
    assert state.params["embed"]["tok"].dtype == torch.bfloat16
    for i, b in enumerate(batches):
        state, m = step(state, b, prng_key(i))
    straight = [_np(x.float()) for x in tree_leaves(state)]

    state = fresh()
    mgr = CheckpointManager(str(tmp_path), async_io=False)
    for i, b in enumerate(batches[:2]):
        state, _ = step(state, b, prng_key(i))
    mgr.save(2, state)
    del state
    restored = trainer.restore_train_state(mgr, fresh())
    assert int(restored.step) == 2
    assert all(p.requires_grad for p in tree_leaves(restored.params))
    restored, m2 = step(restored, batches[2], prng_key(int(restored.step)))
    resumed = [_np(x.float()) for x in tree_leaves(restored)]
    assert float(m2["loss"]) == float(m["loss"])
    assert len(straight) == len(resumed)
    for a, b in zip(straight, resumed):
        assert np.array_equal(a, b)


def test_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    loss = train_cli.main(args + ["--steps", "4"])
    assert np.isfinite(loss)
    loss2 = train_cli.main(args + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "tok/s=" in out
    assert np.isfinite(loss2)
    assert CheckpointManager(str(tmp_path)).latest_step() == 6

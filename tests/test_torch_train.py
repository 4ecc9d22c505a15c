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


def test_thinned_sync_unbiased_and_budgeted():
    """The reference test's check on the port: E[synced] ~= g over many
    generators (HT is exactly unbiased per block), and the synced share of
    blocks near the budget."""
    cfg = compression.ThinnedSyncConfig(budget=0.4, alpha=1.0, block=64)
    rng = np.random.default_rng(2)
    g = {"w": torch.tensor(rng.normal(size=(64, 64)), dtype=torch.float32),
         "b": torch.tensor(rng.normal(size=(37,)), dtype=torch.float32)}
    st = compression.init_state(g)
    acc = tree_map(torch.zeros_like, g)
    R = 400
    gen = torch.Generator().manual_seed(0)
    fracs = []
    for _ in range(R):
        s, _, met = compression.thin_gradients(g, st, gen, cfg)
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


@pytest.mark.parametrize("arch,opt,accum,keep", [
    ("smollm-360m", "adamw", 2, (True, False)),
    ("smollm-360m", "adafactor", 1, None),
    ("qwen2-moe-a2.7b", "adamw", 2, (True, True))])
def test_three_steps_track_jax(arch, opt, accum, keep):
    """From one JAX-initialised state carried over, three steps of each
    package on the same batches (a straggler mask on a 2-way
    accumulation): losses, grad norms and lr agree, and the parameters
    stay within 1e-3 of the distance they moved (module docstring).  The
    accumulator is float32 (``master_weights=True``, which Adafactor reads
    only for that): with a bfloat16 one, XLA's fused step keeps excess
    precision through the bfloat16 casts, so the two packages round the
    accumulated gradients differently by design (that path trains in
    ``test_loss_decreases[adafactor-1]``)."""
    run = smoke_run(arch, optimizer=opt, grad_accum=accum,
                    master_weights=True, warmup_steps=1)
    jrun = jax_smoke(arch)
    jrun = dataclasses.replace(jrun, train=dataclasses.replace(
        jrun.train, **dataclasses.asdict(run.train)))
    jstate = jtrainer.init_train_state(jrun, jax.random.PRNGKey(0))
    init = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    state = from_jax_train_state(run, jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(jrun, total_steps=20))
    step = trainer.make_train_step(run, total_steps=20)
    mask = None if keep is None else torch.tensor(keep)
    for i in range(3):
        batch = token_batch(run.model, 100 + i)
        state, m = step(state, batch, micro_keep=mask)
        args = (jstate, jax_batch(batch), jax.random.PRNGKey(i))
        jstate, jm = jstep(*args, None if keep is None else
                           jnp.asarray(keep))
        for k, rtol in (("loss", 1e-4), ("grad_norm", 1e-3), ("lr", 1e-6)):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-9, err_msg=k)
    assert int(state.step) == int(jstate.step) == 3
    got = [_np(p) for p in tree_leaves(state.params)]
    want = [np.asarray(x) for x in jax.tree.leaves(jstate.params)]
    dist = np.sqrt(sum(np.sum((a - b) ** 2.0) for a, b in zip(got, want)))
    moved = np.sqrt(sum(np.sum((b - a) ** 2.0) for a, b in zip(init, want)))
    assert moved > 0 and dist <= 1e-3 * moved, (dist, moved)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """bfloat16 params with a float32 master copy, 2-way accumulation and
    the thinned sync (its state and its generator): three steps straight
    through, against two steps, a checkpoint, a restore into a fresh
    state and the third step; bitwise."""
    run = smoke_run("recurrentgemma-2b", grad_accum=2, thinned_sync=True)
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, param_dtype="bfloat16"))
    batches = [token_batch(run.model, 200 + i) for i in range(3)]
    step = trainer.make_train_step(run, total_steps=20)

    def fresh():
        return trainer.init_train_state(
            run, torch.Generator().manual_seed(0), device="cpu")

    gen = torch.Generator().manual_seed(5)
    state = fresh()
    assert state.master is not None and state.sync is not None
    assert state.params["embed"]["tok"].dtype == torch.bfloat16
    for b in batches:
        state, m = step(state, b, gen)
    straight = [_np(x.float()) for x in tree_leaves(state)]

    gen = torch.Generator().manual_seed(5)
    state = fresh()
    mgr = CheckpointManager(str(tmp_path), async_io=False)
    for b in batches[:2]:
        state, _ = step(state, b, gen)
    mgr.save(2, state, extra={"gen": gen.get_state().tolist()})
    del state
    restored = trainer.restore_train_state(mgr, fresh())
    assert int(restored.step) == 2
    assert all(p.requires_grad for p in tree_leaves(restored.params))
    gen2 = torch.Generator()
    gen2.set_state(torch.tensor(mgr.restore_manifest(2)["extra"]["gen"],
                                dtype=torch.uint8))
    restored, m2 = step(restored, batches[2], gen2)
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

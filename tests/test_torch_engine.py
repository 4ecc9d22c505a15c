"""repro_torch's engine and block driver against the JAX engine.

Exact mode is held bitwise to JAX (z, p, lam_hat and the final state; the
features to 1 ulp, the reference's own bound across its two schedules).
Fast mode takes bitwise-equal decisions from a shared state; its segment
fold decays with ``torch.exp`` and sums in another order, so its state is
held to a relative tolerance.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro_torch.core import (EngineConfig, Event, init_state,  # noqa: E402
                              make_step, materialize_features, run_stream,
                              state_from_numpy, state_to_numpy)

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
N_KEYS, BATCH = 32, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stream(n_events=600, n_keys=N_KEYS, seed=0, skew=1.1):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _max_per_key_per_batch(keys, batch):
    return max(int(np.bincount(keys[i:i + batch]).max())
               for i in range(0, len(keys), batch))


def _cfg_kw(policy, keys):
    # exact_rounds covers the stream's busiest key per batch: exact mode
    # drops a key's events beyond it, in both packages
    return dict(taus=(60.0, 3600.0), h=600.0, budget=0.002, alpha=1.0,
                policy=policy, fixed_rate=0.3, mu_tau_index=1,
                exact_rounds=_max_per_key_per_batch(keys, BATCH))


def _bitwise(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=name)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("impl", ["compact", "masked"])
@pytest.mark.parametrize("policy", POLICIES)
def test_exact_mode_bitwise_vs_jax(impl, policy):
    keys, qs, ts = _stream()
    kw = _cfg_kw(policy, keys)
    key = jax.random.PRNGKey(7)
    js, ji = jcore.run_stream(jcore.EngineConfig(**kw),
                              jcore.init_state(N_KEYS, 2), keys, qs, ts,
                              batch=BATCH, mode="exact", rng=key,
                              exact_impl=impl)
    ts_, ti = run_stream(EngineConfig(**kw), init_state(N_KEYS, 2,
                                                        device="cpu"),
                         keys, qs, ts, batch=BATCH, mode="exact",
                         rng=np.asarray(key), exact_impl=impl)
    for f in ("z", "p", "lam_hat"):
        _bitwise(_np(getattr(ti, f)), getattr(ji, f), f)
    np.testing.assert_array_max_ulp(_np(ti.features), np.asarray(ji.features),
                                    maxulp=1)
    assert int(ti.writes) == int(ji.writes) > 0
    for f in js._fields:
        _bitwise(_np(getattr(ts_, f)), getattr(js, f), f)


def _warm_pair(policy, keys, qs, ts, n_warm):
    """A JAX exact-mode state after ``n_warm`` events, and its port copy."""
    kw = _cfg_kw(policy, keys)
    js, _ = jcore.run_stream(jcore.EngineConfig(**kw),
                             jcore.init_state(N_KEYS, 2), keys[:n_warm],
                             qs[:n_warm], ts[:n_warm], batch=BATCH,
                             mode="exact", rng=jax.random.PRNGKey(3))
    host = [np.asarray(x) for x in js]
    return kw, js, state_from_numpy(*host, device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_fast_step_from_shared_state(policy):
    """One fast block from a shared warm state: decisions and features
    bitwise; the folded state within rtol 1e-6.

    The JAX step runs op by op here (its ``thinning_rmw`` is jitted on its
    own, the context the reference's numerics contract is defined in).
    Compiled as one program, XLA re-rounds JAX's decision math: p and
    lam_hat then move by 1 ulp on some lanes (ROADMAP.md queue 3).
    """
    keys, qs, ts = _stream()
    kw, js, st = _warm_pair(policy, keys, qs, ts, 384)
    sl = slice(384, 384 + BATCH)
    valid = np.ones(BATCH, bool)
    valid[-5:] = False                              # a padded tail
    key = jax.random.PRNGKey(11)
    js, ji = jcore.make_step(jcore.EngineConfig(**kw), "fast")(
        js, jcore.Event(key=jnp.asarray(keys[sl]), q=jnp.asarray(qs[sl]),
                        t=jnp.asarray(ts[sl]), valid=jnp.asarray(valid)),
        key)
    st, ti = make_step(EngineConfig(**kw), "fast")(
        st, Event(key=torch.from_numpy(keys[sl]), q=torch.from_numpy(qs[sl]),
                  t=torch.from_numpy(ts[sl]), valid=torch.from_numpy(valid)),
        np.asarray(key))
    for f in ("z", "p", "lam_hat", "features"):
        _bitwise(_np(getattr(ti, f)), getattr(ji, f), f)
    for f in js._fields:
        np.testing.assert_allclose(_np(getattr(st, f)), np.asarray(
            getattr(js, f)), rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("policy", POLICIES)
def test_fast_run_stream_state_within_tolerance(policy):
    """Multi-block fast mode: the fold's rounding differences carry from
    block to block, so the state is held to rtol 1e-5 (measured: <= 3e-7
    on this stream; p likewise) and the decisions agree on every event
    (measured)."""
    keys, qs, ts = _stream()
    kw = _cfg_kw(policy, keys)
    key = jax.random.PRNGKey(7)
    js, ji = jcore.run_stream(jcore.EngineConfig(**kw),
                              jcore.init_state(N_KEYS, 2), keys, qs, ts,
                              batch=BATCH, mode="fast", rng=key)
    st, ti = run_stream(EngineConfig(**kw), init_state(N_KEYS, 2,
                                                       device="cpu"),
                        keys, qs, ts, batch=BATCH, mode="fast",
                        rng=np.asarray(key))
    np.testing.assert_array_equal(_np(ti.z), np.asarray(ji.z))
    np.testing.assert_allclose(_np(ti.p), np.asarray(ji.p), rtol=1e-5)
    for f in js._fields:
        np.testing.assert_allclose(_np(getattr(st, f)), np.asarray(
            getattr(js, f)), rtol=1e-5, atol=0, err_msg=f)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_run_stream_matches_per_batch_loop(mode):
    """The block driver is a pure driver change: same final state and same
    per-event info as a per-batch step loop, padded tail included."""
    rng = np.random.default_rng(3)
    n_events, n_entities, batch = 200, 16, 64      # 200 % 64 != 0
    keys = rng.integers(0, n_entities, n_events).astype(np.int32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1e4, n_events)).astype(np.float32)
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.05,
                       policy="pp", exact_rounds=32)
    root = np.asarray(jax.random.PRNGKey(5))
    step = make_step(cfg, mode)
    state_l = init_state(n_entities, 2, device="cpu")
    zs, ps = [], []
    for i in range(0, n_events, batch):
        j = min(i + batch, n_events)
        pad = batch - (j - i)
        ev = Event(*(torch.from_numpy(np.pad(x[i:j], (0, pad))) for x in
                     (keys, qs, ts, np.ones(n_events, bool))))
        state_l, info = step(state_l, ev, root)
        zs.append(info.z[:j - i])
        ps.append(info.p[:j - i])
    state_s, info_s = run_stream(cfg, init_state(n_entities, 2,
                                                 device="cpu"),
                                 keys, qs, ts, batch=batch, mode=mode,
                                 rng=root)
    assert torch.equal(info_s.z, torch.cat(zs))
    assert torch.equal(info_s.p, torch.cat(ps))
    assert int(info_s.writes) == int(torch.cat(zs).sum())
    for a, b, name in zip(state_l, state_s, state_l._fields):
        assert torch.equal(a, b), name


def test_state_carried_across_from_jax():
    """JAX runs the first half of a stream, its state is carried across,
    the port runs the second half: the result is JAX's whole-stream run,
    bitwise."""
    keys, qs, ts = _stream()
    kw = _cfg_kw("pp_vr", keys)
    key = jax.random.PRNGKey(7)
    half = 3 * BATCH                   # block boundaries line up
    whole, info = jcore.run_stream(jcore.EngineConfig(**kw),
                                   jcore.init_state(N_KEYS, 2), keys, qs,
                                   ts, batch=BATCH, mode="exact", rng=key)
    first, _ = jcore.run_stream(jcore.EngineConfig(**kw),
                                jcore.init_state(N_KEYS, 2), keys[:half],
                                qs[:half], ts[:half], batch=BATCH,
                                mode="exact", rng=key)
    st = state_from_numpy(*(np.asarray(x) for x in first), device="cpu")
    st, ti = run_stream(EngineConfig(**kw), st, keys[half:], qs[half:],
                        ts[half:], batch=BATCH, mode="exact",
                        rng=np.asarray(key))
    _bitwise(_np(ti.z), np.asarray(info.z)[half:], "z")
    for got, want, f in zip(state_to_numpy(st), whole, whole._fields):
        _bitwise(got, want, f)


def test_materialize_features_matches_jax():
    keys, qs, ts = _stream()
    kw, js, st = _warm_pair("pp", keys, qs, ts, 600)
    rows = np.arange(N_KEYS, dtype=np.int32)
    t = np.full(N_KEYS, ts[-1] + 100.0, np.float32)
    want = jcore.materialize_features(js, jnp.asarray(rows), jnp.asarray(t),
                                      kw["taus"])
    got = materialize_features(st, torch.from_numpy(rows).long(),
                               torch.from_numpy(t), kw["taus"])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def test_entry_points_default_to_the_card():
    """Without a device, entry points run on cuda:0 — or raise when there
    is no GPU; they never carry on silently on the CPU."""
    if torch.cuda.is_available():
        assert init_state(8, 2).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(8, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            state_from_numpy(np.zeros(8), np.zeros(8), np.zeros((8, 2, 3)),
                             np.zeros(8), np.zeros(8))
    assert init_state(8, 2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("collect_info", [True, False])
def test_run_stream_empty_stream(collect_info):
    empty = np.zeros(0, np.float32)
    st, out = run_stream(EngineConfig(taus=(60.0, 3600.0)),
                         init_state(4, 2, device="cpu"),
                         empty.astype(np.int32), empty, empty, batch=8,
                         collect_info=collect_info)
    if collect_info:
        assert out.z.shape == (0,) and out.features.shape == (0, 8)
        assert int(out.writes) == 0
    else:
        assert out.shape == (0,)
    assert bool(torch.isinf(st.last_t).all())


@pytest.mark.parametrize("option", [{"residency": 8},
                                    {"pipeline_depth": 2}])
def test_unported_driver_options_raise(option):
    keys, qs, ts = _stream(n_events=64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_stream(EngineConfig(taus=(60.0,)), init_state(N_KEYS, 1,
                                                          device="cpu"),
                   keys, qs, ts, batch=32, **option)


def test_import_hygiene():
    """The port imports neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15      # every module was imported

"""repro_torch's scoring tier against the JAX package: the per-event
worker, the feature engine on one card and the scoring pipeline.

Bounds, with their reasons:

* Worker and sink bytes are exact: the worker runs the rows entry of the
  same fused kernel at B = 1, the sink the keyed entry, and both equal the
  JAX package's worker bytes (exact mode, five policies).
* The engine's exact-mode decisions and stored bytes are bitwise those of
  the JAX engine, its features within 1 ulp (the reference's own bound).
* Scores are held to rtol 1e-5, atol 1e-6 against the JAX scorer on the
  same features and weights (``scorer_from_jax``): ``log1p``, ``sign`` and
  the two float32 products may round differently from XLA on the CPU.
* Restart: recovered scores equal live scores bitwise — both come from
  the same calls on bitwise-equal inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.features.engine import \
    ShardedFeatureEngine as JaxEngine                        # noqa: E402
from repro.features.spec import ProfileSpec as JaxSpec       # noqa: E402
from repro.serving import pipeline as jpipe                  # noqa: E402
from repro.streaming.kvstore import KVStore as JaxKV         # noqa: E402
from repro.streaming.worker import FeatureWorker as JaxWorker  # noqa: E402
from repro_torch.core import EngineConfig, init_state, run_stream  # noqa: E402
from repro_torch.core.reference import ReferenceEngine       # noqa: E402
from repro_torch.features.engine import ShardedFeatureEngine  # noqa: E402
from repro_torch.features.spec import ProfileSpec            # noqa: E402
from repro_torch.serving import pipeline                     # noqa: E402
from repro_torch.streaming import workload                   # noqa: E402
from repro_torch.streaming.kvstore import KVStore, partition_of  # noqa: E402
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.worker import FeatureWorker       # noqa: E402

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
N_KEYS = 48
KEY = jax.random.PRNGKey(7)
ROOT = np.asarray(KEY)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


def _stream(n_events=480, n_keys=N_KEYS, seed=0, skew=1.1):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _kw(policy, keys, batch):
    rounds = max(int(np.bincount(keys[i:i + batch]).max())
                 for i in range(0, len(keys), batch))
    return dict(taus=(60.0, 3600.0), h=600.0, budget=0.002, alpha=1.0,
                policy=policy, fixed_rate=0.3, mu_tau_index=1,
                exact_rounds=rounds)


def _contents(stores):
    merged = {}
    for s in stores:
        merged.update(s.data)
    return merged


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------ worker
@pytest.mark.parametrize("policy", POLICIES)
def test_worker_bytes_equal_sink_and_jax_worker(policy):
    """Port worker bytes == port sink bytes == JAX worker bytes."""
    keys, qs, ts = _stream(n_events=300)
    kw = _kw(policy, keys, 64)
    cfg, n_parts = EngineConfig(**kw), 3
    sink = WriteBehindSink(cfg, n_partitions=n_parts, device="cpu")
    _, info = run_stream(cfg, init_state(N_KEYS, 2, device="cpu"), keys, qs,
                         ts, batch=64, mode="exact", rng=ROOT, sink=sink)
    sink.flush()
    stores = [KVStore(seed=i) for i in range(n_parts)]
    workers = [FeatureWorker(cfg, stores[i], rng=ROOT, device="cpu")
               for i in range(n_parts)]
    jstores = [JaxKV(seed=i) for i in range(n_parts)]
    jworkers = [JaxWorker(jcore.EngineConfig(**kw), jstores[i], rng=KEY)
                for i in range(n_parts)]
    for k, q, t in zip(keys.tolist(), qs.tolist(), ts.tolist()):
        p = partition_of(k, n_parts)
        got = workers[p].process(k, q, t)
        want = jworkers[p].process(k, q, t)
        assert got["z"] == want["z"] and got["p"] == want["p"]
        assert got["lam"] == want["lam"]
        np.testing.assert_array_max_ulp(got["features"], want["features"],
                                        maxulp=1)
    s, w, j = _contents(sink.stores), _contents(stores), _contents(jstores)
    assert set(s) == set(w) == set(j) and len(s) > 0
    assert all(s[k] == w[k] == j[k] for k in s)
    assert int(info.writes) == sum(x.metrics.writes for x in workers) > 0
    sink.close()


def test_worker_decision_matches_core_oracle():
    """The worker and the port's ReferenceEngine implement the same
    decision math (p and lambda agree on identical state)."""
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.01,
                       policy="pp", mu_tau_index=1)
    w = FeatureWorker(cfg, seed=0, device="cpu")
    ref = ReferenceEngine(cfg, 4, (0, 0))
    rng = np.random.default_rng(3)
    for i in range(200):
        k = int(rng.integers(0, 4))
        q = float(rng.lognormal(3, 1))
        t = float(i * 37.0)
        out = w.process(k, q, t)
        p_ref, _, lam_ref = ref.process(k, q, t)
        assert abs(out["lam"] - lam_ref) < 2e-3 * max(lam_ref, 1e-9), i
        assert abs(out["p"] - p_ref) < 2e-3, i
        e = ref.ents[k]                  # re-sync to the worker's state
        raw = w.store.get(k)
        if raw is not None:
            last_t, v_f, agg, v_full, ltf = w.serde.unpack(raw)
            e.last_t, e.v_f, e.agg = last_t, v_f, agg.astype(np.float64)
            e.v_full, e.last_t_full = v_full, ltf


@pytest.mark.parametrize("policy", POLICIES)
def test_reference_engine_matches_jax_reference(policy):
    """The oracle's float64 math and counter-RNG uniforms are the JAX
    package's: identical p, z and lambda event for event."""
    from repro.core.reference import ReferenceEngine as JaxReference
    keys, qs, ts = _stream(n_events=200, n_keys=8)
    kw = _kw(policy, keys, 64)
    a = ReferenceEngine(EngineConfig(**kw), 8, ROOT)
    b = JaxReference(jcore.EngineConfig(**kw), 8, KEY)
    for k, q, t in zip(keys.tolist(), qs.tolist(), ts.tolist()):
        assert a.process(k, q, t) == b.process(k, q, t)
    assert a.writes == b.writes > 0


def test_worker_records_latencies():
    cfg = EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002)
    w = FeatureWorker(cfg, seed=0, device="cpu")
    for i in range(20):
        w.process(i % 4, 10.0, float(i) * 7.0)
    lat = w.metrics.latencies_s
    assert lat is not None and len(lat) == 20 and all(x > 0 for x in lat)
    assert w.metrics.score_calls == 20 and w.metrics.compute_s > 0
    assert FeatureWorker(cfg, record_latency=False,
                         device="cpu").metrics.latencies_s is None


# ------------------------------------------------------------ engine
def _engines(layout, keys, kw, mode="exact"):
    weights = dict(key_weights=np.bincount(keys, minlength=N_KEYS)) \
        if layout == "virtual" else {}
    return (ShardedFeatureEngine(EngineConfig(**kw), N_KEYS, mode=mode,
                                 layout=layout, device="cpu", **weights),
            JaxEngine(jcore.EngineConfig(**kw), N_KEYS, mode=mode,
                      layout=layout, **weights))


@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_engine_dense_and_sink_match_jax(layout):
    """Exact mode, both layouts: the dense run and the sink run take the
    JAX engine's decisions, and the sink stores its bytes."""
    keys, qs, ts = _stream()
    kw = _kw("pp_vr", keys, 64)
    eng, jeng = _engines(layout, keys, kw)
    jsink = jeng.make_sink()
    jst, ji = jeng.run_stream(jeng.init_state(), keys, qs, ts,
                              batch_per_shard=64, rng=KEY, sink=jsink)
    jsink.flush()
    sink = eng.make_sink()
    st, ti = eng.run_stream(eng.init_state(), keys, qs, ts,
                            batch_per_shard=64, rng=ROOT, sink=sink)
    sink.flush()
    _, di = eng.run_stream(eng.init_state(), keys, qs, ts,
                           batch_per_shard=64, rng=ROOT)
    for f in ("z", "p", "lam_hat"):
        np.testing.assert_array_equal(_np(getattr(ti, f)),
                                      np.asarray(getattr(ji, f)), err_msg=f)
        assert torch.equal(getattr(ti, f), getattr(di, f)), f
    np.testing.assert_array_max_ulp(_np(ti.features),
                                    np.asarray(ji.features), maxulp=1)
    for f in jst._fields:
        np.testing.assert_array_equal(_np(getattr(st, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    j, t = _contents(jsink.stores), _contents(sink.stores)
    assert set(j) == set(t) and all(j[k] == t[k] for k in j)
    # restart: the hydrated state is the live one (persisted columns)
    hyd = eng.hydrate_state(sink.stores)
    for f in ("last_t", "v_f", "agg"):
        assert torch.equal(getattr(hyd, f), getattr(st, f)), f
    jsink.close(), sink.close()


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_engine_residency_equals_dense(layout, mode):
    """Both layouts, a budget below the flush groups' distinct keys
    (splits): decisions, features and stored bytes equal the dense run."""
    keys, qs, ts = _stream()
    kw = _kw("pp", keys, 64)
    eng, _ = _engines(layout, keys, kw, mode)
    sink_d = eng.make_sink()
    _, info_d = eng.run_stream(eng.init_state(), keys, qs, ts,
                               batch_per_shard=64, rng=ROOT, sink=sink_d)
    sink_d.flush()
    sink_r = eng.make_sink(l2=True)
    _, info_r = eng.run_stream(eng.init_resident_state(8), keys, qs, ts,
                               batch_per_shard=64, rng=ROOT, sink=sink_r,
                               residency=8, sink_group=1)
    sink_r.flush()
    for f in ("z", "p", "lam_hat", "features"):
        assert torch.equal(getattr(info_d, f), getattr(info_r, f)), f
    d, r = _contents(sink_d.stores), _contents(sink_r.stores)
    assert set(d) == set(r) and all(d[k] == r[k] for k in d)
    sink_d.close(), sink_r.close()


@pytest.mark.parametrize("backend", ["memory", "durable"])
@pytest.mark.parametrize("layout", ["block", "virtual"])
def test_cold_scores_match_warm_for_layouts_and_backends(layout, backend,
                                                         tmp_path):
    """``materialize_cold`` equals warm materialization bitwise on both
    layouts and both store backends; through the L2 tier it drops the
    durable gets and changes no bits."""
    keys, qs, ts = _stream()
    kw = _kw("pp", keys, 64)
    eng, _ = _engines(layout, keys, kw, "fast")
    skw = dict(backend="durable", store_dir=str(tmp_path / layout)) \
        if backend == "durable" else {}
    sink = eng.make_sink(l2=True, **skw)
    st, _ = eng.run_stream(eng.init_state(), keys, qs, ts,
                           batch_per_shard=64, rng=ROOT, sink=sink)
    sink.flush()
    ents = np.unique(keys)
    t_s = float(ts[-1]) + 1.0
    warm = eng.materialize(st, ents, t_s)
    assert torch.equal(warm, eng.materialize_cold(sink.stores, ents, t_s))
    assert torch.equal(warm, eng.materialize_cold(
        sink.stores, ents, t_s, l2_probe=sink.l2_probe))
    hot = ents[sink.l2_contains(ents)]
    assert hot.size
    g0 = sink.snapshot()["gets"]
    eng.materialize_cold(sink.stores, hot, t_s, l2_probe=sink.l2_probe)
    assert sink.snapshot()["gets"] == g0
    if backend == "durable":
        sink.close()
        rec = eng.hydrate_from_dir(str(tmp_path / layout))
        assert torch.equal(warm, eng.materialize(rec, ents, t_s))
    sink.close()


def test_engine_routing_and_layout_stats():
    keys, qs, ts = _stream(n_events=100)
    eng = ShardedFeatureEngine(EngineConfig(taus=(60.0,)), N_KEYS,
                               layout="virtual", device="cpu",
                               key_weights=np.bincount(keys,
                                                       minlength=N_KEYS))
    shard, local = eng.route(keys)
    assert (shard == 0).all()
    assert sorted(set(local.tolist())) == sorted(
        set(eng._row_of_key_host()[keys].tolist()))
    ev, slot = eng.partition_stream(keys, qs, ts, 32)
    assert ev.key.shape == (4, 32) and slot.tolist() == list(range(100))
    stats = eng.stream_layout_stats(keys, 32)
    assert stats["n_blocks"] == 4 and stats["events"] == 100
    ev = eng.partition_events(keys, qs, ts, 64)
    assert int(ev.valid.sum()) == 64


def test_unported_mesh_and_serve_raise():
    """A mesh and the serving frontend are not ported yet: both raise,
    naming ROADMAP.md."""
    cfg = EngineConfig(taus=(60.0,))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ShardedFeatureEngine(cfg, 8, mesh=object(), device="cpu")
    pipe = pipeline.ScoringPipeline.build(ProfileSpec(windows=(60.0,)), 8,
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pipe.serve(np.zeros(4, np.int32), np.zeros(4), np.zeros(4))


# ----------------------------------------------------------- scoring
def _jax_scorer_np(feature_dim, seed=1):
    p = jpipe.init_scorer(jax.random.PRNGKey(seed), feature_dim)
    return jax.tree.map(np.asarray, p)


def test_pipeline_scores_match_jax():
    """The whole pipeline (exact mode, sink) against JAX: decisions
    bitwise, features within 1 ulp, scores within rtol 1e-5 — on the JAX
    features and end to end — with the JAX weights carried across."""
    assert not torch.backends.cuda.matmul.allow_tf32
    keys, qs, ts = _stream()
    spec_kw = dict(windows=(60.0, 3600.0, 86400.0), kde_bandwidth=600.0,
                   write_budget_per_min=0.12, policy="pp_vr",
                   variance_alpha=1.0)
    rounds = _kw("pp", keys, 64)["exact_rounds"]
    jp = jpipe.ScoringPipeline.build(JaxSpec(**spec_kw), N_KEYS,
                                     mode="exact", exact_rounds=rounds)
    tp = pipeline.ScoringPipeline.build(ProfileSpec(**spec_kw), N_KEYS,
                                        mode="exact", device="cpu",
                                        exact_rounds=rounds)
    params_np = _jax_scorer_np(12)          # 4 features x 3 windows
    params_np = params_np._replace(
        mu=np.linspace(-1, 1, 12).astype(np.float32),
        sd=np.linspace(0.5, 2, 12).astype(np.float32))
    jp.scorer = jpipe.ScorerParams(*map(jnp.asarray, params_np))
    tp.scorer = pipeline.scorer_from_jax(params_np, device="cpu")
    jsink, tsink = jp.make_sink(), tp.make_sink()
    _, ji = jp.process_stream(jp.init(), keys, qs, ts, rng=KEY,
                              batch_per_shard=64, sink=jsink)
    _, ti = tp.process_stream(tp.init(), keys, qs, ts, rng=ROOT,
                              batch_per_shard=64, sink=tsink)
    np.testing.assert_array_equal(_np(ti.z), np.asarray(ji.z))
    np.testing.assert_array_max_ulp(_np(ti.features),
                                    np.asarray(ji.features), maxulp=1)
    want = np.asarray(jpipe.score(jp.scorer, ji.features))
    same_in = pipeline.score(tp.scorer, torch.from_numpy(
        np.array(ji.features)))
    np.testing.assert_allclose(_np(same_in), want, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(_np(pipeline.score(tp.scorer, ti.features)),
                               want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    # the loss too, on the same features and labels
    y = (np.arange(len(keys)) % 7 == 0).astype(np.float32)
    np.testing.assert_allclose(
        float(pipeline.scorer_loss(tp.scorer, same_in.new_tensor(
            np.asarray(ji.features)), torch.from_numpy(y))),
        float(jpipe.scorer_loss(jp.scorer, ji.features, jnp.asarray(y))),
        rtol=SCORE_RTOL)
    j, t = _contents(jsink.stores), _contents(tsink.stores)
    assert set(j) == set(t) and all(j[k] == t[k] for k in j)
    jsink.close(), tsink.close()


def test_pipeline_score_cold_uses_the_sink_l2():
    keys, qs, ts = _stream()
    spec = ProfileSpec(windows=(60.0, 3600.0), kde_bandwidth=600.0,
                       write_budget_per_min=0.12)
    pipe = pipeline.ScoringPipeline.build(spec, N_KEYS, mode="fast",
                                          device="cpu")
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(1),
                                       spec.feature_dim, device="cpu")
    sink = pipe.make_sink(l2=True)
    state, _ = pipe.process_stream(pipe.init(), keys, qs, ts, rng=ROOT,
                                   batch_per_shard=64, sink=sink)
    ents = np.unique(keys)
    t_s = float(ts[-1]) + 1.0
    cold = pipe.score_cold(sink, ents, t_s)
    warm = pipeline.score(pipe.scorer,
                          pipe.engine.materialize(state, ents, t_s))
    assert torch.equal(warm, cold)
    assert sink.snapshot()["l2_hits"] > 0
    sink.close()


@pytest.mark.parametrize("backend", ["memory", "durable"])
@pytest.mark.parametrize("residency", [None, 24])
def test_score_persist_restart_score_round_trip(residency, backend,
                                                tmp_path):
    """Every event scored, thinned writes persisted, state lost: the
    recovered scores equal the live ones bitwise — dense (hydrate_state)
    and resident (cold-start hydration), memory and durable backends."""
    rng = np.random.default_rng(5)
    n_events, n_keys = 1500, 64
    keys = rng.integers(0, n_keys, n_events).astype(np.int32)
    ts = np.cumsum(rng.exponential(15.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    spec = ProfileSpec(windows=(60.0, 3600.0, 86400.0), policy="pp",
                       write_budget_per_min=0.0005)
    out = pipeline.run_restart_demo(
        spec, n_keys, keys, qs, ts, mode="fast", residency=residency,
        backend=backend, device="cpu",
        store_dir=str(tmp_path / "stores") if backend == "durable"
        else None)
    np.testing.assert_array_equal(out["scores_live"],
                                  out["scores_recovered"])
    assert out["keys_scored"] == len(np.unique(keys))
    assert out["events"] == n_events and out["write_pct"] < 20.0
    assert out["sink"]["puts"] <= out["writes"]
    assert (out["recovery"] is not None) == (backend == "durable")


def test_process_batch_scores_every_event():
    keys, qs, ts = _stream(n_events=64)
    spec = ProfileSpec(windows=(60.0, 3600.0))
    pipe = pipeline.ScoringPipeline.build(spec, N_KEYS, device="cpu")
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(0),
                                       spec.feature_dim, device="cpu")
    ev = pipe.engine.partition_events(keys, qs, ts, 64)
    _, info, scores = pipe.process_batch(pipe.init(), ev, ROOT)
    assert scores.shape == (64,) and bool(torch.isfinite(scores).all())
    assert torch.equal(scores, pipeline.score(pipe.scorer, info.features))


def test_scoring_pipeline_end_to_end():
    """Feature engine + scorer trained with autograd: the thinned
    pipeline finds the planted anomalies clearly better than chance."""
    spec = ProfileSpec(windows=(3600.0, 86400.0),
                       write_budget_per_min=0.005)
    stream = workload.generate_regime("iiot", n_events=12_000)
    pipe = pipeline.ScoringPipeline.build(spec, int(stream.key.max()) + 1,
                                          device="cpu", mu_tau_index=1)
    _, info = pipe.process_stream(pipe.init(), stream.key, stream.q,
                                  stream.t, rng=(0, 0), batch_per_shard=512)
    feats = _np(info.features)
    assert feats.shape == (len(stream), spec.feature_dim)
    cut = int(0.7 * len(stream))
    params = pipeline.init_scorer(torch.Generator().manual_seed(0),
                                  feats.shape[1], device="cpu")
    params = pipeline.fit_standardization(params, feats[:cut])
    params = pipeline.ScorerParams(*(p.clone().requires_grad_(True)
                                     for p in params))
    x = torch.from_numpy(feats[:cut])
    y = torch.from_numpy(stream.label[:cut].astype(np.float32))
    for _ in range(200):
        grads = torch.autograd.grad(pipeline.scorer_loss(params, x, y),
                                    params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= 0.05 * g
    with torch.no_grad():
        scores = _np(pipeline.score(params, torch.from_numpy(feats[cut:])))
    rec = pipeline.recall_at_fpr(scores, stream.label[cut:], fpr=0.05)
    assert rec > 0.15, rec          # planted signal found (chance = 0.05)


def test_recall_at_fpr_and_standardization():
    scores = np.concatenate([np.zeros(1000), np.ones(10)])
    labels = np.concatenate([np.zeros(1000), np.ones(10)])
    assert pipeline.recall_at_fpr(scores, labels, 0.01) == 1.0
    rng = np.random.default_rng(0)
    assert 0.0 <= pipeline.recall_at_fpr(rng.normal(size=1010), labels,
                                         0.01) <= 0.2
    feats = rng.lognormal(0, 2, (50, 4)).astype(np.float32)
    got = pipeline.fit_standardization(pipeline.init_scorer(
        torch.Generator(), 4, device="cpu"), feats)
    want = jpipe.fit_standardization(jpipe.init_scorer(
        jax.random.PRNGKey(0), 4), feats)
    np.testing.assert_array_equal(_np(got.mu), np.asarray(want.mu))
    np.testing.assert_array_equal(_np(got.sd), np.asarray(want.sd))

"""repro_torch's online serving tier against the JAX one and its own
closed loop: admission, dynamic batching, prefetched hydration.

The twin of ``tests/test_frontend.py``, on the injectable ``VirtualClock``
(no wall-clock sleeps in any batching/deadline assertion), on the CPU:

* **Dispatch timing and admission invariants** as in the JAX suite.
* **Exact mode** equals the port's ``run_stream`` and the JAX frontend
  bit for bit under partial batches, for all five policies (decisions,
  features, stored bytes; scores within rtol 1e-5 of the JAX scorer's).
* **Fast mode** equals the port's ``run_stream`` bit for bit at matching
  boundaries and at its own boundaries.  Against JAX it is held op by op:
  the first dispatch (same start state) bitwise, then equal decisions and
  ``p``, count/sum/mean features within rtol 1e-5; the fold rounds in
  another order and the ``std`` features cancel (``sqrt(E[x^2] -
  mean^2)``), so they are not compared after the first dispatch.
* **Padding lanes** (key 0, invalid) never disturb a real event of key 0.
* **Prefetched hydration**, stalled reads and the threaded admission
  plane as in the JAX suite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.serving import frontend as jfe                    # noqa: E402
from repro.serving import pipeline as jpipe                  # noqa: E402
from repro.streaming.persistence import \
    WriteBehindSink as JaxSink                               # noqa: E402
from repro.streaming.residency import \
    ResidencyMap as JaxResidencyMap                          # noqa: E402
from repro_torch.core import EngineConfig, init_state, run_stream  # noqa
from repro_torch.serving.frontend import (ServingFrontend,  # noqa: E402
                                          VirtualClock, make_requests,
                                          poisson_arrivals, score_at_width)
from repro_torch.serving.pipeline import scorer_from_jax     # noqa: E402
from repro_torch.streaming.faults import StallingReads       # noqa: E402
from repro_torch.streaming.kvstore import KVStore            # noqa: E402
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.residency import ResidencyMap     # noqa: E402

N_KEYS = 48
POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
CPU = "cpu"


def _stream(n_events=120, n_keys=N_KEYS, seed=0, skew=1.1):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _kw(policy, n_taus=2, exact_rounds=16):
    return dict(taus=(60.0, 3600.0, 86400.0)[:n_taus], h=600.0,
                budget=0.002, alpha=1.0, policy=policy, fixed_rate=0.3,
                mu_tau_index=1, exact_rounds=exact_rounds)


def _cfg(policy, **kw):
    return EngineConfig(**_kw(policy, **kw))


def _rng():
    return np.asarray(jax.random.PRNGKey(7))


def _sink(cfg, **kw):
    return WriteBehindSink(cfg, device=CPU, **kw)


def _store_contents(stores):
    merged = {}
    for s in stores:
        merged.update(s.data)
    return merged


def _frontend_run(cfg, keys, qs, ts, *, batch, mode, arrival_s,
                  max_wait_s, sink=None, rmap=None, scorer=None,
                  clock=None, admission="serial", adaptive_wait=False):
    n_rows = rmap.n_slots if rmap is not None else N_KEYS
    fe = ServingFrontend(
        cfg, init_state(n_rows, len(cfg.taus), device=CPU), batch=batch,
        max_wait_s=max_wait_s, mode=mode, rng=_rng(),
        clock=clock if clock is not None else VirtualClock(),
        sink=sink, residency=rmap, scorer=scorer,
        admission=admission, adaptive_wait=adaptive_wait)
    return fe.run(make_requests(keys, qs, ts, arrival_s))


def _jax_frontend_run(policy, keys, qs, ts, *, batch, mode, arrival_s,
                      max_wait_s, sink=None, scorer=None):
    cfg = jcore.EngineConfig(**_kw(policy))
    fe = jfe.ServingFrontend(
        cfg, jcore.init_state(N_KEYS, len(cfg.taus)), batch=batch,
        max_wait_s=max_wait_s, mode=mode, rng=jax.random.PRNGKey(7),
        clock=jfe.VirtualClock(), sink=sink, scorer=scorer)
    return fe.run(jfe.make_requests(keys, qs, ts, arrival_s))


def _closed_loop(cfg, keys, qs, ts, *, batch, mode, sink=None):
    state, info = run_stream(cfg, init_state(N_KEYS, len(cfg.taus),
                                             device=CPU), keys, qs, ts,
                             batch=batch, mode=mode, rng=_rng(), sink=sink)
    if sink is not None:
        sink.flush()
    return state, info


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint8)


def _assert_bit_equal(res, info):
    for f in ("z", "p", "lam_hat", "features"):
        a, b = getattr(res, f), getattr(info, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(_bits(a), _bits(b)), f


# ------------------------------------------------ dispatch timing (virtual)
def test_full_batch_dispatches_immediately():
    keys, qs, ts = _stream(16)
    clock = VirtualClock()
    res = _frontend_run(_cfg("pp"), keys, qs, ts, batch=4, mode="fast",
                        arrival_s=np.zeros(16), max_wait_s=1.0, clock=clock)
    assert res.stats.dispatches == 4 and res.stats.full_batches == 4
    assert res.stats.deadline_batches == 0
    # burst at t=0, compute is free on the virtual clock: no sleep is ever
    # taken and every request completes at its arrival instant
    assert clock.sleeps == 0
    assert all(b.t_dispatch == 0.0 and b.full for b in res.batches)
    assert np.all(res.latency_s == 0.0)


def test_partial_batch_dispatches_at_exact_deadline():
    keys, qs, ts = _stream(3)
    res = _frontend_run(_cfg("pp"), keys, qs, ts, batch=8, mode="fast",
                        arrival_s=np.zeros(3), max_wait_s=0.005)
    assert res.stats.dispatches == 1 and res.stats.deadline_batches == 1
    (b,) = res.batches
    assert not b.full and b.size == 3
    assert b.t_dispatch == b.deadline == pytest.approx(0.005, abs=1e-12)
    assert np.all(res.latency_s == pytest.approx(0.005, abs=1e-12))


def test_partial_batches_cut_by_arrival_gaps():
    keys, qs, ts = _stream(4)
    arrival = np.array([0.0, 0.001, 0.002, 0.010])
    res = _frontend_run(_cfg("pp"), keys, qs, ts, batch=8, mode="fast",
                        arrival_s=arrival, max_wait_s=0.004)
    assert [b.size for b in res.batches] == [3, 1]
    assert res.batches[0].t_dispatch == pytest.approx(0.004, abs=1e-12)
    assert res.batches[1].t_dispatch == pytest.approx(0.014, abs=1e-12)
    # latency = own wait, not the batch's: r0 waited the full deadline
    assert res.latency_s[0] == pytest.approx(0.004, abs=1e-12)
    assert res.latency_s[2] == pytest.approx(0.002, abs=1e-12)
    q = res.latency_quantiles()
    assert set(q) == {"p50", "p99", "p999"} and q["p999"] <= 0.004 + 1e-9


def test_arrival_on_deadline_rides_the_dispatching_batch():
    keys, qs, ts = _stream(3)
    # third request lands exactly on the first request's deadline: ties
    # admit first, so the batch fills and dispatches full
    res = _frontend_run(_cfg("pp"), keys, qs, ts, batch=3, mode="fast",
                        arrival_s=np.array([0.0, 0.001, 0.004]),
                        max_wait_s=0.004)
    assert res.stats.dispatches == 1 and res.stats.full_batches == 1
    assert res.batches[0].size == 3 and res.batches[0].full


def test_frontend_contract_errors():
    keys, qs, ts = _stream(4)
    cfg = _cfg("pp")
    with pytest.raises(ValueError, match="batch"):
        ServingFrontend(cfg, init_state(N_KEYS, 2, device=CPU), batch=0,
                        max_wait_s=0.0)
    with pytest.raises(ValueError, match="sink"):
        ServingFrontend(cfg, init_state(8, 2, device=CPU), batch=4,
                        max_wait_s=0.0, residency=ResidencyMap(N_KEYS, 8))
    fe = ServingFrontend(cfg, init_state(N_KEYS, 2, device=CPU), batch=4,
                         max_wait_s=0.0, clock=VirtualClock())
    with pytest.raises(ValueError, match="sorted"):
        fe.run(list(reversed(make_requests(keys, qs, ts,
                                           np.arange(4.0)))))
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(8, 0.0)


# ------------------------------------- bit-exactness vs the closed loop
@pytest.mark.parametrize("policy", POLICIES)
def test_exact_mode_bit_exact_under_partial_batches(policy):
    """Exact mode is batching-invariant: open-loop arrivals that force
    deadline (partial) dispatches reproduce the port's closed-loop block
    driver and the JAX frontend bit for bit, for every policy."""
    keys, qs, ts = _stream(120)
    cfg = _cfg(policy)
    kw = dict(batch=8, mode="exact", arrival_s=np.arange(120) * 1e-3,
              max_wait_s=2.5e-3)
    res = _frontend_run(cfg, keys, qs, ts, **kw)
    assert res.stats.deadline_batches > 0          # partials exercised
    assert np.array_equal(np.sort(res.order), np.arange(120))
    _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="exact")
    _assert_bit_equal(res, info)
    ref = _jax_frontend_run(policy, keys, qs, ts, **kw)
    _assert_bit_equal(res, ref)
    assert np.array_equal(res.order, ref.order)
    assert [b[:5] for b in res.batches] == [b[:5] for b in ref.batches]


@pytest.mark.parametrize("policy", POLICIES)
def test_fast_mode_bit_exact_at_matching_boundaries(policy):
    """Fast mode's block boundaries are semantic (within-batch
    decoupling); when the batcher's boundaries line up with the
    closed-loop blocks — burst arrivals, all batches full — the outputs
    equal the port's ``run_stream`` bit for bit, for every policy."""
    keys, qs, ts = _stream(96)
    cfg = _cfg(policy)
    res = _frontend_run(cfg, keys, qs, ts, batch=8, mode="fast",
                        arrival_s=np.zeros(96), max_wait_s=0.001)
    assert res.stats.full_batches == 12
    assert res.stats.deadline_batches == 0
    _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="fast")
    _assert_bit_equal(res, info)


@pytest.mark.parametrize("policy", POLICIES)
def test_fast_mode_against_jax_frontend(policy):
    """Op by op against the JAX frontend in fast mode: the first dispatch
    runs from the same (fresh) state, so its outputs are bitwise; after
    it the folds' rounding differs, so decisions are held equal, ``p``
    and the count/sum/mean features to rtol 1e-5 (measured <= 2e-6)."""
    keys, qs, ts = _stream(96)
    kw = dict(batch=8, mode="fast", arrival_s=np.zeros(96), max_wait_s=1e-3)
    res = _frontend_run(_cfg(policy), keys, qs, ts, **kw)
    ref = _jax_frontend_run(policy, keys, qs, ts, **kw)
    first = res.order[:8]
    for f in ("z", "p", "lam_hat", "features"):
        assert np.array_equal(_bits(getattr(res, f)[first]),
                              _bits(getattr(ref, f)[first])), f
    assert np.array_equal(res.z, ref.z)
    np.testing.assert_allclose(res.p, ref.p, rtol=1e-5)
    n_taus = len(_cfg(policy).taus)
    np.testing.assert_allclose(res.features[:, :3 * n_taus],
                               ref.features[:, :3 * n_taus], rtol=1e-5)


def test_fast_partial_batches_equal_closed_loop_at_own_boundaries():
    """A padded partial batch is bit-identical to an unpadded block of the
    same events: replaying the frontend's own dispatch chunks through
    ``run_stream`` reproduces every output."""
    keys, qs, ts = _stream(90)
    cfg = _cfg("pp")
    res = _frontend_run(cfg, keys, qs, ts, batch=8, mode="fast",
                        arrival_s=np.arange(90) * 1e-3, max_wait_s=2.5e-3)
    assert res.stats.deadline_batches > 0
    state = init_state(N_KEYS, len(cfg.taus), device=CPU)
    z = np.zeros(90, bool)
    p = np.zeros(90, np.float32)
    feats = np.zeros((90, res.features.shape[1]), np.float32)
    pos = 0
    for rec in res.batches:
        rids = res.order[pos:pos + rec.size]
        pos += rec.size
        state, info = run_stream(cfg, state, keys[rids], qs[rids], ts[rids],
                                 batch=8, mode="fast", rng=_rng())
        z[rids] = info.z.numpy()
        p[rids] = info.p.numpy()
        feats[rids] = info.features.numpy()
    assert np.array_equal(res.z, z)
    assert np.array_equal(_bits(res.p), _bits(p))
    assert np.array_equal(_bits(res.features), _bits(feats))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_padding_lanes_leave_key_zero_alone(mode):
    """Partial batches are padded with key 0 (invalid); a stream whose
    hottest key is 0 puts real key-0 events beside those padding lanes in
    most batches.  Exact mode: equal to the closed loop and to JAX
    (padding is never active in a write-back launch).  Fast mode: equal
    to a closed-loop replay at the frontend's own boundaries."""
    keys, qs, ts = _stream(150, skew=1.6)
    assert (keys == 0).mean() > 0.2
    cfg = _cfg("pp_vr")
    kw = dict(batch=8, mode=mode, arrival_s=np.arange(150) * 1e-3,
              max_wait_s=2.5e-3)
    res = _frontend_run(cfg, keys, qs, ts, **kw)
    pos, shared = 0, 0
    state = init_state(N_KEYS, len(cfg.taus), device=CPU)
    want = {f: np.zeros_like(getattr(res, f))
            for f in ("z", "p", "lam_hat", "features")}
    for rec in res.batches:
        rids = res.order[pos:pos + rec.size]
        pos += rec.size
        shared += rec.size < 8 and bool((keys[rids] == 0).any())
        state, info = run_stream(cfg, state, keys[rids], qs[rids], ts[rids],
                                 batch=8, mode=mode, rng=_rng())
        for f in want:
            want[f][rids] = getattr(info, f).numpy()
    assert shared > 5                   # key 0 beside padding, often
    for f, w in want.items():
        assert np.array_equal(_bits(getattr(res, f)), _bits(w)), f
    if mode == "exact":
        _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="exact")
        _assert_bit_equal(res, info)
        _assert_bit_equal(res, _jax_frontend_run("pp_vr", keys, qs, ts,
                                                 **kw))


def test_frontend_sink_bytes_and_scores_match_closed_loop():
    """With a write-behind sink and a scorer: the frontend's stored bytes
    equal the closed-loop sink's and the JAX frontend's; its scores equal
    the reference features pushed through the same fixed-width scoring
    helper bit for bit, and the JAX frontend's scores within rtol 1e-5."""
    keys, qs, ts = _stream(120)
    cfg = _cfg("pp")
    jscorer = jpipe.init_scorer(jax.random.PRNGKey(1), 4 * len(cfg.taus))
    scorer = scorer_from_jax(jax.tree.map(np.asarray, jscorer), device=CPU)
    kw = dict(batch=8, mode="exact", arrival_s=np.arange(120) * 1e-3,
              max_wait_s=2.5e-3)
    sink_f = _sink(cfg, n_partitions=3)
    res = _frontend_run(cfg, keys, qs, ts, sink=sink_f, scorer=scorer, **kw)
    sink_f.flush()
    sink_d = _sink(cfg, n_partitions=3)
    _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="exact",
                           sink=sink_d)
    _assert_bit_equal(res, info)
    assert _store_contents(sink_f.stores) == _store_contents(sink_d.stores)
    ref_feats = info.features.numpy()
    pos = 0
    for rec in res.batches:
        rids = res.order[pos:pos + rec.size]
        pos += rec.size
        want = score_at_width(scorer, ref_feats[rids], 8)
        assert np.array_equal(_bits(res.scores[rids]), _bits(want))
    sink_j = JaxSink(jcore.EngineConfig(**_kw("pp")), n_partitions=3)
    ref = _jax_frontend_run("pp", keys, qs, ts, sink=sink_j,
                            scorer=jscorer, **kw)
    sink_j.flush()
    _assert_bit_equal(res, ref)
    assert _store_contents(sink_f.stores) == _store_contents(sink_j.stores)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=1e-5,
                               atol=1e-6)
    for s in (sink_f, sink_d, sink_j):
        s.close()


# --------------------------------------- admission-queue property tests
def _check_admission_invariants(arrivals, batch, max_wait):
    """No drop, no dup, strict FIFO, bounded dispatch size, bounded wait —
    for an arbitrary arrival schedule on the virtual clock."""
    arrivals = np.asarray(arrivals, np.float64)
    n = arrivals.size
    keys = (np.arange(n) % 5).astype(np.int64)
    qs = (1.0 + np.arange(n) % 3).astype(np.float32)
    ts = np.cumsum(np.full(n, 0.1, np.float32))
    fe = ServingFrontend(_cfg("pp"), init_state(8, 2, device=CPU),
                         batch=batch, max_wait_s=max_wait, mode="fast",
                         clock=VirtualClock(), rng=_rng())
    res = fe.run(make_requests(keys, qs, ts, arrivals))
    sizes = [b.size for b in res.batches]
    assert sum(sizes) == n and all(1 <= s <= batch for s in sizes)
    for b in res.batches:
        if b.full:
            assert b.size == batch
        else:
            assert b.size < batch
            # a partial dispatch fires at exactly its deadline
            assert b.t_dispatch == pytest.approx(b.deadline, abs=1e-9)
    # strict FIFO: dispatch order IS the arrival-sorted request sequence
    assert np.array_equal(res.order, np.argsort(arrivals, kind="stable"))
    assert np.all(res.latency_s >= -1e-12)
    assert np.all(res.latency_s <= max_wait + 1e-9)


FIXED_SCHEDULES = [
    (np.zeros(7), 3, 0.004),                       # pure burst, tail partial
    (np.array([0.0, 0.001, 0.004, 0.004, 0.02]), 3, 0.004),  # deadline ties
    (np.linspace(0.0, 0.01, 9), 4, 0.0),           # zero-wait singletons
    (np.array([0.005, 0.0, 0.003, 0.001]), 2, 0.002),        # unsorted input
]


@pytest.mark.parametrize("arrivals,batch,max_wait", FIXED_SCHEDULES)
def test_admission_invariants_fixed_examples(arrivals, batch, max_wait):
    _check_admission_invariants(arrivals, batch, max_wait)


def test_admission_invariants_hypothesis():
    """Property form of the fixed examples: arbitrary arrival schedules,
    batch sizes and deadlines (skipped if hypothesis is missing — the
    fixed twins above always run)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(
        arrivals=st.lists(st.floats(0.0, 0.05, allow_nan=False,
                                    allow_infinity=False),
                          min_size=1, max_size=18),
        batch=st.integers(1, 5),
        max_wait=st.floats(0.0, 0.01, allow_nan=False,
                           allow_infinity=False))
    @hyp.settings(max_examples=15, deadline=None)
    def run_case(arrivals, batch, max_wait):
        _check_admission_invariants(arrivals, batch, max_wait)

    run_case()


# --------------------------------------------------- prefetched hydration
def test_residency_evict_mid_wait_rehydrates_bit_exact():
    """Bounded resident set under open-loop partial batching: keys evicted
    while queued are prefetched back from their latest durable row before
    dispatch, and everything — outputs AND stored bytes — stays
    bit-identical to the dense closed-loop engine."""
    keys, qs, ts = _stream(600, seed=3)
    cfg = _cfg("pp")
    sink_d = _sink(cfg, n_partitions=3)
    _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="exact",
                           sink=sink_d)
    rmap = ResidencyMap(N_KEYS, 12)        # 0.25 resident fraction
    sink = _sink(cfg, n_partitions=3)
    res = _frontend_run(cfg, keys, qs, ts, batch=8, mode="exact",
                        arrival_s=np.arange(600) * 1e-3, max_wait_s=2.5e-3,
                        sink=sink, rmap=rmap)
    sink.flush()
    _assert_bit_equal(res, info)
    assert _store_contents(sink.stores) == _store_contents(sink_d.stores)
    st = res.stats
    assert st.deadline_batches > 0             # partial batches exercised
    assert st.prefetch_issued > 0
    # the contract under test: previously-resident keys were evicted while
    # waiting and re-read ahead of their dispatch...
    assert st.prefetch_rehydrations > 0
    # ...and every miss was served by an in-flight prefetch — dispatch
    # never had to stop and read the store
    assert st.demand_reads == 0
    assert st.prefetch_hits == sum(b.n_miss for b in res.batches) > 0
    # the JAX frontend on the same schedule reads the same keys: same
    # hydration accounting, same stored bytes
    sink_j = JaxSink(jcore.EngineConfig(**_kw("pp")), n_partitions=3)
    ref = jfe.ServingFrontend(
        jcore.EngineConfig(**_kw("pp")), jcore.init_state(12, 2), batch=8,
        max_wait_s=2.5e-3, mode="exact", rng=jax.random.PRNGKey(7),
        clock=jfe.VirtualClock(), sink=sink_j,
        residency=JaxResidencyMap(N_KEYS, 12)).run(
            jfe.make_requests(keys, qs, ts, np.arange(600) * 1e-3))
    sink_j.flush()
    assert st.snapshot() == ref.stats.snapshot()
    assert [b[2:] for b in res.batches] == [b[2:] for b in ref.batches]
    assert _store_contents(sink.stores) == _store_contents(sink_j.stores)
    sink.close()
    sink_d.close()
    sink_j.close()


def test_stalled_durable_read_delays_but_never_corrupts_a_dispatch():
    """Slow-read fault injection: every ``multi_get`` under the hydration
    path stalls (``StallingReads``), which can only delay dispatches —
    outputs and stored bytes still match the dense closed-loop engine
    bit-for-bit."""
    keys, qs, ts = _stream(240, seed=5)
    cfg = _cfg("pp")
    sink_d = _sink(cfg, n_partitions=3)
    _, info = _closed_loop(cfg, keys, qs, ts, batch=8, mode="exact",
                           sink=sink_d)
    stores = [StallingReads(KVStore(seed=i), stall_s=0.002)
              for i in range(3)]
    sink = _sink(cfg, stores=stores)
    rmap = ResidencyMap(N_KEYS, 12)
    res = _frontend_run(cfg, keys, qs, ts, batch=8, mode="exact",
                        arrival_s=np.zeros(240), max_wait_s=1e-3,
                        sink=sink, rmap=rmap)
    sink.flush()
    assert sum(s.stalled_gets for s in stores) > 0
    _assert_bit_equal(res, info)
    assert _store_contents(sink.stores) == _store_contents(sink_d.stores)
    sink.close()
    sink_d.close()


# ------------------------------------------- threaded admission plane
def _assert_same_serve(a, b):
    """Bit-equality of the deterministic half of two ServeResults:
    outputs, scores, order, and per-dispatch batch composition.  Latency
    is a measurement and is not compared: under the threaded plane the
    admission thread advances the virtual clock while earlier batches are
    still on the dispatch thread."""
    _assert_bit_equal(a, b)
    if a.scores is not None or b.scores is not None:
        assert np.array_equal(_bits(a.scores), _bits(b.scores))
    assert np.array_equal(a.order, b.order)
    assert [(r.size, r.full, r.t_dispatch, r.deadline, r.n_miss)
            for r in a.batches] == \
           [(r.size, r.full, r.t_dispatch, r.deadline, r.n_miss)
            for r in b.batches]


def test_threaded_admission_validation_errors():
    cfg = _cfg("pp")
    with pytest.raises(ValueError, match="admission"):
        ServingFrontend(cfg, init_state(N_KEYS, 2, device=CPU), batch=4,
                        max_wait_s=0.0, admission="fibered")
    with pytest.raises(ValueError, match="adaptive_alpha"):
        ServingFrontend(cfg, init_state(N_KEYS, 2, device=CPU), batch=4,
                        max_wait_s=0.0, adaptive_alpha=0.0)
    # residency under threaded admission needs the sink's epoch lane:
    # a serial (queue_depth=0) sink has no store workers to park reads on
    sink = _sink(cfg, n_partitions=3, queue_depth=0)
    with pytest.raises(ValueError, match="threaded sink"):
        ServingFrontend(cfg, init_state(12, 2, device=CPU), batch=4,
                        max_wait_s=0.0, admission="threaded", sink=sink,
                        residency=ResidencyMap(N_KEYS, 12))
    sink.close()
    # ...and a degrade-to-serial sink can flush inline on the dispatch
    # thread, racing the admission thread's reads
    sink = _sink(cfg, n_partitions=3, overflow="degrade-to-serial")
    with pytest.raises(ValueError, match="degraded sink"):
        ServingFrontend(cfg, init_state(12, 2, device=CPU), batch=4,
                        max_wait_s=0.0, admission="threaded", sink=sink,
                        residency=ResidencyMap(N_KEYS, 12))
    sink.close()


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_threaded_admission_plain_parity(mode):
    """Sinkless planes: the threaded admission plane reproduces the serial
    loop bit-for-bit — outputs, order, batch composition — under
    partial-batch (deadline) arrivals on the virtual clock."""
    keys, qs, ts = _stream(150)
    cfg = _cfg("pp")
    kw = dict(batch=8, mode=mode, arrival_s=np.arange(150) * 1e-3,
              max_wait_s=2.5e-3)
    ser = _frontend_run(cfg, keys, qs, ts, **kw)
    thr = _frontend_run(cfg, keys, qs, ts, admission="threaded", **kw)
    assert ser.stats.deadline_batches > 0
    _assert_same_serve(ser, thr)
    # completion can never precede dispatch: threaded latency dominates
    # the serial plane's (whose compute is free on the virtual clock)
    assert np.all(thr.latency_s >= ser.latency_s - 1e-12)


@pytest.mark.parametrize("policy", POLICIES)
def test_threaded_admission_sink_parity(policy):
    """Write-behind sink + scorer: stored bytes and scores also match the
    serial plane, for every policy."""
    keys, qs, ts = _stream(120)
    cfg = _cfg(policy)
    scorer = scorer_from_jax(jax.tree.map(np.asarray, jpipe.init_scorer(
        jax.random.PRNGKey(1), 4 * len(cfg.taus))), device=CPU)
    kw = dict(batch=8, mode="exact", arrival_s=np.arange(120) * 1e-3,
              max_wait_s=2.5e-3, scorer=scorer)
    sink_s = _sink(cfg, n_partitions=3)
    ser = _frontend_run(cfg, keys, qs, ts, sink=sink_s, **kw)
    sink_s.flush()
    sink_t = _sink(cfg, n_partitions=3)
    thr = _frontend_run(cfg, keys, qs, ts, sink=sink_t,
                        admission="threaded", **kw)
    sink_t.flush()
    _assert_same_serve(ser, thr)
    assert _store_contents(sink_s.stores) == _store_contents(sink_t.stores)
    sink_s.close()
    sink_t.close()


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_threaded_admission_residency_parity(mode):
    """Bounded resident set under the threaded plane: mid-wait evictions
    rehydrate through the sink's epoch-gated read lane and everything —
    outputs, stored bytes, hydration counters — matches serial admission."""
    keys, qs, ts = _stream(600, seed=3)
    cfg = _cfg("pp")
    kw = dict(batch=8, mode=mode, arrival_s=np.arange(600) * 1e-3,
              max_wait_s=2.5e-3)
    sink_s = _sink(cfg, n_partitions=3)
    ser = _frontend_run(cfg, keys, qs, ts, sink=sink_s,
                        rmap=ResidencyMap(N_KEYS, 12), **kw)
    sink_s.flush()
    sink_t = _sink(cfg, n_partitions=3)
    thr = _frontend_run(cfg, keys, qs, ts, sink=sink_t,
                        rmap=ResidencyMap(N_KEYS, 12),
                        admission="threaded", **kw)
    sink_t.flush()
    _assert_same_serve(ser, thr)
    assert _store_contents(sink_s.stores) == _store_contents(sink_t.stores)
    assert thr.stats.prefetch_rehydrations > 0
    assert thr.stats.demand_reads == ser.stats.demand_reads
    assert thr.stats.prefetch_hits == ser.stats.prefetch_hits
    # the threaded plane routed its reads through the sink's epoch lane
    st = sink_t.stats
    assert st.epochs_staged > 0 and st.staged_reads > 0
    assert sink_s.stats.epochs_staged == 0
    sink_s.close()
    sink_t.close()


# --------------------------------------- adaptive partial-batch deadline
def test_adaptive_wait_off_by_default():
    keys, qs, ts = _stream(60)
    cfg = _cfg("pp")
    kw = dict(batch=8, mode="fast", arrival_s=np.arange(60) * 1e-3,
              max_wait_s=2.5e-3)
    base = _frontend_run(cfg, keys, qs, ts, **kw)
    assert base.stats.adaptive_tightened == 0


def test_adaptive_wait_tightens_slow_arrival_deadlines():
    """Sparse arrivals: the EWMA fill estimate undercuts ``max_wait_s``,
    partials dispatch early (``adaptive_tightened`` counts them), latency
    drops, and the no-drop/no-dup FIFO contract is untouched; exact mode
    is batching-invariant, so the outputs do not change."""
    n = 40
    keys, qs, ts = _stream(n)
    cfg = _cfg("pp")
    kw = dict(batch=16, mode="exact", arrival_s=np.arange(n) * 1e-3,
              max_wait_s=0.020)
    base = _frontend_run(cfg, keys, qs, ts, **kw)
    adap = _frontend_run(cfg, keys, qs, ts, adaptive_wait=True, **kw)
    assert adap.stats.adaptive_tightened > 0
    assert np.array_equal(np.sort(adap.order), np.arange(n))
    assert np.array_equal(adap.order, base.order)
    _assert_bit_equal(adap, base)
    # the tightened deadlines strictly help the tail and hurt no one
    assert float(adap.latency_s.max()) < float(base.latency_s.max())
    assert np.all(adap.latency_s <= kw["max_wait_s"] + 1e-9)


def test_adaptive_wait_identical_across_admission_planes():
    """The EWMA is a pure function of the arrival schedule (never a clock
    read), so adaptive batching is bit-identical between the serial and
    threaded planes — composition, tighten counts, outputs."""
    keys, qs, ts = _stream(90)
    cfg = _cfg("pp")
    kw = dict(batch=16, mode="exact", arrival_s=np.arange(90) * 1e-3,
              max_wait_s=0.020, adaptive_wait=True)
    ser = _frontend_run(cfg, keys, qs, ts, **kw)
    thr = _frontend_run(cfg, keys, qs, ts, admission="threaded", **kw)
    assert ser.stats.adaptive_tightened > 0
    assert thr.stats.adaptive_tightened == ser.stats.adaptive_tightened
    _assert_same_serve(ser, thr)

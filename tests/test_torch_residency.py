"""repro_torch's bounded residency against the JAX package and its own
dense engine.

* The port's resident run equals the JAX package's resident run in exact
  mode for all five policies: z, p and lam_hat bitwise, features within 1
  ulp (the reference's own bound across its schedules), store bytes equal.
* Inside the port the resident run equals the dense run bitwise (decisions,
  features, store bytes), in exact and in fast mode: the decisions read
  the global ids, and the fast fold adds each key's lanes in lane order
  whatever row the key lives on.
* Evict -> rehydrate is bit-exact; a superset budget reproduces the dense
  state row for row; oversized flush groups split and stay exact; the L2
  tier answers rehydrations with zero durable gets.
* The port's copies of ``ResidencyMap``, ``split_oversized_group`` and
  ``HostL2Cache`` behave as the JAX package's tests pin them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.streaming.persistence import \
    WriteBehindSink as JaxSink                               # noqa: E402
from repro.streaming.residency import \
    ResidencyMap as JaxMap                                   # noqa: E402
from repro_torch.core import EngineConfig, init_state, run_stream  # noqa: E402
from repro_torch.core.stream import (hydrate_scatter,        # noqa: E402
                                     hydration_width, pack_hydration)
from repro_torch.streaming.kvstore import SerDe              # noqa: E402
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.residency import (EVICTION,       # noqa: E402
                                             HostL2Cache, ResidencyMap,
                                             split_oversized_group)

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
N_KEYS = 48
ROOT = np.asarray(jax.random.PRNGKey(7))


def _stream(n_events=480, n_keys=N_KEYS, seed=0, skew=1.1):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _rounds(keys, batch):
    return max(int(np.bincount(keys[i:i + batch]).max())
               for i in range(0, len(keys), batch))


def _kw(policy, keys, batch):
    # exact_rounds covers the stream's busiest key per batch: exact mode
    # drops a key's events beyond it, in both packages
    return dict(taus=(60.0, 3600.0), h=600.0, budget=0.002, alpha=1.0,
                policy=policy, fixed_rate=0.3, mu_tau_index=1,
                exact_rounds=_rounds(keys, batch))


def _contents(stores):
    merged = {}
    for s in stores:
        merged.update(s.data)
    return merged


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(kw, keys, qs, ts, *, batch, mode="exact", S=None, rmap=None,
         sink_group=1, sink=None, state=None, **sink_kw):
    """One port run on the CPU: dense (S None) or resident; returns
    (state, info, sink) with the sink flushed."""
    cfg = EngineConfig(**kw)
    sink = sink or WriteBehindSink(cfg, n_partitions=3, device="cpu",
                                   **sink_kw)
    res = rmap if rmap is not None else S
    if state is None:
        state = init_state(N_KEYS if res is None else
                           (rmap.n_slots if rmap is not None else S),
                           len(cfg.taus), device="cpu")
    state, info = run_stream(cfg, state, keys, qs, ts, batch=batch,
                             mode=mode, rng=ROOT, sink=sink, residency=res,
                             sink_group=sink_group)
    sink.flush()
    return state, info, sink


def _assert_same_run(a, b, bytes_a, bytes_b):
    for f in ("z", "p", "lam_hat", "features"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      _np(getattr(b, f)), err_msg=f)
    assert int(a.writes) == int(b.writes)
    assert set(bytes_a) == set(bytes_b)
    assert all(bytes_a[k] == bytes_b[k] for k in bytes_a)


# ----------------------------------------------------- against JAX
@pytest.mark.parametrize("policy", POLICIES)
def test_resident_exact_matches_jax_resident(policy):
    """Resident fraction 0.25, exact mode: the port's decisions and state
    bytes are the JAX package's, its features within 1 ulp."""
    keys, qs, ts = _stream()
    kw = _kw(policy, keys, 8)
    S = N_KEYS // 4
    jsink = JaxSink(jcore.EngineConfig(**kw), n_partitions=3)
    jmap = JaxMap(N_KEYS, S)
    _, ji = jcore.run_stream(jcore.EngineConfig(**kw),
                             jcore.init_state(S, 2), keys, qs, ts, batch=8,
                             mode="exact", rng=jax.random.PRNGKey(7),
                             sink=jsink, residency=jmap, sink_group=1)
    jsink.flush()
    rmap = ResidencyMap(N_KEYS, S)
    _, ti, sink = _run(kw, keys, qs, ts, batch=8, rmap=rmap)
    for f in ("z", "p", "lam_hat"):
        np.testing.assert_array_equal(_np(getattr(ti, f)),
                                      np.asarray(getattr(ji, f)), err_msg=f)
    np.testing.assert_array_max_ulp(_np(ti.features),
                                    np.asarray(ji.features), maxulp=1)
    assert int(ti.writes) == int(ji.writes) > 0
    assert rmap.stats.snapshot() == jmap.stats.snapshot()
    assert rmap.stats.evictions > 0
    j, t = _contents(jsink.stores), _contents(sink.stores)
    assert set(j) == set(t) and all(j[k] == t[k] for k in j)
    jsink.close()
    sink.close()


def test_pack_hydration_matches_jax():
    """The host arrays the hydration scatter takes are the JAX
    package's, value for value (padding lanes on slot n_slots)."""
    from repro.core.stream import pack_hydration as jax_pack
    from repro.streaming.kvstore import SerDe as JaxSerDe

    rng = np.random.default_rng(1)
    serde, jserde = SerDe(3), JaxSerDe(3)
    raw = [serde.pack(float(rng.uniform(0, 1e4)), float(rng.uniform(0, 9)),
                      rng.uniform(0, 5, (3, 3)).astype(np.float32),
                      float(rng.uniform(0, 9)), float(rng.uniform(0, 1e4)))
           for _ in range(5)]
    rows = [raw[0], None, raw[1], raw[2], None, raw[3], raw[4]]
    slots = np.asarray([6, 0, 3, 9, 2, 11, 5], np.int32)
    for width in (None, 16):
        got = pack_hydration(rows, slots, serde, 12, 3, width=width)
        want = jax_pack(rows, slots, jserde, 12, 3, width=width)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert hydration_width(7) == 8 and hydration_width(0) == 1
    assert got[0].shape == (16,) and (got[0][7:] == 12).all()


def test_hydrate_scatter_drops_the_padding_lanes():
    """torch has no drop mode: the scatter takes the first m lanes and
    never touches the out-of-range padding slot."""
    st = init_state(4, 2, device="cpu")
    slots = torch.tensor([2, 0, 4, 4], dtype=torch.int64)
    scal = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    agg = torch.ones(4, 2, 3)
    hydrate_scatter(st, slots, scal, agg, 2)
    assert st.last_t.tolist()[:3] == [1.0, float("-inf"), 0.0]
    assert st.v_full.tolist() == [9.0, 0.0, 8.0, 0.0]
    assert st.agg[[0, 2]].eq(1).all() and st.agg[[1, 3]].eq(0).all()


# ------------------------------------------------- inside the port
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("policy", POLICIES)
def test_resident_equals_dense(policy, mode):
    """Resident fraction 0.25 reproduces the port's dense run bitwise:
    decisions, features and stored bytes."""
    keys, qs, ts = _stream()
    kw = _kw(policy, keys, 8)
    _, info_d, sink_d = _run(kw, keys, qs, ts, batch=8, mode=mode)
    rmap = ResidencyMap(N_KEYS, N_KEYS // 4)
    _, info_r, sink_r = _run(kw, keys, qs, ts, batch=8, mode=mode,
                             rmap=rmap)
    assert rmap.stats.evictions > 0
    _assert_same_run(info_d, info_r, _contents(sink_d.stores),
                     _contents(sink_r.stores))
    sink_d.close()
    sink_r.close()


def test_evict_rehydrate_roundtrip_is_bit_exact():
    """Slots are recycled hard, yet every resident key's persisted row
    equals the dense engine's row for that key."""
    keys, qs, ts = _stream(n_events=1200)
    kw = _kw("pp", keys, 8)
    st_d, _, sink_d = _run(kw, keys, qs, ts, batch=8)
    rmap = ResidencyMap(N_KEYS, N_KEYS // 4)
    st_r, _, sink_r = _run(kw, keys, qs, ts, batch=8, rmap=rmap)
    assert rmap.stats.evictions > 0
    assert rmap.stats.misses > rmap.n_slots     # keys were rehydrated
    for k in rmap.resident_keys():
        s = int(rmap.slot_of_key[k])
        for f in ("last_t", "v_f", "agg"):
            np.testing.assert_array_equal(_np(getattr(st_r, f))[s],
                                          _np(getattr(st_d, f))[int(k)],
                                          err_msg=f"{f}[{k}]")
    sink_d.close()
    sink_r.close()


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_superset_budget_matches_dense_state_exactly(mode):
    """S >= num_entities: nothing is evicted and the whole state, control
    column included, is the dense state row-permuted by the slot table."""
    keys, qs, ts = _stream()
    kw = _kw("pp", keys, 64)
    st_d, _, sink_d = _run(kw, keys, qs, ts, batch=64, mode=mode)
    rmap = ResidencyMap(N_KEYS, N_KEYS)
    st_r, _, sink_r = _run(kw, keys, qs, ts, batch=64, mode=mode,
                           rmap=rmap, sink_group=4)
    assert rmap.stats.evictions == 0
    ks = np.sort(rmap.resident_keys())
    perm = rmap.slot_of_key[ks]
    for f in st_r._fields:
        np.testing.assert_array_equal(_np(getattr(st_r, f))[perm],
                                      _np(getattr(st_d, f))[ks], err_msg=f)
    sink_d.close()
    sink_r.close()


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_oversized_groups_split_and_stay_bit_exact(mode):
    """A budget below every flush group's distinct-key count: the driver
    splits (priority eviction, L2 tier on) and stays dense-exact."""
    keys, qs, ts = _stream(n_events=900)
    kw = _kw("pp", keys, 8)
    _, info_d, sink_d = _run(kw, keys, qs, ts, batch=8, mode=mode)
    rmap = ResidencyMap(N_KEYS, 5, eviction="priority")
    _, info_r, sink_r = _run(kw, keys, qs, ts, batch=8, mode=mode,
                             rmap=rmap, sink_group=2, l2=True)
    assert rmap.stats.splits > 0
    _assert_same_run(info_d, info_r, _contents(sink_d.stores),
                     _contents(sink_r.stores))
    assert sink_r.snapshot()["l2_demotions"] > 0
    sink_d.close()
    sink_r.close()


def test_rehydrate_from_l2_issues_zero_durable_reads():
    """Evict -> demote -> rehydrate: a second pass over seen keys is served
    from host RAM (durable gets do not move) and stays dense-exact."""
    keys1, qs1, ts1 = _stream(n_events=480)
    rng = np.random.default_rng(42)
    keys2 = rng.permutation(keys1)       # same key set: all re-touches
    qs2 = rng.lognormal(3.0, 1.0, 480).astype(np.float32)
    ts2 = (ts1[-1] + np.cumsum(rng.exponential(20.0, 480))) \
        .astype(np.float32)
    cat = np.concatenate
    kw = _kw("pp", cat([keys1, keys2]), 8)
    _, info_d, sink_d = _run(kw, cat([keys1, keys2]), cat([qs1, qs2]),
                             cat([ts1, ts2]), batch=8)
    rmap = ResidencyMap(N_KEYS, 8)
    st, info_1, sink = _run(kw, keys1, qs1, ts1, batch=8, rmap=rmap, l2=True)
    snap1 = sink.snapshot()
    assert rmap.stats.evictions > 0 and snap1["l2_demotions"] > 0
    assert snap1["gets"] > 0
    _, info_2, _ = _run(kw, keys2, qs2, ts2, batch=8, rmap=rmap, sink=sink,
                        state=st)
    snap2 = sink.snapshot()
    assert snap2["gets"] == snap1["gets"]           # zero durable reads
    assert snap2["l2_hits"] > snap1["l2_hits"]
    np.testing.assert_array_equal(cat([_np(info_1.z), _np(info_2.z)]),
                                  _np(info_d.z))
    np.testing.assert_array_equal(
        cat([_np(info_1.features), _np(info_2.features)]),
        _np(info_d.features))
    d, r = _contents(sink_d.stores), _contents(sink.stores)
    assert set(d) == set(r) and all(d[k] == r[k] for k in d)
    sink_d.close()
    sink.close()


def test_continuation_from_store_is_cold_start_hydration():
    """A crash after half the stream: a fresh slot state over the
    surviving stores continues bit-identically to an uninterrupted run."""
    keys, qs, ts = _stream(n_events=800)
    half = 400
    kw = _kw("pp", keys, 8)
    _, info_full, sink_full = _run(kw, keys, qs, ts, batch=8)
    _, _, sink_a = _run(kw, keys[:half], qs[:half], ts[:half], batch=8)
    _, info_b, _ = _run(kw, keys[half:], qs[half:], ts[half:], batch=8,
                        S=N_KEYS // 4, sink=sink_a)
    np.testing.assert_array_equal(_np(info_full.z)[half:], _np(info_b.z))
    np.testing.assert_array_equal(_np(info_full.features)[half:],
                                  _np(info_b.features))
    d, r = _contents(sink_full.stores), _contents(sink_a.stores)
    assert set(d) == set(r) and all(d[k] == r[k] for k in d)
    sink_full.close()
    sink_a.close()


@pytest.mark.parametrize("collect_info", [True, False])
def test_resident_write_counts_match_dense(collect_info):
    keys, qs, ts = _stream(n_events=300)
    kw = _kw("pp", keys, 8)
    cfg = EngineConfig(**kw)
    outs = []
    for res in (None, 6):
        sink = WriteBehindSink(cfg, n_partitions=3, device="cpu")
        st = init_state(res or N_KEYS, 2, device="cpu")
        _, out = run_stream(cfg, st, keys, qs, ts, batch=8, mode="fast",
                            rng=ROOT, sink=sink, residency=res,
                            sink_group=3, collect_info=collect_info)
        sink.close()
        outs.append(out.z if collect_info else out)
    assert torch.equal(*outs)


def test_residency_requires_sink_and_matching_state():
    keys, qs, ts = _stream(n_events=64)
    cfg = EngineConfig(taus=(60.0, 3600.0))
    with pytest.raises(ValueError, match="sink"):
        run_stream(cfg, init_state(8, 2, device="cpu"), keys, qs, ts,
                   batch=8, residency=8)
    with WriteBehindSink(cfg, device="cpu") as sink:
        with pytest.raises(ValueError, match="slots"):
            run_stream(cfg, init_state(N_KEYS, 2, device="cpu"), keys, qs,
                       ts, batch=8, mode="fast", sink=sink, residency=8)


# ------------------------------------------- the copied host plane
def test_map_assigns_hits_and_misses():
    m = ResidencyMap(16, 4)
    a = m.assign_group([3, 5, 3, 7])
    assert a.miss_keys.tolist() == [3, 5, 7] and a.hits == 0
    assert a.slot[0] == a.slot[2] != a.slot[1]
    b = m.assign_group([5, 7, 9])
    assert b.hits == 2 and b.miss_keys.tolist() == [9]
    assert m.resident == 4 and m.stats.hit_rate() == pytest.approx(2 / 6)


def test_map_second_chance_and_fifo():
    m = ResidencyMap(16, 3)
    m.assign_group([0, 1, 2])
    m.assign_group([1, 2])
    assert m.assign_group([3]).evicted.tolist() == [0]
    assert sorted(m.resident_keys().tolist()) == [1, 2, 3]
    m = ResidencyMap(16, 3, eviction="fifo")
    m.assign_group([0, 1, 2])
    m.assign_group([0])
    assert m.assign_group([3]).evicted.tolist() == [0]


def test_map_pins_current_group_and_raises_on_capacity():
    m = ResidencyMap(16, 3)
    m.assign_group([0, 1, 2])
    assert m.assign_group([0, 1, 3]).evicted.tolist() == [2]
    with pytest.raises(ValueError, match="distinct keys"):
        m.assign_group([4, 5, 6, 7])
    assert sorted(m.resident_keys().tolist()) == [0, 1, 3]
    with pytest.raises(ValueError, match="eviction"):
        ResidencyMap(4, 2, eviction="lru")
    m = ResidencyMap(32, 4)
    m.assign_group([0, 1])
    with pytest.raises(ValueError,
                       match=r"flush group 1 holds 6 distinct keys"):
        m.assign_group([2, 3, 4, 5, 6, 7])


def test_map_valid_mask_excludes_padding():
    m = ResidencyMap(16, 2)
    a = m.assign_group([3, 9, 9], valid=[True, False, False])
    assert a.miss_keys.tolist() == [3] and m.resident == 1
    assert a.slot[0] == m.slot_of_key[3]


def test_priority_eviction_is_cost_aware():
    m = ResidencyMap(64, 3, eviction="priority")
    m.assign_group([0, 1, 2])
    assert m.assign_group([3]).evicted.tolist() == [0]
    assert sorted(m.assign_group([0, 4]).evicted.tolist()) == [1, 2]
    assert m.assign_group([5]).evicted.tolist() == [3]
    assert m.assign_group([6]).evicted.tolist() == [4]
    assert 0 in m.resident_keys().tolist()


@pytest.mark.parametrize("eviction", EVICTION)
def test_map_matches_jax_map_decision_for_decision(eviction):
    """The copy takes the JAX map's decisions: slots, misses, first
    touches and victims, group after group, serial and batch take."""
    rng = np.random.default_rng(5)
    for batch_take in (False, True):
        a, b = ResidencyMap(40, 7, eviction), JaxMap(40, 7, eviction)
        for _ in range(60):
            g = rng.integers(0, 40, rng.integers(1, 12))
            v = rng.random(g.size) < 0.9
            if len(np.unique(g[v])) > 7:
                continue
            ra = a.assign_group(g, v, batch_take=batch_take)
            rb = b.assign_group(g, v, batch_take=batch_take)
            for x, y in zip(ra, rb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert a.stats.snapshot() == b.stats.snapshot()


def test_split_oversized_group_is_key_complete():
    keys = np.asarray([7, 1, 7, 2, 3, 1, 4, 5, 7, 6])
    valid = np.ones(10, bool)
    masks = split_oversized_group(keys, valid, 3)
    assert len(masks) == 3
    np.testing.assert_array_equal(sum(m.astype(int) for m in masks),
                                  valid.astype(int))
    for m in masks:
        for k in set(keys[m].tolist()):
            assert np.array_equal(np.nonzero(keys == k)[0],
                                  np.nonzero(m & (keys == k))[0])
    assert [set(keys[m].tolist()) for m in masks] == [{7, 1, 2}, {3, 4, 5},
                                                      {6}]
    keys = np.asarray([0, 1, 0, 9])
    valid = np.asarray([True, True, True, False])
    (only,) = split_oversized_group(keys, valid, 2)
    np.testing.assert_array_equal(only, valid)
    assert not any(m[3] for m in split_oversized_group(keys, valid, 1))
    with pytest.raises(ValueError, match="positive"):
        split_oversized_group(keys, valid, 0)


def test_l2_cache_rows_absence_and_demote():
    l2 = HostL2Cache(capacity=1)
    l2.put_rows([1], [b"row-1"])
    l2.put_rows([2], [b"row-2"])          # capacity 1: row-1 LRU'd out
    l2.demote([1])                        # must not invent an absence
    rows, hit = l2.probe([1])
    assert not hit[0] and rows[0] is None
    l2 = HostL2Cache()
    l2.fill_from_read([5], [None])
    l2.put_rows([5], [b"flushed"])
    l2.fill_from_read([5], [None])        # a stale read never clobbers
    rows, hit = l2.probe([5])
    assert hit[0] and rows[0] == b"flushed"

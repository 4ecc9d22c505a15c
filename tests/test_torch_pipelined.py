"""repro_torch's pipelined plane: depth 2 must change no bits.

``run_stream(pipeline_depth=2)`` moves group planning, hydration reads and
packing onto a prep thread and orders rehydrations through the sink's
epoch-gated read lane.  Equality with the serial driver — z/p/lam/features
and the stored bytes — is the test of every ordering invariant (per-key
FIFO, evict -> rehydrate reading the latest durable row): a violation
changes stored bytes or features.  On the CPU the staging is plain host
tensors; the card's asynchronous copies are held by the CUDA tests.
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
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.residency import ResidencyMap     # noqa: E402

N_KEYS = 96
POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
ROOT = np.asarray(jax.random.PRNGKey(7))


def _stream(n_events=384, n_keys=N_KEYS, seed=0, skew=1.2):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _kw(policy):
    return dict(taus=(60.0, 3600.0), h=600.0, budget=0.002, alpha=1.0,
                policy=policy, fixed_rate=0.3, mu_tau_index=1,
                exact_rounds=16)


def _stored(sink):
    sink.flush()
    merged = {}
    for s in sink.stores:
        merged.update(s.data)
    return merged


def _run(kw, keys, qs, ts, *, mode, depth, batch=16, sink_group=3,
         n_slots=None, l2=None):
    """One port run on the CPU; returns (info, stored bytes, sink, rmap)."""
    cfg = EngineConfig(**kw)
    sink = WriteBehindSink(cfg, n_partitions=3, l2=l2, device="cpu")
    rmap = ResidencyMap(N_KEYS, n_slots) if n_slots is not None else None
    state = init_state(n_slots or N_KEYS, len(cfg.taus), device="cpu")
    _, info = run_stream(cfg, state, keys, qs, ts, batch=batch, mode=mode,
                         rng=ROOT, sink=sink, sink_group=sink_group,
                         residency=rmap, pipeline_depth=depth)
    return info, _stored(sink), sink, rmap


def _assert_bit_equal(a, b):
    for f in ("z", "p", "lam_hat", "features"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert int(a.writes) == int(b.writes)


def test_pipeline_depth_validation():
    keys, qs, ts = _stream(32)
    cfg = EngineConfig(**_kw("pp"))
    st = lambda n: init_state(n, 2, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        run_stream(cfg, st(N_KEYS), keys, qs, ts, batch=8, pipeline_depth=0)
    with pytest.raises(ValueError, match="requires a sink"):
        run_stream(cfg, st(N_KEYS), keys, qs, ts, batch=8, pipeline_depth=2)
    # residency pipelining needs the epoch lane's store workers ...
    with WriteBehindSink(cfg, queue_depth=0, device="cpu") as sink:
        with pytest.raises(ValueError, match="threaded sink"):
            run_stream(cfg, st(16), keys, qs, ts, batch=8, sink=sink,
                       residency=ResidencyMap(N_KEYS, 16), pipeline_depth=2)
    # ... and pure backpressure (no inline flush on the dispatch thread)
    with WriteBehindSink(cfg, overflow="degrade-to-serial",
                         device="cpu") as sink:
        with pytest.raises(ValueError, match="block"):
            run_stream(cfg, st(16), keys, qs, ts, batch=8, sink=sink,
                       residency=ResidencyMap(N_KEYS, 16), pipeline_depth=2)


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("policy", POLICIES)
def test_pipelined_sink_parity(policy, mode):
    """Dense pipelined driver == serial driver, outputs and stored bytes."""
    keys, qs, ts = _stream()
    a, sa, ska, _ = _run(_kw(policy), keys, qs, ts, mode=mode, depth=1)
    b, sb, skb, _ = _run(_kw(policy), keys, qs, ts, mode=mode, depth=2)
    _assert_bit_equal(a, b)
    assert sa == sb and len(sa) > 0
    ska.close(), skb.close()


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("policy", POLICIES)
def test_pipelined_residency_parity(policy, mode):
    """Residency pipelined == serial, with the L2 tier on and oversized
    flush groups forced to split (16 slots vs up to 48 distinct keys a
    group): the whole state hierarchy under overlap."""
    keys, qs, ts = _stream()
    a, sa, ska, rma = _run(_kw(policy), keys, qs, ts, mode=mode, depth=1,
                           n_slots=16, l2=24)
    b, sb, skb, rmb = _run(_kw(policy), keys, qs, ts, mode=mode, depth=2,
                           n_slots=16, l2=24)
    _assert_bit_equal(a, b)
    assert sa == sb
    assert rma.stats.splits > 0 and rmb.stats.splits > 0
    assert rma.stats.snapshot() == rmb.stats.snapshot()
    st = skb.stats
    assert st.epochs_staged > 0 and st.staged_reads > 0
    ska.close(), skb.close()


def test_pipelined_residency_bytes_equal_jax_serial():
    """The port at depth 2 stores the JAX package's serial bytes."""
    keys, qs, ts = _stream()
    kw = _kw("pp_vr")
    jsink = JaxSink(jcore.EngineConfig(**kw), n_partitions=3, l2=24)
    _, ji = jcore.run_stream(jcore.EngineConfig(**kw),
                             jcore.init_state(16, 2), keys, qs, ts,
                             batch=16, mode="exact",
                             rng=jax.random.PRNGKey(7), sink=jsink,
                             sink_group=3, residency=JaxMap(N_KEYS, 16))
    info, stored, sink, _ = _run(kw, keys, qs, ts, mode="exact", depth=2,
                                 n_slots=16, l2=24)
    np.testing.assert_array_equal(info.z.numpy(), np.asarray(ji.z))
    np.testing.assert_array_equal(info.p.numpy(), np.asarray(ji.p))
    assert stored == _stored(jsink)
    jsink.close(), sink.close()


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_epoch_lane_parks_and_drains(depth):
    """Under overlap some staged reads arrive before their epoch's flush
    has landed: they park and drain, and the overlap meter records the
    host and device channels."""
    keys, qs, ts = _stream(n_events=512, skew=0.6)   # flat -> heavy churn
    a, sa, ska, _ = _run(_kw("pp"), keys, qs, ts, mode="fast", depth=1,
                         n_slots=16, sink_group=1)
    b, sb, skb, _ = _run(_kw("pp"), keys, qs, ts, mode="fast", depth=depth,
                         n_slots=16, sink_group=1)
    _assert_bit_equal(a, b)
    assert sa == sb
    st = skb.stats
    assert st.epochs_staged > 0 and st.parked_reads > 0
    snap = skb.snapshot()
    assert snap["host_pack_s"] > 0.0 and snap["device_wait_s"] >= 0.0
    for col in ("overlap_s", "overlap_frac", "staged_reads"):
        assert col in snap
    ska.close(), skb.close()


@pytest.mark.parametrize("collect_info", [True, False])
def test_pipelined_collect_info_off(collect_info):
    """Without per-event info the drivers return the per-block write
    counts, equal at both depths (split groups' counts summed)."""
    keys, qs, ts = _stream()
    cfg = EngineConfig(**_kw("pp"))
    outs = []
    for depth in (1, 2):
        sink = WriteBehindSink(cfg, n_partitions=3, device="cpu")
        _, out = run_stream(cfg, init_state(16, 2, device="cpu"), keys, qs,
                            ts, batch=16, mode="fast", rng=ROOT, sink=sink,
                            sink_group=3, residency=ResidencyMap(N_KEYS, 16),
                            pipeline_depth=depth,
                            collect_info=collect_info)
        sink.close()
        outs.append(out.writes if collect_info else out)
    assert torch.equal(*outs)


def test_pipelined_error_in_prep_surfaces():
    """A failing plan on the prep thread raises on the caller's thread
    and shuts the pipeline down."""
    keys, qs, ts = _stream()
    cfg = EngineConfig(**_kw("pp"))
    sink = WriteBehindSink(cfg, n_partitions=3, device="cpu")
    rmap = ResidencyMap(8, 16)          # too few keys: the plan indexes out
    with pytest.raises(IndexError):
        run_stream(cfg, init_state(16, 2, device="cpu"), keys, qs, ts,
                   batch=16, mode="fast", rng=ROOT, sink=sink,
                   residency=rmap, pipeline_depth=2)
    sink.close()


def _check_batch_take(groups, n_slots=12, num_keys=32):
    """Vectorized victim take == per-miss serial take, decision for
    decision, on the port's copy of the map."""
    a = ResidencyMap(num_keys, n_slots)
    b = ResidencyMap(num_keys, n_slots)
    for g in groups:
        g = np.asarray(g, np.int64)
        ra = a.assign_group(g, batch_take=False)
        rb = b.assign_group(g, batch_take=True)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert np.array_equal(a.slot_of_key, b.slot_of_key)
    assert np.array_equal(a.key_of_slot, b.key_of_slot)


@pytest.mark.parametrize("groups,n_slots", [
    ([[0, 1, 2, 3], [4, 5], [0, 6], [7] * 3], 12),
    ([list(range(10)), [10, 11], [0, 1, 12], [3, 13, 14, 15],
      list(range(16, 26))], 12),
    ([[31], [30], [29], [28]], 2)])
def test_batch_take_equivalence(groups, n_slots):
    _check_batch_take(groups, n_slots=n_slots)


def test_pipelined_parity_under_fast_thread_switching():
    """The prep, dispatch and sink threads interleaved as finely as the
    interpreter allows: depth 3 with splits and rehydrations still equals
    the serial driver."""
    import sys

    keys, qs, ts = _stream(n_events=256, skew=0.8)
    a, sa, ska, _ = _run(_kw("pp"), keys, qs, ts, mode="fast", depth=1,
                         n_slots=12, sink_group=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        b, sb, skb, rmb = _run(_kw("pp"), keys, qs, ts, mode="fast",
                               depth=3, n_slots=12, sink_group=2)
    finally:
        sys.setswitchinterval(old)
    _assert_bit_equal(a, b)
    assert sa == sb and rmb.stats.splits > 0
    ska.close(), skb.close()

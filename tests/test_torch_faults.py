"""repro_torch's fault-injection harness: torn tails, bit flips, transient
and exhausted retries, the overflow stall, and the SIGKILL matrix.

The twin of the ``faults`` tests of ``tests/test_durable.py`` and
``tests/test_storage_plane.py``, driven through the port's
``streaming.faults`` and the port's engine on the CPU:

* **Failure classification** — a torn tail is repaired, a bit flip raises
  ``CorruptionError``, a transient ``OSError`` is retried by the port's
  sink with no data loss, exhaustion surfaces on the next ``flush``, a
  stalled store degrades to inline flushes.
* **The headline contract** — the port's victim
  (``python -m repro_torch.streaming.faults --device cpu``) is SIGKILLed
  mid-WAL-append (inline compaction) or mid-segment-build (background
  compaction); the recovered store equals the port's ``run_reference``
  over the acknowledged prefix byte for byte, for all five policies in
  both modes.  Against the JAX ``run_reference``: byte for byte in exact
  mode; in fast mode the fold rounds in another order, so the same keys
  are stored and the hydrated state is held to rtol 1e-5 (the port's
  fast-mode bound, ``tests/test_torch_engine.py``).
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.streaming import faults as jfaults                # noqa: E402
from repro.streaming.persistence import \
    hydrate_state as jax_hydrate_state                       # noqa: E402
from repro_torch.core import (EngineConfig, init_state,      # noqa: E402
                              prng_key, run_stream)
from repro_torch.streaming import faults                     # noqa: E402
from repro_torch.streaming.durable import (CorruptionError,  # noqa: E402
                                           DurableStore, HEADER_BYTES,
                                           IDX_SUFFIX, WAL_NAME)
from repro_torch.streaming.kvstore import SerDe              # noqa: E402
from repro_torch.streaming.persistence import (RetryPolicy,  # noqa: E402
                                               WriteBehindSink,
                                               hydrate_state)

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
CPU = "cpu"


def _cfg(policy):
    return EngineConfig(taus=(60.0, 3600.0), h=600.0, budget=0.002,
                        alpha=1.0, policy=policy, fixed_rate=0.3,
                        mu_tau_index=1, exact_rounds=64)


def _stream(n_events=1200, n_keys=48, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n_events).astype(np.int32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    return keys, qs, ts


def _wal(path):
    return os.path.join(str(path), WAL_NAME)


# -------------------------------------------------- failure classification
@pytest.mark.parametrize("cut", ["header", "body", "footer"])
def test_torn_tail_repaired(tmp_path, cut):
    d = str(tmp_path / "s")
    with DurableStore(d) as s:
        s.multi_put([1], [b"first"])
        base = os.path.getsize(_wal(d))
        s.multi_put([2], [b"second" * 10])
        total = os.path.getsize(_wal(d))
    at = {"header": base + HEADER_BYTES - 2,
          "body": base + HEADER_BYTES + 3,
          "footer": total - 2}[cut]
    faults.truncate_at(_wal(d), at)
    with DurableStore(d) as r:
        # batch 1 survives, the torn batch 2 is dropped and the file
        # repaired by truncation — appends work again afterwards
        assert r.data == {1: b"first"}
        assert r.durable.torn_tails == 1
        assert r.durable.torn_bytes_dropped == at - base
        assert os.path.getsize(_wal(d)) == base
        r.multi_put([2], [b"again"])
    with DurableStore(d) as r2:
        assert r2.data == {1: b"first", 2: b"again"}
        assert r2.durable.torn_tails == 0


@pytest.mark.parametrize("where", ["header", "payload"])
def test_bitflip_raises_corruption(tmp_path, where):
    d = str(tmp_path / "s")
    with DurableStore(d) as s:
        s.multi_put([1, 2], [b"aaaa", b"bbbb"])
    off = {"header": 2, "payload": HEADER_BYTES + 6}[where]
    faults.flip_bit(_wal(d), off, bit=3)
    with pytest.raises(CorruptionError):
        DurableStore(d)


def test_segment_bitflip_raises_corruption(tmp_path):
    d = str(tmp_path / "s")
    with DurableStore(d, compact_threshold_bytes=1 << 30) as s:
        s.multi_put([1], [b"payload-bytes"])
        s.compact()
        seg = [f for f in os.listdir(d) if f.endswith(".seg")][0]
    faults.flip_bit(os.path.join(d, seg), HEADER_BYTES + 8, bit=1)
    with pytest.raises(CorruptionError):
        DurableStore(d)


def test_bloom_trailer_damage_falls_back_to_eager(tmp_path):
    """A bit flip in the sidecar's bloom trailer demotes the lazy reopen
    to an eager full replay (counted), never an error or a wrong answer."""
    d = str(tmp_path / "s")
    want = {k: b"v" * 4 for k in range(64)}
    with DurableStore(d, seg_block_rows=8, bloom_bits_per_key=10) as s:
        s.multi_put(list(want), list(want.values()))
        s.compact()
    idx = [os.path.join(d, f) for f in os.listdir(d)
           if f.endswith(IDX_SUFFIX)]
    assert len(idx) == 1
    faults.flip_bit(idx[0], os.path.getsize(idx[0]) - 3, bit=2)
    with DurableStore(d, seg_block_rows=8, lazy_recovery=True) as r:
        assert r.durable.index_fallbacks == 1
        assert r.data == want


def test_failure_atomic_append_then_retry(tmp_path):
    """A transient write error leaves the WAL at its pre-batch length, so
    the same ``multi_put`` can simply be issued again — no torn record
    mid-file, no double apply."""
    d = str(tmp_path / "s")
    fops = faults.FaultyFileOps(faults.FaultPlan(transient_at=frozenset({2})))
    s = DurableStore(d, fileops=fops)
    s.multi_put([1], [b"one"])
    size = os.path.getsize(_wal(d))
    with pytest.raises(OSError):
        s.multi_put([2], [b"two"])
    assert os.path.getsize(_wal(d)) == size       # failure-atomic
    assert 2 not in s.data                        # applied only when durable
    s.multi_put([2], [b"two"])                    # the retry
    s.close()
    with DurableStore(d) as r:
        assert r.data == {1: b"one", 2: b"two"}


def test_transient_faults_retried_no_data_loss(tmp_path):
    """Injected transient OSErrors on WAL appends under the port's engine
    and sink: the backoff retry completes the run and the durable
    contents equal a clean run's."""
    keys, qs, ts = _stream(n_events=800)
    cfg = _cfg("pp")
    root = prng_key(1)

    clean = WriteBehindSink(cfg, n_partitions=1, backend="durable",
                            store_dir=str(tmp_path / "clean"), device=CPU)
    run_stream(cfg, init_state(48, 2, device=CPU), keys, qs, ts, batch=128,
               mode="fast", rng=root, sink=clean, sink_group=1)
    clean.flush()

    # sink_group=1: one WAL append per block (7 for 800 events @ 128), so
    # transient_every=3 demonstrably fires more than once
    fops = faults.FaultyFileOps(faults.FaultPlan(transient_every=3))
    faulty_store = DurableStore(str(tmp_path / "faulty"), fileops=fops)
    faulty = WriteBehindSink(cfg, stores=[faulty_store],
                             retry=RetryPolicy(base_s=1e-4), device=CPU)
    run_stream(cfg, init_state(48, 2, device=CPU), keys, qs, ts, batch=128,
               mode="fast", rng=root, sink=faulty, sink_group=1)
    snap = faulty.flush()

    assert fops.injected_transients > 0
    assert snap["retries"] == snap["transient_errors"] \
        == fops.injected_transients
    assert snap["flush_errors"] == 0
    assert snap["retry_wait_s"] > 0.0
    assert faulty_store.data == clean.stores[0].data   # zero data loss
    clean.close()
    faulty.close()
    faulty_store.close()


def test_retry_exhaustion_surfaces_promptly(tmp_path):
    fops = faults.FaultyFileOps(faults.FaultPlan(fail_always=True))
    store = DurableStore(str(tmp_path / "s"), fileops=fops)
    sink = WriteBehindSink(_cfg("unfiltered"), stores=[store],
                           retry=RetryPolicy(retries=2, base_s=1e-4),
                           device=CPU)
    B = 8
    rows = (np.zeros((4, B), np.float32), np.zeros((B, 2, 3), np.float32))
    sink.submit(np.arange(B), np.ones(B, bool), np.ones(B, bool), rows)
    with pytest.raises(RuntimeError, match="write-behind flush failed"):
        sink.flush()                       # a single flush() suffices
    assert fops.injected_transients == 3   # initial try + 2 retries
    assert sink.stats.flush_errors == 1
    sink.close()


def test_overflow_degrades_to_serial_under_stall(tmp_path):
    """A stalled store with overflow='degrade-to-serial': the driver
    drains and flushes inline instead of blocking behind the full queue;
    ordering (last-write-wins) is preserved."""
    fops = faults.FaultyFileOps(faults.FaultPlan(stall_s=0.03))
    store = DurableStore(str(tmp_path / "s"), fileops=fops)
    sink = WriteBehindSink(_cfg("unfiltered"), stores=[store],
                           queue_depth=1, overflow="degrade-to-serial",
                           device=CPU)
    B = 8
    for i in range(6):
        rows = (np.full((4, B), float(i), np.float32),
                np.zeros((B, 2, 3), np.float32))
        sink.submit(np.arange(B), np.ones(B, bool), np.ones(B, bool), rows)
    snap = sink.flush()
    assert snap["degraded_flushes"] >= 1
    assert len(store.data) == B
    # last submit wins on every key
    lt, *_ = SerDe(2).unpack_rows([store.data[k] for k in range(B)])
    np.testing.assert_array_equal(lt, np.full(B, 5.0))
    sink.close()
    store.close()


# ------------------------------------------------ the crash protocol
def test_crash_protocol_matches_the_reference_package():
    """Both packages regenerate the same stream and config from the seed:
    the victim and either reference see identical events."""
    for n in (256, 1024, faults.CRASH_MAX_EVENTS):
        for a, b in zip(faults.crash_stream(n, seed=3),
                        jfaults.crash_stream(n, seed=3)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg, jcfg = faults.crash_cfg("pp_vr"), jfaults.crash_cfg("pp_vr")
    for f in ("taus", "h", "budget", "alpha", "policy", "fixed_rate",
              "mu_tau_index", "min_p", "exact_rounds"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    with pytest.raises(ValueError, match="chunk"):
        faults.run_reference("pp", "exact", 100, device=CPU)


def test_victim_without_a_card_fails_instead_of_falling_back(tmp_path):
    """The victim's default device is the card: without one it must die
    before its first ACK, never run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "victim on it")
    rc, acked, err = faults.spawn_kill_mid_flush(
        str(tmp_path / "victim"), policy="pp", mode="exact",
        kill_at_write=2)
    assert rc not in (0, -signal.SIGKILL) and acked == 0
    assert "device='cpu'" in err


def _assert_matches_references(rec, policy, mode, n_events):
    """``rec`` (a recovered store) against the port's reference (bytes)
    and the JAX one (bytes in exact mode; keys and the hydrated state
    within rtol 1e-5 in fast mode)."""
    ref = faults.run_reference(policy, mode, n_events, device=CPU)
    assert set(rec.data) == set(ref.data)
    bad = [k for k in rec.data if rec.data[k] != ref.data[k]]
    assert not bad, f"{len(bad)} rows differ after recovery: {bad[:5]}"
    h_rec = hydrate_state([rec], faults.CRASH_N_KEYS, 2, device=CPU)
    h_ref = hydrate_state([ref], faults.CRASH_N_KEYS, 2, device=CPU)
    for a, b, name in zip(h_rec, h_ref, h_rec._fields):
        assert torch.equal(a, b), name
    jref = jfaults.run_reference(policy, mode, n_events)
    assert set(rec.data) == set(jref.data)
    if mode == "exact":
        assert rec.data == jref.data
    else:
        h_j = jax_hydrate_state([jref], faults.CRASH_N_KEYS, 2)
        for a, b, name in zip(h_rec, h_j, h_rec._fields):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("policy", POLICIES)
def test_kill_mid_flush_bit_exact(tmp_path, policy, mode):
    """SIGKILL mid-WAL-append, recover from disk, compare against an
    uninterrupted run over the acknowledged prefix."""
    d = str(tmp_path / "victim")
    rc, acked, err = faults.spawn_kill_mid_flush(
        d, policy=policy, mode=mode, kill_at_write=3, device=CPU)
    assert rc == -signal.SIGKILL, f"victim exited {rc}: {err[-2000:]}"
    assert acked > 0, f"victim never ACKed: {err[-2000:]}"
    with DurableStore(d) as rec:
        assert rec.durable.torn_tails == 1        # the SIGKILL's torn tail
        _assert_matches_references(rec, policy, mode, acked)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("policy", POLICIES)
def test_kill_mid_background_compaction_bit_exact(tmp_path, policy, mode):
    """SIGKILL the background compactor mid-segment-build (before the
    atomic rename), recover, and match an uninterrupted reference run
    over *some* whole-chunk prefix in ``[acked, n_chunks]``."""
    d = str(tmp_path / "victim")
    n_chunks = 6
    rc, acked, err = faults.spawn_kill_mid_flush(
        d, policy=policy, mode=mode, n_chunks=n_chunks,
        compaction="background", compact_threshold=2048,
        kill_at_seg_write=1, device=CPU)
    assert rc == -signal.SIGKILL, f"victim exited {rc}: {err[-2000:]}"
    chunk = faults.CRASH_BATCH * faults.CRASH_GROUP
    assert acked % chunk == 0

    # the kill landed mid-build: a torn unpublished segment and no
    # published one
    names = os.listdir(d)
    assert any(n.endswith(".seg.tmp") for n in names), names
    assert not any(n.endswith(".seg") for n in names), names

    with DurableStore(d) as rec:
        matched = None
        for k in range(acked // chunk, n_chunks + 1):
            ref = faults.run_reference(policy, mode, k * chunk, device=CPU)
            if rec.data == ref.data:
                matched = k
                break
        assert matched is not None, (
            f"recovered store matches no whole-chunk prefix in "
            f"[{acked // chunk}, {n_chunks}] (acked={acked})")
        _assert_matches_references(rec, policy, mode, matched * chunk)
    # the torn .tmp is gone after recovery (discarded, not absorbed)
    assert not any(n.endswith(".tmp") for n in os.listdir(d))

"""repro_torch's write-behind sink against the JAX package's sink.

For the same stream, policy, rng root and partitions, the port's
exact-mode sink stores the very bytes the JAX sink stores;
``hydrate_state`` rebuilds the in-memory state bit for bit; and the
durable backend lands the same bytes as the memory backend.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.streaming.persistence import \
    WriteBehindSink as JaxSink                               # noqa: E402
from repro_torch.core import EngineConfig, init_state, run_stream  # noqa: E402
from repro_torch.streaming.persistence import (WriteBehindSink,  # noqa: E402
                                               hydrate_state)

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
N_KEYS, BATCH, N_PARTS = 48, 256, 3


def _stream(n_events=1200, n_keys=N_KEYS, seed=0, skew=1.1):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_keys + 1) ** skew
    w /= w.sum()
    keys = rng.choice(n_keys, n_events, p=w).astype(np.int32)
    ts = np.cumsum(rng.exponential(20.0, n_events)).astype(np.float32)
    qs = rng.lognormal(3.0, 1.0, n_events).astype(np.float32)
    return keys, qs, ts


def _cfg_kw(policy, keys):
    rounds = max(int(np.bincount(keys[i:i + BATCH]).max())
                 for i in range(0, len(keys), BATCH))
    return dict(taus=(60.0, 3600.0), h=600.0, budget=0.002, alpha=1.0,
                policy=policy, fixed_rate=0.3, mu_tau_index=1,
                exact_rounds=rounds)


def _contents(stores):
    merged = {}
    for s in stores:
        merged.update(s.data)
    return merged


def _port_run(policy, keys, qs, ts, **sink_kw):
    kw = _cfg_kw(policy, keys)
    sink = WriteBehindSink(EngineConfig(**kw), n_partitions=N_PARTS,
                           device="cpu", **sink_kw)
    state, info = run_stream(EngineConfig(**kw),
                             init_state(N_KEYS, 2, device="cpu"), keys, qs,
                             ts, batch=BATCH, mode="exact",
                             rng=np.asarray(jax.random.PRNGKey(7)),
                             sink=sink)
    sink.flush()
    return sink, state, info


@pytest.mark.parametrize("policy", POLICIES)
def test_sink_bytes_identical_to_jax_sink(policy):
    keys, qs, ts = _stream()
    kw = _cfg_kw(policy, keys)
    jsink = JaxSink(jcore.EngineConfig(**kw), n_partitions=N_PARTS)
    _, jinfo = jcore.run_stream(jcore.EngineConfig(**kw),
                                jcore.init_state(N_KEYS, 2), keys, qs, ts,
                                batch=BATCH, mode="exact",
                                rng=jax.random.PRNGKey(7), sink=jsink)
    jsink.flush()
    sink, _, info = _port_run(policy, keys, qs, ts)
    want, got = _contents(jsink.stores), _contents(sink.stores)
    assert set(got) == set(want) and len(got) > 0
    bad = [k for k in got if got[k] != want[k]]
    assert not bad, f"{len(bad)} rows differ, e.g. key {bad[:3]}"
    # same partition of keys, too
    for js, ps in zip(jsink.stores, sink.stores):
        assert set(js.data) == set(ps.data)
    assert int(info.writes) == int(jinfo.writes)
    jsink.close()
    sink.close()


@pytest.mark.parametrize("policy", ["pp", "full"])
def test_hydrate_state_equals_memory_state(policy):
    keys, qs, ts = _stream()
    sink, state, _ = _port_run(policy, keys, qs, ts)
    hyd = hydrate_state(sink.stores, N_KEYS, 2, device="cpu")
    for f in ("last_t", "v_f", "agg"):
        assert torch.equal(getattr(hyd, f), getattr(state, f)), f
    if policy == "full":
        # full-stream policies persist the control column too
        assert torch.equal(hyd.v_full, state.v_full)
        assert torch.equal(hyd.last_t_full, state.last_t_full)
    else:
        # thinning policies restart the control estimate cold, by design
        assert float(hyd.v_full.sum()) == 0.0
    sink.close()


def test_durable_backend_stores_memory_bytes(tmp_path):
    keys, qs, ts = _stream(n_events=600)
    mem, _, _ = _port_run("pp_vr", keys, qs, ts)
    dur, _, _ = _port_run("pp_vr", keys, qs, ts, backend="durable",
                          store_dir=str(tmp_path))
    assert _contents(dur.stores) == _contents(mem.stores)
    assert dur.snapshot()["measured"]["fsyncs"] > 0
    mem.close()
    dur.close()


def test_sink_path_state_identical_to_dense_path():
    """The sink is a pure observer: same final state and per-event info as
    the dense driver."""
    keys, qs, ts = _stream(n_events=700)
    sink, st_sink, info_sink = _port_run("pp", keys, qs, ts)
    sink.close()
    st, info = run_stream(EngineConfig(**_cfg_kw("pp", keys)),
                          init_state(N_KEYS, 2, device="cpu"), keys, qs, ts,
                          batch=BATCH, mode="exact",
                          rng=np.asarray(jax.random.PRNGKey(7)))
    for a, b, name in zip(st_sink, st, st._fields):
        assert torch.equal(a, b), name
    for a, b, name in zip(info_sink, info, info._fields):
        assert torch.equal(a, b), name


def test_sink_defaults_to_the_card():
    """Without a device the sink takes cuda:0's tensors — or raises when
    there is no GPU, rather than carrying on silently on the CPU."""
    if torch.cuda.is_available():
        assert WriteBehindSink(EngineConfig()).device == \
            torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            WriteBehindSink(EngineConfig())


@pytest.mark.parametrize("queue_depth", [0, 2])
@pytest.mark.parametrize("l2", [None, True])
def test_submit_read_returns_stored_bytes(queue_depth, l2):
    """An ordered read sees every flush submitted before it, with or
    without the host L2 tier; absent keys read as None."""
    keys, qs, ts = _stream(n_events=600)
    sink, _, _ = _port_run("pp_vr", keys, qs, ts, queue_depth=queue_depth,
                           l2=l2)
    stored = _contents(sink.stores)
    ask = np.arange(N_KEYS + 4)
    for _ in range(2):              # the second read is answered by the L2
        rows = sink.submit_read(ask).result()
        assert rows == [stored.get(int(k)) for k in ask]
    snap = sink.flush()
    assert snap["reads"] == 2 and snap["rows_read"] == 2 * ask.size
    assert snap["l2_hits"] == (ask.size + len(stored) if l2 else 0)
    sink.close()

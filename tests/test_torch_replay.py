"""repro_torch's replay drivers (§6.3) over the port's per-event worker,
on the CPU — the twin of the replay tests of ``tests/test_streaming.py``,
plus the write counts and stored bytes of a closed-loop replay held
against the JAX package's on the same stream."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.types import EngineConfig as JaxConfig       # noqa: E402
from repro.streaming import replay as jreplay                # noqa: E402
from repro.streaming import workload as jworkload            # noqa: E402
from repro_torch.core.types import EngineConfig              # noqa: E402
from repro_torch.streaming import kvstore, replay, workload  # noqa: E402


def test_closed_loop_thinning_raises_throughput():
    s = workload.generate_regime("ibm", n_events=4000)
    unf = replay.closed_loop(s, EngineConfig(policy="unfiltered"),
                             device="cpu")
    thin = replay.closed_loop(s, EngineConfig(budget=0.001 / 60, h=3600.0),
                              device="cpu")
    assert thin.write_pct < 40.0
    assert thin.throughput_eps > 1.3 * unf.throughput_eps
    assert thin.lat_avg_ms < unf.lat_avg_ms


def test_waf_model_monotone():
    m = kvstore.StorageModel()
    wafs = [m.waf(b) for b in [10_000, 10_000_000, 10_000_000_000]]
    assert wafs[0] <= wafs[1] <= wafs[2]
    assert 1.0 <= wafs[0] and wafs[2] <= 3.0


@pytest.mark.parametrize("policy", ["pp", "unfiltered"])
def test_replay_writes_match_jax(policy):
    """Same stream, same seeds: the port's two-worker closed-loop and
    fixed-rate replays take the JAX replays' decisions and land the same
    bytes (the worker is held bitwise to the JAX one)."""
    kw = dict(policy=policy, budget=0.001 / 60, h=3600.0)
    s = workload.generate_regime("ibm", n_events=300, seed=2)
    js = jworkload.generate_regime("ibm", n_events=300, seed=2)
    assert np.array_equal(s.key, js.key) and np.array_equal(s.t, js.t)
    got = replay.closed_loop(s, EngineConfig(**kw), n_workers=2,
                             device="cpu")
    want = jreplay.closed_loop(js, JaxConfig(**kw), n_workers=2)
    for f in ("events", "writes", "write_pct", "bytes_written"):
        assert getattr(got, f) == getattr(want, f), f
    fr = replay.fixed_rate(s, EngineConfig(**kw), rate_eps=500.0,
                           device="cpu")
    assert fr.writes == jreplay.fixed_rate(js, JaxConfig(**kw),
                                           rate_eps=500.0).writes
    assert fr.utilization_pct > 0.0

"""Replay drivers: closed-loop and fixed-rate execution (§6.3), PyTorch.

The counterpart of ``repro.streaming.replay``, driving the port's
per-event ``FeatureWorker`` on ``device`` (``cuda:0`` unless named).

Closed-loop (Schroeder et al., NSDI'06): each in-flight request issues the
next event only after the previous response — measures peak sustainable
throughput and per-event latency.  Fixed-rate: events arrive at a target
rate; utilization = busy_time / wall_time isolates system-side resource use.

Per-event latency = real (measured) SerDe time + modeled storage service
time (see kvstore.StorageModel and WorkerMetrics.latencies_s; the oracle's
per-event kernel call and copies are excluded from the model).  Absolute
numbers therefore reflect this container; *ratios across policies* are the
reproduction target (Table 3 columns).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.types import EngineConfig
from repro_torch.streaming.kvstore import KVStore, StorageModel, partition_of
from repro_torch.streaming.worker import FeatureWorker
from repro_torch.streaming.workload import Stream


@dataclasses.dataclass
class ReplayResult:
    name: str
    events: int
    writes: int
    write_pct: float
    throughput_eps: float       # events / second (closed-loop: peak)
    lat_avg_ms: float
    lat_p95_ms: float
    lat_p9999_ms: float
    waf: float
    bytes_written: int
    serde_s: float
    modeled_io_s: float
    utilization_pct: Optional[float] = None  # fixed-rate only

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(xs: np.ndarray, p: float) -> float:
    return float(np.percentile(xs, p)) if len(xs) else float("nan")


def _run_workers(stream: Stream, cfg: EngineConfig, n_workers: int,
                 storage: Optional[StorageModel], seed: int, device=None):
    workers = [FeatureWorker(cfg, KVStore(storage or StorageModel(),
                                          seed=seed + i), seed=seed + i,
                             device=device)
               for i in range(n_workers)]
    latencies = np.zeros(len(stream), np.float64)
    busy = 0.0
    for i in range(len(stream)):
        k = int(stream.key[i])
        w = workers[partition_of(k, n_workers)]
        out = w.process(k, float(stream.q[i]), float(stream.t[i]))
        # per-event latency = measured compute + modeled storage service
        # time, recorded by the worker itself (WorkerMetrics.latencies_s)
        latencies[i] = out["latency_s"]
        busy += latencies[i]
    return workers, latencies, busy


def closed_loop(stream: Stream, cfg: EngineConfig, *, n_workers: int = 1,
                storage: Optional[StorageModel] = None, seed: int = 0,
                name: str = "", device=None) -> ReplayResult:
    """Closed-loop replay: latency-limited peak throughput.

    With one outstanding request per worker, throughput is
    n_workers / mean(latency) — the paper's client-side metric.
    """
    workers, lat, _ = _run_workers(stream, cfg, n_workers, storage, seed,
                                   device)
    events = sum(w.metrics.events for w in workers)
    writes = sum(w.metrics.writes for w in workers)
    bw = sum(w.store.counters.bytes_written for w in workers)
    return ReplayResult(
        name=name or cfg.policy, events=events, writes=writes,
        write_pct=100.0 * writes / max(events, 1),
        throughput_eps=n_workers / max(lat.mean(), 1e-12),
        lat_avg_ms=lat.mean() * 1e3,
        lat_p95_ms=_percentile(lat, 95) * 1e3,
        lat_p9999_ms=_percentile(lat, 99.99) * 1e3,
        waf=float(np.mean([w.store.waf() for w in workers])),
        bytes_written=bw,
        serde_s=sum(w.store.counters.serde_s for w in workers),
        modeled_io_s=sum(w.store.counters.modeled_io_s for w in workers))


def fixed_rate(stream: Stream, cfg: EngineConfig, *, rate_eps: float = 200.0,
               n_workers: int = 1, storage: Optional[StorageModel] = None,
               seed: int = 0, name: str = "", device=None) -> ReplayResult:
    """Fixed-rate replay: utilization at a pinned arrival rate (Table 3 RHS).

    Utilization = total busy seconds / simulated wall seconds at `rate_eps`.
    """
    workers, lat, busy = _run_workers(stream, cfg, n_workers, storage, seed,
                                      device)
    events = sum(w.metrics.events for w in workers)
    writes = sum(w.metrics.writes for w in workers)
    bw = sum(w.store.counters.bytes_written for w in workers)
    wall = events / rate_eps
    return ReplayResult(
        name=name or cfg.policy, events=events, writes=writes,
        write_pct=100.0 * writes / max(events, 1),
        throughput_eps=rate_eps,
        lat_avg_ms=lat.mean() * 1e3,
        lat_p95_ms=_percentile(lat, 95) * 1e3,
        lat_p9999_ms=_percentile(lat, 99.99) * 1e3,
        waf=float(np.mean([w.store.waf() for w in workers])),
        bytes_written=bw,
        serde_s=sum(w.store.counters.serde_s for w in workers),
        modeled_io_s=sum(w.store.counters.modeled_io_s for w in workers),
        utilization_pct=100.0 * busy / max(wall * n_workers, 1e-12))


def saturation_threshold(stream: Stream, cfg: EngineConfig, *,
                         collapse_ms: float = 500.0, step_eps: float = 50.0,
                         n_workers: int = 1, seed: int = 0,
                         queue_depth_limit: int = 64, device=None) -> float:
    """Find the arrival rate where queueing collapses latency (Table 4).

    M/G/1-style check: with per-event mean service time s, a rate above
    1/s makes the queue diverge; we sweep rates in `step_eps` increments and
    report the last sustainable rate (mean sojourn under collapse_ms).
    """
    _, lat, _ = _run_workers(stream, cfg, n_workers, None, seed, device)
    s = lat.mean()                      # mean service time
    cs2 = lat.var() / max(s ** 2, 1e-18)
    rate = step_eps
    last_ok = 0.0
    while rate < 1e5:
        rho = rate * s / n_workers
        if rho >= 1.0:
            break
        # M/G/1 Pollaczek–Khinchine mean waiting time
        wq = rho * s * (1 + cs2) / (2 * (1 - rho))
        if (wq + s) * 1e3 > collapse_ms:
            break
        last_ok = rate
        rate += step_eps
    return last_ok


def periodic_batching(stream: Stream, cfg: EngineConfig, *,
                      buffer_size: int = 100, n_workers: int = 1,
                      storage: Optional[StorageModel] = None, seed: int = 0,
                      device=None) -> ReplayResult:
    """Baseline: per-key buffering with flush every `buffer_size` events.

    Scores still happen per event (against stale state); writes amortize.
    """
    storage = storage or StorageModel()
    base = dataclasses.replace(cfg, policy="unfiltered")
    workers = [FeatureWorker(base, KVStore(storage, seed=seed + i),
                             seed=seed + i, device=device)
               for i in range(n_workers)]
    buffers: Dict[int, list] = {}
    latencies = []
    events = 0
    for i in range(len(stream)):
        k = int(stream.key[i])
        w = workers[partition_of(k, n_workers)]
        t0 = time.perf_counter()
        w.features_at(k, float(stream.t[i]))       # score against stale state
        buffers.setdefault(k, []).append((float(stream.q[i]),
                                          float(stream.t[i])))
        lat = time.perf_counter() - t0 \
            + w.store.model.service_time_s(w.rng, write=False)
        if len(buffers[k]) >= buffer_size:
            for q, t in buffers.pop(k):
                w.process(k, q, t)
        latencies.append(lat)
        events += 1
    lat = np.asarray(latencies)
    writes = sum(w.metrics.writes for w in workers)
    bw = sum(w.store.counters.bytes_written for w in workers)
    return ReplayResult(
        name="periodic_batching", events=events, writes=writes,
        write_pct=100.0 * writes / max(events, 1),
        throughput_eps=n_workers / max(lat.mean(), 1e-12),
        lat_avg_ms=lat.mean() * 1e3,
        lat_p95_ms=_percentile(lat, 95) * 1e3,
        lat_p9999_ms=_percentile(lat, 99.99) * 1e3,
        waf=float(np.mean([w.store.waf() for w in workers])),
        bytes_written=bw,
        serde_s=sum(w.store.counters.serde_s for w in workers),
        modeled_io_s=sum(w.store.counters.modeled_io_s for w in workers))

"""Per-event feature-aggregation worker over a byte-backed KV store (§5).

The counterpart of ``repro.streaming.worker``.  Implements the paper's
worker loop literally:
  (1) retrieve feature state + control statistics from storage (real SerDe)
  (2) materialize features for inference
  (3) derive an inclusion probability from disk-backed estimates only
  (4) sample a Bernoulli decision
  (5) execute a write-back only if selected
Inference happens for every event; persistence is gated.

It is the **byte-level oracle** of the write-behind sink
(``streaming/persistence.py``): for the same stream, policy and rng, the
bytes this worker stores per key equal the bytes the sink stores, and the
bytes the JAX package's worker stores.  Three design points make that
exact:

* the worker holds no private decision math — steps (2)-(4) are the rows
  entry of the fused kernel (``ops.thinning_rmw``) on a one-event batch on
  the worker's device: the CUDA kernel on the card, its plain version on
  the CPU, both bitwise equal to the keyed entry the engine runs;
* the uniform is drawn on the host: ``kernels/threefry.uniform_for_events``
  on CPU tensors, which runs on numpy — the counter RNG never runs as
  torch ops on the card (``threefry.cuda_calls`` stays 0);
* under thinning policies the full-stream control column is not durable:
  stored rows carry the fresh (0.0, -inf) control column, exactly like
  the sink.  Under 'full'/'unfiltered' every event writes back, so the
  stored control column stays current.

One event moves one host-to-device copy (the packed row and event) and one
device-to-host copy (the packed outputs).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import EngineConfig, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import FRESH_SENTINEL
from repro_torch.kernels.threefry import prng_key, uniform_for_events
from repro_torch.streaming.kvstore import KVStore, SerDe

# Finite stand-in for -inf "never persisted" timestamps (the kernel masks
# freshness on `< -1e30`).
_FRESH_SENTINEL = np.float32(FRESH_SENTINEL)

_FULL_STREAM = ("full", "unfiltered")


@functools.lru_cache(maxsize=None)
def _event_step(cfg: EngineConfig, device: torch.device):
    """Single-event decision + update via the rows entry of the fused
    kernel, cached per (config, device).

    The step takes the row and the event as host floats and returns host
    numpy outputs ``(new_last_t, new_v_f, new_agg[3T], z, p, features[4T],
    lam, new_v_full, new_last_t_full)``.
    """
    T = len(cfg.taus)
    taus = torch.tensor(cfg.taus, dtype=torch.float32, device=device)
    kw = dict(h=cfg.h, budget=cfg.budget, alpha=cfg.alpha, policy=cfg.policy,
              fixed_rate=cfg.fixed_rate, mu_tau_index=cfg.mu_tau_index,
              min_p=cfg.min_p)
    splits = (1, 1, 3 * T, 1, 1, 4 * T, 1, 1, 1)
    ends = np.cumsum(splits)

    def step(rng, ent, last_t, v_f, agg, q, t, v_full, last_t_full):
        t32 = np.float32(t)
        u = uniform_for_events(
            rng, torch.tensor([int(ent)], dtype=torch.int64),
            torch.tensor([int(t32.view(np.uint32))], dtype=torch.int64))
        host = np.empty(8 + 3 * T, np.float32)
        host[:8] = (last_t, v_f, q, t32, float(u[0]), 1.0, v_full,
                    last_t_full)
        host[8:] = np.asarray(agg, np.float32).reshape(-1)
        x = torch.from_numpy(host).to(device)
        r = lambda i: x[i:i + 1]
        out = ops.thinning_rmw(taus, r(0), r(1), x[8:].view(1, 3 * T), r(2),
                               r(3), r(4), r(5), r(6), r(7), **kw)
        flat = torch.cat([o.reshape(-1).to(torch.float32) for o in out])
        res = flat.cpu().numpy()
        return np.split(res, ends[:-1])

    return step


@dataclasses.dataclass
class WorkerMetrics:
    events: int = 0
    writes: int = 0
    score_calls: int = 0
    compute_s: float = 0.0
    # Per-event *worker-model* latency, appended by process(): real SerDe
    # time + modeled storage service time.  The kernel call and its copies
    # (compute_s) are deliberately excluded — they stand in for
    # sub-microsecond scalar decision math in the paper's JVM worker.
    latencies_s: Optional[list] = None

    def write_pct(self) -> float:
        return 100.0 * self.writes / max(self.events, 1)


class FeatureWorker:
    """One partition worker: KV store + persistence-path control.

    ``rng`` is the thinning RNG root (a key, ``core.thinning.prng_key``;
    default ``prng_key(seed + 17)``).  Decisions are counter-based on
    (entity id, event-time bits) — reproducible, order- and
    batching-invariant, and identical to the engine's under the same key.
    ``device`` is where the kernel runs (``cuda:0`` unless named).
    """

    def __init__(self, cfg: EngineConfig, store: Optional[KVStore] = None,
                 seed: int = 0, record_latency: bool = True, rng=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.taus = np.asarray(cfg.taus, np.float64)
        self.store = store or KVStore(seed=seed)
        self.serde = SerDe(len(cfg.taus))
        self.rng = rng if rng is not None else prng_key(seed + 17)
        self.metrics = WorkerMetrics(
            latencies_s=[] if record_latency else None)
        self._step = _event_step(cfg, self.device)
        self._full_stream = cfg.policy in _FULL_STREAM

    @staticmethod
    def _fin(x: float) -> np.float32:
        """-inf -> kernel freshness sentinel (finite)."""
        return np.float32(x) if math.isfinite(x) else _FRESH_SENTINEL

    def process(self, key: int, q: float, t: float) -> dict:
        """One event through the worker loop.  Returns observability dict.

        ``latency_s`` in the result (and ``metrics.latencies_s``) is the
        worker-model per-event latency: real SerDe seconds + modeled
        storage service seconds.  ``compute_s`` is the measured wall time
        of the whole call, kernel and copies included.
        """
        serde, store = self.serde, self.store
        t0 = time.perf_counter()
        io0 = store.counters.modeled_io_s
        sd0 = store.counters.serde_s

        # (1) retrieve + deserialize
        raw = store.get(int(key))
        ts0 = time.perf_counter()
        if raw is None:
            row = (-math.inf, 0.0, np.zeros((len(self.taus), 3), np.float32),
                   0.0, -math.inf)
        else:
            row = serde.unpack(raw, key=int(key))
        store.counters.serde_s += time.perf_counter() - ts0
        last_t, v_f, agg, v_full, last_t_full = row

        # (2)-(4) materialize + decide + Bernoulli: the fused kernel on a
        # one-event batch (no private decision math in this class)
        (nlt, nvf, nagg, z_, p_, feats, lam_, nvfull, nltf) = self._step(
            self.rng, int(key), self._fin(last_t), np.float32(v_f), agg,
            np.float32(q), np.float32(t), np.float32(v_full),
            self._fin(last_t_full))
        z = bool(z_[0])
        p = float(p_[0])
        lam = float(lam_[0])
        features = feats.copy()
        self.metrics.score_calls += 1

        # (5) conditional write-back (serialize + put).  Kernel outputs are
        # already z-masked (new == old on z=0 lanes), so the packed row is
        # the post-event durable row in either case.
        if z or self._full_stream:
            if z:
                self.metrics.writes += 1
            store_lt = float(nlt[0])
            if store_lt < -1e30:        # sentinel back to -inf for storage
                store_lt = -math.inf
            if self._full_stream:
                ctrl = (float(nvfull[0]), float(nltf[0]))
            else:
                # thinning policies do not maintain the control column
                # durably; stored rows carry the fresh column (sink parity)
                ctrl = (0.0, -math.inf)
            ts0 = time.perf_counter()
            raw = serde.pack(store_lt, float(nvf[0]), nagg.reshape(-1, 3),
                             *ctrl)
            store.counters.serde_s += time.perf_counter() - ts0
            store.put(int(key), raw)

        self.metrics.events += 1
        compute = time.perf_counter() - t0
        self.metrics.compute_s += compute
        latency = (store.counters.serde_s - sd0) \
            + (store.counters.modeled_io_s - io0)
        if self.metrics.latencies_s is not None:
            self.metrics.latencies_s.append(latency)
        return {"p": p, "z": z, "lam": lam, "features": features,
                "compute_s": compute, "latency_s": latency}

    def features_at(self, key: int, t: float) -> np.ndarray:
        """Read-only feature materialization (scoring path, no write)."""
        raw = self.store.get(int(key))
        if raw is None:
            agg_now = np.zeros((len(self.taus), 3), np.float32)
        else:
            last_t, v_f, agg, *_ = self.serde.unpack(raw, key=int(key))
            dt = t - last_t
            agg_now = agg * np.exp(
                -np.clip(dt, 0, None) / self.taus)[:, None] \
                if math.isfinite(last_t) else np.zeros_like(agg)
        cnt = agg_now[:, 0]
        s = agg_now[:, 1]
        mean = s / np.maximum(cnt, 1e-12)
        var = np.maximum(agg_now[:, 2] / np.maximum(cnt, 1e-12) - mean ** 2,
                         0.0)
        return np.concatenate([cnt, s, mean, np.sqrt(var)]).astype(np.float32)

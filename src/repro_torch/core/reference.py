"""Pure-Python per-event oracle for the feature engine.

The counterpart of ``repro.core.reference``.  Implements the paper's
worker loop literally, one event at a time, in float64 with no
vectorization tricks.  Tests check the engine (exact mode) and the
per-event worker against it up to fp tolerance.  Its uniforms come from the
port's counter RNG (``kernels/threefry.py``) on host arrays, so it takes
the engine's decisions wherever ``p`` agrees.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.types import EngineConfig
from repro_torch.kernels.threefry import uniform_for_events


@dataclasses.dataclass
class RefEntity:
    last_t: float = -math.inf
    v_f: float = 0.0
    agg: np.ndarray | None = None  # [T,3]
    v_full: float = 0.0
    last_t_full: float = -math.inf


def _decay(dt: float, h: float) -> float:
    if not math.isfinite(dt):
        return 0.0
    return math.exp(-max(dt, 0.0) / h)


class ReferenceEngine:
    def __init__(self, cfg: EngineConfig, num_entities: int, rng):
        self.cfg = cfg
        self.taus = np.asarray(cfg.taus, np.float64)
        self.ents = [RefEntity(agg=np.zeros((len(cfg.taus), 3)))
                     for _ in range(num_entities)]
        self.rng = rng
        self.writes = 0
        self.events = 0

    def _uniform(self, key: int, t: float) -> float:
        bits = np.float32(t).view(np.uint32)
        return float(uniform_for_events(
            self.rng, torch.tensor([int(key)], dtype=torch.int64),
            torch.tensor([int(bits)], dtype=torch.int64))[0])

    def process(self, key: int, q: float, t: float):
        cfg, e = self.cfg, self.ents[key]
        self.events += 1
        # decayed state at decision time
        agg_now = e.agg * np.exp(
            -np.clip(t - e.last_t, 0, None) / self.taus)[:, None] \
            if math.isfinite(e.last_t) else np.zeros_like(e.agg)

        if cfg.policy == "full":
            lam = (1.0 + _decay(t - e.last_t_full, cfg.h) * e.v_full) / cfg.h
        else:
            lam = (1.0 + _decay(t - e.last_t, cfg.h) * e.v_f) / cfg.h

        if cfg.policy == "unfiltered":
            p = 1.0
        elif cfg.policy == "fixed":
            p = min(max(cfg.fixed_rate, cfg.min_p), 1.0)
        elif cfg.policy == "pp_vr":
            sel = agg_now[cfg.mu_tau_index]
            cnt = max(sel[0], 1e-12)
            mu = sel[1] / cnt
            var = max(sel[2] / cnt - mu * mu, 0.0)
            if sel[0] < 1.0:
                mu, sigma = 0.0, 1e8
            else:
                sigma = math.sqrt(var) + 1e-8
            base = min(1.0, cfg.budget / max(lam, 1e-30))
            zs = float(np.clip((q - mu) / max(sigma, 1e-8), -8.0, 8.0))
            b = float(np.clip(base, 1e-6, 1 - 1e-6))
            logit = math.log(b) - math.log1p(-b) + cfg.alpha * zs
            p = 1.0 / (1.0 + math.exp(-logit))
            if base >= 1.0 - 1e-6:
                p = 1.0
            p = min(max(p, cfg.min_p), 1.0)
        else:
            p = min(1.0, cfg.budget / max(lam, 1e-30))
            p = min(max(p, cfg.min_p), 1.0)

        z = self._uniform(key, t) < p
        if z:
            e.agg = agg_now + (1.0 / p) * np.array([1.0, q, q * q])[None, :]
            e.v_f = 1.0 / p + _decay(t - e.last_t, cfg.h) * e.v_f
            e.last_t = t
            self.writes += 1
        e.v_full = 1.0 + _decay(t - e.last_t_full, cfg.h) * e.v_full
        e.last_t_full = t
        return p, z, lam

    def true_aggregate(self, events_by_key, key: int, t: float) -> np.ndarray:
        """Ground-truth full-stream decayed aggregates for one entity at t."""
        out = np.zeros((len(self.taus), 3))
        for (q, tn) in events_by_key.get(key, []):
            if tn <= t:
                beta = np.exp(-(t - tn) / self.taus)
                out += beta[:, None] * np.array([1.0, q, q * q])[None, :]
        return out

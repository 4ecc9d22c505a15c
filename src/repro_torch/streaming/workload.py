"""Synthetic event-stream generators matched to the paper's Table 2 regimes.

The paper evaluates four workload regimes distinguished by key skew, anomaly
rate, and aggregand kurtosis.  The proprietary datasets are not shipped, so we
generate streams whose *measured* statistics land on each Table 2 row:

  regime      keys    anomaly%   80% vol. from   kurtosis
  fraud       7K      0.05       ~4.1% of keys   ~8   (lognormal, heavy)
  ibm         7K      0.13       ~1.5% of keys   ~3   (lognormal, moderate)
  iiot        50K*    40.0       ~0.7% of keys   ~2   (near-symmetric)
  wikipedia   3K      8.35       ~23.6% of keys  ~2   (balanced, weak skew)

(*) iiot is scaled from 800K keys to keep CPU benchmarks tractable; the skew
fraction — the property the mechanism depends on — is preserved.

Anomalies are *planted* with behavioural signal so downstream ML evaluation
(Table 5) is meaningful: anomalous entities burst (10x arrival intensity for
a short horizon) and draw marks from a shifted distribution, which is exactly
the structure the decayed count/sum/mean profiles can detect.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_events: int
    n_keys: int
    anomaly_rate: float        # fraction of *events* labelled anomalous
    vol80_target: float        # fraction of keys producing 80% of events
    mark: str                  # lognormal | pareto | gamma | normal
    mark_param: float          # sigma (lognormal), alpha (pareto), shape (gamma)
    duration: float = 7 * 24 * 3600.0   # stream horizon (seconds)
    burst_factor: float = 10.0          # anomalous-entity intensity boost
    mark_shift: float = 3.0             # anomalous-mark scale multiplier
    anomaly_mode: str = "burst"         # burst (hot entities) | throwaway
    anom_pool_frac: float = 0.003       # entity-pool size for 'burst' mode


REGIMES: Dict[str, WorkloadSpec] = {
    # mark params chosen so measured kurtosis lands on the Table 2 row:
    # lognormal(sigma=0.5) -> ~8; lognormal(0.12) -> ~3; uniform -> ~2.
    "fraud": WorkloadSpec("fraud", 200_000, 7_000, 0.0005, 0.041,
                          "lognormal", 0.5),
    "ibm": WorkloadSpec("ibm", 200_000, 7_000, 0.0013, 0.015,
                        "lognormal", 0.12, mark_shift=1.5),
    "iiot": WorkloadSpec("iiot", 150_000, 50_000, 0.40, 0.007,
                         "uniform", 0.0, mark_shift=1.3),
    "wikipedia": WorkloadSpec("wikipedia", 6_000, 3_000, 0.0835, 0.236,
                              "uniform", 0.0, mark_shift=1.3,
                              anomaly_mode="throwaway"),
}


def zipf_weights(n_keys: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** a
    return w / w.sum()


def vol80_fraction(weights: np.ndarray) -> float:
    """Fraction of keys (by weight order) that carry 80% of the volume."""
    w = np.sort(weights)[::-1]
    cum = np.cumsum(w)
    k = int(np.searchsorted(cum, 0.80)) + 1
    return k / len(w)


def calibrate_zipf(n_keys: int, vol80_target: float, tol: float = 1e-3
                   ) -> float:
    """Bisection on the Zipf exponent to hit a Table 2 '80% Vol.' figure."""
    lo, hi = 0.01, 3.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        frac = vol80_fraction(zipf_weights(n_keys, mid))
        if abs(frac - vol80_target) < tol:
            return mid
        if frac > vol80_target:   # not skewed enough -> raise exponent
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _draw_marks(rng: np.random.Generator, dist: str, param: float,
                n: int) -> np.ndarray:
    if dist == "lognormal":
        return rng.lognormal(3.0, param, n)
    if dist == "pareto":
        return (rng.pareto(param, n) + 1.0) * 20.0
    if dist == "gamma":
        return rng.gamma(param, 10.0, n)
    if dist == "normal":
        return np.abs(rng.normal(50.0, 10.0, n))
    if dist == "uniform":
        return rng.uniform(10.0, 100.0, n)
    raise ValueError(dist)


@dataclasses.dataclass
class Stream:
    """A generated event stream (time-ordered)."""
    key: np.ndarray     # int32 [N]
    q: np.ndarray       # float32 [N]
    t: np.ndarray       # float32 [N] seconds, ascending
    label: np.ndarray   # int8 [N] 1 = anomalous
    spec: WorkloadSpec

    def __len__(self) -> int:
        return len(self.key)

    def stats(self) -> dict:
        counts = np.bincount(self.key, minlength=self.spec.n_keys)
        w = counts / max(counts.sum(), 1)
        qc = self.q - self.q.mean()
        m2 = np.mean(qc ** 2)
        kurt = float(np.mean(qc ** 4) / max(m2 ** 2, 1e-12))
        return {
            "events": len(self.key),
            "keys_seen": int((counts > 0).sum()),
            "anomaly_pct": float(self.label.mean() * 100),
            "vol80_pct": float(vol80_fraction(w[counts > 0]) * 100),
            "kurtosis": kurt,
        }


def generate(spec: WorkloadSpec, seed: int = 0) -> Stream:
    rng = np.random.default_rng(seed)
    a = calibrate_zipf(spec.n_keys, spec.vol80_target)
    weights = zipf_weights(spec.n_keys, a)
    # random key identity permutation: skew is not aligned with key index
    perm = rng.permutation(spec.n_keys)

    keys = rng.choice(spec.n_keys, size=spec.n_events, p=weights)
    keys = perm[keys].astype(np.int32)

    # Anomaly injection preserves each regime's skew profile:
    #  * 'burst' (fraud/ibm/iiot): a small pool of hot anomalous entities
    #    carries the anomalous volume with its own Zipf law — like DoS
    #    sources or compromised merchants.  The pool is small enough that
    #    heavy anomaly rates (iiot: 40%) *steepen* rather than flatten skew.
    #  * 'throwaway' (wikipedia): anomalous events come from many fresh
    #    tail keys (short-lived vandal accounts), weakening skew — which is
    #    exactly the Table 2 wikipedia regime.
    n_anom_events = int(round(spec.anomaly_rate * spec.n_events))
    label = np.zeros(spec.n_events, np.int8)
    if n_anom_events > 0:
        idx = rng.choice(spec.n_events, size=n_anom_events, replace=False)
        if spec.anomaly_mode == "throwaway":
            tail = np.arange(int(spec.n_keys * 0.7), spec.n_keys)
            keys[idx] = rng.choice(tail, size=n_anom_events)
        else:
            pool = max(1, int(spec.n_keys * spec.anom_pool_frac))
            anom_keys = rng.choice(spec.n_keys, size=pool,
                                   replace=False).astype(np.int32)
            pw = zipf_weights(pool, 1.2)
            keys[idx] = anom_keys[rng.choice(pool, size=n_anom_events, p=pw)]
        label[idx] = 1

    # arrival times: homogeneous base + per-event jitter; anomalous events
    # cluster (bursts) by shrinking their inter-arrival contribution.
    base_gap = spec.duration / spec.n_events
    gaps = rng.exponential(base_gap, spec.n_events)
    gaps[label == 1] /= spec.burst_factor
    t = np.cumsum(gaps)

    q = _draw_marks(rng, spec.mark, spec.mark_param, spec.n_events)
    q[label == 1] *= spec.mark_shift

    order = np.argsort(t, kind="stable")
    return Stream(key=keys[order], q=q[order].astype(np.float32),
                  t=t[order].astype(np.float32), label=label[order],
                  spec=spec)


def generate_regime(name: str, seed: int = 0,
                    n_events: Optional[int] = None) -> Stream:
    spec = REGIMES[name]
    if n_events is not None:
        spec = dataclasses.replace(spec, n_events=n_events)
    return generate(spec, seed)

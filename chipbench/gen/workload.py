"""Synthetic keyed event streams for the paper's Table 2 regimes (numpy only).

A frozen copy of ``repro_torch.streaming.workload``'s generator, kept with
the benchmark so that a change to the program cannot change the traffic it
is measured on.  Two departures from the original, both for the benchmark:

* the Zipf exponent comes from the configuration file (calibrated once and
  written in) instead of a bisection at every call;
* a stream continues past its first span in further spans of the same size
  and statistics: the key identities (the Zipf permutation) and the pool of
  anomalous entities are drawn once per seed, each span draws its own keys,
  gaps and marks, and its times continue from the end of the span before;
  ``Repeating`` then replays a few such spans end to end, shifted in time,
  so a closed loop of any length needs only their draws in its set-up.
  Either way every key keeps the source's arrival rate however long a run
  lasts.

Timestamps are float32 seconds, as the engine's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    n_keys: int
    span_events: int
    anomaly_rate: float          # fraction of *events* labelled anomalous
    zipf_exponent: float         # calibrated to the Table 2 80 % volume share
    mark: str                    # lognormal|uniform|pareto|gamma|normal
    mark_param: float
    span_seconds: float = 7 * 24 * 3600.0
    burst_factor: float = 10.0   # anomalous-entity intensity boost
    mark_shift: float = 3.0      # anomalous-mark scale multiplier
    anomaly_mode: str = "burst"  # burst (hot entities) | throwaway
    anom_pool_frac: float = 0.003


def spec_from_config(stream: dict) -> StreamSpec:
    """The ``stream`` block of a configuration file as a ``StreamSpec``."""
    names = {f.name for f in dataclasses.fields(StreamSpec)}
    return StreamSpec(**{k: v for k, v in stream.items() if k in names})


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
    """Bisection on the Zipf exponent to hit a Table 2 '80% Vol.' figure
    (how the configuration files' ``zipf_exponent`` was found)."""
    lo, hi = 0.01, 3.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        frac = vol80_fraction(zipf_weights(n_keys, mid))
        if abs(frac - vol80_target) < tol:
            return mid
        if frac > vol80_target:
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
    """A time-ordered event stream."""
    key: np.ndarray     # int32 [N]
    q: np.ndarray       # float32 [N]
    t: np.ndarray       # float32 [N] seconds, ascending
    label: np.ndarray   # int8 [N] 1 = anomalous

    def __len__(self) -> int:
        return len(self.key)

    def stats(self, n_keys: int) -> dict:
        counts = np.bincount(self.key, minlength=n_keys)
        w = counts / max(counts.sum(), 1)
        qc = self.q - self.q.mean()
        m2 = np.mean(qc ** 2)
        return {"events": len(self.key),
                "keys_seen": int((counts > 0).sum()),
                "anomaly_pct": float(self.label.mean() * 100),
                "vol80_pct": float(vol80_fraction(w[counts > 0]) * 100),
                "kurtosis": float(np.mean(qc ** 4) / max(m2 ** 2, 1e-12))}


def _seed_words(seed: int) -> list:
    """A seed of any size as the words numpy's SeedSequence takes."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seeds are non-negative")
    return [seed & 0xFFFFFFFF, seed >> 32]


def generate(spec: StreamSpec, seed: int, n_spans: int = 1) -> Stream:
    """``n_spans`` spans of ``spec.span_events`` events each, from ``seed``.

    The first span is the original generator's stream with the written
    exponent, up to the order of its draws; each later span continues it.
    """
    base = np.random.SeedSequence(_seed_words(seed))
    rng0 = np.random.default_rng(base.spawn(1)[0])
    weights = zipf_weights(spec.n_keys, spec.zipf_exponent)
    perm = rng0.permutation(spec.n_keys)          # skew not aligned with id
    pool = max(1, int(spec.n_keys * spec.anom_pool_frac))
    anom_keys = rng0.choice(spec.n_keys, size=pool,
                            replace=False).astype(np.int32)
    pool_w = zipf_weights(pool, 1.2)
    n = spec.span_events
    keys_all, q_all, t_all, lab_all = [], [], [], []
    t_end = 0.0
    for span_rng in (np.random.default_rng(s)
                     for s in base.spawn(n_spans + 1)[1:]):
        keys = perm[span_rng.choice(spec.n_keys, size=n, p=weights)
                    ].astype(np.int32)
        # Anomalies: a small pool of hot anomalous entities ('burst') or
        # fresh tail keys ('throwaway'), as in the original generator.
        n_anom = int(round(spec.anomaly_rate * n))
        label = np.zeros(n, np.int8)
        if n_anom > 0:
            idx = span_rng.choice(n, size=n_anom, replace=False)
            if spec.anomaly_mode == "throwaway":
                tail = np.arange(int(spec.n_keys * 0.7), spec.n_keys)
                keys[idx] = span_rng.choice(tail, size=n_anom)
            else:
                keys[idx] = anom_keys[span_rng.choice(pool, size=n_anom,
                                                      p=pool_w)]
            label[idx] = 1
        gaps = span_rng.exponential(spec.span_seconds / n, n)
        gaps[label == 1] /= spec.burst_factor
        t = t_end + np.cumsum(gaps)
        t_end = float(t[-1])
        q = _draw_marks(span_rng, spec.mark, spec.mark_param, n)
        q[label == 1] *= spec.mark_shift
        keys_all.append(keys)
        q_all.append(q.astype(np.float32))
        t_all.append(t.astype(np.float32))
        lab_all.append(label)
    return Stream(key=np.concatenate(keys_all), q=np.concatenate(q_all),
                  t=np.concatenate(t_all), label=np.concatenate(lab_all))


class Repeating:
    """An unbounded stream: ``base`` end to end, again and again, each
    repeat shifted in time by the base's span, so every key keeps its
    arrival rate for as long as a run lasts.  Events are addressed by their
    global position."""

    def __init__(self, base: Stream):
        self.base = base
        self.n = len(base)
        self.period = float(base.t[-1])

    def _parts(self, lo: int, hi: int):
        """(repeat, start, stop) pieces of the base that [lo, hi) covers."""
        while lo < hi:
            k, r = divmod(lo, self.n)
            stop = min(self.n, r + hi - lo)
            yield k, r, stop
            lo += stop - r

    def events(self, lo: int, hi: int):
        """Keys, marks and times of global events [lo, hi)."""
        parts = list(self._parts(lo, hi))
        cat = lambda xs: xs[0] if len(xs) == 1 else np.concatenate(xs)
        b = self.base
        key = cat([b.key[r:s] for _, r, s in parts])
        q = cat([b.q[r:s] for _, r, s in parts])
        t = cat([(b.t[r:s].astype(np.float64) + k * self.period)
                 .astype(np.float32) for k, r, s in parts])
        return key, q, t

    def positions(self, base_pos: np.ndarray, lo: int, hi: int):
        """Global positions in [lo, hi) of the base positions
        ``base_pos`` (sorted), as (repeat, index into base_pos) pieces."""
        for k, r, s in self._parts(lo, hi):
            a, b = np.searchsorted(base_pos, (r, s))
            yield k, int(a), int(b)

    def at(self, gpos: np.ndarray):
        """Keys, marks and times of the events at global positions."""
        k, r = np.divmod(np.asarray(gpos, np.int64), self.n)
        b = self.base
        t = (b.t[r].astype(np.float64) + k * self.period).astype(np.float32)
        return b.key[r], b.q[r], t

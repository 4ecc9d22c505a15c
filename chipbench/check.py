"""What decides ``correct``: the program's outputs on a sample of keys
against the plain reference's, and the rows the reopened stores hold.

The reference judges step by step (``reference.engine.expect``): each
decision from the row the program reported it saw, each reported row from
the one the program reported a block before with the events it persisted
folded in, each key's first block from empty rows, and each key's stored
row from its last.  So every sampled event and every sampled key's stored
row is compared, however long its history.  The numbers compared (each
against its limit in ``checks/<cell>.json``):

* ``tie_gap`` -- the largest ``|u - p| / p`` over the events whose
  decision differs from ``u < p`` (``p`` the reference's, on the row the
  program saw); 0 when none does.  A sound program differs only where
  ``u`` lies within rounding of ``p``.
* ``decision_gap`` -- the largest relative gap of ``p`` and of
  lambda-hat.
* ``feature_gap`` -- per event, the normwise relative gap of each feature
  group over the windows: counts, sums, and the means with the standard
  deviations; the largest.  A standard deviation is the root of a
  difference that cancels to rounding when a window holds one persisted
  event, so it is known only to about ``sqrt(eps) * |mean|`` and is
  measured against the means' scale.
* ``score_gap`` -- the scorer alone: the program's scores against the
  reference scorer on the program's own features, as the largest gap over
  the root mean square of the scores.
* ``stored_gap`` -- for every sampled key: the row the reopened stores
  hold against the reference's, normwise per group (last_t; v_f on the
  scale ``1 + v_f`` of lambda-hat; count, sum and sum of squares over the
  windows; decayed to the time of the key's last event when its last
  block persisted nothing), the largest; a
  row that is missing, or present where no event of the key persisted,
  reads infinite.
* ``misordered`` (online cells) -- requests answered out of arrival
  order or not at all; exact.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from chipbench.reference import engine as ref


class Sample(NamedTuple):
    """The sampled events of a run and what the program answered."""
    slot: np.ndarray        # [n] index into ``keys``
    entity: np.ndarray      # [n] global key
    q: np.ndarray           # [n] float32
    t: np.ndarray           # [n] float32
    block: np.ndarray       # [n] engine block of each event
    keys: np.ndarray        # [K] the sampled keys
    z: np.ndarray           # [n] the program's outputs ...
    p: np.ndarray
    lam: np.ndarray
    features: np.ndarray    # [n, 4T]
    score: np.ndarray       # [n]
    stored: Optional[list]  # [K] each key's stored row bytes, or None
    #                         where the stretch's rows are not read back


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise normwise relative gap of ``a`` against ``b``; 0 where
    both rows are (almost) zero."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    with np.errstate(invalid="ignore", over="ignore"):
        diff = np.linalg.norm(a - b, axis=1)
        scale = np.maximum(np.linalg.norm(b, axis=1),
                           np.linalg.norm(a, axis=1))
        out = np.where(scale > 1e-20, diff / np.maximum(scale, 1e-20), 0.0)
    return np.where(np.isfinite(a).all(1) & np.isfinite(b).all(1), out,
                    np.where((a == b).all(1), 0.0, np.inf))


def _max(x) -> float:
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0
    if np.isnan(x).any():
        return math.inf
    return float(x.max())


def compare(sample: Sample, ex: "ref.Expected", weights: dict, n_taus: int
            ) -> dict:
    """The numbers compared, program (``sample``) against what the
    reference expects of it (``expect_sample``)."""
    K = sample.keys.size
    z = sample.z.astype(bool)
    u = ex.u.astype(np.float64)
    off = np.flatnonzero(z != (u < ex.p))
    tie_gap = _max(np.abs(u[off] - ex.p[off]) / ex.p[off])
    decision = np.concatenate([
        np.abs(sample.p.astype(np.float64) - ex.p) / ex.p,
        np.abs(sample.lam.astype(np.float64) - ex.lam) / ex.lam])
    T = n_taus
    groups = (slice(0, T), slice(T, 2 * T), slice(2 * T, 4 * T))
    feature = np.max([_rel(sample.features[:, g], ex.features[:, g])
                      for g in groups], axis=0) if z.size else []
    s_ref = ref.score(weights, sample.features)
    rms = float(np.sqrt(np.mean(s_ref.astype(np.float64) ** 2))) \
        if s_ref.size else 1.0
    score_gap = _max(np.abs(sample.score.astype(np.float64) - s_ref)
                     / max(rms, 1e-30))
    stored = []
    for j in range(K if sample.stored is not None else 0):
        raw = sample.stored[j]
        if raw is None or not ex.persisted[j]:
            stored.append(0.0 if raw is None and not ex.persisted[j]
                          else math.inf)
            continue
        row = ref.decode_rows(raw, T)
        if row.size != 1 or row["n"][0] != T:
            stored.append(math.inf)
            continue
        # the stored row decayed to the time the expected one is at
        dt = max(float(ex.row_t[j]) - float(row["last_t"][0]), 0.0)
        keep = np.exp(-dt / np.asarray(ex.taus))
        # v_f beside a 1: lambda-hat carries it as 1 + v_f, and the
        # reference reads it back from lambda-hat to that scale
        got = [row["last_t"], [[row["v_f"][0] * math.exp(-dt / ex.h), 1.0]]
               ] + [row["agg"][:, :, c] * keep for c in range(3)]
        want = [ex.last_t[j:j + 1], [[ex.v_f[j], 1.0]]] + \
            [ex.agg[j:j + 1, :, c] for c in range(3)]
        stored.append(max(float(_rel(a, b)[0]) for a, b in zip(got, want)))
    return {"tie_gap": tie_gap, "decision_gap": _max(decision),
            "feature_gap": _max(feature), "score_gap": score_gap,
            "stored_gap": _max(stored),
            "compared_events": int(z.size), "compared_keys": int(K),
            "stored_keys": len(stored), "persisted_events": int(z.sum()),
            "folded_events": int((~ex.first).sum()),
            "differing_decisions": int(off.size)}


COUNTS = ("compared_events", "compared_keys", "stored_keys",
          "persisted_events", "folded_events", "differing_decisions")


def merge(parts) -> dict:
    """One set of numbers over several stretches of a run: the largest
    gap, the summed counts."""
    out = dict(parts[0])
    for p in parts[1:]:
        for k, v in p.items():
            out[k] = out[k] + v if k in COUNTS else max(out[k], v)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit; a NaN or a missing number fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = value <= limit
        ok = ok and bool(good)
        rows.append((name, value, limit))
    return ok, rows


def control_sample(sample: Sample, eng: "ref.Engine", rng_words,
                   weights: dict) -> Sample:
    """The control in the program's place: the reference one precision
    below the configuration's (bfloat16), on the same events and blocks;
    its rows as the stores would hold them."""
    low = ref.replay(eng, sample.slot, sample.entity, sample.q, sample.t,
                     sample.block, rng_words, sample.keys.size,
                     dtype=torch.bfloat16)
    T = len(eng.taus)
    stored = None if sample.stored is None else []
    for j in range(sample.keys.size if stored is not None else 0):
        if not low.persisted[j]:
            stored.append(None)
            continue
        row = np.zeros(1, ref.decode_rows(b"", T).dtype)
        row["n"], row["last_t"], row["v_f"] = T, low.last_t[j], low.v_f[j]
        row["agg"] = low.agg[j]
        stored.append(row.tobytes())
    return sample._replace(
        z=low.z, p=low.p, lam=low.lam, features=low.features,
        score=ref.score(weights, low.features, dtype=torch.bfloat16),
        stored=stored)


def expect_sample(sample: Sample, eng: "ref.Engine",
                  rng_words) -> "ref.Expected":
    """What the reference expects of the program's outputs in ``sample``."""
    return ref.expect(eng, sample.slot, sample.entity, sample.q, sample.t,
                      sample.block, rng_words, sample.keys.size, sample.z,
                      sample.features, sample.lam)


def numbers_of(sample: Sample, eng: "ref.Engine", rng_words,
               weights: dict) -> dict:
    """The numbers compared for one sample (program or control)."""
    return compare(sample, expect_sample(sample, eng, rng_words), weights,
                   len(eng.taus))

"""Stability diagnostics for filtered estimation (paper Remarks 4.1 / 4.2).

These run the single-entity stochastic processes the theory is stated for and
expose the quantities of Appendix C/D: the normalized deviation martingale
M_n, and the write counts N_F (filtered control) vs N (full-stream control).
Used by tests (martingale property, oversampling bound) and, in the JAX
package, by ``benchmarks/bench_estimators.py`` (Fig. 7).  A copy of
``repro.core.diagnostics``: numpy only, nothing to port.
"""
from __future__ import annotations

import numpy as np


def simulate_entity(ts: np.ndarray, h: float, budget: float,
                    rng: np.random.Generator):
    """Run filtered & full-stream control along one entity's arrival times.

    Returns dict with per-event arrays: lam_full, lam_filt, p_full, p_filt,
    z_full, z_filt, M (normalized deviation), n_writes_*.
    """
    n = len(ts)
    v = 0.0            # full-stream KDE numerator
    v_f = 0.0          # filtered numerator
    last_t = None      # last event time (full-stream recurrence)
    last_t_f = None    # last *persisted* time (filtered recurrence)
    out = {k: np.zeros(n) for k in
           ("lam_full", "lam_filt", "p_full", "p_filt", "z_full", "z_filt", "M")}
    for i, t in enumerate(ts):
        beta = 1.0 if last_t is None else np.exp(-(t - last_t) / h)
        beta_f = 0.0 if last_t_f is None else np.exp(-(t - last_t_f) / h)
        lam = (1.0 + beta * v) / h if last_t is not None else 1.0 / h
        lam_f = (1.0 + beta_f * v_f) / h
        p = min(1.0, budget / lam)
        p_f = min(1.0, budget / lam_f)
        z = rng.random() < p
        z_f = rng.random() < p_f
        # full-stream recurrence: update every event
        v = 1.0 + (beta * v if last_t is not None else 0.0)
        last_t = t
        # filtered recurrence: update only on persisted events, HT-weighted
        if z_f:
            v_f = 1.0 / p_f + beta_f * v_f
            last_t_f = t
        out["lam_full"][i], out["lam_filt"][i] = lam, lam_f
        out["p_full"][i], out["p_filt"][i] = p, p_f
        out["z_full"][i], out["z_filt"][i] = z, z_f
        out["M"][i] = (lam_f - lam) / np.exp(-t / h) if t / h < 500 else np.nan
    out["n_writes_full"] = out["z_full"].sum()
    out["n_writes_filt"] = out["z_filt"].sum()
    return out


def martingale_increments(ts: np.ndarray, h: float, budget: float,
                          n_runs: int, seed: int = 0) -> np.ndarray:
    """E[M_n - M_{n-1} | past] ~ 0 check data: per-run increment matrix."""
    rng = np.random.default_rng(seed)
    M = np.stack([simulate_entity(ts, h, budget, rng)["M"]
                  for _ in range(n_runs)])
    return np.diff(M, axis=1)


def oversampling_gap(ts: np.ndarray, h: float, budget: float, n_runs: int,
                     seed: int = 0) -> tuple[float, float]:
    """Returns (mean N_F, mean N) across runs — Remark 4.2 says N_F >= N."""
    rng = np.random.default_rng(seed)
    nf, n = [], []
    for _ in range(n_runs):
        r = simulate_entity(ts, h, budget, rng)
        nf.append(r["n_writes_filt"])
        n.append(r["n_writes_full"])
    return float(np.mean(nf)), float(np.mean(n))

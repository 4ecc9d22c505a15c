"""Statistical invariants from the paper's theory (App. A–D) on the port:
its thinning policies, estimators, intensity recurrences, exact-mode
engine and ``core.diagnostics`` — the twin of ``tests/test_core_theory.py``,
on the CPU.  The policies are also held against the JAX ones on the same
inputs, and the diagnostics copy against the JAX module run for run."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st     # noqa: E402

import jax.numpy as jnp                                      # noqa: E402

from repro.core import diagnostics as jdiag                  # noqa: E402
from repro.core import thinning as jthinning                 # noqa: E402
from repro_torch.core import (EngineConfig, Event,           # noqa: E402
                              diagnostics, estimators, init_state,
                              intensity, make_step, prng_key, thinning)

f32 = lambda x: torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------- Eq. 2 / Eq.4
@given(lam=st.floats(1e-6, 1e6), budget=st.floats(1e-6, 1e3))
@settings(max_examples=200, deadline=None)
def test_naive_inclusion_bounds(lam, budget):
    p = float(thinning.naive_inclusion(f32(lam), budget))
    assert 0.0 < p <= 1.0
    assert p <= max(budget / lam, 1e-6) * (1 + 1e-4) or p == 1.0
    assert p == float(jthinning.naive_inclusion(jnp.float32(lam), budget))


@given(lam=st.floats(1e-3, 1e3), budget=st.floats(1e-3, 10.0),
       w=st.floats(-1e4, 1e4), mu=st.floats(-100, 100),
       sigma=st.floats(1e-3, 1e3), alpha=st.floats(0.0, 5.0))
@settings(max_examples=200, deadline=None)
def test_variance_aware_inclusion_valid_prob(lam, budget, w, mu, sigma, alpha):
    p = float(thinning.variance_aware_inclusion(
        f32(lam), budget, f32(w), f32(mu), f32(sigma), alpha))
    assert 0.0 < p <= 1.0
    assert math.isfinite(p)
    want = float(jthinning.variance_aware_inclusion(
        jnp.float32(lam), budget, jnp.float32(w), jnp.float32(mu),
        jnp.float32(sigma), alpha))
    assert p == pytest.approx(want, rel=1e-5)


def test_variance_aware_monotone_in_magnitude():
    """Eq. 4: inclusion probability increases with standardized |contribution|."""
    lam = f32(10.0)
    ws = torch.linspace(-5, 5, 21)
    ps = thinning.variance_aware_inclusion(lam, 0.5, ws, f32(0.0), f32(1.0),
                                           2.0)
    assert bool(torch.all(torch.diff(ps) > 0))


def test_variance_aware_alpha0_equals_naive():
    lam = f32(7.0)
    p_naive = thinning.naive_inclusion(lam, 0.3)
    p_va = thinning.variance_aware_inclusion(lam, 0.3, f32(123.0), f32(0.0),
                                             f32(1.0), 0.0)
    np.testing.assert_allclose(float(p_naive), float(p_va), rtol=1e-5)


# --------------------------------------------------------------- HT estimator
@given(seed=st.integers(0, 2**30), n=st.integers(5, 60))
@settings(max_examples=30, deadline=None)
def test_ht_aggregate_unbiased(seed, n):
    """Monte-Carlo check of App. A.1 through the port's ``ht_update`` and
    ``decay_to``: E[A_hat] == A for a fixed p sequence."""
    rng = np.random.default_rng(seed)
    qs = rng.lognormal(0, 1, n)
    ts = np.sort(rng.uniform(0, 100, n))
    tau = 50.0
    t_end = 100.0
    ps = rng.uniform(0.2, 1.0, n)
    truth = np.sum(qs * np.exp(-(t_end - ts) / tau))
    n_mc = 600
    z = torch.from_numpy(rng.random((n_mc, n)) < ps[None, :])
    taus = torch.tensor([tau], dtype=torch.float64)
    agg = torch.zeros((n_mc, 1, 3), dtype=torch.float64)
    last = torch.full((n_mc,), -math.inf, dtype=torch.float64)
    for i in range(n):
        t = torch.full((n_mc,), ts[i], dtype=torch.float64)
        agg = estimators.decay_to(agg, torch.where(torch.isinf(last), t,
                                                   last), t, taus)
        agg = estimators.ht_update(
            agg, torch.full((n_mc,), qs[i], dtype=torch.float64), z[:, i],
            torch.full((n_mc,), ps[i], dtype=torch.float64))
        last = t
    end = torch.full((n_mc,), t_end, dtype=torch.float64)
    est = estimators.decay_to(agg, last, end, taus)[:, 0, 1].numpy()
    se = est.std() / math.sqrt(n_mc)
    assert abs(est.mean() - truth) < 5 * se + 1e-9


def test_ht_variance_formula_matches_mc():
    """Eq. (3) with deterministic p: Var = sum w^2 (1/p - 1), against the
    port's ``ht_variance_bound``."""
    rng = np.random.default_rng(3)
    n, n_mc = 20, 200_000
    w = rng.lognormal(0, 1, n)
    p = rng.uniform(0.3, 0.9, n)
    z = rng.random((n_mc, n)) < p[None, :]
    est = np.sum(np.where(z, w / p, 0.0), axis=1)
    analytic = float(estimators.ht_variance_bound(
        torch.from_numpy(w), torch.from_numpy(p)).sum())
    np.testing.assert_allclose(analytic, np.sum(w * w * (1.0 / p - 1.0)),
                               rtol=1e-12)
    np.testing.assert_allclose(est.var(), analytic, rtol=0.05)


def test_recursive_equals_direct_decayed_sum():
    """§3.3 recursion (the port's ``decay_to`` + an unfiltered update) ==
    closed-form decayed aggregate."""
    rng = np.random.default_rng(4)
    n = 50
    qs = rng.lognormal(0, 1, n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1000, n)).astype(np.float32)
    taus = torch.tensor([30.0, 300.0])
    a = torch.zeros((2, 3))
    last = None
    for q, t in zip(qs, ts):
        a = estimators.decay_to(a, f32(last if last is not None else t),
                                f32(t), taus)
        a = a + torch.tensor([1.0, q, q * q])[None, :]
        last = t
    direct = np.stack([
        np.sum(np.exp(-(ts[-1] - ts) / tau)[:, None]
               * np.stack([np.ones_like(qs), qs, qs * qs], -1), axis=0)
        for tau in (30.0, 300.0)])
    np.testing.assert_allclose(a.numpy(), direct, rtol=1e-4)


# ------------------------------------------------------------- Remark 4.1/4.2
def test_martingale_increments_centered():
    """App. C: normalized deviation increments are conditionally mean-zero
    (and the port's diagnostics copy draws what the JAX module draws)."""
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.exponential(1.0, 60))
    inc = diagnostics.martingale_increments(ts, h=20.0, budget=0.3, n_runs=4000)
    np.testing.assert_array_equal(
        inc[:50], jdiag.martingale_increments(ts, h=20.0, budget=0.3,
                                              n_runs=50))
    inc = inc[:, :40]  # keep normalization factor representable
    m = inc.mean(axis=0)
    se = inc.std(axis=0) / math.sqrt(inc.shape[0])
    frac_within = np.mean(np.abs(m) < 4 * se + 1e-9)
    assert frac_within > 0.9, (m, se)


def test_oversampling_bound():
    """App. D: E[N_F] >= E[N] (filtered control can only oversample)."""
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.exponential(0.2, 400))  # high intensity -> p < 1 regime
    nf, n = diagnostics.oversampling_gap(ts, h=10.0, budget=0.5, n_runs=300)
    assert nf >= n * 0.98, (nf, n)  # allow MC slack; theory says nf >= n


def test_write_budget_respected():
    """Eq. 2 guarantee: steady-state write rate <= Lambda (high-rate
    regime), counted after the KDE's ~h warm-up."""
    rng = np.random.default_rng(2)
    ts = np.cumsum(rng.exponential(0.05, 4000))  # lam ~ 20/s
    budget, h = 0.5, 10.0
    warm = ts > 5 * h
    nf, n = 0.0, 0.0
    n_runs = 50
    for s in range(n_runs):
        r = diagnostics.simulate_entity(ts, h, budget,
                                        np.random.default_rng(1000 + s))
        n += r["z_full"][warm].sum() / n_runs
        nf += r["z_filt"][warm].sum() / n_runs
    horizon = ts[-1] - ts[warm][0]
    assert n <= budget * horizon * 1.10, (n, budget * horizon)
    # filtered control oversamples but stays within a modest factor (Fig. 7)
    assert nf <= budget * horizon * 1.6, (nf, budget * horizon)


# ---------------------------------------------------- engine-level statistics
def test_engine_ht_sum_unbiased_vs_truth():
    """End-to-end: the port's thinned exact-mode engine keeps the decayed
    sum ~unbiased for the true one."""
    rng = np.random.default_rng(5)
    n_events, n_entities = 400, 4
    probs = np.array([0.85, 0.05, 0.05, 0.05])
    keys = rng.choice(n_entities, n_events, p=probs).astype(np.int32)
    ts = np.cumsum(rng.exponential(2.0, n_events)).astype(np.float32)
    qs = rng.lognormal(0, 0.5, n_events).astype(np.float32)
    tau, t_end = 500.0, float(ts[-1])
    truth = np.zeros(n_entities)
    for k, q, t in zip(keys, qs, ts):
        truth[k] += q * np.exp(-(t_end - t) / tau)

    cfg = EngineConfig(taus=(tau,), h=100.0, budget=0.05, policy="pp",
                       exact_rounds=32)
    step = make_step(cfg, "exact")
    n_mc = 40
    sums = np.zeros((n_mc, n_entities))
    writes = 0
    for m in range(n_mc):
        state = init_state(n_entities, 1, device="cpu")
        root = prng_key(100 + m)
        for i in range(0, n_events, 32):
            k, q, t = keys[i:i + 32], qs[i:i + 32], ts[i:i + 32]
            pad = 32 - len(k)
            ev = Event(key=torch.from_numpy(np.pad(k, (0, pad))),
                       q=torch.from_numpy(np.pad(q, (0, pad))),
                       t=torch.from_numpy(np.pad(t, (0, pad))),
                       valid=torch.from_numpy(np.pad(np.ones(len(k), bool),
                                                     (0, pad))))
            state, info = step(state, ev, root)
            writes += int(info.writes)
        decayed = estimators.decay_to(state.agg, state.last_t, f32(t_end),
                                      torch.tensor(cfg.taus))
        sums[m] = decayed[:, 0, 1].numpy()
    # substantial thinning happened
    assert writes / (n_mc * n_events) < 0.75
    est = sums.mean(axis=0)
    se = sums.std(axis=0) / math.sqrt(n_mc) + 1e-6
    # hot key (0) must stay unbiased despite aggressive thinning
    assert abs(est[0] - truth[0]) < 5 * se[0] + 0.05 * truth[0]


def test_kde_estimator_tracks_constant_rate():
    """App. B: for homogeneous arrivals, E[lam_hat] -> lam (low bias)."""
    lam_true, h = 5.0, 50.0
    runs = []
    for s in range(200):
        ts = np.cumsum(np.random.default_rng(s).exponential(1 / lam_true,
                                                            2000))
        lam_hat = float(intensity.kde_intensity_dense(
            torch.tensor(ts, dtype=torch.float32),
            torch.tensor([ts[-1]], dtype=torch.float32), h)[0])
        runs.append(lam_hat)
    np.testing.assert_allclose(np.mean(runs), lam_true, rtol=0.05)

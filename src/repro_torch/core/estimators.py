"""Horvitz–Thompson decayed aggregates (paper §3.2–3.4), PyTorch.

The counterpart of ``repro.core.estimators``.  Per (entity, tau) the state
keeps the HT count (w=1), sum (w=q) and sum of squares (w=q^2) under the
recursive masked update

    A_hat(t_n) = Z_n * w(t_n, e_n) / p_n + exp(-(t_n - t_{n-1})/tau) * A_hat(t_{n-1}),

and Eq. 4's (mu_w, sigma_w) are read from these same persisted columns.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import intensity
from repro_torch.core.types import AGG_COUNT, AGG_SUM, AGG_SUMSQ


def decay_to(agg: torch.Tensor, last_t: torch.Tensor, t: torch.Tensor,
             taus: torch.Tensor) -> torch.Tensor:
    """Lazily decay aggregates [..., T, 3] from last_t to t (exact composition)."""
    beta = intensity.decay((t - last_t)[..., None], taus)  # [..., T]
    return agg * beta[..., None]


def ht_update(agg_decayed: torch.Tensor, q: torch.Tensor, z: torch.Tensor,
              p: torch.Tensor) -> torch.Tensor:
    """Apply the HT-masked contribution to already-decayed aggregates."""
    inv_p = torch.where(z, 1.0 / p, 0.0)
    w = torch.stack([torch.ones_like(q), q, q * q], dim=-1)  # [..., 3]
    return agg_decayed + inv_p[..., None, None] * w[..., None, :]


def mean_estimate(agg: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """HT ratio estimator of the decayed mean: sum / count per tau."""
    return agg[..., AGG_SUM] / torch.clamp_min(agg[..., AGG_COUNT], eps)


def variance_estimate(agg: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    cnt = torch.clamp_min(agg[..., AGG_COUNT], eps)
    mean = agg[..., AGG_SUM] / cnt
    return torch.clamp_min(agg[..., AGG_SUMSQ] / cnt - mean * mean, 0.0)


def contribution_moments(agg: torch.Tensor, tau_index: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu_w, sigma_w) for Eq. 4, read from the persisted aggregates."""
    sel = agg[..., tau_index, :]
    cnt = torch.clamp_min(sel[..., AGG_COUNT], 1e-12)
    mu = sel[..., AGG_SUM] / cnt
    var = torch.clamp_min(sel[..., AGG_SUMSQ] / cnt - mu * mu, 0.0)
    # Fresh entities (count ~ 0) fall back to a unit-scale standardization.
    cold = sel[..., AGG_COUNT] < 1.0
    return (torch.where(cold, 0.0, mu),
            torch.where(cold, 1e8, torch.sqrt(var) + 1e-8))


def materialize(agg_now: torch.Tensor) -> torch.Tensor:
    """Feature vector from decayed aggregates [..., T, 3] -> [..., 4*T]:
    count, sum, mean, std per decay constant (§6.1)."""
    return torch.cat([agg_now[..., AGG_COUNT], agg_now[..., AGG_SUM],
                      mean_estimate(agg_now),
                      torch.sqrt(variance_estimate(agg_now))], dim=-1)


def ht_variance_bound(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-event variance term of Eq. (3): w^2 (E[1/p] - 1), given realized p."""
    return w * w * (1.0 / p - 1.0)

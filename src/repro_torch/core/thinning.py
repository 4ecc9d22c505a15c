"""Inclusion-probability policies (paper Eq. 2 and Eq. 4) and Bernoulli draws.

The counterpart of ``repro.core.thinning``.  The counter RNG (threefry-2x32,
bit for bit as ``jax.random``) lives in ``repro_torch.kernels.threefry``,
beside the kernel that draws the same uniforms in-kernel; its public names
are re-exported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.kernels.threefry import (as_key, prng_key,  # noqa: F401
                                          threefry2x32, time_bits,
                                          uniform_for_events)


def bernoulli_mask(rng, key_ids: torch.Tensor, seq_ids: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    """Reproducible, order-independent thinning decisions."""
    return uniform_for_events(rng, key_ids, seq_ids) < p


def naive_inclusion(lam_hat: torch.Tensor, budget: float,
                    min_p: float = 1e-6) -> torch.Tensor:
    """Eq. (2):  p = min(1, Lambda / lam_hat)."""
    ratio = torch.div(torch.full_like(lam_hat, budget),
                      torch.clamp_min(lam_hat, 1e-30))
    return torch.clamp(torch.clamp_max(ratio, 1.0), min_p, 1.0)


def _logit(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.clamp(p, eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


def variance_aware_inclusion(lam_hat: torch.Tensor, budget: float,
                             w: torch.Tensor, mu_w: torch.Tensor,
                             sigma_w: torch.Tensor, alpha: float,
                             min_p: float = 1e-6) -> torch.Tensor:
    """Eq. (4):  p = sigmoid(logit(min(1, Lambda/lam_hat)) + alpha*(w-mu)/sigma)."""
    base = torch.clamp_max(torch.div(torch.full_like(lam_hat, budget),
                                     torch.clamp_min(lam_hat, 1e-30)), 1.0)
    zscore = torch.clamp((w - mu_w) / torch.clamp_min(sigma_w, 1e-8),
                         -8.0, 8.0)
    p = torch.sigmoid(_logit(base) + alpha * zscore)
    # Events already at p≈1 under the naive rule stay mandatory.
    p = torch.where(base >= 1.0 - 1e-6, 1.0, p)
    return torch.clamp(p, min_p, 1.0)


def fixed_rate_inclusion(shape, rate: float, min_p: float = 1e-6,
                         device=None) -> torch.Tensor:
    """Naive fixed-rate baseline (global probability, activity-independent)."""
    return torch.full(shape, min(max(float(np.float32(rate)), min_p), 1.0),
                      dtype=torch.float32, device=resolve_device(device))

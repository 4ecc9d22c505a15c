"""Inclusion-probability policies (paper Eq. 2 and Eq. 4) and Bernoulli draws.

The counterpart of ``repro.core.thinning``.  The counter RNG reproduces
``jax.random``'s threefry-2x32 bit for bit, so an event gets the same
uniform — hence the same thinning decision — in both packages.  A key is a
plain ``(k0, k1)`` pair of uint32 words: ``prng_key(seed)`` returns the two
words ``jax.random.PRNGKey(seed)`` holds, and ``np.asarray`` of a JAX key
may be passed wherever a key is taken.  torch has no uint32 arithmetic, so
the words travel in int64 tensors masked to 32 bits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> Tuple[int, int]:
    """The two uint32 words of ``jax.random.PRNGKey(seed)`` (32-bit seeds)."""
    return (0, int(seed) & _M32)


def as_key(rng) -> Tuple[int, int]:
    """Normalize a key (pair, numpy array or tensor of two words)."""
    words = np.asarray(rng.cpu() if isinstance(rng, torch.Tensor) else rng)
    words = words.astype(np.int64).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {words.shape}")
    return (int(words[0]) & _M32, int(words[1]) & _M32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, as ``jax.random`` computes it.

    Keys and counters are ints or int64 tensors holding uint32 values (at
    least one operand must be a tensor); returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def time_bits(t: torch.Tensor) -> torch.Tensor:
    """Per-event RNG counter: the float32 bit pattern of the timestamp
    (as an int64 tensor holding the uint32 value)."""
    return t.to(torch.float32).view(torch.int32).to(torch.int64) & _M32


def uniform_for_events(rng, key_ids: torch.Tensor,
                       seq_ids: torch.Tensor) -> torch.Tensor:
    """U[0, 1) per event from ``fold_in(fold_in(rng, key), seq)``.

    ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``; a scalar uniform takes
    the xor of the two words of ``threefry2x32(k, (0, 0))`` and keeps its
    top 23 bits as the mantissa of a float in [1, 2).
    """
    k0, k1 = as_key(rng)
    e = key_ids.to(torch.int64) & _M32
    s = seq_ids.to(torch.int64) & _M32
    a0, a1 = threefry2x32(k0, k1, 0, e)
    b0, b1 = threefry2x32(a0, a1, 0, s)
    c0, c1 = threefry2x32(b0, b1, 0, 0)
    bits = ((c0 ^ c1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


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

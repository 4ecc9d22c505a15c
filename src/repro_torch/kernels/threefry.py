"""The counter RNG of the thinning decisions: threefry-2x32 as ``jax.random``.

An event's uniform is ``fold_in(fold_in(key, entity), time_bits(t))``
through threefry-2x32, bit for bit as the JAX package draws it, so an
event gets the same decision in both packages.  A key is a plain
``(k0, k1)`` pair of uint32 words: ``prng_key(seed)`` returns the two words
``jax.random.PRNGKey(seed)`` holds, and ``np.asarray`` of a JAX key may be
passed wherever a key is taken.  torch has no uint32 arithmetic, so the
words travel in int64 tensors masked to 32 bits.

This is the plain version of the uniform that the keyed ``thinning_rmw``
kernel draws in-kernel (``csrc/thinning_rmw.cu``, ``event_uniform``).
``cuda_calls`` counts calls of ``uniform_for_events`` on CUDA tensors, so a
run can show that its main path left the uniforms to the kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

cuda_calls = 0          # uniform_for_events calls on CUDA tensors


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

    Keys and counters are ints, or int64 tensors or numpy arrays holding
    uint32 values (at least one operand must be an array); returns the two
    output words.
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
    global cuda_calls
    if key_ids.is_cuda:
        cuda_calls += 1
        words = lambda x: x.to(torch.int64) & _M32
    else:   # the same arithmetic on numpy arrays: a third of torch's cost
        words = lambda x: x.numpy().astype(np.int64) & _M32
    k0, k1 = as_key(rng)
    a0, a1 = threefry2x32(k0, k1, 0, words(key_ids))
    b0, b1 = threefry2x32(a0, a1, 0, words(seq_ids))
    c0, c1 = threefry2x32(b0, b1, 0, 0)
    bits = torch.as_tensor(((c0 ^ c1) >> 9) | 0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0

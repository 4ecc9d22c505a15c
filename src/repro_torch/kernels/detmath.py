"""Deterministic float32 exp for the persistence path (PyTorch).

The counterpart of ``repro.kernels.detmath``.  ``det_exp`` is the one
transcendental on the decision/update path: Cody-Waite range reduction, a
degree-6 Horner polynomial and an exact power-of-two scale, every step
individually rounded.  The JAX reference needs ``pin``/``zero32`` to stop
XLA from contracting ``a*b + c`` into an FMA; eager torch runs each op as
its own kernel, so every product here is already rounded once and the
plain op sequence is the contract.  The CUDA kernel
(``csrc/thinning_rmw.cu``) spells the same sequence with ``__fmul_rn`` /
``__fadd_rn``.
"""
from __future__ import annotations

import torch

# Cephes expf constants (the same set as the JAX reference).
_LOG2E = 1.4426950408889634
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
# exp(x) underflows f32 below ~-87.33; clamp keeps 2^k representable.
_EXP_LO = -87.0
_EXP_HI = 88.0


def det_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp(x): ~1 ulp, exp(0) == 1 exactly, 0.0 below -87.

    Python float constants are rounded once to f32 by torch's scalar ops,
    which is JAX's weak-type rule for the same spelling.
    """
    x = x.to(torch.float32)
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    kf = torch.round(xc * _LOG2E)              # round half to even
    # Cody-Waite: r = x - k*ln2, in two exactly-rounded steps.
    r = xc - kf * _LN2_HI
    r = r - kf * _LN2_LO
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = y * r + c
    rr = r * r
    y = y * rr + r + 1.0
    # 2^k by exponent-bit construction (exact), applied as an exact multiply.
    two_k = ((kf.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * two_k
    return torch.where(x < _EXP_LO, 0.0, out)

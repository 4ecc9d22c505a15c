"""Public wrapper of the fused persistence-path RMW (PyTorch).

The counterpart of ``repro.kernels.ops.thinning_rmw``: the single
decision + update implementation that ``core/engine.py`` routes both
execution modes through.  Dispatch follows the tensors, not a flag: CUDA
tensors go to the hand-written kernel (``kernels/thinning_rmw.py``), CPU
tensors to the plain version (``kernels/ref.py``).  There is no fallback
from one to the other — a CUDA tensor reaches the kernel or the call raises.

Two contracts every caller inherits from the reference:

* **Full-stream control column.**  ``v_full`` / ``last_t_full`` advance on
  every valid event, the persisted columns only on ``z``.  Decision-only
  callers may omit them (fresh rows); callers that persist state must
  scatter both returned columns back.
* **Functional RMW.**  The wrapper reads gathered rows and returns new
  rows; it never writes its inputs.  In-place state updates happen in the
  engine's scatters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import thinning_rmw as _tr
from repro_torch.kernels.ref import FRESH_SENTINEL, POLICIES


def thinning_rmw(taus, last_t, v_f, agg_flat, q, t, u, valid,
                 v_full=None, last_t_full=None, *,
                 h: float, budget: float, alpha: float = 0.0,
                 policy: str = "pp", fixed_rate: float = 0.1,
                 mu_tau_index: int = 2, min_p: float = 1e-6):
    """Fused persistence-path RMW decision + update over gathered rows.

    ``policy`` selects the inclusion rule ('pp', 'pp_vr', 'full', 'fixed',
    'unfiltered').  Returns (new_last_t, new_v_f, new_agg_flat, z, p,
    features, lam, new_v_full, new_last_t_full).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    kw = dict(h=h, budget=budget, alpha=alpha, policy=policy,
              fixed_rate=fixed_rate, mu_tau_index=mu_tau_index, min_p=min_p)
    if v_full is None:
        v_full = torch.zeros_like(last_t)
    if last_t_full is None:
        last_t_full = torch.full_like(last_t, FRESH_SENTINEL)
    args = (taus, last_t, v_f, agg_flat, q, t, u, valid, v_full, last_t_full)
    device = last_t.device
    if device.type == "cuda":
        return _tr.thinning_rmw_cuda(*args, **kw)
    if device.type == "cpu":
        return ref.thinning_rmw_ref(*args, **kw)
    raise ValueError(f"thinning_rmw has no implementation for {device}")

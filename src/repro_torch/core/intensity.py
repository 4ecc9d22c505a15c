"""Arrival-intensity estimation (paper §4.1–4.2), PyTorch.

The counterpart of ``repro.core.intensity``.  Full-stream KDE estimator
(Eq. 5) and its persistence-path *filtered* counterpart share the
constant-space recurrence

    v(t_n) = c_n + exp(-(t_n - t_{n-1})/h) * v(t_{n-1}),      lam_hat = v / h

with c_n = 1 (every event) or c_n = Z_n / p_n (persisted events, HT
re-weighted).  Skipped updates compose lazily, so storing (v, last_t) and
decaying at the next persisted event is exact.
"""
from __future__ import annotations

import torch


def decay(dt: torch.Tensor, h) -> torch.Tensor:
    """exp(-dt/h) with dt=inf (fresh entity) mapping to 0."""
    dt = torch.clamp_min(dt, 0.0)
    return torch.where(torch.isfinite(dt), torch.exp(-dt / h), 0.0)


def lam_hat_from_state(v: torch.Tensor, last_t: torch.Tensor,
                       t: torch.Tensor, h: float) -> torch.Tensor:
    """lam_hat(t) = (1 + decay * v_prev) / h at decision time."""
    return (1.0 + decay(t - last_t, h) * v) / h


def update_v(v: torch.Tensor, last_t: torch.Tensor, t: torch.Tensor,
             h: float, contrib: torch.Tensor) -> torch.Tensor:
    """v(t) = contrib + exp(-(t - last_t)/h) v(last_t)."""
    return contrib + decay(t - last_t, h) * v


def kde_intensity_dense(ts: torch.Tensor, t_eval: torch.Tensor,
                        h: float) -> torch.Tensor:
    """O(N·M) reference: lam_hat(t) = (1/h) * sum_{t_n <= t} exp(-(t-t_n)/h).

    Used by tests/diagnostics only.
    """
    dt = t_eval[:, None] - ts[None, :]
    return torch.where(dt >= 0, torch.exp(-dt / h), 0.0).sum(dim=1) / h

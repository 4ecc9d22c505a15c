"""Core datatypes for persistence-path control (PyTorch).

The counterpart of ``repro.core.types``.  The durable per-entity state is
deliberately minimal: thinning decisions read *only* state already persisted
for feature maintenance (paper §4) — the filtered KDE numerator ``v_f`` and
the decayed count/sum/sumsq aggregates.

Every entry point runs on ``cuda:0`` unless the caller names a device
(``device="cpu"``, as the tests do).  Without a GPU and without an explicit
device they raise: nothing carries on silently on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

# Aggregate columns maintained per (entity, tau).
AGG_COUNT = 0
AGG_SUM = 1
AGG_SUMSQ = 2
NUM_AGG_COLS = 3


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless one is named.

    A CUDA device named without an index (``"cuda"``) resolves to the
    current card's index, the device its tensors report, so two entry
    points given ``"cuda"`` and ``"cuda:0"`` agree."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Event(NamedTuple):
    """A micro-batch of events (tensors of length B)."""

    key: torch.Tensor    # int [B] entity index
    q: torch.Tensor      # float32 [B] quantitative mark (e.g. amount)
    t: torch.Tensor      # float32 [B] event timestamp (seconds)
    valid: torch.Tensor  # bool [B] padding mask


class ProfileState(NamedTuple):
    """Durable, entity-partitioned profile table (the KV store contents).

    Shapes: E = number of entities, T = number of decay constants.  The
    engine updates these tensors in place.
    """

    last_t: torch.Tensor   # f32 [E] time of last *persisted* event (-inf if fresh)
    v_f: torch.Tensor      # f32 [E] filtered KDE numerator  (paper §4.2)
    agg: torch.Tensor      # f32 [E, T, 3] HT decayed count / sum / sumsq (§3.3)
    # Reference full-stream control column (baseline only).
    v_full: torch.Tensor   # f32 [E] unfiltered KDE numerator (Eq. 5)
    last_t_full: torch.Tensor  # f32 [E] last *event* time (full-stream)

    @property
    def num_entities(self) -> int:
        return self.last_t.shape[0]

    @property
    def num_taus(self) -> int:
        return self.agg.shape[1]

    @property
    def device(self) -> torch.device:
        return self.last_t.device


def init_state(num_entities: int, num_taus: int, dtype=torch.float32,
               device=None) -> ProfileState:
    """A fresh state; every leaf owns its storage (the engine writes in place)."""
    dev = resolve_device(device)
    return ProfileState(
        last_t=torch.full((num_entities,), -torch.inf, dtype=dtype,
                          device=dev),
        v_f=torch.zeros((num_entities,), dtype=dtype, device=dev),
        agg=torch.zeros((num_entities, num_taus, NUM_AGG_COLS), dtype=dtype,
                        device=dev),
        v_full=torch.zeros((num_entities,), dtype=dtype, device=dev),
        last_t_full=torch.full((num_entities,), -torch.inf, dtype=dtype,
                               device=dev),
    )


def state_from_numpy(last_t, v_f, agg, v_full, last_t_full,
                     device=None) -> ProfileState:
    """A ``ProfileState`` holding copies of five host arrays (any array
    the caller hands over, e.g. ``np.asarray`` of another engine's state)."""
    dev = resolve_device(device)
    own = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    return ProfileState(own(last_t), own(v_f), own(agg), own(v_full),
                        own(last_t_full))


def state_to_numpy(state: ProfileState) -> ProfileState:
    """The state's five columns as host numpy arrays."""
    return ProfileState(*(x.detach().cpu().numpy() for x in state))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration of the feature-engine thinning mechanism.

    Attributes:
      taus: decay constants (seconds) for the maintained aggregations; the
        paper uses windows from 1 minute to 120 days (§6.1).
      h: KDE bandwidth (seconds) for arrival-intensity estimation (Eq. 5).
      budget: user-defined write budget Lambda (expected writes / second / key).
      alpha: variance-aware tilt strength (Eq. 4); 0 disables.
      policy: 'pp' (persistence-path, Eq. 2), 'pp_vr' (persistence-path +
        variance reduction, Eq. 4), 'full' (full-stream control baseline),
        'fixed' (naive fixed-rate baseline), 'unfiltered'.
      fixed_rate: inclusion probability for the 'fixed' policy.
      mu_tau_index: which tau's aggregates supply (mu_w, sigma_w) for Eq. 4.
      min_p: numerical floor on inclusion probabilities.
      exact_rounds: static bound on events-per-key-per-microbatch for the
        exact sequential-semantics mode.
    """

    taus: Sequence[float] = (60.0, 3600.0, 86400.0, 30 * 86400.0, 60 * 86400.0, 120 * 86400.0)
    h: float = 3600.0
    budget: float = 0.01
    alpha: float = 0.0
    policy: str = "pp"
    fixed_rate: float = 0.1
    mu_tau_index: int = 2
    min_p: float = 1e-6
    exact_rounds: int = 16

    def __post_init__(self):
        if self.policy not in ("pp", "pp_vr", "full", "fixed", "unfiltered"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if not self.taus:
            raise ValueError("need at least one decay constant")
        # hashable tuple: configs key the driver caches
        object.__setattr__(self, "taus", tuple(self.taus))
        if not 0 <= self.mu_tau_index < len(self.taus):
            # standardization window defaults to the longest maintained
            # decay when the configured index exceeds the tau list
            object.__setattr__(self, "mu_tau_index", len(self.taus) - 1)


class StepInfo(NamedTuple):
    """Per-event observability emitted by one engine step."""

    z: torch.Tensor         # bool [B] persisted?
    p: torch.Tensor         # f32 [B] inclusion probability used
    lam_hat: torch.Tensor   # f32 [B] intensity estimate at decision time
    features: torch.Tensor  # f32 [B, F] materialized feature vector (pre-update)
    writes: torch.Tensor    # i32 [] number of persistence ops this batch

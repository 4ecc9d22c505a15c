"""Persistence-path control — the paper's primary contribution, in PyTorch.

Public API:
  - ``EngineConfig``, ``ProfileState``, ``Event``, ``StepInfo`` (types)
  - ``init_state``, ``state_from_numpy``, ``state_to_numpy``
  - ``make_step``, ``materialize_features`` (engine)
  - ``run_stream`` (in-place block driver, core/stream.py)
  - ``prng_key`` and the thinning policies (core/thinning.py), intensity
    estimators and Horvitz–Thompson decayed aggregates
  - ``diagnostics``: the single-entity processes of the theory (App. C/D)
"""
from repro_torch.core.types import (Event, EngineConfig, ProfileState,
                                    StepInfo, init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.core.engine import make_step, materialize_features
from repro_torch.core.stream import run_stream
from repro_torch.core.thinning import prng_key
from repro_torch.core import thinning, intensity, estimators, diagnostics

__all__ = [
    "Event", "EngineConfig", "ProfileState", "StepInfo", "init_state",
    "state_from_numpy", "state_to_numpy", "make_step",
    "materialize_features", "run_stream", "prng_key", "thinning",
    "intensity", "estimators", "diagnostics",
]

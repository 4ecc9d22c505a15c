"""Feature-profile specifications (the paper's §6.1 feature set).

The counterpart of ``repro.features.spec``, copied: it is plain Python.

A profile is a set of exponentially decayed aggregations per entity; the
paper uses decay factors approximating windows of 1 minute, 1 hour and 1,
30, 60, 120 days, with counts / sums / means per window, all realizable as
constant-space recursive updates (Table 1).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.core.types import EngineConfig

MINUTE = 60.0
HOUR = 3600.0
DAY = 86400.0

PAPER_WINDOWS: Tuple[float, ...] = (
    MINUTE, HOUR, DAY, 30 * DAY, 60 * DAY, 120 * DAY)


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """Which aggregations a profile maintains and how it is thinned."""
    windows: Sequence[float] = PAPER_WINDOWS
    kde_bandwidth: float = HOUR
    write_budget_per_min: float = 0.6       # Lambda, events/min/key
    variance_alpha: float = 0.0             # Eq. 4 tilt (0 = naive rule)
    policy: str = "pp"

    @property
    def feature_dim(self) -> int:
        return 4 * len(self.windows)        # count, sum, mean, std / window

    def engine_config(self, **overrides) -> EngineConfig:
        kw = dict(
            taus=tuple(self.windows),
            h=self.kde_bandwidth,
            budget=self.write_budget_per_min / 60.0,
            alpha=self.variance_alpha,
            policy=self.policy,
        )
        kw.update(overrides)
        return EngineConfig(**kw)

    def feature_names(self) -> list:
        names = []
        for stat in ("count", "sum", "mean", "std"):
            for w in self.windows:
                if w < HOUR:
                    tag = f"{int(w / MINUTE)}m"
                elif w < DAY:
                    tag = f"{int(w / HOUR)}h"
                else:
                    tag = f"{int(w / DAY)}d"
                names.append(f"{stat}_{tag}")
        return names

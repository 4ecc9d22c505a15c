"""Feature substrate (PyTorch port): profile specs + the feature engine."""
from repro_torch.features.engine import ShardedFeatureEngine
from repro_torch.features.spec import PAPER_WINDOWS, ProfileSpec

__all__ = ["ShardedFeatureEngine", "ProfileSpec", "PAPER_WINDOWS"]

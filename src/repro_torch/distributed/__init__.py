"""Distribution (PyTorch port): skew-aware virtual-shard layouts.  The
mesh context and sharding rules are not ported (multi-GPU is ROADMAP.md
queue 1 item 9)."""
from repro_torch.distributed import rebalance

__all__ = ["rebalance"]

"""Distribution (PyTorch port): skew-aware virtual-shard layouts, the
sharded feature engine's collectives and the harness that starts its
ranks, one process a shard (``ShardedFeatureEngine(mesh=...)``).  The LM
mesh context and sharding rules are not ported (ROADMAP.md queue 1
item 3)."""
from repro_torch.distributed import collectives, rebalance, spawn

__all__ = ["collectives", "rebalance", "spawn"]

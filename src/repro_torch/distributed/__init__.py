"""Distribution (PyTorch port): skew-aware virtual-shard layouts, the
collectives of the sharded feature engine and of the expert-parallel MoE,
the harness that starts their ranks (one process a shard or mesh device),
and the mesh context that ``models/moe_ep.py`` reads.  The sharding rules
of the dry-run stack are not ported (ROADMAP.md queue 1 item 3)."""
from repro_torch.distributed import collectives, context, rebalance, spawn

__all__ = ["collectives", "context", "rebalance", "spawn"]

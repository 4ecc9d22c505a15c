"""Fault tolerance: async integrity-checked checkpointing + elastic restore
(PyTorch port of ``repro.checkpoint``; same on-disk format)."""
from repro_torch.checkpoint.elastic import repartition_profile_state
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "repartition_profile_state"]

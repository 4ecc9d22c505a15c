"""Streaming substrate (PyTorch port): workload generation, the byte-backed
KV store, the durable WAL backend and its fault injection, the resident
set and host L2 tier, the write-behind sink, the per-event worker and the
closed-loop / fixed-rate replay drivers."""
from repro_torch.streaming import (durable, faults, kvstore, persistence,
                                   replay, residency, worker, workload)

__all__ = ["durable", "faults", "kvstore", "persistence", "replay",
           "residency", "worker", "workload"]

"""Streaming substrate (PyTorch port): workload generation, the byte-backed
KV store, the durable WAL backend, the resident set and host L2 tier, the
write-behind sink and the per-event worker.  Fault injection and replay are
not ported yet."""
from repro_torch.streaming import (durable, kvstore, persistence, residency,
                                   worker, workload)

__all__ = ["durable", "kvstore", "persistence", "residency", "worker",
           "workload"]

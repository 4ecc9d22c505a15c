"""Streaming substrate (PyTorch port): workload generation, the byte-backed
KV store, the durable WAL backend, the host L2 tier and the write-behind
sink.  The per-event worker, fault injection and replay are not ported
yet."""
from repro_torch.streaming import (durable, kvstore, persistence, residency,
                                   workload)

__all__ = ["durable", "kvstore", "persistence", "residency", "workload"]

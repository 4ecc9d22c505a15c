"""Collective, FLOP and byte accounting of one step (PyTorch counterpart
of ``repro.launch.hlo_analysis``).

A torch program has no HLO to parse, so the dry-run runs the real step
under ``FakeTensorMode`` (no storage, on a fake process group) inside
``StepAnalysis``, a ``TorchDispatchMode`` that sees every operation on
this rank's local tensors:

* collectives: each ``_c10d_functional`` (DTensor's redistributions) or
  ``c10d`` op, with its kind, result bytes and group size, converted to
  *per-device bytes on the wire* with the reference's ring factors over
  the group size n:

      all-gather        result * (n-1)/n      (each device receives the rest)
      reduce-scatter    result * (n-1)        (operand = n * result shards)
      all-reduce        2 * size * (n-1)/n    (RS + AG ring)
      all-to-all        size * (n-1)/n
      collective-permute size                 (one send per device)

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, with the kernels'
  own formulas (``kernels/ops.py``);
* bytes accessed: every local op's input and output bytes (views and
  collectives excluded).  The hand-written kernels are one op each, so
  they count as their inputs and outputs: their intermediates (the
  attention's score tiles, the scan's carries) stay in shared memory and
  registers, which is what the reference's ``attention_stub`` stood for;
* memory: ``argument_size_in_bytes``, the exact sum of every argument's
  local shard bytes, and ``peak_bytes_estimate``, the most bytes that
  arguments and live op outputs (not views) held at once, tracked by
  the outputs' lifetimes: an estimate (the caching allocator's blocks,
  fragmentation and library workspaces are not seen).

Operations on DTensors themselves are not counted (each dispatches to
local operations, which are).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# functional collectives (DTensor) and c10d ops -> the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    per_chip_bytes: float = 0.0
    by_kind_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, bytes_: float):
        self.per_chip_bytes += bytes_
        self.by_kind_bytes[kind] = self.by_kind_bytes.get(kind, 0.0) + bytes_
        self.count += 1


def _wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_size(op_name: str, args) -> int:
    """The group size of a collective: the ``group_size`` argument where
    the op has one, else the size of the group it names or holds."""
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, torch.distributed.ProcessGroup):
            return a.size()
    if op_name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                   "all_gather_into_tensor_coalesced",
                   "reduce_scatter_tensor_coalesced"):
        ints = [a for a in args if isinstance(a, int)]
        if ints:
            return ints[-1]
    names = [a for a in args if isinstance(a, str)]
    if names:
        return c10d._resolve_process_group(names[-1]).size()
    return 1


def _is_view(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


class StepAnalysis(TorchDispatchMode):
    """Counts one step's collectives, bytes accessed and live bytes (see
    the module docstring); enter it inside ``FakeTensorMode``, beside a
    ``FlopCounterMode``."""

    def __init__(self, argument_bytes: int = 0):
        super().__init__()
        self.collectives = CollectiveStats()
        self.bytes_accessed = 0
        self.argument_bytes = argument_bytes
        self.live = argument_bytes
        self.peak = argument_bytes
        self.ops = 0

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        ins = _tensors((args, kwargs))
        if any(isinstance(x, DTensor) for x in ins):
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d") and name in _KINDS:
            kind = _KINDS[name]
            result = sum(_nbytes(x) for x in _tensors(out)) if ns == \
                "_c10d_functional" else sum(_nbytes(x) for x in ins)
            n = _group_size(name, list(args) + list(kwargs.values()))
            self.collectives.add(kind, _wire_bytes(kind, result, n))
            return out
        if ns in ("_c10d_functional", "c10d") or _is_view(func):
            return out
        self.ops += 1
        outs = _tensors(out)
        self.bytes_accessed += sum(_nbytes(x) for x in ins) \
            + sum(_nbytes(x) for x in outs)
        for x in outs:
            n = _nbytes(x)
            self.live += n
            weakref.finalize(x, self._release, n)
        self.peak = max(self.peak, self.live)
        return out


def memory_analysis_dict(analysis: StepAnalysis) -> dict:
    return {"argument_size_in_bytes": int(analysis.argument_bytes),
            "peak_bytes_estimate": int(analysis.peak)}

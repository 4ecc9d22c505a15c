"""The program's own spans (``repro_torch.tracing``), for the readers of
per-layer metrics.

A traced run's recording is the one the program took of its calls while
the traced window's profiler ran (``tracing.profiled()``), handed over
once and kept on the view.  None in an untraced run, and with a program
that has no tracing."""
from __future__ import annotations

from typing import List, Optional, Tuple

from chipbench.trace import _union


def recording(view):
    if view.trace is None:
        return None
    if not hasattr(view, "tracing"):
        try:
            from repro_torch import tracing
        except ImportError:
            view.tracing = None
        else:
            view.tracing = tracing.profiled()
    return view.tracing


def named(rec, name: str) -> list:
    return [s for s in rec.spans if s.name == name]


def length(iv: List[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in _union(iv))


def minus(iv, cut) -> List[Tuple[int, int]]:
    """The union of ``iv`` less the union of ``cut``."""
    out, cut = [], _union(cut)
    for a, b in _union(iv):
        for c, d in cut:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
        if b > a:
            out.append((a, b))
    return out


def clip(iv, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv if min(b, hi) > max(a, lo)]


def per_block_ms(rec, ns: int) -> Optional[float]:
    blocks = rec.counts.get("stream.blocks", 0)
    return 1e-6 * ns / blocks if blocks else None

"""The traced window: ``torch.profiler`` over a stretch of a run, reduced to
device busy time, kernel times by name and by the benchmark's spans, and
the device's idle gaps by what the host was doing.

Spans are the benchmark's own (``span(name)``: a ``record_function`` range
named ``chipbench.<name>`` around a call into a layer of the program).
Device activity is what the profiler records on the card: kernels, copies
and sets.  A kernel belongs to a span when the host operation that
launched it started inside the span (the profiler links the two by a
correlation id).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "chipbench."


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark around a call into the program."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class TraceSummary:
    """What the metric readers take from a traced window."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.window_s = (t1_ns - t0_ns) / 1e9
        dev, host, spans = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            name = e.name()
            if e.device_type() == cuda:
                # the card's kernels, copies and sets; a span's range on
                # the card's timeline (same name) is not device work
                if not name.startswith(SPAN_PREFIX):
                    dev.append((start, end, name,
                                int(e.linked_correlation_id())))
                continue
            # host side: operations and spans (linked id 0), and the CUDA
            # runtime calls they make (linked to their operation)
            front = int(e.linked_correlation_id()) == 0
            host.append((start, end, name,
                         int(e.correlation_id()) if front else 0,
                         int(e.start_thread_id())))
            if front and name.startswith(SPAN_PREFIX):
                spans.append((start, end, name[len(SPAN_PREFIX):],
                              int(e.start_thread_id())))
        self.counts = {"device": len(dev), "host": len(host),
                       "spans": len(spans)}
        clip = [(max(a, t0_ns), min(b, t1_ns)) for a, b, _, _ in dev]
        busy = _union([(a, b) for a, b in clip if b > a])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.device_events = len(dev)
        self._dev = dev
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in dev:
            by_name[name] += (b - a) / 1e9
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        # the host thread that ran the window is the one with the spans
        threads = {tid for _, _, _, tid in spans}
        main = [h for h in host if h[4] in threads] if threads else host
        self._op_start = {cid: a for a, _, _, cid, _ in main if cid}
        self._spans = spans
        self.idle_by_host = self._idle_by_host(busy, main, t0_ns, t1_ns)

    def span_device_seconds(self, span_name: str) -> Optional[float]:
        """Device seconds of the work launched inside the spans named
        ``span_name``; None when the trace links no device work to a host
        operation."""
        ranges = sorted((a, b) for a, b, n, _ in self._spans
                        if n == span_name)
        if not ranges or not any(cid for _, _, _, cid in self._dev):
            return None
        starts = [a for a, _ in ranges]
        total = 0.0
        for a, b, _, cid in self._dev:
            t = self._op_start.get(cid)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += (b - a) / 1e9
        return total

    @staticmethod
    def _idle_by_host(busy, host, t0_ns, t1_ns) -> List[Tuple[str, float]]:
        """Idle seconds of the device, by the innermost host operation or
        span running at the middle of each gap."""
        gaps, cur = [], t0_ns
        for a, b in busy:
            if a > cur:
                gaps.append((cur, min(a, t1_ns)))
            cur = max(cur, b)
        if cur < t1_ns:
            gaps.append((cur, t1_ns))
        host = sorted(host)
        starts = [h[0] for h in host]
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) // 2
            name = "host outside any operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            out[name] += (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_by_host[:10]]}


class TracedWindow:
    """Profile the body of a ``with`` block (off when ``enabled`` is
    False); ``summary`` holds the reduction after it closes."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.enabled = enabled
        self.summary: Optional[TraceSummary] = None
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._sync()
        t1 = time.time_ns()
        self._prof.stop()
        if exc[0] is None:
            self.summary = TraceSummary(
                self._prof.profiler.kineto_results.events(), self._t0, t1)
        self._prof = None
        return False

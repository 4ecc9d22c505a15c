"""The 99th percentile of the (untraced) window's request latencies, each
from its due time to its score on the host, in milliseconds.  Host-paced
and spread too widely between runs for a bound, so a per-layer reading."""


def read(view):
    return view.counters.get("p99_ms")

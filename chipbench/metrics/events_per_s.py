"""Events the closed loop completed per second of its (untraced) window:
all events scored and handed to the sink, over all the window's seconds.
Host-paced and spread too widely between runs for a bound, so a per-layer
reading."""


def read(view):
    c = view.counters
    if not c.get("window_s") or "events" not in c:
        return None
    return c["events"] / c["window_s"]

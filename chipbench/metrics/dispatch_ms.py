"""The median time of a frontend dispatch, from leaving the queue to its
outputs on the host (``ServeResult.batches``), in milliseconds."""

import numpy as np


def read(view):
    d = view.counters.get("dispatch_ms")
    if not d:
        return None
    return float(np.median(d))

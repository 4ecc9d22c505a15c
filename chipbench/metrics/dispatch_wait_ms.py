"""The median time a frontend dispatch spends copying its outputs to the
host (the program's ``frontend.materialize`` spans: the four ``.cpu()``
copies after the scorer's), in milliseconds, in the traced stretch."""

import numpy as np

from chipbench import spans


def read(view):
    rec = spans.recording(view)
    if rec is None:
        return None
    d = spans.named(rec, "frontend.materialize")
    if not d:
        return None
    return 1e-6 * float(np.median([s.end_ns - s.start_ns for s in d]))

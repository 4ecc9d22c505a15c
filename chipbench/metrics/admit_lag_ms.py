"""The 99th percentile of how late the frontend admitted a request: its
admission time (``ServeResult.admitted_s``, on the frontend's clock) less
its arrival, as the program records it per dispatch
(``frontend.admit_lag_s``), in milliseconds, in the traced stretch."""

import numpy as np

from chipbench import spans


def read(view):
    rec = spans.recording(view)
    if rec is None:
        return None
    lag = rec.values.get("frontend.admit_lag_s")
    if lag is None or not lag.size:
        return None
    return 1e3 * float(np.quantile(lag, 0.99))

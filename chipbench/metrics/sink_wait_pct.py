"""The share of the window in which the block driver was blocked handing
flush groups to the write-behind sink (``SinkStats.submit_wait_s``), in
percent."""


def read(view):
    c = view.counters
    if "sink_submit_wait_s" not in c or not c.get("window_s"):
        return None
    return 100.0 * c["sink_submit_wait_s"] / c["window_s"]

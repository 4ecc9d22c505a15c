"""Device milliseconds a block of the engine step takes: the kernels that
the host launched inside the ``process_stream`` calls (the engine's steps
and the sink's row gathers), over the traced window's blocks."""


def read(view):
    tr, blocks = view.trace, view.counters.get("traced_blocks", 0)
    if tr is None or not blocks:
        return None
    s = tr.span_device_seconds("process_stream")
    if not s:
        return None
    return 1e3 * s / blocks

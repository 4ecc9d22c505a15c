"""Host milliseconds a block the block driver's thread spends in the
program's ``stream.*`` spans outside the step's enqueue (``stream.step``):
routing, staging, each group's hand-over to the sink (its wait included)
and the concatenation, in the traced stretch."""

from chipbench import spans


def read(view):
    rec = spans.recording(view)
    if rec is None:
        return None
    steps = spans.named(rec, "stream.step")
    if not steps:
        return None
    driver = steps[0].thread
    mine = [(s.start_ns, s.end_ns) for s in rec.spans
            if s.thread == driver and s.name.startswith("stream.")]
    rest = spans.minus(mine, [(s.start_ns, s.end_ns) for s in steps])
    return spans.per_block_ms(rec, spans.length(rest))

"""Host milliseconds the block driver takes a block to enqueue the engine's
fused step and the sink's row gather (the program's ``stream.step`` spans
over its ``stream.blocks`` count), in the traced stretch."""

from chipbench import spans


def read(view):
    rec = spans.recording(view)
    if rec is None:
        return None
    steps = spans.named(rec, "stream.step")
    if not steps:
        return None
    return spans.per_block_ms(rec, sum(s.end_ns - s.start_ns for s in steps))

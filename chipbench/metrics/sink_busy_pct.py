"""The busiest sink thread's busy share of the traced stretch, in percent:
the flush dispatcher's ``sink.flush`` or a partition worker's
``sink.put`` spans, less the dispatcher's waits for the card
(``sink.d2h``), over the stretch the block driver's ``stream.*`` spans
cover."""

from chipbench import spans

SINK = ("sink.flush", "sink.put")


def read(view):
    rec = spans.recording(view)
    if rec is None:
        return None
    steps = spans.named(rec, "stream.step")
    if not steps:
        return None
    driver = steps[0].thread
    mine = [s for s in rec.spans
            if s.thread == driver and s.name.startswith("stream.")]
    lo = min(s.start_ns for s in mine)
    hi = max(s.end_ns for s in mine)
    threads = {s.thread for s in rec.spans if s.name in SINK} - {driver}
    if not threads:
        return None
    busiest = 0
    for th in threads:
        work = [(s.start_ns, s.end_ns) for s in rec.spans
                if s.thread == th and s.name in SINK]
        wait = [(s.start_ns, s.end_ns) for s in rec.spans
                if s.thread == th and s.name == "sink.d2h"]
        busiest = max(busiest, spans.length(
            spans.clip(spans.minus(work, wait), lo, hi)))
    return 100.0 * busiest / (hi - lo)

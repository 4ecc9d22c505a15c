"""Open-loop online scoring: one request an event, Poisson arrivals at the
mix's fixed rate, through ``ScoringPipeline.serve`` on the real clock.

Independent cardholders make an open loop: requests arrive on their
schedule whatever the system does, and each is timed from its due time
(its arrival) to its score on the host.  The serving settings (batch,
deadline, admission) are the configuration's; the rate is the mix's.

Set-up serves ``warmup_requests`` requests of the same stream through a
throwaway sink, so every kernel and shape is warm; the window then serves
the following ``rate * seconds`` requests from a fresh state with the
durable sink, and closes when the sink acknowledges the last flush.
``serve`` returns once every request has its answer; an answer that comes
late is late, and counts in the tail.  A traced run then profiles
``program.TRACE_SECONDS`` of further requests.
"""
from __future__ import annotations

import math
import shutil
import tempfile
import time

import numpy as np

from chipbench import program
from chipbench.check import Sample
from chipbench.gen import workload
from chipbench.trace import TracedWindow, span


def arrivals(rate: float, n: int, seed: int) -> np.ndarray:
    """Poisson arrival times (seconds from the window's start)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 11])
    return np.cumsum(rng.exponential(1.0 / rate, n))


def serve(sut, keys, qs, ts, arrival_s, srv: dict, sink):
    from repro_torch.serving.frontend import RealClock

    return sut.pipe.serve(keys, qs, ts, arrival_s=arrival_s,
                          batch=int(srv["batch"]),
                          max_wait_s=float(srv["max_wait_s"]),
                          clock=RealClock(), rng=sut.rng, sink=sink,
                          admission=srv["admission"])


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> "program.Outcome":
    cfg, mix = cell.config, cell.traffic
    srv = cfg["serving"]
    rate = float(mix["rate_per_s"])
    n = int(round(rate * seconds))
    m = int(round(rate * program.TRACE_SECONDS)) if trace else 0
    warm = int(mix["warmup_requests"])
    phases = program.start(device, t_start)
    mark = time.perf_counter()
    spec = workload.spec_from_config(cfg["stream"])
    stream = workload.generate(spec, seed,
                               math.ceil((warm + n + m) / spec.span_events))
    part = lambda lo, hi: (stream.key[lo:hi], stream.q[lo:hi],
                           stream.t[lo:hi])
    k, q, t = part(warm, warm + n)
    keys = program.sample_keys(k, spec.n_keys, seed)
    phases["stream"] = time.perf_counter() - mark
    mark = time.perf_counter()
    sut = program.SystemUnderTest(cfg, seed, device)
    phases["build"] = time.perf_counter() - mark
    mark = time.perf_counter()
    throwaway(sut, *part(0, warm), arrivals(rate, warm, seed + 1), srv)
    arrival_s = arrivals(rate, n, seed)
    program.sync(device)
    setup_peak = program.reset_peak(device)
    phases["warm-up"] = time.perf_counter() - mark
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    bytes0 = program.written_bytes()
    with span("serve"):
        res = serve(sut, k, q, t, arrival_s, srv, sut.sink)
    with span("flush"):
        sut.sink.flush()
    program.sync(device)
    window_s = time.perf_counter() - t0
    peak = program.peak(device)
    wrote = program.written_bytes() - bytes0
    counted = program.store_counted_bytes(sut.sink)
    stored = sut.close_and_read(keys)
    samples = [sample_of(res, k, q, t, keys, stored)]
    # the traced run then profiles a short stretch more: the next requests
    # through a fresh frontend and a throwaway sink
    with TracedWindow(device, trace) as tw:
        if trace:
            k2, q2, t2 = part(warm + n, warm + n + m)
            with span("serve"):
                res2 = throwaway(sut, k2, q2, t2,
                                 arrivals(rate, m, seed + 2), srv)
    if trace:
        samples.append(sample_of(res2, k2, q2, t2,
                                 program.sample_keys(k2, spec.n_keys, seed),
                                 None))

    st = res.stats
    answered = int(sum(b.size for b in res.batches))
    misordered = int(np.count_nonzero(res.order != np.arange(n))) \
        if answered == n else n
    lat = np.asarray(res.latency_s, np.float64)
    tenth = max(1, lat.size // 10)
    counters = {
        "setup_phases": phases, "window_s": window_s,
        "frontend_events": st.events, "frontend_dispatches": st.dispatches,
        "dispatch_ms": [1e3 * (b.t_complete - b.t_dispatch)
                        for b in res.batches],
        "max_queue": st.max_queue,
        "served_per_s": lat.size / max(b.t_complete for b in res.batches),
        "p50_ms": 1e3 * float(np.quantile(lat, 0.5)),
        "p99_ms": 1e3 * float(np.quantile(lat, 0.99)),
        "max_ms": 1e3 * float(lat.max()),
        # the last tenth's mean wait over the first tenth's: ~1 while the
        # backlog stays bounded, growing with the window when it does not
        "latency_trend": float(lat[-tenth:].mean() / lat[:tenth].mean()),
    }
    metrics = {
        "p99_ms": counters["p99_ms"],
        "durable_bytes_per_event": wrote / max(n, 1),
        "peak_device_mb": peak / 1e6,
        "setup_s": setup_s,
        "store_counted_bytes_per_event": counted / max(n, 1),
    }
    return program.Outcome(metrics=metrics, counters=counters,
                           trace=tw.summary, samples=samples,
                           numbers={"misordered": misordered},
                           attempted=n, failed=n - answered,
                           memory_peak_bytes=max(setup_peak, peak),
                           weights=sut.weights)


def throwaway(sut, keys, qs, ts, arrival_s, srv: dict):
    """Serve requests through a sink in a directory of their own, removed
    after (the warm-up; the traced stretch)."""
    d = tempfile.mkdtemp(prefix="chipbench-aside-")
    try:
        sink = sut.make_sink(d)
        try:
            return serve(sut, keys, qs, ts, arrival_s, srv, sink)
        finally:
            sink.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def sample_of(res, k, q, t, keys, stored) -> Sample:
    """The sampled keys' requests and the frontend's answers to them; each
    dispatch is a block (the frontend answers in arrival order)."""
    n = len(k)
    sizes = np.array([b.size for b in res.batches], np.int64)
    block = np.repeat(np.arange(sizes.size), sizes) if sizes.sum() == n \
        else np.zeros(n, np.int64)
    sel = np.flatnonzero(np.isin(k, keys))
    return Sample(
        slot=np.searchsorted(keys, k[sel]), entity=k[sel].astype(np.int64),
        q=q[sel], t=t[sel], block=block[sel], keys=keys, z=res.z[sel],
        p=res.p[sel], lam=res.lam_hat[sel], features=res.features[sel],
        score=res.scores[sel], stored=stored)

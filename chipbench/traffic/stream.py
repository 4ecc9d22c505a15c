"""Closed-loop ingest at full speed: a backfill, or an ingest that saturates
the engine.

The stream (the configuration's ``stream``: ``base_spans`` spans drawn
from the seed, then repeated end to end, shifted in time) is cut into
calls of ``chunk_blocks`` engine blocks, each a whole number of flush
groups.  Set-up runs ``warmup_chunks`` calls; the window then calls
``ScoringPipeline.process_stream`` with the durable sink on the following
chunks, carrying state and sink from call to call, and scores every event
with ``score``, until ``--seconds`` have passed.  It closes when the
sink acknowledges the last flush group, fsync included.  A chunk's events
are completed when they are scored and their rows are handed to the sink.
A traced run then profiles ``program.TRACE_SECONDS`` of further calls.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import program
from chipbench.check import Sample
from chipbench.gen import workload
from chipbench.trace import TracedWindow, span


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> "program.Outcome":
    from repro_torch.serving.pipeline import score

    cfg, mix = cell.config, cell.traffic
    eng = cfg["engine"]
    B, G = int(eng["batch"]), int(eng["flush_group_blocks"])
    chunk = int(mix["chunk_blocks"]) * B
    if chunk % (B * G):
        raise ValueError("a chunk must be a whole number of flush groups")
    phases = program.start(device, t_start)
    mark = time.perf_counter()
    spec = workload.spec_from_config(cfg["stream"])
    base = workload.generate(spec, seed, int(cfg["stream"]["base_spans"]))
    stream = workload.Repeating(base)
    warm = int(mix["warmup_chunks"])
    keys = program.sample_keys(base.key, spec.n_keys, seed)
    hit = np.isin(base.key, keys)
    pos = np.flatnonzero(hit)
    pos_dev = torch.from_numpy(pos).to(device)

    phases["stream"] = time.perf_counter() - mark
    mark = time.perf_counter()
    sut = program.SystemUnderTest(cfg, seed, device)
    phases["build"] = time.perf_counter() - mark
    mark = time.perf_counter()
    state = sut.pipe.init()
    # room for the most sampled events any call can hold
    reps = 2 + chunk // hit.size
    run_sum = np.cumsum(np.concatenate([[0]] + [hit] * reps))
    most = int((run_sum[chunk:] - run_sum[:-chunk]).max())
    T = len(eng["windows_s"])
    host_out = program.HostCopies(most, 4 + 4 * T, device)

    def step(c: int):
        lo, hi = c * chunk, (c + 1) * chunk
        nonlocal state
        key, q, t = stream.events(lo, hi)
        # the sampled events' places in this call, without a host sync
        at = [pos_dev[a:b] + (k * stream.n - lo)
              for k, a, b in stream.positions(pos, lo, hi)]
        with span("process_stream"):
            state, info = sut.pipe.process_stream(
                state, key, q, t, rng=sut.rng, batch_per_shard=B,
                sink=sut.sink, sink_group=G)
        with span("score"):
            s = score(sut.pipe.scorer, info.features)
        with span("sample"):
            idx = at[0] if len(at) == 1 else torch.cat(at)
            packed = torch.cat([info.z[idx, None].float(), info.p[idx, None],
                                info.lam_hat[idx, None], s[idx, None],
                                info.features[idx]], 1)
            host_out.put(packed)

    def window(c: int, limit: float):
        """Calls from chunk ``c`` on until ``limit`` seconds have passed,
        closed by the sink's acknowledgement; (next chunk, seconds, CPU
        seconds of the process and of this thread)."""
        cpu0, own0 = time.process_time(), time.thread_time()
        t0 = time.perf_counter()
        while True:
            step(c)
            c += 1
            if time.perf_counter() - t0 >= limit:
                break
        with span("flush"):
            sut.sink.flush()
        program.sync(device)
        return (c, time.perf_counter() - t0, time.process_time() - cpu0,
                time.thread_time() - own0)

    for c in range(warm):
        step(c)
    sut.sink.flush()
    program.sync(device)
    stats0 = sut.sink.stats.snapshot()
    bytes0 = program.written_bytes()
    counted0 = program.store_counted_bytes(sut.sink)
    setup_peak = program.reset_peak(device)
    phases["warm-up"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - t_start
    c, window_s, cpu_s, own_cpu_s = window(warm, seconds)
    peak = program.peak(device)
    events = (c - warm) * chunk
    stats1 = sut.sink.stats.snapshot()
    wrote = program.written_bytes() - bytes0
    counted = program.store_counted_bytes(sut.sink) - counted0
    counters = {
        "setup_phases": phases, "window_s": window_s, "events": events,
        "sink_submit_wait_s": (stats1["submit_wait_s"]
                               - stats0["submit_wait_s"]),
    }
    # the traced run then profiles a short stretch of further calls
    with TracedWindow(device, trace) as tw:
        if trace:
            c0 = c
            c, traced_s = window(c, program.TRACE_SECONDS)[:2]
    if trace:
        counters.update(traced_s=traced_s,
                        traced_blocks=(c - c0) * chunk // B)
    stored = sut.close_and_read(keys)

    out = host_out.result()
    gpos = np.concatenate([pos[a:b] + k * stream.n
                           for k, a, b in stream.positions(pos, 0, c * chunk)])
    key, q, t = stream.at(gpos)
    sample = Sample(
        slot=np.searchsorted(keys, key), entity=key.astype(np.int64), q=q,
        t=t, block=gpos // B, keys=keys,
        z=out[:, 0] > 0.5, p=out[:, 1], lam=out[:, 2], score=out[:, 3],
        features=out[:, 4:4 + 4 * T], stored=stored)
    metrics = {
        "events_per_s": events / window_s,
        "durable_bytes_per_event": wrote / max(events, 1),
        "peak_device_mb": peak / 1e6,
        "setup_s": setup_s,
        "store_counted_bytes_per_event": counted / max(events, 1),
        "host_cpu_us_per_event": 1e6 * cpu_s / max(events, 1),
        "driver_cpu_us_per_event": 1e6 * own_cpu_s / max(events, 1),
    }
    return program.Outcome(metrics=metrics, counters=counters,
                           trace=tw.summary, samples=[sample], numbers={},
                           attempted=events, failed=0,
                           memory_peak_bytes=max(setup_peak, peak),
                           weights=sut.weights)

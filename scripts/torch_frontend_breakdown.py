#!/usr/bin/env python3
"""Where one dispatch of the PyTorch port's serving frontend spends its
time, on a GPU.

    PYTHONPATH=src python3 scripts/torch_frontend_breakdown.py [--dispatches 64]

Drives ``serving.frontend.ServingFrontend`` at capacity (every request
queued at once, so every batch is full) in the configuration of
``chip_smoke.py`` phase 8 (a): the iiot stream at 800,000 keys, six decay
windows, h = 3600 s, Lambda*h = 0.1, ``pp``, fast mode, batch 256, a
one-partition memory sink, a seeded scorer of hidden width 64, serial
admission.  Prints one JSON object with, per dispatch:

* ``as_run_ms``: the steady-state time between two dispatches'
  completions, as the frontend runs (no added synchronise), median of
  each of ``--repeats`` runs;
* ``synced_ms``: the host wall time of each part of a dispatch, each
  ended by a device synchronise — batch composition, staging, the
  keyed ``thinning_rmw`` call, the rest of the engine step (the segment
  fold) with the sink's row gather, the sink submit, scoring at the
  fixed width, and the copies of the outputs to the host with the
  per-request fill;
* the same for a frontend without sink and scorer (``plain``) and for
  phase 8 (d)'s bounded resident set of 100,000 slots with serial
  admission (``resident_serial``, whose ``plan_hydration`` is slot
  assignment, the prefetched rows and their packing), and ``as_run_ms``
  for the resident set under threaded admission
  (``resident_threaded``);
* from ``torch.profiler`` over 16 unsynchronised dispatches: GPU kernels
  per dispatch, device busy time per dispatch and the device's idle
  share (``null`` when the profiler records no device activity;
  ``incomplete_trace`` when it did not record one ``thinning_rmw``
  launch a dispatch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import init_state, prng_key  # noqa: E402
from repro_torch.features.spec import ProfileSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import frontend, pipeline  # noqa: E402
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402
from repro_torch.streaming.residency import ResidencyMap  # noqa: E402
from repro_torch.streaming.workload import REGIMES, generate  # noqa: E402

N_KEYS, N_EVENTS, BATCH, WARM = 800_000, 2_000_000, 256, 16
N_SLOTS = 100_000
PROFILED = 16           # dispatches under the profiler


def make_frontend(cfg, device, scorer, with_sink, slots=None,
                  admission="serial"):
    sink = WriteBehindSink(cfg, device=device) if with_sink else None
    rmap = ResidencyMap(N_KEYS, slots) if slots else None
    fe = frontend.ServingFrontend(
        cfg, init_state(slots or N_KEYS, len(cfg.taus), device=device),
        batch=BATCH, max_wait_s=2e-3, mode="fast", rng=prng_key(0),
        sink=sink, residency=rmap, scorer=scorer if with_sink else None,
        admission=admission)
    return fe, sink


def requests(stream, lo, n):
    sl = slice(lo, lo + n)
    return frontend.make_requests(stream.key[sl], stream.q[sl],
                                  stream.t[sl], np.zeros(n))


def as_run(fe, reqs):
    """Steady-state ms between dispatch completions, as run."""
    res = fe.run(reqs)
    done = np.array([b.t_complete for b in res.batches])
    return float(np.median(np.diff(done))) * 1e3


def synced(fe, reqs):
    """Median host ms of each part of a dispatch, each synchronised."""
    sync = torch.cuda.synchronize
    times = defaultdict(list)
    patched = []

    def timed(obj, name, label, total=None):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            times[label].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(obj, name, wrapper)
        patched.append((obj, name, fn))

    timed(fe, "_compose", "compose")
    timed(frontend._Stager, "stage", "stage")
    timed(ops, "thinning_rmw_keyed", "keyed_kernel_call")
    timed(fe, "_bstep", "step_with_gather")
    if fe.sink is not None:
        timed(fe.sink, "submit", "sink_submit")
    if fe._rmap is not None:
        timed(fe, "_plan_hydration", "plan_hydration")
    timed(frontend, "score_at_width", "score")
    timed(fe, "_materialize", "materialize")
    try:
        t0 = time.perf_counter()
        res = fe.run(reqs)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, fn in reversed(patched):
            setattr(obj, name, fn)
    med = {k: float(np.median(v)) for k, v in times.items()}
    med["fold"] = med["step_with_gather"] - med["keyed_kernel_call"]
    if "score" in med:
        med["copies_and_fill"] = med["materialize"] - med["score"]
    med["whole_dispatch"] = total / len(res.batches)
    return med


def profiled(fe, reqs):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fe.run(reqs)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    n = len(res.batches)         # the frontend's stats add up over runs
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    keyed = sum("thinning_rmw" in e.name for e in kernels)
    if keyed != n:
        return {"incomplete_trace": True,
                "thinning_rmw_per_dispatch": keyed / n}
    return {"kernels_per_dispatch": len(kernels) / n,
            "thinning_rmw_per_dispatch": keyed / n,
            "device_busy_ms_per_dispatch": busy_us / 1e3 / n,
            "wall_ms_per_dispatch": wall * 1e3 / n,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dispatches", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    stream = generate(dataclasses.replace(REGIMES["iiot"], n_keys=N_KEYS,
                                          n_events=N_EVENTS), seed=0)
    spec = ProfileSpec(kde_bandwidth=3600.0, write_budget_per_min=0.1 / 60,
                       policy="pp")
    cfg = spec.engine_config()
    scorer = pipeline.init_scorer(torch.Generator().manual_seed(0),
                                  spec.feature_dim, device=device)
    n = args.dispatches * BATCH
    out = {"device": torch.cuda.get_device_name(0), "batch": BATCH,
           "keys": N_KEYS, "dispatches": args.dispatches}
    runs = (("sink_and_scorer", True, None, "serial"),
            ("plain", False, None, "serial"),
            ("resident_serial", True, N_SLOTS, "serial"),
            ("resident_threaded", True, N_SLOTS, "threaded"))
    for label, with_sink, slots, admission in runs:
        fe, sink = make_frontend(cfg, device, scorer, with_sink, slots,
                                 admission)
        fe.run(requests(stream, 0, WARM * BATCH))
        rec = {"as_run_ms": [as_run(fe, requests(stream, WARM * BATCH, n))
                             for _ in range(args.repeats)]}
        if admission == "serial":
            rec["synced_ms"] = synced(fe, requests(stream, 0, n))
            try:
                rec["profile"] = profiled(
                    fe, requests(stream, n, PROFILED * BATCH))
            except Exception as e:      # the profiler may be unavailable
                rec["profile"] = {"error": repr(e)}
        if sink is not None:
            sink.close()
        out[label] = rec
    out["as_run_events_per_s"] = {
        label: [BATCH / ms * 1e3 for ms in rec["as_run_ms"]]
        for label, rec in out.items() if isinstance(rec, dict)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

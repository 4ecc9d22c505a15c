#!/usr/bin/env python3
"""Where one fast-mode block of the PyTorch port spends its time, on a GPU.

    PYTHONPATH=src python3 scripts/torch_stream_breakdown.py [--blocks 40]

Drives the iiot stream at 800,000 keys (the configuration of
``chip_smoke.py``'s stream phase: six decay windows, h = 3600 s, budget
Lambda*h = 0.1, batch 4096, policy ``pp``) through the fast-mode step on
``cuda:0`` and prints one JSON object with, per block:

* the host wall time of each layer — counter RNG, row gather, the fused
  ``thinning_rmw`` call, and the rest of the step (the segment fold) —
  each ended by a device synchronise;
* the whole step without synchronising, as ``run_stream`` runs it;
* from ``torch.profiler`` over the unsynchronised blocks: GPU kernels per
  block, device busy time per block and the device's idle share (``null``
  when the profiler records no device activity).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (EngineConfig, Event, engine,  # noqa: E402
                              init_state, make_step, prng_key, thinning)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.streaming.workload import REGIMES, generate  # noqa: E402

N_KEYS, N_EVENTS, BATCH, WARM = 800_000, 2_000_000, 4096, 40


def profile_blocks(step, state, blocks, rng):
    """Kernel count and device busy time over unsynchronised blocks."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ev in blocks:
            step(state, ev, rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return {"kernels_per_block": len(kernels) / len(blocks),
            "device_busy_ms_per_block": busy_us / 1e3 / len(blocks),
            "wall_ms_per_block": wall * 1e3 / len(blocks),
            "device_idle_share": 1.0 - busy_us / 1e6 / wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    stream = generate(dataclasses.replace(REGIMES["iiot"], n_keys=N_KEYS,
                                          n_events=N_EVENTS), seed=0)
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp")
    step, rng = make_step(cfg, "fast"), prng_key(0)
    state = init_state(N_KEYS, len(cfg.taus), device=dev)
    n = (WARM + 2 * args.blocks) * BATCH
    blocks = [Event(key=torch.tensor(stream.key[i:i + BATCH], device=dev),
                    q=torch.tensor(stream.q[i:i + BATCH], device=dev),
                    t=torch.tensor(stream.t[i:i + BATCH], device=dev),
                    valid=torch.ones(BATCH, dtype=torch.bool, device=dev))
              for i in range(0, n, BATCH)]
    for ev in blocks[:WARM]:
        step(state, ev, rng)
    taus = engine._taus(cfg, dev)

    layers = {"rng": [], "gather": [], "kernel": [], "fold": [], "step": []}
    sync = torch.cuda.synchronize
    for ev in blocks[WARM:WARM + args.blocks]:
        key = ev.key.to(torch.int64)
        sync()
        t0 = time.perf_counter()
        u = thinning.uniform_for_events(rng, key, thinning.time_bits(ev.t))
        sync()
        t1 = time.perf_counter()
        rows = engine._gather_rows(state, key)
        sync()
        t2 = time.perf_counter()
        ops.thinning_rmw(taus, *rows[:3], ev.q, ev.t, u,
                         ev.valid.to(torch.float32), *rows[3:],
                         **engine._fused_kw(cfg))
        sync()
        t3 = time.perf_counter()
        step(state, ev, rng)
        sync()
        t4 = time.perf_counter()
        for name, dt in (("rng", t1 - t0), ("gather", t2 - t1),
                         ("kernel", t3 - t2), ("step", t4 - t3)):
            layers[name].append(dt * 1e3)
        layers["fold"].append((t4 - t3 - (t3 - t0)) * 1e3)

    tail = blocks[WARM + args.blocks:]
    sync()
    t0 = time.perf_counter()
    for ev in tail:
        step(state, ev, rng)
    sync()
    unsynced = (time.perf_counter() - t0) * 1e3 / len(tail)
    try:
        prof = profile_blocks(step, state, tail, rng)
    except Exception as e:      # the profiler may be unavailable
        prof = {"error": repr(e)}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": BATCH,
        "keys": N_KEYS, "blocks": args.blocks,
        "synced_ms_per_block": {k: float(np.median(v))
                                for k, v in layers.items()},
        "unsynced_step_ms_per_block": unsynced,
        "events_per_s_unsynced": BATCH / unsynced * 1e3,
        "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

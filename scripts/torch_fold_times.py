#!/usr/bin/env python3
"""Time fast mode's segment fold on the card: the kernel and its plain version.

    PYTHONPATH=src python3 scripts/torch_fold_times.py [--reps 50] \
        [--zipf 1.1]

On ``cuda:0``, over one block at each of the benchmark's two shapes (the
iiot cell's, B = 4096 over 800,000 rows; the fraud cell's dispatch, B =
256 over 7,000 rows; six decay windows, keys drawn with Zipf exponent
``--zipf`` (0: uniform; at 1.1 the hottest key takes an eighth of the
iiot block's lanes), about 10 % of the valid lanes persisted), it times with CUDA events over ``--reps`` back-to-back
calls after a warm-up:

* ``ops.segment_fold`` on CUDA tensors: the kernel (two launches);
* ``ref.segment_fold_ref`` on the same CUDA tensors: the plain whole-table
  fold, which the fast step ran before the kernel;

and for each, the device time of every GPU kernel it launches
(``torch.profiler``, µs a call), the memory it allocates above what was
live before it, and the fold's bound: the bytes it has to move (each
lane's key, t, q, p, valid and z; the sorted lanes, their rows and their
rows' lengths written and read; the touched rows read and written) over
3.35 TB/s.

It prints one JSON object with the times and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
TAUS = (60.0, 3600.0, 86400.0, 2592000.0, 5184000.0, 10368000.0)
SHAPES = {"iiot": (4096, 800_000), "fraud": (256, 7_000)}


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def block(torch, B, N, dev, zipf, seed=0):
    """A warm state of N rows and one block of B lanes on ``dev``."""
    import numpy as np

    from repro_torch.core import init_state

    rng = np.random.default_rng(seed)
    state = init_state(N, len(TAUS), device=dev)
    warm = rng.random(N) < 0.7
    state.last_t.copy_(torch.tensor(np.where(warm, rng.uniform(
        0, 1e5, N), -np.inf), dtype=torch.float32))
    state.last_t_full.copy_(state.last_t)
    state.v_f.copy_(torch.tensor(rng.uniform(0, 50, N) * warm,
                                 dtype=torch.float32))
    state.v_full.copy_(state.v_f)
    state.agg.copy_(torch.tensor(rng.uniform(0, 10, (N, len(TAUS), 3))
                                 * warm[:, None, None], dtype=torch.float32))
    w = 1.0 / np.arange(1, N + 1) ** zipf
    key = rng.permutation(N)[rng.choice(N, B, p=w / w.sum())]
    valid = rng.random(B) < 0.98
    z = valid & (rng.random(B) < 0.1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    lanes = dict(key=torch.tensor(key, dtype=torch.int64, device=dev),
                 q=f32(rng.lognormal(3, 1, B)),
                 t=f32(np.sort(rng.uniform(1e5, 1.01e5, B))),
                 valid=torch.tensor(valid, device=dev),
                 z=torch.tensor(z, device=dev),
                 p=f32(rng.uniform(0.05, 1.0, B)))
    rows, counts = np.unique(key[valid], return_counts=True)
    rows, hottest = len(rows), int(counts.max())
    bound_bytes = B * (8 + 4 * 3 + 2) + 3 * 4 * 2 * B \
        + rows * 2 * 4 * (4 + 3 * len(TAUS))
    return state, lanes, rows, hottest, bound_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--zipf", type=float, default=1.1)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import thinning_rmw as trmw

    if not torch.cuda.is_available():
        print("torch_fold_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    taus = torch.tensor(TAUS, dtype=torch.float32, device=dev)

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def kernels_us(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.device_time_total / args.reps
                for e in prof.key_averages() if e.device_time_total > 0}

    def extra_mb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - before) / 1e6

    out = {"card": card_name_and_limit(), "reps": args.reps,
           "zipf": args.zipf}
    for name, (B, N) in SHAPES.items():
        state, lanes, rows, hottest, bound_bytes = block(torch, B, N, dev,
                                                args.zipf)
        a = (taus, state, lanes["key"], lanes["q"], lanes["t"],
             lanes["valid"], lanes["z"], lanes["p"])
        kernel = lambda: ops.segment_fold(*a, h=3600.0)
        plain = lambda: ref.segment_fold_ref(*a, h=3600.0)
        launched = trmw.fold_launches
        kernel()
        torch.cuda.synchronize()
        out[name] = {
            "B": B, "rows": N, "touched_rows": rows,
            "hottest_key_lanes": hottest,
            "launches_a_call": trmw.fold_launches - launched,
            "bound_bytes": bound_bytes,
            "bound_us": bound_bytes / HBM_BYTES_PER_S * 1e6,
            "kernel_ms": ms(kernel), "plain_ms": ms(plain),
            "kernel_device_us": kernels_us(kernel),
            "plain_device_us_top": dict(sorted(
                kernels_us(plain).items(), key=lambda kv: -kv[1])[:6]),
            "kernel_extra_mb": extra_mb(kernel),
            "plain_extra_mb": extra_mb(plain)}
        del state, lanes
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

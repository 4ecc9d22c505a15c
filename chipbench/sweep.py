"""Find the highest rate an online cell sustains: its mix at each of a list
of fixed rates, one window each, in one process on the card.

    python3 chipbench/sweep.py --workload <name> --seconds <s> \
        --rates <r> ... [--seed <n>] [--out <file>]

A rate is sustained when the admission backlog stays bounded over the
whole window: the last tenth of the requests wait no longer than the
first tenth (``trend``, their mean latencies' ratio, near 1) and the tail
stays within a few deadlines.  One JSON line a rate.  The benchmark's own
runs do not run this; a cell's rate is written into its mix as a number.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from chipbench import bench
    from chipbench.traffic import online

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for rate in args.rates:
            c = copy.copy(cell)
            c.traffic = dict(cell.traffic, rate_per_s=rate)
            o = online.run(c, args.seed, args.seconds, False, device,
                           time.perf_counter())
            k = o.counters
            rec = {"workload": cell.name, "rate_per_s": rate,
                   "requests": o.attempted,
                   "served_per_s": k["served_per_s"], "p50_ms": k["p50_ms"],
                   "p99_ms": o.metrics["p99_ms"], "max_ms": k["max_ms"],
                   "trend": k["latency_trend"], "max_queue": k["max_queue"],
                   "mean_batch": k["frontend_events"]
                   / k["frontend_dispatches"],
                   "dispatch_ms_median": float(np.median(k["dispatch_ms"])),
                   "durable_bytes_per_event":
                       o.metrics["durable_bytes_per_event"],
                   "peak_device_mb": o.metrics["peak_device_mb"]}
            text = json.dumps(rec)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

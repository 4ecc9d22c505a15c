"""The readings that ``correct``'s limits are set from, on the card.

    python3 chipbench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--out <file>]

For each seed, one run of the cell as ``run.py`` makes it (set-up, the
window, the reference's check): the numbers the program reads (the lower
readings).  For each control seed, the control in the program's place --
the reference computed one precision below the configuration's
(bfloat16), on the same events and blocks -- read by the same comparison
(the upper readings).  One JSON line a reading, on standard output and,
with ``--out``, in a file.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(cell, seeds, control_seeds, seconds, device):
    import torch

    from chipbench import bench, check
    from chipbench.reference import engine as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = ref.engine_from_config(cell.config)
    loop = bench.loop(cell.traffic["kind"])
    for seed in seeds:
        outcome = loop.run(cell, seed, seconds, False, device,
                           time.perf_counter())
        words = bench.rng_words(seed)
        (sample,) = outcome.samples
        weights = {k: v.detach().cpu().numpy()
                   for k, v in outcome.weights.items()}
        t0 = time.perf_counter()
        sound = check.numbers_of(sample, eng, words, weights)
        ref_s = time.perf_counter() - t0
        sound.update(outcome.numbers)
        yield {"workload": cell.name, "seed": seed, "side": "program",
               "numbers": sound, "metrics": outcome.metrics,
               "reference_s": ref_s}
        if seed in control_seeds:
            low = check.control_sample(sample, eng, words, weights)
            ctrl = check.numbers_of(low, eng, words, weights)
            yield {"workload": cell.name, "seed": seed, "side": "control",
                   "numbers": ctrl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from chipbench import bench

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = bench.cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for rec in readings(cell, args.seeds, set(args.control_seeds),
                            args.seconds, torch.device("cuda", 0)):
            text = json.dumps(rec, default=str)
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

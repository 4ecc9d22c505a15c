"""Run one cell of the port's benchmark once and print one result line.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the stream and weights from the seed, the kernel's build
on a first run in a checkout, the warm-up of the cell's shapes) runs
first; the window then measures for ``--seconds`` (``--trace 1``: then
a traced stretch of ``program.TRACE_SECONDS`` more).  After the window
the plain reference checks what the window produced, and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
then ``checks``, each number compared beside its limit, which standard
error repeats as its last lines.

It runs only on a CUDA card, in a checkout that holds the program
(``src/repro_torch``), and refuses to print a result if JAX or the JAX
package was loaded into the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# No build or kernel cache outside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules (``sys.modules`` by default) that
    the port's runs must not load, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _fmt(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def evaluate(cell, outcome, seed: int, trace: bool) -> tuple:
    """The reference's check and the metrics: the result line (a dict,
    ``checks`` its last key) and every number the check computed."""
    from chipbench import bench, check
    from chipbench.reference import engine as ref

    eng = ref.engine_from_config(cell.config)
    weights = {k: v.detach().cpu().numpy()
               for k, v in outcome.weights.items()}
    words = bench.rng_words(seed)
    numbers = check.merge([check.numbers_of(s, eng, words, weights)
                           for s in outcome.samples])
    numbers.update(outcome.numbers)
    numbers["setup_phases"] = outcome.counters.get("setup_phases", {})
    numbers["window"] = {k: v for k, v in outcome.metrics.items()
                         if k not in {m["name"] for m in cell.end_to_end}}
    if outcome.trace is not None:
        numbers["trace_kinds"] = outcome.trace.counts
    correct, rows = check.judge(numbers, cell.limits)
    correct = correct and outcome.failed == 0
    if trace:
        view = SimpleNamespace(trace=outcome.trace, counters=outcome.counters)
        metrics = {}
        for m in cell.per_layer:
            v = bench.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(outcome.metrics[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = outcome.device
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    if trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    rows.append(("failed", int(outcome.failed), 0))
    line["checks"] = {name: {"value": value if math.isfinite(value)
                             else str(value), "limit": limit}
                      for name, value, limit in rows}
    return line, numbers


def device_record(device, outcome, trace: bool) -> dict:
    import torch

    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace and device.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i", str(device.index)],
                capture_output=True, text=True, timeout=30)
            rec["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired):
            pass
    return rec


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> tuple:
    """Set up, measure and check one run of ``cell`` on ``device`` (no
    look for a card: the caller has chosen the device); ``evaluate``'s
    pair."""
    import torch

    from chipbench import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = bench.loop(cell.traffic["kind"])
    outcome = loop.run(cell, seed, seconds, trace, device,
                       T_START if t_start is None else t_start)
    outcome.device = device_record(device, outcome, trace)
    return evaluate(cell, outcome, seed, trace)


def emit(line: dict, numbers: dict) -> None:
    from chipbench import check

    print("compared: " + ", ".join(
        f"{k} {numbers[k]}" for k in check.COUNTS), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {_fmt(c['value'])} (limit {_fmt(c['limit'])})",
              file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False))
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("the seed must be a whole number >= 0", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"no program to measure: {ROOT}/src/repro_torch is missing",
              file=sys.stderr)
        return 2
    from chipbench import bench

    cell = bench.cell(args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {cards} "
              f"available", file=sys.stderr)
        return 2
    line, numbers = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 numbers["setup_phases"].items()),
          file=sys.stderr)
    print("window (not bounded): " + ", ".join(
        f"{k} {v!r}" for k, v in numbers["window"].items()), file=sys.stderr)
    if numbers.get("trace_kinds"):
        print(f"trace events: {numbers['trace_kinds']}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"modules that the port's runs must not load were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    emit(line, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())

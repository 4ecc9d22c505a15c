#!/usr/bin/env python3
"""Where RecurrentGemma-2B serving on the PyTorch port spends its time.

    PYTHONPATH=src python3 scripts/torch_serve_breakdown.py [--steps 8]

Serves the configuration of ``chip_smoke.py``'s serving phase on
``cuda:0``: ``recurrentgemma-2b`` at full width and depth in bfloat16
(seeded random weights), batch 2, a 4096-token prompt, then greedy decode
steps.  After one warm-up request it prints one JSON object with, for the
prefill and for one decode step:

* the host wall time, ended by a device synchronise, without and with the
  profiler;
* from ``torch.profiler``: GPU kernels launched, device busy time by kernel
  class (the port's ``decay_scan`` and ``flash_attention``, cuBLAS GEMMs,
  everything else) and the device's idle share (``null`` when the profiler
  records no device activity).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs.base import load_config  # noqa: E402
from repro_torch.kernels import _build, decay_scan  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.serving.engine import make_serve_step, sample_token  # noqa

BATCH, PROMPT = 2, 4096
GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "decay_scan" in low:
        return "decay_scan"
    if "flash_attention" in low:
        return "flash_attention"
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    return "other"


def profiled(fn, repeats: int, classify=kernel_class):
    """Wall ms per call, synchronised, and the profiler's device view
    (device busy time by ``classify(kernel name)``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"wall_ms": plain_wall * 1e3 / repeats,
           "profiled_wall_ms": wall * 1e3 / repeats}
    if not kernels:
        return dict(out, profile=None)
    busy = {}
    for e in kernels:
        cls = classify(e.name)
        busy[cls] = busy.get(cls, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(busy.values())
    return dict(out, profile={
        "kernels_per_call": len(kernels) / repeats,
        "device_busy_ms_per_call": {k: v / repeats for k, v in busy.items()},
        "device_idle_share": 1.0 - total / (wall * 1e3)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.build_all([decay_scan.KERNEL, flash_attention.KERNEL])
    run = load_config("recurrentgemma-2b")
    cfg = run.model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = backbone.init_params(cfg, gen, torch.bfloat16, dev)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    prefill = make_serve_step(run, "prefill", compute_dtype=torch.bfloat16,
                              max_len=PROMPT + 4 * args.steps)
    decode = make_serve_step(run, "decode", compute_dtype=torch.bfloat16)
    greedy = lambda logits: sample_token(logits, None, temperature=0.0,
                                         vocab_size=cfg.vocab_size)

    with torch.inference_mode():
        logits, state = prefill(params, prompts)         # warm-up request
        for _ in range(args.steps):
            logits, state = decode(params, state, greedy(logits))
        pre = profiled(lambda: prefill(params, prompts), 1)
        box = {"state": state, "tok": greedy(logits)}

        def step():
            lg, box["state"] = decode(params, box["state"], box["tok"])
            box["tok"] = greedy(lg)

        dec = profiled(step, args.steps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": run.model.name,
        "batch": BATCH, "prompt": PROMPT, "decode_steps": args.steps,
        "prefill": pre, "decode_step": dec,
        "prefill_tok_per_s": BATCH * PROMPT / pre["wall_ms"] * 1e3,
        "decode_tok_per_s": BATCH / dec["wall_ms"] * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time and memory.

    PYTHONPATH=src python3 scripts/torch_train_breakdown.py \
        [--arch recurrentgemma-2b] [--optimizer adamw] [--steps 2]

Trains the configuration of ``chip_smoke.py`` phase 12 on ``cuda:0``
(full width and depth in bfloat16, seeded random weights, batch 2 x 4096
of the CLI's Zipf tokens, warmup 1, the config's ``grad_accum`` and
remat; ``--optimizer adafactor`` without master weights).  After
``--steps`` warm-up steps it prints one JSON object with, for one step:

* the host wall time, ended by a device synchronise, without and with the
  profiler, and the synchronised time of the gradient accumulation, the
  clip and the optimizer update (timed by wrapping them; the rest of the
  step is the forward and backward);
* from ``torch.profiler``: GPU kernels launched, device busy time by
  kernel class (the port's scan and attention kernels forward and
  backward, cuBLAS GEMMs, everything else) and the device's idle share
  (``null`` when the profiler records no device activity);
* memory: allocated before the state is made, the state's own bytes by
  part (parameters, master copy, optimizer moments), and the peak over a
  step.
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

from repro_torch.configs.base import load_config  # noqa: E402
from repro_torch.kernels import _build, decay_scan  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402

BATCH, SEQ = 2, 4096
GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "decay_scan_bwd" in low:
        return "decay_scan_bwd"
    if "decay_scan" in low:
        return "decay_scan"
    if "attn_bwd" in low:
        return "flash_attention_bwd"
    if "flash_attention" in low:
        return "flash_attention"
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    return "other"


def gb(tree) -> float:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)) / 1e9


def timed(fn, spent: dict, key: str):
    """``fn`` wrapped to add its synchronised seconds to ``spent[key]``."""
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    _build.build_all([decay_scan.KERNEL, flash_attention.KERNEL,
                      flash_attention.BWD_KERNEL])
    run = load_config(args.arch)
    extra = {} if args.optimizer == "adamw" else {"master_weights": False}
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, warmup_steps=1, optimizer=args.optimizer, **extra))
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    state = trainer.init_train_state(
        run, torch.Generator(device=dev).manual_seed(12), device=dev)
    state_gb = {"params": gb(state.params), "master": gb(state.master),
                "optimizer": gb(state.opt), "sync": gb(state.sync)}
    data = synthetic_batch(run.model, np.random.default_rng(12), BATCH, SEQ,
                           dev)
    spent: dict = {}
    trainer._take_grads = timed(trainer._take_grads, spent, "take_grads")
    optim.clip_by_global_norm = timed(optim.clip_by_global_norm, spent,
                                      "clip")
    optim.adamw_update = timed(optim.adamw_update, spent, "optimizer")
    optim.adafactor_update = timed(optim.adafactor_update, spent,
                                   "optimizer")
    step = trainer.make_train_step(run, total_steps=100)
    for _ in range(args.steps):
        state, _ = step(state, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    spent.clear()
    t0 = time.perf_counter()
    state, m = step(state, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parts = dict(spent)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, data)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = None
    if kernels:
        busy: dict = {}
        count: dict = {}
        for e in kernels:
            cls = kernel_class(e.name)
            busy[cls] = busy.get(cls, 0.0) + e.time_range.elapsed_us() / 1e3
            count[cls] = count.get(cls, 0) + 1
        device = {"kernels": len(kernels), "kernels_by_class": count,
                  "busy_ms_by_class": busy,
                  "idle_share": 1.0 - sum(busy.values())
                  / (profiled_wall * 1e3)}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": run.model.name,
        "optimizer": args.optimizer, "grad_accum": run.train.grad_accum,
        "batch": BATCH, "seq": SEQ, "loss": float(m["loss"]),
        "step_ms": wall * 1e3, "profiled_step_ms": profiled_wall * 1e3,
        "synchronised_ms": {k: v * 1e3 for k, v in parts.items()},
        "forward_backward_ms": (wall - sum(parts.values())) * 1e3,
        "tok_per_s": BATCH * SEQ / wall,
        "memory_gb": {"before_state": before_gb, "state": state_gb,
                      "peak_in_step": peak},
        "profile": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

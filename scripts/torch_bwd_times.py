#!/usr/bin/env python3
"""Time the port's two backward kernels at the training shapes.

    python3 scripts/torch_bwd_times.py [--src DIR] [--reps 20]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src/``), so the same script times an earlier checkout unpacked beside
this one (``git archive <commit> | tar -x -C old/``, then ``--src
old/src``) in the same call on the same card.  On ``cuda:0`` it times,
with CUDA events over ``--reps`` back-to-back calls after a warm-up:

* ``decay_scan_bwd_cuda`` at RecurrentGemma-2B's micro-batch [4096, 2560]
  and Mamba-2's chunk recurrence [16, 1,310,720];
* ``flash_attention_bwd_cuda`` (bfloat16) at RecurrentGemma-2B's
  (1, 10, 1, 4096, 4096, 256, window 2048) and SmolLM-360M's (2, 15, 5,
  4096, 4096, 64, causal), and the forward with its log-sum-exp;

and, at the attention shapes, the device time of each GPU kernel a call
launches (``torch.profiler``, ms a call) for the port's backward and for
SDPA's cuDNN backend (``is_causal`` where there is no window, else the
boolean causal-window mask) through autograd, forward + backward and the
backward alone on a retained graph.

It prints one JSON object with the times in ms, the checkout it timed and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = {"recurrentgemma-2b": (4096, 2560), "mamba2-2.7b": (16, 1_310_720)}
ATTN = {"recurrentgemma-2b": (1, 10, 1, 4096, 256, 2048),
        "smollm-360m": (2, 15, 5, 4096, 64, 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

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

    def kernels(fn):
        """{kernel name: device ms a call} over ``--reps`` calls."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name[:80]
                out[name] = out.get(name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / args.reps
        return out

    def sdpa_kernels(q, k, v, do, S, W):
        """SDPA's cuDNN backend with the kernel's masks, through
        autograd: each kernel's device ms, forward + backward and the
        backward alone."""
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel

        mask = None
        if W:
            pos = torch.arange(S, device=dev)
            mask = (pos[:, None] >= pos[None, :]) & \
                (pos[:, None] - pos[None, :] < W)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            sdpa = lambda: F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            both = kernels(lambda: torch.autograd.grad(
                sdpa(), (qg, kg, vg), do))
            o = sdpa()
            alone = kernels(lambda: torch.autograd.grad(
                o, (qg, kg, vg), do, retain_graph=True))
        return {"fwd_bwd_kernels": both,
                "fwd_bwd_device_ms": sum(both.values()),
                "bwd_kernels": alone, "bwd_device_ms": sum(alone.values())}

    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"src": os.path.relpath(os.path.abspath(args.src), HERE),
           "decay_scan_bwd": {}, "flash_attention_bwd": {}}
    for label, (T, C) in SCANS.items():
        a = torch.rand(T, C, generator=gen, device=dev)
        u, g = (torch.randn(T, C, generator=gen, device=dev)
                for _ in range(2))
        h = ds.decay_scan_cuda(a, u)
        out["decay_scan_bwd"][label] = ms(
            lambda: ds.decay_scan_bwd_cuda(a, h, g))
        del a, u, g, h
    for label, (B, H, Kh, S, D, W) in ATTN.items():
        q = torch.randn(B, H, S, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Kh, S, D, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        do = torch.randn_like(q)
        kw = dict(causal=True, window=W)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        out["flash_attention_bwd"][label] = {
            "bwd_ms": ms(bwd),
            "fwd_with_lse_ms": ms(lambda: fa.flash_attention_cuda(
                q, k, v, return_lse=True, **kw)),
            "bwd_kernels": kernels(bwd),
            "sdpa_cudnn": sdpa_kernels(q, k, v, do, S, W)}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

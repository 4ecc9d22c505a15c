#!/usr/bin/env python3
"""Where MoE serving on the PyTorch port spends its time.

    PYTHONPATH=src python3 scripts/torch_moe_breakdown.py \\
        [--arch qwen2-moe-a2.7b] [--layers N] [--steps 8]

Runs on ``cuda:0`` at the configuration of ``chip_smoke.py`` phase 11:
``--arch`` at full width in bfloat16 (seeded random weights, the shared
experts' gate drawn), ``--layers`` of its layers (all by default; Kimi-K2
needs 2 on one card), batch 2, a 4096-token prompt.  It prints one JSON
object with:

* ``layer``: one MoE layer of the model (``ffn.moe``'s parts, each timed
  with CUDA events over repeated calls after a warm-up, so a part's time
  includes the device's waits for the host's launches) at the prefill's
  2 x 4096 tokens and a decode step's 2: the router (``ffn.route``), the
  sort (``ffn.sort_slots``), the dispatch into the [E, cap, D] buffer,
  the expert products (``ffn.experts_swiglu``), the combine, the shared
  expert, and the whole ``ffn.moe``; with the capacity and the buffer's
  rows;
* ``prefill`` and ``decode_step``: the whole model's request after a
  warm-up, host wall time synchronised and, from ``torch.profiler``, the
  kernels launched, device busy time by class (``flash_attention``,
  GEMMs, sorts, index and scatter kernels, the rest) and the device's
  idle share.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from repro_torch.configs.base import load_config  # noqa: E402
from repro_torch.kernels import _build, flash_attention  # noqa: E402
from repro_torch.models import backbone, ffn  # noqa: E402
from repro_torch.serving.engine import make_serve_step, sample_token  # noqa
from torch_serve_breakdown import GEMM_MARKERS, profiled  # noqa: E402

BATCH, PROMPT = 2, 4096


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if any(m in low for m in GEMM_MARKERS):
        return "gemm"
    if "sort" in low:
        return "sort"
    if any(m in low for m in ("index", "scatter", "gather")):
        return "index"
    return "other"


def event_ms(fn, reps: int = 10) -> float:
    """Device milliseconds a call, between CUDA events, after a warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_parts(p, x, cfg) -> dict:
    """``ffn.moe``'s parts on ``x`` [B, S, D], each timed alone."""
    B, S, D = x.shape
    T, k = B * S, cfg.top_k
    E_pad = p["router"].shape[1]
    xf = x.reshape(T, D)
    cap = ffn.capacity(T, k, cfg.num_experts, cfg.capacity_factor)
    gate_w, eid, _, _ = ffn.route(xf, p["router"], cfg.num_experts, k)
    order, sorted_e, rank, keep = ffn.sort_slots(eid, cap)
    n = E_pad * cap
    dest = torch.where(keep, sorted_e * cap + rank, n)

    def dispatch():
        buf = x.new_zeros(n + 1, D)
        buf[dest] = xf[order // k]
        return buf
    xe = dispatch()[:n].view(E_pad, cap, D)
    ye = ffn.experts_swiglu(xe, p["w_gate"], p["w_up"],
                            p["w_down"]).reshape(n, D)
    parts = {
        "router": event_ms(lambda: ffn.route(xf, p["router"],
                                             cfg.num_experts, k)),
        "sort": event_ms(lambda: ffn.sort_slots(eid, cap)),
        "dispatch": event_ms(dispatch),
        "experts": event_ms(lambda: ffn.experts_swiglu(
            xe, p["w_gate"], p["w_up"], p["w_down"])),
        "combine": event_ms(lambda: ffn.combine(
            ye[torch.clamp_max(dest, n - 1)], keep, order, gate_w, k)),
        "shared_expert": event_ms(lambda: ffn.shared_expert(p, x))
        if "shared" in p else 0.0}
    whole = event_ms(lambda: ffn.moe(p, x, num_experts=cfg.num_experts,
                                     top_k=k,
                                     capacity_factor=cfg.capacity_factor))
    flops = 3 * 2 * n * D * cfg.moe_d_ff
    return {"tokens": T, "capacity": cap, "buffer_rows": n,
            "routed_rows": T * k, "ms": parts, "moe_ms": whole,
            "parts_sum_ms": sum(parts.values()),
            "expert_tflop": flops / 1e12,
            "expert_tflop_per_s": flops / parts["experts"] / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all([flash_attention.KERNEL])
    run = load_config(args.arch)
    if args.layers is not None:
        run = dataclasses.replace(run, model=dataclasses.replace(
            run.model, num_layers=args.layers))
    cfg = run.model
    gen = torch.Generator(device=dev).manual_seed(11)
    params = backbone.init_params(cfg, gen, torch.bfloat16, dev)
    with torch.no_grad():
        for layer in params["layers"]:
            if "moe" in layer and "shared_gate" in layer["moe"]:
                g = layer["moe"]["shared_gate"]
                g.normal_(0.0, g.shape[0] ** -0.5, generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    moe = next(layer["moe"] for layer, kind in
               zip(params["layers"], backbone.layer_plan(cfg).kinds)
               if kind == "moe")
    prefill = make_serve_step(run, "prefill", compute_dtype=torch.bfloat16,
                              max_len=PROMPT + 4 * args.steps)
    decode = make_serve_step(run, "decode", compute_dtype=torch.bfloat16)
    greedy = lambda logits: sample_token(logits, None, temperature=0.0,
                                         vocab_size=cfg.vocab_size)
    with torch.inference_mode():
        layer = {name: layer_parts(moe, torch.randn(
            BATCH, S, cfg.d_model, generator=gen, device=dev,
            dtype=torch.bfloat16), cfg)
            for name, S in (("prefill", PROMPT), ("decode", 1))}
        logits, state = prefill(params, prompts)         # warm-up request
        for _ in range(args.steps):
            logits, state = decode(params, state, greedy(logits))
        pre = profiled(lambda: prefill(params, prompts), 1, kernel_class)
        box = {"state": state, "tok": greedy(logits)}

        def step():
            lg, box["state"] = decode(params, box["state"], box["tok"])
            box["tok"] = greedy(lg)

        dec = profiled(step, args.steps, kernel_class)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "layers": cfg.num_layers, "batch": BATCH, "prompt": PROMPT,
        "decode_steps": args.steps, "layer": layer, "prefill": pre,
        "decode_step": dec,
        "prefill_tok_per_s": BATCH * PROMPT / pre["wall_ms"] * 1e3,
        "decode_tok_per_s": BATCH / dec["wall_ms"] * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

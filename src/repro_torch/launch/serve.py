"""Serving CLI (PyTorch): one CLI, two frontends (``--frontend``, names in
``FRONTENDS``).

The counterpart of ``repro.launch.serve``.  It runs on ``cuda:0`` unless
``--device cpu`` is given.

* ``llm`` — prefill + decode for every architecture of ``ARCH_IDS``
  (dense, MoE, SSM, hybrid, vision, audio), at the full configuration
  unless ``--smoke`` is given, with random weights drawn from ``--seed``.
  An encoder-only architecture (hubert) encodes ``--batch`` x
  ``--prompt-len`` random frames instead; the vision family's prompts come
  with ``image_embeds`` [batch, num_vision_tokens, d_model] drawn from the
  seed, as the JAX CLI draws them.  At full depth Kimi-K2 (2.06 TB) and
  Llama-3.2-Vision (175 GB) fit no one card.
* ``scoring`` — the online feature-scoring tier (``serving/frontend.py``
  via ``ScoringPipeline.serve``): open-loop Poisson request admission at
  ``--load`` events/s (0: all at once), dynamic batching with a
  ``--max-wait-ms`` deadline, write-behind persistence underneath,
  optionally a ``--residency`` slot budget; after a warm-up burst it
  prints per-request latency quantiles, the dispatch counts and the
  persistence summary.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --requests 2 --batch 2 \\
        --prompt-len 4096 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-4b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --frontend scoring \\
        --regime fraud --requests 5000 --load 20000 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (ARCH_IDS, DEFAULT_ARCH, load_config,
                                      load_smoke_config)
from repro_torch.core.thinning import prng_key
from repro_torch.core.types import resolve_device
from repro_torch.kernels import _build, decay_scan, flash_attention
from repro_torch.models import backbone
from repro_torch.serving.engine import make_serve_step, sample_token

FRONTENDS = ("llm", "scoring")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def _serve_llm(args) -> None:
    device = resolve_device(args.device)
    if device.type == "cuda":   # build the kernels before any timing
        _build.build_all([decay_scan.KERNEL, flash_attention.KERNEL])
    run = (load_smoke_config if args.smoke else load_config)(args.arch)
    cfg = run.model
    dtype = torch.float32 if args.smoke else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = backbone.init_params(cfg, gen, dtype, device)
    rng = np.random.default_rng(args.seed)
    if not cfg.causal:
        # encoder-only: serve = full-sequence frame classification
        encode = make_serve_step(run, "prefill", compute_dtype=dtype)
        frames = torch.from_numpy(rng.normal(
            size=(args.batch, args.prompt_len, cfg.frame_dim))).to(
                device, dtype)
        _sync(device)
        t0 = time.perf_counter()
        logits = encode(params, frames)
        _sync(device)
        wall = time.perf_counter() - t0
        print(f"encoded {args.batch}x{args.prompt_len} frames -> "
              f"{tuple(logits.shape)} on {device} in {wall:.2f}s "
              f"({args.batch * args.prompt_len / max(wall, 1e-9):,.0f} "
              f"frames/s)")
        return
    prefill = make_serve_step(run, "prefill", compute_dtype=dtype,
                              max_len=args.prompt_len + args.new_tokens)
    decode = make_serve_step(run, "decode", compute_dtype=dtype)

    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    n_batches = -(-args.requests // args.batch)
    decoded = 0
    t_pre = t_dec = 0.0
    for b in range(n_batches):
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
        image_embeds = None
        if cfg.family == "vlm":
            image_embeds = torch.from_numpy(rng.normal(
                size=(args.batch, cfg.num_vision_tokens, cfg.d_model))).to(
                    device, dtype)
        _sync(device)
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts, image_embeds)
        tok = sample_token(logits, sampler, temperature=args.temperature,
                           vocab_size=cfg.vocab_size)
        _sync(device)
        t_pre += time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            logits, state = decode(params, state, tok)
            tok = sample_token(logits, sampler,
                               temperature=args.temperature,
                               vocab_size=cfg.vocab_size)
        _sync(device)
        t_dec += time.perf_counter() - t0
        # the first new token of each request comes from the prefill
        decoded += args.batch * (args.new_tokens - 1)
        print(f"batch {b}: prefill ok, decoded {args.new_tokens} tokens")

    n_prompt = n_batches * args.batch * args.prompt_len
    print(f"\nserved {n_batches * args.batch} requests on {device} | "
          f"prefill {t_pre:.2f}s ({n_prompt / max(t_pre, 1e-9):,.0f} tok/s)"
          f" | decode {t_dec:.2f}s "
          f"({decoded / max(t_dec, 1e-9):,.0f} tok/s)")


def _serve_scoring(args) -> None:
    from repro_torch.features.spec import ProfileSpec
    from repro_torch.kernels import thinning_rmw
    from repro_torch.serving.frontend import poisson_arrivals
    from repro_torch.serving.pipeline import ScoringPipeline, init_scorer
    from repro_torch.streaming.workload import REGIMES, generate_regime

    if args.regime not in REGIMES:
        raise SystemExit(f"unknown regime {args.regime!r}; choose from "
                         f"{tuple(REGIMES)}")
    device = resolve_device(args.device)
    if device.type == "cuda":   # build the kernel before any timing
        _build.build_all([thinning_rmw.KERNEL])
    spec = ProfileSpec(windows=(60.0, 3600.0, 86400.0),
                       write_budget_per_min=0.1 / 60.0, variance_alpha=1.0)
    stream = generate_regime(args.regime, seed=args.seed,
                             n_events=args.requests)
    pipe = ScoringPipeline.build(spec, stream.spec.n_keys, mode="fast",
                                 device=device)
    pipe.scorer = init_scorer(torch.Generator().manual_seed(1),
                              spec.feature_dim, device=device)
    n = len(stream)
    arrivals = poisson_arrivals(n, args.load, seed=args.seed) \
        if args.load > 0 else np.zeros(n)
    residency = args.residency if args.residency > 0 else None
    # warm-up: a short burst prefix, so the reported latencies measure
    # serving, not first-call allocation and library set-up
    w = min(4 * args.batch, n)
    wsink = pipe.make_sink()
    pipe.serve(stream.key[:w], stream.q[:w], stream.t[:w],
               arrival_s=np.zeros(w), batch=args.batch,
               max_wait_s=args.max_wait_ms / 1e3,
               rng=prng_key(args.seed), sink=wsink, residency=residency)
    wsink.close()
    sink = pipe.make_sink()
    t0 = time.perf_counter()
    res = pipe.serve(stream.key, stream.q, stream.t, arrival_s=arrivals,
                     batch=args.batch, max_wait_s=args.max_wait_ms / 1e3,
                     rng=prng_key(args.seed), sink=sink,
                     residency=residency)
    stats = sink.flush()
    wall = time.perf_counter() - t0
    sink.close()
    q = res.latency_quantiles()
    st = res.stats
    print(f"served {n} score requests over regime={args.regime} on "
          f"{device} (offered "
          f"{'burst' if args.load <= 0 else f'{args.load:,.0f}/s'}, "
          f"batch<={args.batch}, deadline {args.max_wait_ms}ms)")
    print(f"  latency p50 {q['p50'] * 1e3:.3f}ms | p99 "
          f"{q['p99'] * 1e3:.3f}ms | p999 {q['p999'] * 1e3:.3f}ms")
    print(f"  dispatches {st.dispatches} (full {st.full_batches}, deadline "
          f"{st.deadline_batches}) | mean batch "
          f"{st.events / max(st.dispatches, 1):.1f} | max queue "
          f"{st.max_queue}")
    if residency:
        print(f"  residency: prefetched {st.prefetch_issued} "
              f"(hits {st.prefetch_hits}, rehydrations "
              f"{st.prefetch_rehydrations}), demand reads {st.demand_reads}")
    print(f"  persistence: {stats['puts']} puts "
          f"({stats['puts'] / n:.4f}/event) | wall {wall:.2f}s "
          f"({n / wall:,.0f} events/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frontend", default="llm", choices=FRONTENDS,
                    help="llm: prefill+decode token serving; scoring: "
                         "open-loop feature-scoring tier "
                         "(serving/frontend.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config, in float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=DEFAULT_ARCH, choices=ARCH_IDS)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    # scoring frontend
    ap.add_argument("--regime", default="fraud",
                    help="Table 2 workload regime (streaming/workload.py)")
    ap.add_argument("--load", type=float, default=0.0,
                    help="offered load, events/s (<=0: burst — all "
                         "requests arrive at once)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="partial-batch dispatch deadline")
    ap.add_argument("--residency", type=int, default=0,
                    help="resident-slot budget (0: dense state)")
    args = ap.parse_args(argv)
    if args.frontend == "scoring":
        if args.requests == 8:          # llm-sized default: too small to
            args.requests = 4096        # exercise the batcher
        if args.batch == 4:
            args.batch = 256
        _serve_scoring(args)
    else:
        _serve_llm(args)


if __name__ == "__main__":
    main()

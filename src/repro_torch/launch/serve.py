"""Serving CLI (PyTorch): the ``llm`` frontend over prefill + decode.

The counterpart of ``repro.launch.serve`` (``--frontend llm``) for the
architectures the port serves.  It runs on ``cuda:0`` unless
``--device cpu`` is given, at the full configuration unless ``--smoke``
is given, with random weights drawn from ``--seed``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --requests 2 --batch 2 \\
        --prompt-len 4096 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, load_config, load_smoke_config
from repro_torch.core.types import resolve_device
from repro_torch.kernels import _build, decay_scan, flash_attention
from repro_torch.models import backbone
from repro_torch.serving.engine import make_serve_step, sample_token

FRONTENDS = ("llm",)     # the scoring frontend is not ported yet


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
    prefill = make_serve_step(run, "prefill", compute_dtype=dtype,
                              max_len=args.prompt_len + args.new_tokens)
    decode = make_serve_step(run, "decode", compute_dtype=dtype)

    rng = np.random.default_rng(args.seed)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    n_batches = -(-args.requests // args.batch)
    decoded = 0
    t_pre = t_dec = 0.0
    for b in range(n_batches):
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
        _sync(device)
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frontend", default="llm", choices=FRONTENDS,
                    help="llm: prefill+decode token serving")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config, in float32")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default=ARCH_IDS[0], choices=ARCH_IDS)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)
    _serve_llm(args)


if __name__ == "__main__":
    main()

"""Training driver: synthetic-stream LM training with checkpoint/restart
(PyTorch port of ``repro.launch.train``).

Full configs in bfloat16 on ``cuda:0`` by default; ``--smoke`` takes the
reduced same-family config in float32, and ``--device cpu`` runs it on the
CPU with the kernels' plain versions:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir runs/ckpt

``synthetic_batch`` draws the JAX CLI's batches with numpy from the seed
(Zipf tokens, or normal frames and uniform labels, and normal
``image_embeds`` for the vision family), so both CLIs see the same data;
step ``i`` passes the key ``prng_key(i)`` (JAX's ``PRNGKey(i)``) to the
thinned sync, as the JAX CLI does; the weights are drawn from a
``torch.Generator`` and differ from JAX's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import (ARCH_IDS, load_config,
                                      load_smoke_config)
from repro_torch.core.types import resolve_device
from repro_torch.kernels.threefry import prng_key
from repro_torch.models.common import tree_leaves
from repro_torch.train import trainer


def synthetic_batch(cfg, rng: np.random.Generator, batch: int, seq: int,
                    device=None) -> dict:
    """Zipf-distributed synthetic tokens (loosely natural-language-shaped),
    or frames and labels for frame input; the JAX CLI's draws."""
    out = {}
    if cfg.input_mode == "frames":
        out["frames"] = rng.normal(size=(batch, seq, cfg.frame_dim)
                                   ).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq)
                                     ).astype(np.int32)
    else:
        z = rng.zipf(1.3, size=(batch, seq))
        out["tokens"] = np.minimum(z, cfg.vocab_size - 1).astype(np.int32)
        if cfg.family == "vlm":
            out["image_embeds"] = rng.normal(
                size=(batch, cfg.num_vision_tokens, cfg.d_model)
            ).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config in float32")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    run = (load_smoke_config if args.smoke else load_config)(args.arch)
    if args.smoke:
        run = dataclasses.replace(run, train=dataclasses.replace(
            run.train, param_dtype="float32", compute_dtype="float32",
            grad_accum=1, warmup_steps=10, learning_rate=3e-3))
    cfg = run.model
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"opt={run.train.optimizer} device={device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_train_state(run, gen, device=device)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"params: {n_params / 1e6:.2f}M")

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            state = trainer.restore_train_state(mgr, state)
            start_step = int(state.step)
            print(f"resumed from step {start_step}")

    step_fn = trainer.make_train_step(run, total_steps=args.steps)
    rng = np.random.default_rng(args.seed + 1)
    for _ in range(start_step):      # the batches already trained on
        synthetic_batch(cfg, rng, args.batch, args.seq)
    t0 = time.perf_counter()
    tokens_seen = 0
    metrics = {"loss": float("nan")}
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg, rng, args.batch, args.seq, device)
        state, metrics = step_fn(state, batch, prng_key(step))
        tokens_seen += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start_step:
            dt = time.perf_counter() - t0
            print(f"step {step + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics.get('accuracy', 0)):.3f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"tok/s={tokens_seen / dt:,.0f}", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)
    if mgr:
        mgr.save(args.steps, state)
        mgr.wait()
    print("done")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()

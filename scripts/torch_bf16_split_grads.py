#!/usr/bin/env python3
"""How far gradients move when a batch is split in two, as a data mesh
splits it.

    PYTHONPATH=src python3 scripts/torch_bf16_split_grads.py \
        [--device cpu|cuda] [--seq N]

Under a ("data", ...) mesh of 2 data ranks each rank differentiates its
row of the batch with the loss scaled by its share of the tokens (1/2
here), and the ranks' bfloat16 gradients are summed in bfloat16 by a
reduce-scatter; one process differentiates the whole batch at once.  For
SmolLM-360M and RecurrentGemma-2B's first pattern group (rec, rec, attn),
with seeded weights on 2 sequences of Zipf tokens (the train CLI's
draws), in one process, this prints:

* the global gradient norm of the whole batch, and of the two rows'
  halves summed in float64 and in bfloat16 (as the mesh sums them), in
  bfloat16 (weights and compute) and in float32, and the tied
  embedding's gradient norm both ways;
* the five leaves whose gradient moves most between the whole batch and
  the split (relative L2), in bfloat16;
* on a card, the attention kernel's backward on RecurrentGemma's 2-row
  shape (1 KV head, D 256, window 2048) against each row alone and
  against the float32 plain backward (normwise).

On the CPU (the default) it runs the smoke configs; ``--device cuda``
runs full width on ``cuda:0`` and adds the card's name and power limit.
It prints one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

RG_GROUP = 3          # RecurrentGemma's first pattern group (rec, rec, attn)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from named_leaves(x, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def norm(gs) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))


def split_grads(params, cfg, data, dtype):
    """(whole, half 0, half 1): each a list of ``.grad`` tensors in
    ``params``' dtype, a half being its row's gradient of the loss times
    its share of the tokens."""
    from repro_torch.models import backbone

    leaves = [p for _, p in named_leaves(params)]

    def grads(batch, share):
        for p in leaves:
            p.grad = None
        loss, met = backbone.train_loss(params, cfg, batch,
                                        compute_dtype=dtype)
        (loss * share).backward()
        return [p.grad.detach().clone() for p in leaves]

    whole = grads(data, 1.0)
    halves = [grads({k: v[i:i + 1] for k, v in data.items()}, 0.5)
              for i in range(2)]
    for p in leaves:
        p.grad = None
    return whole, halves


def one_model(cfg, device, seq):
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import backbone

    data = synthetic_batch(cfg, np.random.default_rng(13), 2, seq, device)
    out = {}
    for label, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        params = backbone.init_train_params(
            cfg, torch.Generator(device=device).manual_seed(1),
            torch.bfloat16, device)
        if dtype == torch.float32:
            from repro_torch.models.common import tree_map, trainable
            params = trainable(tree_map(lambda p: p.detach().float(),
                                        params))
        whole, (h0, h1) = split_grads(params, cfg, data, dtype)
        names = [n for n, _ in named_leaves(params)]
        f64 = [a.double() + b.double() for a, b in zip(h0, h1)]
        low = [a + b for a, b in zip(h0, h1)]      # summed in the dtype
        e = names.index("/embed/tok")
        rec = {"norm_whole": norm(whole), "norm_split_f64": norm(f64),
               "norm_split_summed_in_dtype": norm(low),
               "embed_norm_whole": norm(whole[e:e + 1]),
               "embed_norm_split": norm(f64[e:e + 1])}
        if dtype == torch.bfloat16:
            gaps = []
            for n, w, s in zip(names, whole, f64):
                wn = float(w.double().norm())
                gaps.append((float((w.double() - s).norm()) / max(wn, 1e-30),
                             n, wn, float(s.norm())))
            gaps.sort(reverse=True)
            rec["top_leaf_gaps"] = [
                {"leaf": n, "rel_gap": g, "norm_whole": a, "norm_split": b}
                for g, n, a, b in gaps[:5]]
        out[label] = rec
        del params, whole, h0, h1, f64, low
    return out


def attention_rows(device):
    """RecurrentGemma's attention backward at batch 2 on the card: each
    row against the same row alone (the grid's split count differs), and
    the whole against the float32 plain backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, Kh, S, D, W = 2, 10, 1, 4096, 256, 2048
    gen = torch.Generator(device=device).manual_seed(5)
    q = torch.randn(B, H, S, D, generator=gen, device=device
                    ).to(torch.bfloat16)
    k, v = (torch.randn(B, Kh, S, D, generator=gen, device=device
                        ).to(torch.bfloat16) for _ in range(2))
    do = torch.randn(B, H, S, D, generator=gen, device=device
                     ).to(torch.bfloat16)

    def bwd(q, k, v, do):
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=W,
                                         return_lse=True)
        return o, lse, fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                    causal=True, window=W)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    o, lse, whole = bwd(q, k, v, do)
    rows = [bwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1])[2]
            for i in range(B)]
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=W)
    return {"shape": [B, H, Kh, S, D, W],
            "splits_batch2": fa.bwd_splits(q, k),
            "splits_batch1": fa.bwd_splits(q[:1], k[:1]),
            "row_vs_alone": [max(rel(g[i:i + 1], r[j]) for j, g in
                                 enumerate(whole)) for i, r in
                             enumerate(rows)],
            "vs_plain": [rel(g, w) for g, w in zip(whole, want)]}


def main() -> int:
    from repro_torch.configs.base import load_config, load_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens a row (default 1024 on the CPU, 4096 on "
                         "a card)")
    args = ap.parse_args()
    device = torch.device(args.device)
    card = device.type == "cuda"
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    seq = args.seq or (4096 if card else 1024)
    load = load_config if card else load_smoke_config
    out = {"device": str(device), "seq": seq}
    for arch, layers in (("smollm-360m", None),
                         ("recurrentgemma-2b", RG_GROUP)):
        cfg = load(arch).model
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out[arch] = one_model(cfg, device, seq)
        if card:
            torch.cuda.empty_cache()
    if card:
        out["attention_rows"] = attention_rows(device)
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which collectives work under gloo with CUDA tensors, rank by rank.

    python3 scripts/torch_gloo_collectives.py

On one card it starts 2 gloo ranks on ``cuda:0`` (``distributed.spawn.
run_ranks``) once per collective and dtype (float32, bfloat16): c10d's
all-reduce, all-gather-into-tensor and reduce-scatter; the functional
collectives' all-gather, reduce-scatter and all-reduce (what DTensor
issues); DTensor's Shard -> Replicate, Partial -> Shard and Partial ->
Replicate; and ``distributed.collectives.whole`` on a sharded DTensor
(the host-staged gather the trainer uses).  Rank r holds (r + 1) in every
element of a [4, 2] tensor, so each result's sum is known: 24 for a
gather or an all-reduce, 12 for a reduce-scatter.  A collective that
kills its rank (a signal) reads ``FAILED``.

It prints one JSON object, with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

OPS = ("c10d_all_reduce", "c10d_all_gather", "c10d_reduce_scatter",
       "funcol_all_gather", "funcol_reduce_scatter", "funcol_all_reduce",
       "dtensor_shard_to_replicate", "dtensor_partial_to_shard",
       "dtensor_partial_to_replicate", "collectives_whole")


def rank_fn(mesh, op: str, dtype: str):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_mesh

    dt = getattr(torch, dtype)
    x = (torch.ones(4, 2, device="cuda") * (dist.get_rank() + 1)).to(dt)
    world = dist.group.WORLD
    if op == "c10d_all_reduce":
        dist.all_reduce(x)
        out = x
    elif op == "c10d_all_gather":
        out = torch.empty(8, 2, device="cuda", dtype=dt)
        dist.all_gather_into_tensor(out, x)
    elif op == "c10d_reduce_scatter":
        out = torch.empty(2, 2, device="cuda", dtype=dt)
        dist.reduce_scatter_tensor(out, x)
    elif op == "funcol_all_gather":
        out = fc.wait_tensor(fc.all_gather_tensor(x, 0, world))
    elif op == "funcol_reduce_scatter":
        out = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, world))
    elif op == "funcol_all_reduce":
        out = fc.wait_tensor(fc.all_reduce(x, "sum", world))
    else:
        m = make_mesh((2,), ("data",), device_type="cuda")
        if op == "dtensor_shard_to_replicate":
            out = distribute_tensor(x, m, [Shard(0)], src_data_rank=None
                                    ).redistribute(m, [Replicate()])
        elif op == "dtensor_partial_to_shard":
            out = DTensor.from_local(x, m, [Partial()]).redistribute(
                m, [Shard(0)])
        elif op == "dtensor_partial_to_replicate":
            out = DTensor.from_local(x, m, [Partial()]).redistribute(
                m, [Replicate()])
        else:
            out = collectives.whole(distribute_tensor(
                x, m, [Shard(0)], src_data_rank=None))
        if isinstance(out, DTensor):
            out = out.to_local()
    return float(out.float().sum())


def main() -> int:
    import torch

    from repro_torch.distributed.spawn import run_ranks

    if not torch.cuda.is_available():
        print("torch_gloo_collectives: no CUDA device", file=sys.stderr)
        return 2
    out = {}
    for dtype in ("float32", "bfloat16"):
        for op in OPS:
            try:
                out[f"{op}_{dtype}"] = run_ranks(
                    rank_fn, 2, op, dtype, backend="gloo", device="cuda:0",
                    timeout_s=60)
            except Exception as e:  # a rank killed by a signal, or raising
                out[f"{op}_{dtype}"] = "FAILED: " + repr(e)[-120:]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out["torch"] = torch.__version__
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

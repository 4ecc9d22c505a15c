"""Multi-pod dry-run: run every (architecture x shape x mesh) cell's real
step with no storage and extract memory / FLOP / collective roofline
terms (PyTorch port of ``repro.launch.dryrun``).

Each cell runs the port's real ``make_train_step`` or ``make_serve_step``
over the sharded stand-ins of ``launch.shardings`` (DTensors placed by the
rule table of ``distributed.sharding``) under ``FakeTensorMode``, as rank
0 of a fake process group of the mesh's world size: nothing is
allocated and no collective moves a byte, but every operation, every
DTensor redistribution and every kernel (one ``torch.library`` op each,
with its fake and its FLOP formula) executes.  The steps gather each
layer's parameters over the data axes and run the model tensor-parallel
over ``model`` (``train.trainer``, ``serving.engine``): rank 0 computes
each product the rules split on its shard, with the tensor-parallel
collectives (``distributed.collectives``) where GSPMD would put them, a
MoE block on the rank's experts (or their ``ff`` columns; its routing
statistics and slots summed over the data axes, as in the reference's one
program), and a decode attends its ``kv_seq`` slots and merges partial
softmaxes.
``--seq-parallel`` (``make_rules(seq_parallel=True)``) shards the
residual stream's rows over ``model`` between blocks; the record's
``seq_parallel`` says which.  ``launch.hlo_analysis``
counts what rank 0 does.  Every layer and every micro-batch executes, so
no 1-group/2-group extrapolation is needed (the reference lowers two
unrolled variants because XLA's cost analysis counts a loop body once).
Where the reference forces 512 host devices, the port needs a fake
process group only.

The roofline constants are the NVIDIA H100 SXM 80 GB datasheet's (card
``NVIDIA H100 80GB HBM3``, power limit 700 W): 989e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM3 and 450e9 B/s of NVLink a direction.  The terms
built on them are estimates from those constants, not measurements.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh single --out runs/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import shapes as shape_lib
from repro_torch.configs.base import ARCH_IDS, load_config
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as sharding_rules
from repro_torch.launch import hlo_analysis, shardings
from repro_torch.launch.mesh import MESH_SHAPES, make_mesh
from repro_torch.models import backbone

# NVIDIA H100 SXM 80 GB datasheet values, for the roofline terms
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s a card
HBM_BW = 3.35e12             # HBM3 bytes/s a card
NVLINK_BW = 450e9            # NVLink bytes/s a card, one direction

AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_shape_of(mesh_name: str) -> tuple:
    """``"single"`` (16, 16), ``"multi"`` (2, 16, 16), or an ``AxB[xC]``
    shape (``"4x2"``: ``("data", "model")`` = (4, 2))."""
    if mesh_name in MESH_SHAPES:
        return MESH_SHAPES[mesh_name]
    return tuple(int(n) for n in mesh_name.split("x"))


def fake_mesh(mesh_name: str):
    """The mesh on a fake process group of its world size, this process
    its rank 0 (an existing group of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = mesh_shape_of(mesh_name)
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized() and (dist.get_world_size() != world
                                  or dist.get_backend() != "fake"):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_mesh(shape, AXES[len(shape)], device_type="cpu")


def _cell_step(run, shape, mesh):
    """(the step's arguments: the sharded stand-ins, the step called on
    them) for one cell."""
    from repro_torch.kernels.threefry import prng_key
    from repro_torch.serving.engine import make_serve_step
    from repro_torch.train.trainer import make_train_step

    if shape.kind == "train":
        args = (shardings.train_state_sds(run, mesh),
                shardings.batch_sds(run, shape, mesh),
                shardings.rng_sds(mesh))
        step = make_train_step(run)
        return args, lambda: step(args[0], args[1], prng_key(0))
    params = shardings.param_sds(run, mesh, dtype=torch.bfloat16)
    batch = shardings.batch_sds(run, shape, mesh)
    if shape.kind == "prefill":
        step = make_serve_step(run, "prefill", max_len=shape.seq_len)
        if not run.model.causal:
            return (params, batch), lambda: step(params, batch["frames"])
        return (params, batch), lambda: step(
            params, batch["tokens"], image_embeds=batch.get("image_embeds"))
    dstate = shardings.decode_state_sds(run, mesh, shape)
    step = make_serve_step(run, "decode")
    return (params, dstate, batch), lambda: step(params, dstate,
                                                 batch["tokens"])


def measure(run, shape, mesh) -> dict:
    """Run one cell's step under ``FakeTensorMode`` on ``mesh`` (the rule
    table installed by the caller) and count what rank 0 does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            shardings.leaf_device("cpu"):
        args, step = _cell_step(run, shape, mesh)
        t_args = time.time()
        analysis = hlo_analysis.StepAnalysis(shardings.argument_bytes(*args))
        flops = FlopCounterMode(display=False)
        with flops, analysis:
            step()
    return {"analysis": analysis, "flops": flops.get_total_flops(),
            "args_s": t_args - t0, "step_s": time.time() - t_args}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             extra_rules: dict | None = None,
             grad_accum: int | None = None,
             model_overrides: dict | None = None, run=None,
             shape: shape_lib.ShapeSpec | None = None,
             seq_parallel: bool = False) -> dict:
    """One cell's record, with the reference's keys.  ``run`` and
    ``shape`` replace ``load_config(arch)`` and ``SHAPES[shape_name]``
    (a smoke cell); ``mesh_name`` is ``single``, ``multi`` or ``AxB[xC]``;
    ``seq_parallel`` picks the reference's sequence-parallel rules.
    ``lower_s`` is the time the stand-ins took, ``compile_s`` the step's
    run."""
    t0 = time.time()
    mesh = fake_mesh(mesh_name)
    n_dev = mesh.size()
    run = run if run is not None else load_config(arch)
    if grad_accum is not None:
        run = dataclasses.replace(run, train=dataclasses.replace(
            run.train, grad_accum=grad_accum))
    if model_overrides:
        run = dataclasses.replace(run, model=dataclasses.replace(
            run.model, **model_overrides))
    mcfg = run.model
    shape = shape if shape is not None else shape_lib.SHAPES[shape_name]

    ok, why = shape_lib.applicable(mcfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    # FSDP only for training: serving has no optimizer state to amortize
    # (serve cells shard weights over 'model' only)
    rules = sharding_rules.make_rules(fsdp=(shape.kind == "train"),
                                      seq_parallel=seq_parallel,
                                      overrides=extra_rules)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": n_dev, "status": "ok", "seq_parallel": seq_parallel}
    with dctx.mesh_context(mesh, rules):
        m = measure(run, shape, mesh)
    a = m["analysis"]
    coll = a.collectives
    flops_dev = float(m["flops"])
    bytes_dev = float(a.bytes_accessed)
    rec.update({
        "lower_s": round(m["args_s"], 1),
        "compile_s": round(m["step_s"], 1),
        "total_s": round(time.time() - t0, 1),
        "memory": hlo_analysis.memory_analysis_dict(a),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_per_chip_bytes": coll.per_chip_bytes,
        "collective_by_kind": dict(coll.by_kind_bytes),
        "collective_count": coll.count,
        "raw_flops_per_device_scan_once": flops_dev,
        "bytes_per_device_incl_vmem_intermediates": bytes_dev,
        # roofline terms (seconds), from datasheet constants
        "t_compute": flops_dev / PEAK_FLOPS,
        "t_memory": bytes_dev / HBM_BW,
        "t_collective": coll.per_chip_bytes / NVLINK_BW,
        "params_total": backbone.count_params(mcfg),
        "params_active": backbone.active_params(mcfg),
        "roofline_constants": {"card": CARD, "power_limit_w": POWER_LIMIT_W,
                               "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                               "nvlink_bw": NVLINK_BW,
                               "source": "datasheet"},
        "ops_per_device": a.ops,
    })
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["dominant"] = max(terms, key=terms.get)
    # MODEL_FLOPS: 6*N*D for train, 2*N*D forward-only for inference
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    rec["model_flops"] = mult * rec["params_active"] * d_tokens
    total_flops = flops_dev * n_dev
    rec["useful_flops_ratio"] = (rec["model_flops"] / total_flops
                                 if total_flops else 0.0)
    # roofline fraction: useful model flops at peak vs the achievable step
    # time implied by the dominant term
    t_star = max(terms.values())
    rec["roofline_fraction"] = (
        rec["model_flops"] / (n_dev * PEAK_FLOPS) / t_star
        if t_star > 0 else 0.0)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--rules-json", default=None,
                    help="JSON dict of rule overrides (perf iteration)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--model-json", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard activation seq dims over 'model'")
    args = ap.parse_args()
    torch.set_num_threads(1)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = shape_lib.SHAPE_ORDER if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    extra_rules = json.loads(args.rules_json) if args.rules_json else None

    failures = 0
    t_sweep = time.time()
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{arch}__{shape}__{mesh_name}" + \
                    (f"__{args.tag}" if args.tag else "")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    try:
                        with open(path) as f:
                            if json.load(f).get("status") in ("ok",
                                                              "skipped"):
                                print(f"[cached ] {tag}", flush=True)
                                continue
                    except (OSError, ValueError):
                        pass
                try:
                    rec = run_cell(arch, shape, mesh_name,
                                   extra_rules=extra_rules,
                                   grad_accum=args.grad_accum,
                                   model_overrides=json.loads(
                                       args.model_json)
                                   if args.model_json else None,
                                   seq_parallel=args.seq_parallel)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    mem_gb = rec["memory"].get("argument_size_in_bytes", 0) \
                        / 1e9
                    extra = (f" args={mem_gb:.2f}GB/dev "
                             f"tC={rec['t_compute']:.3e}s "
                             f"tM={rec['t_memory']:.3e}s "
                             f"tX={rec['t_collective']:.3e}s "
                             f"dom={rec['dominant']} "
                             f"run={rec['compile_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                elif status == "skipped":
                    extra = " " + rec["reason"]
                print(f"[{status:7s}] {tag}{extra}", flush=True)
    print(f"done; {failures} failures; sweep {time.time() - t_sweep:.1f}s")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

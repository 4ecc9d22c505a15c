"""Readings behind ``chip_smoke.py``'s bfloat16 tensor-parallel gates.

    python3 scripts/torch_tp_gate_readings.py             # on one H100
    python3 scripts/torch_tp_gate_readings.py --moe-only  # (d), (e) only
    python3 scripts/torch_tp_gate_readings.py --cpu-smoke  # a dry run

On 4 gloo ranks sharing the card, as phases 13 and 14 run, it prints one
JSON object with the card's name and power limit and:

* ``sound``: the gaps of phase 13's bfloat16 runs (SmolLM-360M, and
  RecurrentGemma-2B's one pattern group) and phase 14 (a)'s (Qwen3-4B, 4
  layers) from their witnesses (``chip_smoke.train_gaps``), and phase
  14 (b)'s logits against one process (``chip_smoke.logit_gaps``);
* ``planted``: the same readings with a tensor-parallel fault planted in
  the port's code on every rank:

  - ``row_partial_dropped``: one rank's partial sum of one row-parallel
    product (``common.region_out``'s ``ROW_K``-th call a step) zeroed
    before the ranks sum it;
  - ``col_grad_unsummed``: one column-parallel product's input gradient
    (``common._ColProduct``'s ``COL_K``-th backward a step) left as the
    rank's own share, its all-reduce skipped on every rank;
  - ``slots_dropped`` (decode): one layer's split softmax
    (``collectives.combine_softmax``'s ``COMBINE_K``-th call a step)
    leaving out the last rank's cache slots;

  and for the MoE on "model" (phase 14 (d)'s bfloat16 Qwen2-MoE run
  against its one-process witness, with its drops, and (e)'s serves):

  - ``moe_partial_dropped``: the first MoE layer's partial output of
    model rank 1 (``ffn.combine_partial``, its forward and its
    recompute) zeroed before the ranks sum it;
  - ``moe_aux_grad_summed`` (training): the router's aux and z losses,
    the same on every rank, passed through Megatron's f, so that their
    gradient is summed over the model ranks (M times the single
    program's);
  - ``moe_routing_local`` (training): the ranks that split the batch
    hidden from the MoE (``context.data_groups`` empty), so each data
    rank routes its rows alone: its statistics, capacity and slots.

The gates sit between the largest sound gap and the smallest planted one.
``--moe-only`` reads the MoE runs alone.
``--cpu-smoke`` runs the same code on the CPU at the smoke configs and a
short sequence, to check the script and not the numbers.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as C                                        # noqa: E402

ROW_K, COL_K, COMBINE_K = 3, 12, 17
SERVE_ROW_K = 35
TRAIN_FAULTS = (None, "row_partial_dropped", "col_grad_unsummed")
SERVE_FAULTS = (None, "row_partial_dropped", "slots_dropped")
MOE_TRAIN_FAULTS = (None, "moe_partial_dropped", "moe_aux_grad_summed",
                    "moe_routing_local")
MOE_SERVE_FAULTS = (None, "moe_partial_dropped")
TIMEOUT_S = 1200.0

_FAULT = {"name": None, "row_k": ROW_K, "moe_calls": (0,)}
_COUNT = {"row_out": 0, "col_bwd": 0, "combine": 0, "moe_partial": 0}
_MESH_COUNT = {}        # the counts of the last step under a model group


def _reset():
    for k in _COUNT:
        _COUNT[k] = 0


def _install(p):
    """On a rank: the smoke sizes for a dry run, then the faults' hooks
    (each inert until ``_FAULT["name"]`` names it; the counts restart at
    every train or serve step, and a step under a model group keeps
    them in ``_MESH_COUNT``)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as dctx
    from repro_torch.models import common, ffn
    from repro_torch.serving import engine
    from repro_torch.train import trainer

    if p["cpu_smoke"]:
        _smoke_sizes()

    def model_rank():
        g = dctx.model_group()
        return None if g is None else dist.get_rank(g)

    region_out = common.region_out

    def row_out(out, local, dtype=None):
        n = _COUNT["row_out"]
        _COUNT["row_out"] += 1
        if _FAULT["name"] == "row_partial_dropped" and local \
                and n == _FAULT["row_k"] and model_rank() == 1:
            out = out * 0      # zero, the graph kept: every rank's
            # backward runs the same collectives
        return region_out(out, local, dtype)
    common.region_out = row_out

    col_backward = common._ColProduct.backward

    def col_bwd(ctx, g):
        n = _COUNT["col_bwd"]
        _COUNT["col_bwd"] += 1
        if _FAULT["name"] != "col_grad_unsummed" or n != COL_K:
            return col_backward(ctx, g)
        all_reduce = collectives.all_reduce_model
        collectives.all_reduce_model = lambda x, group, op="sum": x
        try:
            return col_backward(ctx, g)
        finally:
            collectives.all_reduce_model = all_reduce
    common._ColProduct.backward = staticmethod(col_bwd)

    combine = collectives.combine_softmax

    def combine_softmax(o, lse, group):
        n = _COUNT["combine"]
        _COUNT["combine"] += 1
        if _FAULT["name"] == "slots_dropped" and n == COMBINE_K \
                and model_rank() == dist.get_world_size(group) - 1:
            lse = torch.full_like(lse, -float("inf"))
        return combine(o, lse, group)
    collectives.combine_softmax = combine_softmax

    combine_partial = ffn.combine_partial

    def moe_partial(*a, **k):
        n = _COUNT["moe_partial"]
        _COUNT["moe_partial"] += 1
        out = combine_partial(*a, **k)
        if _FAULT["name"] == "moe_partial_dropped" \
                and n in _FAULT["moe_calls"] and model_rank() == 1:
            out = out * 0
        return out
    ffn.combine_partial = moe_partial

    def summed_losses(route):
        def wrapped(*a, **k):
            out = route(*a, **k)
            g = dctx.model_group()
            if _FAULT["name"] != "moe_aux_grad_summed" or g is None:
                return out
            aux, z = (collectives.copy_to_model(t, g) for t in out[2:4])
            return out[:2] + (aux, z) + out[4:]
        return wrapped
    ffn.route_over = summed_losses(ffn.route_over)

    data_groups = dctx.data_groups

    def groups():
        if _FAULT["name"] == "moe_routing_local":
            return []
        return data_groups()
    dctx.data_groups = groups

    def counted(make):
        def make_step(*a, **k):
            step = make(*a, **k)

            def one(*args, **kw):
                _reset()
                out = step(*args, **kw)
                if dctx.model_group() is not None:
                    _MESH_COUNT.update(_COUNT)
                return out
            return one
        return make_step
    trainer.make_train_step = counted(trainer.make_train_step)
    engine.make_serve_step = counted(engine.make_serve_step)


def _smoke_sizes():
    """The dry run's sizes: the smoke configs, 2 x 64 tokens (and no
    card to wait for)."""
    from repro_torch.configs import base
    base.load_config = base.load_smoke_config
    torch.cuda.synchronize = lambda *a, **k: None
    C.TRAIN_SEQ, C.PROMPT, C.TP_DECODE_STEPS = 64, 32, 2
    C.SHARDED_ATTN, C.SHARDED_SCAN = (2, 4, 2, 64, 16), (64, 32)
    C.TP_TRAIN = ("qwen3-4b", 2)
    C.MESH_RUNS = [("smollm", "smollm-360m", None, {})]
    C.MOE_TP_SERVE = [("bf16", None, torch.bfloat16),
                      ("f32", 1, torch.float32)]


def phase13_rank(mesh, p):
    """Phase 13's bfloat16 runs (``MESH_RUNS`` but the float32 one)."""
    if p["cpu_smoke"]:
        _smoke_sizes()
    C.MESH_RUNS = [r for r in C.MESH_RUNS if "compute_dtype" not in r[3]]
    out = C.phase13_rank(mesh, p)
    out["runs"] = C.MESH_RUNS
    return out


def train_rank(mesh, p):
    """Phase 14 (a)'s bfloat16 run, sound and with each training fault."""
    _install(p)
    device = torch.device(p["device"])
    out = {}
    for fault in TRAIN_FAULTS:
        _FAULT.update(name=fault, row_k=ROW_K)
        out[str(fault)] = C.tp_train(device, {"grad_accum": 1})
        out[str(fault)]["counts"] = dict(_MESH_COUNT)
    _FAULT["name"] = None
    return out


def moe_train_rank(mesh, p):
    """Phase 14 (d)'s bfloat16 run, sound and with each MoE fault (the
    first MoE layer's forward and, under remat, its recompute: calls 0
    and 2 L - 1 a step)."""
    _install(p)
    device = torch.device(p["device"])
    layers = C.MOE_TP_LAYERS
    out = {}
    for fault in MOE_TRAIN_FAULTS:
        _FAULT.update(name=fault, moe_calls=(0, 2 * layers - 1))
        out[str(fault)] = C.moe_tp_train(device, layers, {"grad_accum": 1})
        out[str(fault)]["counts"] = dict(_MESH_COUNT)
    _FAULT["name"] = None
    return out


def moe_serve_rank(mesh, p):
    """Phase 14 (e)'s serves, sound and with the dropped partial sum (the
    first MoE layer of the prefill and of every decode step)."""
    _install(p)
    device = torch.device(p["device"])
    out = {}
    for label, layers, dtype in C.MOE_TP_SERVE:
        for fault in MOE_SERVE_FAULTS:
            _FAULT.update(name=fault, moe_calls=(0,))
            rec = C.tp_serve(device, p["moe_serve"][label], C.MOE_TP,
                             layers, dtype, C.MOE_TP_SEED)
            out[label, str(fault)] = {"logits": rec["logits"],
                                      "counts": dict(_MESH_COUNT)}
            C._free(device)
    _FAULT["name"] = None
    return out


def moe_readings(p, device, out) -> None:
    """(d) and (e)'s readings into ``out``."""
    from repro_torch.configs import base
    from repro_torch.distributed.spawn import run_ranks

    dev = p["device"]
    ranks = run_ranks(moe_train_rank, 4, p, backend="gloo", device=dev,
                      timeout_s=TIMEOUT_S)
    run = C.mesh_run(C.MOE_TP, C.MOE_TP_LAYERS, {"grad_accum": 1})
    for fault in MOE_TRAIN_FAULTS:
        head = ranks[0][str(fault)]
        gaps = {**C.train_gaps(head, head["whole"], run)[0],
                "drop_gap": C._drop_gap(head["drops"],
                                        head["whole"]["drops"]),
                "router_grad_gap": head["whole"]["router_grad_gap"],
                "drops": head["drops"],
                "drops_one_process": head["whole"]["drops"],
                "counts": head["counts"],
                "ranks_agree": all(r[str(fault)]["losses"] == head["losses"]
                                   for r in ranks)}
        key = ("sound", "moe_train") if fault is None \
            else ("planted", f"moe_train_{fault}")
        out[key[0]][key[1]] = gaps

    refs = {label: C.tp_serve_reference(device, C.MOE_TP, layers, dtype,
                                        C.MOE_TP_SEED)
            for label, layers, dtype in C.MOE_TP_SERVE}
    V = base.load_config(C.MOE_TP).model.vocab_size
    ranks = run_ranks(moe_serve_rank, 4, {**p, "moe_serve": {
        k: {"prompts": v["prompts"], "fed": v["fed"]}
        for k, v in refs.items()}}, backend="gloo", device=dev,
        timeout_s=TIMEOUT_S)
    for label, _, _ in C.MOE_TP_SERVE:
        for fault in MOE_SERVE_FAULTS:
            rec = ranks[0][label, str(fault)]
            rel, flips, fails = C.logit_gaps(rec["logits"],
                                             refs[label]["logits"], V)
            key = ("sound", f"moe_serve_{label}") if fault is None \
                else ("planted", f"moe_serve_{label}_{fault}")
            out[key[0]][key[1]] = {
                "rel_l2_by_step": rel, "max": max(rel), "flips": flips,
                "not_near_tie": [f for f in fails if "near tie" in f],
                "counts": rec["counts"]}


def serve_rank(mesh, p):
    """Phase 14 (b), sound and with each serving fault."""
    _install(p)
    device = torch.device(p["device"])
    out = {}
    for fault in SERVE_FAULTS:
        _FAULT.update(name=fault, row_k=SERVE_ROW_K)
        rec = C.tp_serve(device, p)
        out[str(fault)] = {"logits": rec["logits"],
                           "counts": dict(_MESH_COUNT)}
    _FAULT["name"] = None
    return out


def main() -> int:
    from repro_torch.configs import base
    from repro_torch.distributed.spawn import run_ranks

    smoke = "--cpu-smoke" in sys.argv[1:]
    if smoke:
        _smoke_sizes()
        torch.set_num_threads(1)
        dev = "cpu"
    elif not torch.cuda.is_available():
        print("torch_tp_gate_readings: no CUDA device", file=sys.stderr)
        return 2
    else:
        dev = "cuda:0"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        C.build_kernels()
    device = torch.device(dev)
    p = {"device": dev, "cpu_smoke": smoke}
    out = {"card": None if smoke else C.card_name_and_limit(),
           "sound": {}, "planted": {}}
    moe_readings(p, device, out)
    if "--moe-only" in sys.argv[1:]:
        print(json.dumps(out), flush=True)
        return 0

    ranks = run_ranks(phase13_rank, 4, p, backend="gloo", device=dev,
                      timeout_s=TIMEOUT_S)
    for label, arch, layers, overrides in ranks[0]["runs"]:
        head = ranks[0][label]
        out["sound"][label] = C.train_gaps(
            head, head["split"], C.mesh_run(arch, layers, overrides))[0]

    ranks = run_ranks(train_rank, 4, p, backend="gloo", device=dev,
                      timeout_s=TIMEOUT_S)
    run = C.mesh_run(*C.TP_TRAIN, {"grad_accum": 1})
    for fault in TRAIN_FAULTS:
        head = ranks[0][str(fault)]
        gaps = {**C.train_gaps(head, head["split"], run)[0],
                "counts": head["counts"],
                "ranks_agree": all(r[str(fault)]["losses"] == head["losses"]
                                   for r in ranks)}
        key = ("sound", "qwen3_4layers") if fault is None \
            else ("planted", f"train_{fault}")
        out[key[0]][key[1]] = gaps

    ref = C.tp_serve_reference(device)
    V = base.load_config(C.TP_SERVE).model.vocab_size
    ranks = run_ranks(serve_rank, 4, {**p, "prompts": ref["prompts"],
                                      "fed": ref["fed"]},
                      backend="gloo", device=dev, timeout_s=TIMEOUT_S)
    for fault in SERVE_FAULTS:
        rec = ranks[0][str(fault)]
        rel, flips, _ = C.logit_gaps(rec["logits"], ref["logits"], V)
        key = ("sound", "serve") if fault is None \
            else ("planted", f"serve_{fault}")
        out[key[0]][key[1]] = {"rel_l2_by_step": rel, "max": max(rel),
                               "flips": flips, "counts": rec["counts"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

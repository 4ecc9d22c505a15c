"""repro_torch's dry-run (``launch/dryrun.py``, ``launch/hlo_analysis.py``):
cells run under ``FakeTensorMode`` on a fake process group in this
process, torn down after the module.

* The counterpart of the JAX package's ``test_dryrun_cell_small_mesh``
  (which fails under jax 0.9): a smoke Yi-9B train cell on an 8-rank
  (4, 2) ``("data", "model")`` mesh, with the reference's record keys.
* The FLOPs counted against the analytic count.  ``FlopCounterMode``
  counts the matrix products and the kernels' own formulas
  (``kernels/ops.py``), nothing elementwise, so for a dense model the
  count is exactly: every layer's projections and MLP, 2 FLOPs a
  multiply-add a token, four times (the forward, remat's recompute of
  each pattern group, and the backward's two products a weight), less
  each group's last down-projection once (the recompute stops at the
  last tensor the backward saved, ``torch.utils.checkpoint``'s early
  stop: that product's output is not one; split over the model axis it
  is an autograd Function and runs before the stop), the head's four times
  (each ``chunked_xent`` chunk is recomputed), and attention's 4 FLOPs a
  kept (query, key) pair a head dim twice (forward, recompute) plus the
  backward's 10.  Tokens are the rank's:
  the batch over the data axes; the model axis divides each product whose
  split dim (heads, KV heads, ff, vocab) it divides, as the rank computes
  on its shard (``dense_train_flops(model=)``).  The band is therefore
  zero wide: rtol 1e-12, for float summation.
* One full-width cell, SmolLM-360M train_4k on the (16, 16) mesh, held
  the same way, its argument bytes to ``launch.shardings``'.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist                              # noqa: E402

from repro_torch.configs import shapes                        # noqa: E402
from repro_torch.configs.base import load_config, load_smoke_config  # noqa
from repro_torch.kernels.ops import attended_pairs            # noqa: E402
from repro_torch.launch import dryrun                         # noqa: E402
from repro_torch.models import backbone                       # noqa: E402

JAX_KEYS = {"arch", "shape", "mesh", "devices", "status", "seq_parallel",
            "lower_s", "compile_s", "total_s", "memory", "flops_per_device",
            "bytes_per_device", "collective_per_chip_bytes",
            "collective_by_kind", "collective_count",
            "raw_flops_per_device_scan_once",
            "bytes_per_device_incl_vmem_intermediates", "t_compute",
            "t_memory", "t_collective", "params_total", "params_active",
            "dominant", "model_flops", "useful_flops_ratio",
            "roofline_fraction"}


@pytest.fixture(scope="module", autouse=True)
def teardown_group():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def dense_train_flops(cfg, tokens_per_seq: int, seqs: int,
                      model: int = 1) -> float:
    """The analytic FLOPs of a dense model's remat'd train step on
    ``seqs`` sequences (module docstring), on one rank of a ``model``-wide
    tensor-parallel axis: each product whose split dim (heads, KV heads,
    ff, vocab) ``model`` divides runs on the rank's share of it."""
    assert cfg.family == "dense" and cfg.first_dense_layers == 0
    D, H, Kh, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    Vp = backbone.padded_vocab(cfg)

    def split(n):
        return n // model if n % model == 0 else n

    Hl = split(H)
    # KV heads split only where they divide; else each rank projects all
    Khl = split(Kh) if Hl < H else Kh
    Fl = split(F)
    gemm = D * Hl * Dh + 2 * D * Khl * Dh + Hl * Dh * D \
        + (3 if cfg.mlp_gated else 2) * D * Fl
    head = D * split(Vp)
    T = tokens_per_seq * seqs
    # one layer a pattern group; its recompute skips the last product,
    # unless the model axis splits it: a row-parallel product
    # (``common.row_matmul``) is an autograd Function, whose forward runs
    # whole before its saved tensors pack, so the early stop comes after
    skipped = 0 if Fl < F else cfg.num_layers * Fl * D
    gemms = 2 * T * (4 * (cfg.num_layers * gemm + head) - skipped)
    pairs = attended_pairs(tokens_per_seq, tokens_per_seq, cfg.causal,
                           cfg.attn_window)
    attn = cfg.num_layers * (2 * 4 + 10) * seqs * Hl * Dh * pairs
    return float(gemms + attn)


def test_dryrun_cell_small_mesh():
    run = load_smoke_config("yi-9b")
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, grad_accum=1))
    shape = shapes.ShapeSpec("t", 64, 8, "train")
    rec = dryrun.run_cell("yi-9b", "t", "4x2", run=run, shape=shape)
    assert rec["status"] == "ok"
    assert JAX_KEYS <= set(rec)
    assert rec["devices"] == 8
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["peak_bytes_estimate"] >= \
        rec["memory"]["argument_size_in_bytes"]
    assert rec["model_flops"] == 6 * rec["params_active"] * 8 * 64
    # 8 sequences over 4 data ranks: 2 a rank; the model axis of 2 splits
    # the heads, KV heads, ff and vocab
    want = dense_train_flops(run.model, 64, 2, model=2)
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-12)
    # FSDP: parameters gathered, gradients reduce-scattered
    assert rec["collective_by_kind"]["all-gather"] > 0
    assert rec["collective_by_kind"]["reduce-scatter"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline_fraction"] <= 1


def test_dryrun_skips_what_applicable_skips():
    """The cells ``applicable`` refuses are recorded as skipped with its
    reason, and run nothing."""
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", "4x2")
    assert rec["status"] == "skipped"
    assert rec["reason"] == shapes.applicable(
        load_config("hubert-xlarge").model, shapes.SHAPES["decode_32k"])[1]


def test_full_width_cell_on_the_production_mesh():
    """SmolLM-360M train_4k on the (16, 16) mesh at full width: 256
    sequences over 16 data ranks, 16 a rank; its 15 heads and 5 KV heads
    stay whole on the model axis of 16, its ff and vocab split."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch import shardings

    rec = dryrun.run_cell("smollm-360m", "train_4k", "single")
    assert rec["status"] == "ok" and rec["devices"] == 256
    cfg = load_config("smollm-360m").model
    want = dense_train_flops(cfg, 4096, 16, model=16)
    assert rec["flops_per_device"] == pytest.approx(want, rel=1e-12)
    run = load_config("smollm-360m")
    mesh = dryrun.fake_mesh("single")
    with dctx.mesh_context(mesh, sharding.make_rules(fsdp=True)):
        args = shardings.argument_bytes(
            shardings.train_state_sds(run, mesh),
            shardings.batch_sds(run, shapes.SHAPES["train_4k"], mesh),
            shardings.rng_sds(mesh))
    assert rec["memory"]["argument_size_in_bytes"] == args


def test_seq_parallel_cell():
    """The ``--seq-parallel`` rules on a smoke Qwen3 train cell: the record
    says so, the FLOPs are the default rules' (the same products), and the
    residual stream's rows move by reduce-scatter and all-gather where the
    default rules all-reduce."""
    run = load_smoke_config("qwen3-4b")
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, grad_accum=1))
    shape = shapes.ShapeSpec("t", 64, 8, "train")
    base = dryrun.run_cell("qwen3-4b", "t", "4x2", run=run, shape=shape)
    sp = dryrun.run_cell("qwen3-4b", "t", "4x2", run=run, shape=shape,
                         seq_parallel=True)
    assert base["seq_parallel"] is False and sp["seq_parallel"] is True
    assert sp["flops_per_device"] == base["flops_per_device"]
    kinds = sp["collective_by_kind"]
    assert kinds["reduce-scatter"] > base["collective_by_kind"][
        "reduce-scatter"]
    assert kinds.get("all-reduce", 0) < base["collective_by_kind"][
        "all-reduce"]

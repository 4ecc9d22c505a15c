#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

It builds the port's three CUDA kernels from this checkout's sources
(``thinning_rmw``, ``decay_scan``, ``flash_attention``: one ``nvcc`` each
for ``sm_90a``, all started together, into ``build/``), checks with
``cuobjdump`` that the bfloat16 attention kernel holds ``HGMMA``
(tensor-core) instructions, then runs seven phases; any failure raises
and the script exits non-zero.

1. Kernel: ``thinning_rmw`` on the card against its plain PyTorch
   version on the CPU (which the CPU tests hold bitwise to the JAX
   reference), bitwise, over B x T x policy: the rows entry on all 9
   outputs; the keyed entry over an 800,000-row table in both modes
   (decision only: z, p, lam, features; write-back: those and the whole
   state after the in-place update), keys repeating (decision) or distinct
   (write-back, with empty slots and a valid event on the padding key 0),
   never-persisted and NaN times, an RNG entity at or above 2^31 on half
   the cases.  Then the kernel's and the plain versions' times on the card
   at the engine's block shapes, beside the bound.
2. Stream: ``run_stream`` on the card at the paper's iiot key count
   (800,000 keys, 2,000,000 events, six decay windows, write budget
   Lambda*h = 0.1), fast mode at batch 4096: dense ``pp``, then ``pp`` and
   ``pp_vr`` through a 4-partition write-behind sink.  The keyed kernel's
   launch count must equal the block count of each run, and neither the
   plain uniforms nor the plain row gather may run on a CUDA tensor.
3. Parity: exact mode (one keyed write-back launch per chunk) on a
   262,144-event prefix on the card and on the CPU (decisions, state and
   sink bytes identical); two fast-mode runs on the card (identical
   state); one fast block from a shared state on the card and on the CPU
   (identical decisions, state within 1e-5 relative).
4. Kernels of the serving path: ``decay_scan`` on the card bitwise against
   its plain loop on the card over T x C x (with, without h0);
   ``flash_attention`` against its plain version on the card over MHA,
   GQA, MQA, causal, window, softcap, non-causal and ragged shapes and the
   serving shapes at batch 1 and 2, in float32 (rtol = atol = 2e-4, the JAX
   suite's) and bfloat16 (``|got - want| <= 2^-6 |want| + 2^-7 m``, with
   m the largest ``|want|`` of the same query row: two bfloat16 ulps of
   each value, plus a floor tied to the row's scale, since a window of
   2048 keys averages random values down to a few hundredths while a
   row with one key keeps them whole); then each kernel's, its plain
   version's and (attention only) PyTorch's
   ``scaled_dot_product_attention``'s times at the serving shapes.
5. Serving: ``recurrentgemma-2b`` at full width and depth (2,894,574,080
   parameters, bfloat16, seeded random weights on the card) serves 2
   requests at batch 2: a 4096-token prompt (twice the window, so the
   window mask and the ring cache's wrap both run), then 32 greedy decode
   steps.  One warm-up request runs first (the process's first prefill
   pays for allocator growth and cuBLAS's first calls; its time is
   printed as ``cold_prefill_s``), so the tokens/s are the warm rates.
   The prefill must launch ``decay_scan`` 18 times and
   ``flash_attention`` 8 times; every logit must be finite; parameters and
   caches must stay on the card; each step's logits must agree with a
   teacher-forced forward over prompt + fed tokens, to a relative L2 error
   of at most 0.1.  The two paths round in bfloat16 at other places (the
   conv as four shifted adds against one einsum, one-token projections
   against whole-prompt GEMMs), and the difference grows with depth; the
   JAX reference's own bfloat16 decode and forward differ the same way.
   A wrong position, mask or state gives an error of order 1.
6. Card against CPU at full width: one ``rec`` and one ``attn`` block in
   float32 at S = 2304 (> window), the card with its kernels against the
   CPU with the plain versions, normwise (max abs difference over max
   abs value) within 1e-4 for ``attn`` (float32 sums in another order)
   and 1e-3 for ``rec``, whose input ``sqrt(1 - a^2)`` cancels near
   a = 1 and amplifies the one-ulp differences of the card's and the
   CPU's ``exp``.

7. Scoring (it runs after phase 3, on phase 2's stream): the paper's
   pipeline through ``serving.pipeline.ScoringPipeline`` at full size
   (``ProfileSpec()``'s six windows, ``kde_bandwidth=3600``, Lambda*h =
   0.1, ``pp``, fast mode, batch 4096, flush groups of 4 blocks, a
   seeded scorer of hidden width 64 scoring all 2,000,000 events):
   (a) dense with a memory sink; (b) a resident set of 100,000 slots
   (12.5 % of the keys), serial; (c) the same at ``pipeline_depth=2``;
   (b) must equal (a) and (c) must equal (b) bitwise in decisions,
   features, scores and store bytes, with evictions and rehydrations in
   the run; (d) ``run_restart_demo`` on the durable backend with the same
   budget: the scores recovered from the reopened stores must equal the
   live ones bitwise over every key the stream touched; (e) the per-event
   ``FeatureWorker`` on the card over the first 16,384 events, exact
   mode: its store bytes must equal an exact ``run_stream`` + sink's, with
   one rows-entry launch an event and no uniform drawn on the card.  The
   keyed kernel must launch once per block in (a)-(c).

After phase 6 the ``scaled_dot_product_attention`` call of phase 4 is
timed under each backend that accepts its boolean mask, and the backend
its default dispatch picked is named (matched by the kernels it
launches).

Earlier lines print JSON records; the line before the last is the kernel
table, the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

POLICIES = ("pp", "pp_vr", "full", "fixed", "unfiltered")
N_KEYS, N_EVENTS, BATCH = 800_000, 2_000_000, 4096
PREFIX, EXACT_BATCH = 262_144, 1024
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
ARCH = "recurrentgemma-2b"
N_PARAMS = 2_894_574_080
SERVE_BATCH, PROMPT, NEW_TOKENS = 2, 4096, 32
SCAN_T, SCAN_C = (1, 7, 256, 4096), (1, 100, 2560, 5120)
# (B, H, Kh, Sq, Skv, D, causal, window, softcap)
ATTN_CASES = [(2, 4, 4, 64, 64, 32, True, 0, 0.0),       # MHA
              (2, 4, 2, 64, 64, 64, True, 32, 0.0),      # GQA, window
              (1, 8, 1, 128, 128, 64, True, 0, 20.0),    # MQA, softcap
              (2, 4, 2, 96, 96, 64, False, 0, 0.0),      # ragged, non-causal
              (2, 4, 2, 96, 160, 64, True, 48, 0.0),     # Sq < Skv
              (1, 10, 1, 300, 300, 256, True, 0, 0.0),   # D 256, ragged
              (2, 10, 1, 1000, 1000, 256, True, 256, 30.0),
              (1, 10, 1, 4096, 4096, 256, True, 2048, 0.0),   # serving,
              (2, 10, 1, 4096, 4096, 256, True, 2048, 0.0)]   # batch 1, 2
F32_TOL = 2e-4                         # rtol = atol
BF16_RTOL, BF16_FLOOR = 2.0 ** -6, 2.0 ** -7   # of |want|, of its row's max
DECODE_REL_L2 = 0.1
BLOCK_TOL = {"rec": 1e-3, "attn": 1e-4}
BLOCK_S = 2304
N_SLOTS, SINK_GROUP, SCORER_HIDDEN = 100_000, 4, 64
WORKER_EVENTS = 16_384


def check(ok: bool, what: str) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def emit(**record):
    print(json.dumps(record), flush=True)


def trmw_inputs(rng, B, T):
    """The JAX suite's ``_trmw_inputs`` recipe (tests/test_kernels.py):
    fresh and warm rows for the persisted and the control columns."""
    f32 = lambda x: np.asarray(x, np.float32)
    taus = f32(np.geomspace(60, 86400, T))
    fresh = rng.random(B) < 0.3
    last_t = f32(np.where(fresh, -1e38, rng.uniform(0, 1e4, B)))
    v_f = f32(np.where(fresh, 0, rng.uniform(0, 50, B)))
    agg = f32(rng.uniform(0, 10, (B, 3 * T))) * (~fresh[:, None])
    q = f32(rng.lognormal(3, 1, B))
    t = f32(rng.uniform(1e4, 2e4, B))
    u = f32(rng.random(B))
    valid = f32(rng.random(B) < 0.9)
    fresh_full = fresh & (rng.random(B) < 0.5)
    last_t_full = f32(np.where(fresh_full, -1e38, rng.uniform(0, 1.2e4, B)))
    v_full = f32(np.where(fresh_full, 0, rng.uniform(0, 80, B)))
    return taus, last_t, v_f, agg, q, t, u, valid, v_full, last_t_full


def trmw_kw(policy, T):
    return dict(h=3600.0, budget=0.001, alpha=1.5, policy=policy,
                fixed_rate=0.3, mu_tau_index=min(2, T - 1))


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu().double(), b.cpu().double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float((a - b).abs()[~same].max()) if bool((~same).any()) else 0.0


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, per_graph: int, replays: int) -> float:
    """Device milliseconds per call with host launch overhead removed:
    ``per_graph`` calls captured in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, replays) / per_graph


def trmw_bytes(B, T):
    """Bytes the fused pass must move: each input read once (8 per-row
    floats, the [3T] row, taus), each output written once (6 per-row
    floats, the [3T] row, the [4T] features, the z byte)."""
    return B * ((8 + 3 * T) * 4 + (6 + 7 * T) * 4 + 1) + T * 4


def trmw_ops(B, T, policy):
    """Float32 operations of the kernel's op sequence: ~27 per det_exp,
    ~37 per tau's decay and moments (one det_exp), ~6 per tau for the
    features and the update, ~30 per row for intensity and decision,
    two det_exps for the KDE decays, ~64 more for pp_vr's tilt."""
    per_row = 43 * T + 2 * 27 + 30 + (64 if policy == "pp_vr" else 0)
    return B * per_row


THREEFRY_OPS = 3 * 79 + 4   # 32-bit integer operations of one uniform


def keyed_bytes(B, T, separate_ent):
    """Bytes the keyed decision pass must move: each event's key (8), q,
    t (4 each), valid (1), its row ((4 + 3T) floats) and, when it is not
    the key, its RNG entity (8) read once; z (1), p, lam (4 each) and the
    4T features written once; taus."""
    per_event = 8 + 4 + 4 + 1 + 4 * (4 + 3 * T) + (8 if separate_ent else 0)
    return B * (per_event + 1 + 4 + 4 + 16 * T) + 4 * T


def keyed_ops(B, T, policy):
    """The fused pass's float32 operations plus the threefry uniform's
    32-bit integer ones (three 20-round blocks of 79, and 4 to make the
    float), both counted at the float32 rate."""
    return trmw_ops(B, T, policy) + B * THREEFRY_OPS


def bound(nbytes, ops):
    """(bound_ms, bound_by) against the card's memory and float32 rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sass_counts(lib_path, kernel: str, opcodes) -> dict:
    """How many times each SASS opcode occurs in the built library's
    functions whose name contains ``kernel`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = dict.fromkeys(opcodes, 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in opcodes:
                counts[op] += f" {op}." in line or f" {op} " in line
    return counts


def build_kernels():
    """Start one nvcc per kernel source, all together; check that the
    bfloat16 attention kernel runs its products on the tensor cores."""
    from repro_torch.kernels import _build, decay_scan, flash_attention
    from repro_torch.kernels import thinning_rmw as trmw

    kernels = (trmw.KERNEL, decay_scan.KERNEL, flash_attention.KERNEL)
    t0 = time.perf_counter()
    _build.build_all(kernels)
    wall = time.perf_counter() - t0
    sass = sass_counts(flash_attention.KERNEL.library_path(),
                       "flash_attention_tc", ("HGMMA", "HMMA"))
    check(sass["HGMMA"] > 0, f"no HGMMA in the bf16 attention kernel: {sass}")
    emit(build={"wall_s": wall, "kernels": {
        k.name: {"seconds": k.build_seconds,
                 "ptxas": [ln.strip() for ln in k.build_log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "C7512" in ln]}
        for k in kernels}, "flash_attention_tc_sass": sass})


def keyed_table(rng, N, T):
    """A profile table as host tensors: never-persisted rows (-inf) and
    NaN times in both time columns."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    fresh = rng.random(N) < 0.3
    last_t = np.where(fresh, -np.inf, rng.uniform(0, 1e4, N))
    last_t[(rng.random(N) < 0.05) & ~fresh] = np.nan
    last_t_full = np.where(fresh & (rng.random(N) < 0.5), -np.inf,
                           rng.uniform(0, 1.2e4, N))
    last_t_full[rng.random(N) < 0.05] = np.nan
    return (f32(last_t), f32(np.where(fresh, 0, rng.uniform(0, 50, N))),
            f32(rng.uniform(0, 10, (N, T, 3)) * ~fresh[:, None, None]),
            f32(rng.uniform(0, 80, N)), f32(last_t_full))


def keyed_events(rng, N, B, distinct, big_ent):
    """B events on an N-row table (host tensors): keys repeat, or are
    distinct on the valid events (invalid ones on key 0, and one valid
    event on key 0 too); N - 1 is always among them."""
    valid = rng.random(B) < 0.9
    if distinct:
        key = rng.choice(np.arange(1, N - 1), B, replace=False)
        key[~valid] = 0
        valid[B // 2] = True
        key[B // 2] = 0
    else:
        key = rng.integers(0, N, B)
        key[1::7] = key[0]
    valid[0] = True
    key[0] = N - 1
    ent = rng.integers(2 ** 31, 2 ** 32, B) if big_ent else key
    lanes = rng.permutation(np.concatenate(
        [rng.permutation(B), np.full(B // 8, B)]))
    i64 = lambda x: torch.tensor(np.asarray(x, np.int64))
    return (i64(key), i64(ent), torch.tensor(rng.lognormal(3, 1, B),
                                             dtype=torch.float32),
            torch.tensor(rng.uniform(1e4, 2e4, B), dtype=torch.float32),
            torch.tensor(valid), i64(lanes))


def keyed_case(table, taus, events, write_back, policy, T):
    """One keyed pass on the device that ``table`` and ``taus`` lie on
    (over a copy of the table with write-back); returns the outputs and
    (with write-back) the state, on the CPU."""
    from repro_torch.core import ProfileState
    from repro_torch.kernels import ops

    device = taus.device
    key, ent, q, t, valid, lanes = (x.to(device) for x in events)
    B = key.shape[0]
    state = ProfileState(*(x.clone() if write_back else x for x in table))
    out = None
    if write_back:
        out = (torch.zeros(B, dtype=torch.bool, device=device),
               torch.full((B,), -1.0, device=device),
               torch.full((B, 4 * T), -1.0, device=device),
               torch.full((B,), -1.0, device=device))
    got = ops.thinning_rmw_keyed(
        taus, state, key, q, t, valid, (3, 0xDEADBEEF), ent,
        write_back=write_back, lanes=lanes if write_back else None, out=out,
        **trmw_kw(policy, T))
    return [x.cpu() for x in got] + ([x.cpu() for x in state]
                                     if write_back else [])


def keyed_times(device, B, T=6, policy="pp"):
    """The keyed kernel's times at block size B over the 800,000-row table:
    decision only (the fast step's launch) and write-back of a 256-row
    chunk (the exact step's), with the plain version's and the bound."""
    from repro_torch.core import ProfileState
    from repro_torch.kernels import ref
    from repro_torch.kernels import thinning_rmw as trmw

    rng = np.random.default_rng([B, T])
    state = ProfileState(*(x.to(device) for x in keyed_table(rng, N_KEYS,
                                                             T)))
    taus = torch.tensor(np.geomspace(60, 86400, T), dtype=torch.float32,
                        device=device)
    key, _, q, t, valid, _ = (x.to(device) for x in keyed_events(
        rng, N_KEYS, B, False, False))
    kw = trmw_kw(policy, T)
    args = (taus, state, key, q, t, valid, (0, 7))
    kernel = lambda: trmw.thinning_rmw_keyed_cuda(*args, **kw)
    plain = lambda: ref.thinning_rmw_keyed_ref(*args, **kw)
    bound_ms, bound_by = bound(keyed_bytes(B, T, False),
                               keyed_ops(B, T, policy))
    rec = {"ms": graph_ms(kernel, 100, 20),
           "wrapper_ms": cuda_ms(kernel, 500), "plain_ms": cuda_ms(plain, 20),
           "bound_ms": bound_ms, "bound_by": bound_by}
    # one exact-mode chunk: 256 lanes over B distinct-key events
    key, _, q, t, valid, lanes = (x.to(device) for x in keyed_events(
        rng, N_KEYS, B, True, False))
    lanes = lanes[:256]
    out = (torch.zeros(B, dtype=torch.bool, device=device),
           *(torch.zeros(s, device=device) for s in ((B,), (B, 4 * T), (B,))))
    chunk = lambda: trmw.thinning_rmw_keyed_cuda(
        taus, state, key, q, t, valid, (0, 7), write_back=True, lanes=lanes,
        out=out, **kw)
    chunk()
    slots = lanes[lanes < B]
    n_active = int(valid[slots].sum())
    n_z = int(out[0][slots].sum())
    # reads: the lane index and the active events' inputs and rows;
    # writes: their decisions, control columns, and the z rows' columns
    nbytes = (8 * lanes.shape[0] + n_active * (
        8 + 4 + 4 + 1 + 4 * (4 + 3 * T) + 1 + 4 + 4 + 16 * T + 8)
        + n_z * 4 * (2 + 3 * T) + 4 * T)
    rec["write_back_chunk256_ms"] = graph_ms(chunk, 100, 20)
    rec["write_back_chunk256_bound_ms"], _ = bound(
        nbytes, keyed_ops(lanes.shape[0], T, policy))
    rec["write_back_chunk256_rows"] = {"active": n_active, "z": n_z}
    return rec


def keyed_shape():
    """The keyed kernel's tau-parallel shape: the plain constants of its
    source (lanes per row, rows per block)."""
    from repro_torch.kernels import thinning_rmw as trmw

    src = trmw.KERNEL.source.read_text()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    return {"lanes_per_row": const("kLanes"),
            "rows_per_block": const("kRowsPerBlock")}


def phase_kernel(device):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import thinning_rmw as trmw

    worst, cases = 0.0, 0
    for B in (1, 100, 256, 4096, 65536):
        for T in (2, 3, 6):
            for policy in POLICIES:
                args = trmw_inputs(np.random.default_rng(
                    [B, T, POLICIES.index(policy)]), B, T)
                want = ops.thinning_rmw(*(torch.tensor(a) for a in args),
                                        **trmw_kw(policy, T))
                got = ops.thinning_rmw(
                    *(torch.tensor(a, device=device) for a in args),
                    **trmw_kw(policy, T))
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    worst = max(worst, max_abs_err(g, w))
                    check(bitwise_equal(g, w),
                          f"kernel != plain at B={B} T={T} {policy}: "
                          f"max abs err {max_abs_err(g, w)}")
                cases += 1
    emit(kernel_grid={"cases": cases, "bitwise_vs_plain_cpu": True,
                      "max_abs_err": worst})

    keyed_cases, launched = 0, trmw.keyed_launches
    for T in (2, 3, 6):
        table = keyed_table(np.random.default_rng(T), N_KEYS, T)
        taus = torch.tensor(np.geomspace(60, 86400, T), dtype=torch.float32)
        card = ([x.to(device) for x in table], taus.to(device))
        for B in (1, 100, 256, 4096, 65536):
            for policy in POLICIES:
                for write_back in (False, True):
                    events = keyed_events(np.random.default_rng(
                        [B, T, POLICIES.index(policy), write_back]), N_KEYS,
                        B, write_back, keyed_cases % 2 == 1)
                    args = (events, write_back, policy, T)
                    got = keyed_case(*card, *args)
                    want = keyed_case(table, taus, *args)
                    for g, w in zip(got, want):
                        check(bitwise_equal(g, w),
                              f"keyed kernel != plain at B={B} T={T} "
                              f"{policy} write_back={write_back}: max abs "
                              f"err {max_abs_err(g, w)}")
                    keyed_cases += 1
    check(trmw.keyed_launches - launched == keyed_cases,
          f"{trmw.keyed_launches - launched} keyed launches for "
          f"{keyed_cases} cases")
    emit(keyed_grid={"cases": keyed_cases, "table_rows": N_KEYS,
                     "bitwise_vs_plain_cpu": True, "max_abs_err": worst})

    times = {}
    for B in (4096, 256):
        T, policy = 6, "pp"
        args = [torch.tensor(a, device=device) for a in trmw_inputs(
            np.random.default_rng(B), B, T)]
        kw = trmw_kw(policy, T)
        kernel = lambda: trmw.thinning_rmw_cuda(*args, **kw)
        plain = lambda: ref.thinning_rmw_ref(*args, **kw)
        bound_ms, bound_by = bound(trmw_bytes(B, T), trmw_ops(B, T, policy))
        times[B] = {
            "ms": graph_ms(kernel, 100, 20),
            "wrapper_ms": cuda_ms(kernel, 500),
            "plain_ms": cuda_ms(plain, 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "keyed": keyed_times(device, B)}
    emit(kernel_times={str(B): v for B, v in times.items()},
         keyed_shape=keyed_shape())
    return worst, times


def reset_counts():
    """Zero the keyed kernel's launch count and the plain steps' CUDA
    call counts (uniforms, row gather)."""
    from repro_torch.kernels import ref, threefry
    from repro_torch.kernels import thinning_rmw as trmw

    trmw.launches = trmw.keyed_launches = 0
    threefry.cuda_calls = ref.gather_cuda_calls = 0


def check_no_plain_steps(what, rows_entry=0):
    """Fail if the plain uniforms or the plain gather ran on the card since
    ``reset_counts``, or the rows entry launched other than ``rows_entry``
    times (only the per-event worker launches it)."""
    from repro_torch.kernels import ref, threefry
    from repro_torch.kernels import thinning_rmw as trmw

    plain = {"uniform_for_events": threefry.cuda_calls,
             "gather_rows": ref.gather_cuda_calls}
    check(not any(plain.values()) and trmw.launches == rows_entry,
          f"{what} ran plain steps on the card: {plain}, rows entry "
          f"{trmw.launches} launches for {rows_entry} worker events")


def phase_stream(device, stream):
    from repro_torch.core import EngineConfig, init_state, prng_key, run_stream
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.streaming.persistence import WriteBehindSink

    n_blocks = -(-len(stream.key) // BATCH)
    runs = [("pp", None), ("pp", 4), ("pp_vr", 4)]
    reset_counts()                          # the main path starts here
    for policy, n_parts in runs:
        cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy=policy,
                           alpha=1.0 if policy == "pp_vr" else 0.0)
        state = init_state(N_KEYS, len(cfg.taus), device=device)
        sink = (WriteBehindSink(cfg, n_partitions=n_parts, device=device)
                if n_parts else None)
        before = trmw.keyed_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, writes = run_stream(cfg, state, stream.key, stream.q,
                                   stream.t, batch=BATCH, mode="fast",
                                   rng=prng_key(0), collect_info=False,
                                   sink=sink, sink_group=4)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        snap = sink.flush() if sink else None
        wall = time.perf_counter() - t0
        if sink:
            sink.close()
        launched = trmw.keyed_launches - before
        writes = int(writes.sum())
        check(launched == n_blocks,
              f"{launched} keyed kernel launches for {n_blocks} blocks")
        check(all(x.device == device for x in state), "state left the card")
        check(all(bool(torch.isfinite(x).all()) for x in
                  (state.v_f, state.agg, state.v_full)), "non-finite state")
        puts = snap["puts"] if snap else writes
        check(0 < puts < 0.5 * len(stream.key), f"{puts} puts")
        emit(stream={
            "policy": policy, "sink_partitions": n_parts,
            "events": len(stream.key), "keys": N_KEYS, "batch": BATCH,
            "blocks": n_blocks, "kernel_launches": launched,
            "writes": writes, "puts": puts,
            "puts_per_event": puts / len(stream.key),
            "events_per_s": len(stream.key) / wall, "wall_s": wall,
            "device_done_s": t_dev,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    check_no_plain_steps("the stream phase")
    return trmw.keyed_launches


def _store_bytes(sink):
    merged = {}
    for s in sink.stores:
        merged.update(s.data)
    return merged


def phase_parity(device, stream):
    from repro_torch.core import (EngineConfig, Event, init_state, make_step,
                                  prng_key, run_stream, state_from_numpy,
                                  state_to_numpy)
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.streaming.persistence import WriteBehindSink

    keys, qs, ts = (stream.key[:PREFIX], stream.q[:PREFIX],
                    stream.t[:PREFIX])
    rounds = max(int(np.bincount(keys[i:i + EXACT_BATCH]).max())
                 for i in range(0, PREFIX, EXACT_BATCH))
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp_vr",
                       alpha=1.0, exact_rounds=rounds)
    out = []
    reset_counts()
    for dev in (device, torch.device("cpu")):
        sink = WriteBehindSink(cfg, n_partitions=4, device=dev)
        t0 = time.perf_counter()
        state, info = run_stream(cfg, init_state(N_KEYS, len(cfg.taus),
                                                 device=dev),
                                 keys, qs, ts, batch=EXACT_BATCH,
                                 mode="exact", rng=prng_key(7), sink=sink)
        sink.flush()
        sink.close()
        out.append((state_to_numpy(state), [x.cpu() for x in info[:4]],
                    _store_bytes(sink), time.perf_counter() - t0,
                    int(info.writes)))
        if dev == device:
            check_no_plain_steps("exact mode")
            launched = trmw.keyed_launches
    (gs, gi, gb, gt, gw), (cs, ci, cb, ct, _) = out
    n_chunks = PREFIX // EXACT_BATCH * (-(-EXACT_BATCH // 256) + rounds)
    check(launched == n_chunks,
          f"exact mode: {launched} keyed launches for {n_chunks} chunks")
    for name, a, b in zip(("z", "p", "lam_hat", "features"), gi, ci):
        check(bitwise_equal(a, b), f"exact {name}: cuda != cpu")
    for name, a, b in zip(gs._fields, gs, cs):
        check(np.array_equal(a.view(np.uint8), b.view(np.uint8)),
              f"exact state {name}: cuda != cpu")
    check(gb == cb and len(gb) > 0, "exact sink bytes: cuda != cpu")
    emit(parity_exact={"events": PREFIX, "batch": EXACT_BATCH,
                       "exact_rounds": rounds, "policy": "pp_vr",
                       "keyed_write_back_launches": launched,
                       "writes": gw, "rows_stored": len(gb),
                       "bitwise": True, "cuda_s": gt, "cpu_s": ct})

    # fast mode: two runs on the card give identical state
    fcfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp")
    states = []
    for _ in range(2):
        st, _ = run_stream(fcfg, init_state(N_KEYS, len(fcfg.taus),
                                            device=device),
                           keys, qs, ts, batch=BATCH, mode="fast",
                           rng=prng_key(0), collect_info=False)
        states.append(st)
    for name, a, b in zip(states[0]._fields, *states):
        check(bitwise_equal(a, b), f"fast state {name}: run 1 != run 2")
    # one block from a shared start state: cuda vs cpu decisions
    host = state_to_numpy(states[0])
    sl = slice(PREFIX, PREFIX + BATCH)
    step = make_step(fcfg, "fast")
    res = []
    for dev in (device, torch.device("cpu")):
        ev = Event(key=torch.tensor(stream.key[sl], device=dev),
                   q=torch.tensor(stream.q[sl], device=dev),
                   t=torch.tensor(stream.t[sl], device=dev),
                   valid=torch.ones(BATCH, dtype=torch.bool, device=dev))
        st, info = step(state_from_numpy(*host, device=dev), ev, prng_key(0))
        res.append((st, info))
    (gst, ginf), (cst, cinf) = res
    for name in ("z", "p", "lam_hat", "features"):
        check(bitwise_equal(getattr(ginf, name), getattr(cinf, name)),
              f"fast step {name}: cuda != cpu")
    rel = max(float(((a.cpu().double() - b.double()).abs()
                     / b.double().abs().clamp_min(1e-30))[
                         torch.isfinite(b)].max())
              for a, b in zip(gst, cst))
    check(rel <= 1e-5, f"fast step state: cuda vs cpu max rel diff {rel}")
    emit(parity_fast={"events": PREFIX, "runs_identical": True,
                      "step_decisions_bitwise": True,
                      "step_state_max_rel_diff": rel})


def bitwise_same_run(a, b, what):
    """Fail unless two StepInfo-like runs agree bit for bit."""
    for name in ("z", "p", "lam_hat", "features"):
        check(bitwise_equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differs")


def phase_scoring(device, stream):
    """Phase 7: the scoring pipeline at full size — dense, resident
    (serial and pipelined), the durable restart and the worker oracle."""
    import tempfile

    from repro_torch.core import EngineConfig, init_state, prng_key, run_stream
    from repro_torch.features.spec import ProfileSpec
    from repro_torch.kernels import threefry
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.serving import pipeline
    from repro_torch.streaming.kvstore import KVStore
    from repro_torch.streaming.persistence import WriteBehindSink
    from repro_torch.streaming.residency import ResidencyMap
    from repro_torch.streaming.worker import FeatureWorker

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    n = len(stream.key)
    n_blocks = -(-n // BATCH)
    span = BATCH * SINK_GROUP
    floor = max(len(np.unique(stream.key[i:i + span]))
                for i in range(0, n, span))
    spec = ProfileSpec(kde_bandwidth=3600.0, write_budget_per_min=0.1 / 60,
                       policy="pp")
    pipe = pipeline.ScoringPipeline.build(spec, N_KEYS, mode="fast",
                                          device=device)
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(0),
                                       spec.feature_dim,
                                       hidden=SCORER_HIDDEN, device=device)
    emit(scoring_setup={"events": n, "keys": N_KEYS, "batch": BATCH,
                        "sink_group": SINK_GROUP, "slots": N_SLOTS,
                        "state_mb_resident": N_SLOTS * 22 * 4 / 1e6,
                        "capacity_floor": floor, "scorer_hidden":
                        SCORER_HIDDEN, "policy": "pp", "mode": "fast"})
    reset_counts()                          # the scoring path starts here

    def drive(step, slots=None, depth=1):
        sink = pipe.make_sink()
        rmap = ResidencyMap(N_KEYS, slots) if slots else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before = trmw.keyed_launches
        t0 = time.perf_counter()
        _, info = pipe.process_stream(
            pipe.init(residency=slots), stream.key, stream.q, stream.t,
            rng=prng_key(0), batch_per_shard=BATCH, sink=sink,
            residency=[rmap] if rmap else None, sink_group=SINK_GROUP,
            pipeline_depth=depth)
        scores = pipeline.score(pipe.scorer, info.features)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        snap = sink.flush()
        wall = time.perf_counter() - t0
        stored = _store_bytes(sink)
        sink.close()
        launched = trmw.keyed_launches - before
        check(launched == n_blocks,
              f"{step}: {launched} keyed launches for {n_blocks} blocks")
        check(scores.shape == (n,) and bool(torch.isfinite(scores).all()),
              f"{step}: scores not finite or of the wrong shape")
        rec = {"step": step, "slots": slots, "pipeline_depth": depth,
               "events": n, "blocks": n_blocks, "kernel_launches": launched,
               "writes": int(info.writes), "puts": snap["puts"],
               "puts_per_event": snap["puts"] / n,
               "durable_gets": snap["gets"],
               "gets_per_event": snap["gets"] / n,
               "events_per_s": n / wall, "wall_s": wall,
               "device_done_s": t_dev,
               "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        if rmap is not None:
            rec["residency"] = rmap.stats.snapshot()
            for k in ("host_pack_s", "device_wait_s", "overlap_s",
                      "overlap_frac", "parked_reads"):
                rec[k] = snap[k]
            check(rmap.stats.splits == 0, f"{step}: groups were split")
        emit(scoring=rec)
        return info, scores, stored, rmap

    dense, dense_scores, dense_bytes, _ = drive("a_dense")
    res, res_scores, res_bytes, rmap = drive("b_resident", N_SLOTS)
    bitwise_same_run(dense, res, "resident vs dense")
    check(bitwise_equal(dense_scores, res_scores), "resident scores differ")
    check(res_bytes == dense_bytes and len(res_bytes) > 0,
          "resident store bytes differ from dense")
    check(rmap.stats.evictions > 0 and rmap.stats.misses > N_SLOTS,
          f"the resident run did not churn: {rmap.stats.snapshot()}")
    del dense, dense_scores
    piped, piped_scores, piped_bytes, rmap2 = drive("c_pipelined", N_SLOTS,
                                                    depth=2)
    bitwise_same_run(res, piped, "depth 2 vs depth 1")
    check(bitwise_equal(res_scores, piped_scores), "depth 2 scores differ")
    check(piped_bytes == res_bytes, "depth 2 store bytes differ")
    check(rmap2.stats.snapshot() == rmap.stats.snapshot(),
          "depth 2 residency counters differ")
    del res, res_scores, piped, piped_scores

    with tempfile.TemporaryDirectory() as store_dir:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        demo = pipeline.run_restart_demo(
            spec, N_KEYS, stream.key, stream.q, stream.t, mode="fast",
            batch_per_shard=BATCH, rng=prng_key(0), residency=N_SLOTS,
            sink_group=SINK_GROUP, backend="durable",
            store_dir=os.path.join(store_dir, "stores"), device=device)
        wall = time.perf_counter() - t0
    live, recovered = demo["scores_live"], demo["scores_recovered"]
    check(live.shape == recovered.shape == (demo["keys_scored"],)
          and np.array_equal(live.view(np.uint32), recovered.view(np.uint32))
          and bool(np.isfinite(live).all()),
          "restart: recovered scores differ from the live ones")
    emit(scoring={"step": "d_restart", "backend": "durable",
                  "slots": N_SLOTS, "events": n,
                  "keys_scored": demo["keys_scored"],
                  "writes": demo["writes"], "puts": demo["sink"]["puts"],
                  "puts_per_event": demo["sink"]["puts"] / n,
                  "durable_gets": demo["sink"]["gets"],
                  "gets_per_event": demo["sink"]["gets"] / n,
                  "wall_s": wall, "recovery": demo["recovery"],
                  "recovered_bitwise": True,
                  "peak_mem_gb": torch.cuda.max_memory_allocated(device)
                  / 1e9})

    keys, qs, ts = (x[:WORKER_EVENTS] for x in (stream.key, stream.q,
                                                stream.t))
    rounds = max(int(np.bincount(keys[i:i + EXACT_BATCH]).max())
                 for i in range(0, WORKER_EVENTS, EXACT_BATCH))
    cfg = spec.engine_config(exact_rounds=rounds)
    sink = WriteBehindSink(cfg, n_partitions=4, device=device)
    run_stream(cfg, init_state(N_KEYS, len(cfg.taus), device=device), keys,
               qs, ts, batch=EXACT_BATCH, mode="exact", rng=prng_key(7),
               sink=sink)
    sink.flush()
    sink.close()
    worker = FeatureWorker(cfg, KVStore(), rng=prng_key(7), device=device)
    before = trmw.launches
    t0 = time.perf_counter()
    for k, q, t in zip(keys.tolist(), qs.tolist(), ts.tolist()):
        worker.process(k, q, t)
    wall = time.perf_counter() - t0
    rows_launches = trmw.launches - before
    check(rows_launches == WORKER_EVENTS,
          f"worker: {rows_launches} rows-entry launches for "
          f"{WORKER_EVENTS} events")
    sink_bytes = _store_bytes(sink)
    check(worker.store.data == sink_bytes and len(sink_bytes) > 0,
          "worker store bytes differ from the exact sink's")
    check(threefry.cuda_calls == 0, "the worker drew uniforms on the card")
    emit(scoring={"step": "e_worker", "events": WORKER_EVENTS,
                  "mode": "exact", "exact_rounds": rounds,
                  "rows_entry_launches": rows_launches,
                  "writes": worker.metrics.writes,
                  "rows_stored": len(sink_bytes), "bytes_equal_sink": True,
                  "events_per_s": WORKER_EVENTS / wall, "wall_s": wall})
    check_no_plain_steps("the scoring phase", rows_entry=WORKER_EVENTS)
    return {"keyed": trmw.keyed_launches, "rows_entry": rows_launches}


def window_pairs(Sq, Skv, causal, window):
    """(q, k) pairs the causal and window masks leave (positions from 0)."""
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(B, H, Kh, Sq, Skv, D, causal, window, itemsize):
    """(bound_ms, bound_by): two products of 2 D FLOP per unmasked pair and
    head at the bf16 tensor-core rate, against q, k, v read once and the
    output written once."""
    ops = 4 * D * B * H * window_pairs(Sq, Skv, causal, window)
    nbytes = itemsize * D * (2 * B * H * Sq + 2 * B * Kh * Skv)
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_limit(want: torch.Tensor) -> torch.Tensor:
    """Elementwise limit on |kernel - plain| for attention outputs."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return BF16_RTOL * w + BF16_FLOOR * w.amax(-1, keepdim=True)
    return F32_TOL + F32_TOL * w


def device_kernels(fn) -> set:
    """Names of the GPU kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def sdpa_backends(device, batch) -> dict:
    """The yardstick of phase 4 at the serving shape of ``batch``: one
    ``scaled_dot_product_attention`` with the boolean window mask, timed
    under each backend alone (``None`` where the backend refuses the
    inputs), and the backend that the default dispatch picks, named by the
    kernels it launches.  Run after the serving phase: the profiler it
    uses stays out of the timed serving run."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=device).manual_seed(8)
    S, W = PROMPT, 2048
    q, k, v = (torch.randn(batch, h, S, 256, generator=gen, device=device,
                           dtype=torch.bfloat16) for h in (10, 1, 1))
    pos = torch.arange(S, device=device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    call = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)
    times, kernels = {}, {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                kernels[backend.name] = device_kernels(call)
                times[backend.name] = cuda_ms(call, 10)
        except RuntimeError:
            times[backend.name] = None
    default = device_kernels(call)
    picked = [name for name, ks in kernels.items() if ks == default]
    return {"ms": times, "default": picked[0] if picked else None,
            "default_kernels": sorted(name[:100] for name in default)}


def phase_serving_kernels(device):
    """Phase 4: decay_scan and flash_attention against their plain
    versions on the card, then their times at the serving shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(4)
    cases = 0
    for T in SCAN_T:
        for C in SCAN_C:
            a = torch.rand(T, C, generator=gen, device=device)
            u = torch.randn(T, C, generator=gen, device=device)
            for h0 in (None, torch.randn(C, generator=gen, device=device)):
                got = ds.decay_scan_cuda(a, u, h0)
                want = ref.decay_scan_ref(a, u, h0)
                torch.cuda.synchronize()
                check(bitwise_equal(got, want),
                      f"decay_scan != plain at T={T} C={C} "
                      f"h0={h0 is not None}: max abs err "
                      f"{max_abs_err(got, want)}")
                cases += 1
    emit(decay_scan_grid={"cases": cases, "bitwise_vs_plain_card": True})

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    records, failed = [], []
    for B, H, Kh, Sq, Skv, D, causal, window, softcap in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, D, generator=gen, device=device)
            k = torch.randn(B, Kh, Skv, D, generator=gen, device=device)
            v = torch.randn(B, Kh, Skv, D, generator=gen, device=device)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            ratio = float(((got.float() - want.float()).abs()
                           / attention_limit(want)).max())
            rec = {"shape": [B, H, Kh, Sq, Skv, D], **kw,
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": max_abs_err(got.float(), want.float()),
                   "max_abs_want": float(want.float().abs().max()),
                   "err_over_limit": ratio}
            records.append(rec)
            if not (ratio <= 1.0 and bool(torch.isfinite(got).all())):
                failed.append(rec)
            worst[dtype] = max(worst[dtype], rec["max_abs_err"])
            del q, k, v, got, want
    emit(flash_attention_grid={
        "cases": records, "limits": {
            "float32": {"rtol": F32_TOL, "atol": F32_TOL},
            "bfloat16": {"rtol": BF16_RTOL,
                         "atol_of_row_max_abs_want": BF16_FLOOR}}})
    check(not failed, f"flash_attention != plain: {failed}")

    times = {"decay_scan": {}, "flash_attention": {}}
    T = PROMPT
    for batch in (1, SERVE_BATCH):
        C = batch * 2560
        a = torch.rand(T, C, generator=gen, device=device)
        u = torch.randn(T, C, generator=gen, device=device)
        times["decay_scan"][batch] = {
            "shape": [T, C],
            "ms": graph_ms(lambda: ds.decay_scan_cuda(a, u), 10, 5),
            "plain_ms": cuda_ms(lambda: ref.decay_scan_ref(a, u), 2),
            "bound_ms": 1e3 * 12 * T * C / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None}
    for batch in (1, SERVE_BATCH):
        B, H, Kh, S, D, W = batch, 10, 1, PROMPT, 256, 2048
        q = torch.randn(B, H, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16)
        k = torch.randn(B, Kh, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16)
        v = torch.randn(B, Kh, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16)
        pos = torch.arange(S, device=device)
        mask = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < W)
        bound, by = attention_bound(B, H, Kh, S, S, D, True, W, 2)
        times["flash_attention"][batch] = {
            "shape": [B, H, Kh, S, S, D], "window": W, "dtype": "bfloat16",
            "ms": cuda_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, window=W), 10),
            "plain_ms": cuda_ms(lambda: ref.attention_ref(
                q, k, v, causal=True, window=W), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), 10),
            "bound_ms": bound, "bound_by": by}
    emit(serving_kernel_times=times)
    return worst, times


def on_device(tensors, device) -> bool:
    return all(t.device == device for t in tensors)


def phase_serve(device):
    """Phase 5: full-width, full-depth recurrentgemma-2b serving 2
    requests at batch 2 on the card, checked against a teacher-forced
    forward."""
    from repro_torch.configs.base import load_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone
    from repro_torch.serving.engine import make_serve_step, sample_token

    run = load_config(ARCH)
    cfg = run.model
    dtype = torch.bfloat16
    plan = backbone.layer_plan(cfg)
    n_rec, n_attn = plan.kinds.count("rec"), plan.kinds.count("attn")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = backbone.init_params(cfg, gen, dtype, device)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                            generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in params.parameters())
    check(n_params == N_PARAMS, f"{n_params} parameters")
    check(on_device(params.parameters(), device), "a parameter is off card")
    prefill = make_serve_step(run, "prefill", compute_dtype=dtype,
                              max_len=PROMPT + NEW_TOKENS)
    decode = make_serve_step(run, "decode", compute_dtype=dtype)

    with torch.inference_mode():
        # one warm-up request: the process's first prefill also pays for
        # the allocator's growth and cuBLAS's first calls
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts)
        tok = sample_token(logits, None, temperature=0.0,
                           vocab_size=cfg.vocab_size)
        torch.cuda.synchronize()
        cold_prefill_s = time.perf_counter() - t0
        decode(params, state, tok)
        del logits, state, tok
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)

        ds.launches = fa.launches = 0          # the main path starts here
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts)
        tok = sample_token(logits, None, temperature=0.0,
                           vocab_size=cfg.vocab_size)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_logits, fed = [logits], []
        t0 = time.perf_counter()
        for _ in range(NEW_TOKENS):
            fed.append(tok)
            logits, state = decode(params, state, tok)
            tok = sample_token(logits, None, temperature=0.0,
                               vocab_size=cfg.vocab_size)
            step_logits.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = {"decay_scan": ds.launches,
                    "flash_attention": fa.launches}
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        check(launches == {"decay_scan": n_rec, "flash_attention": n_attn},
              f"launches {launches} for one prefill of {n_rec} rec and "
              f"{n_attn} attn layers")
        check(all(bool(torch.isfinite(x).all()) for x in step_logits),
              "non-finite logits")
        caches = [x for c in state.layers for x in c]
        check(on_device(caches, device), "a cache left the card")
        check(on_device(params.parameters(), device),
              "a parameter left the card")

        # teacher-forced forward over prompt + fed tokens; logits only at
        # the positions the prefill and the decode steps predicted from
        ds.launches = fa.launches = 0
        t0 = time.perf_counter()
        seq = torch.cat([prompts] + fed, dim=1)
        hidden = backbone.forward_hidden(params, cfg, seq,
                                         compute_dtype=dtype)
        want = backbone.logits_from_hidden(
            params, cfg, hidden[:, PROMPT - 1:PROMPT + NEW_TOKENS])
        torch.cuda.synchronize()
        teacher_s = time.perf_counter() - t0
        check((ds.launches, fa.launches) == (n_rec, n_attn),
              f"teacher-forced forward launched {ds.launches} scans and "
              f"{fa.launches} attentions")
        rel, err, agree = [], [], 0
        for i, got in enumerate(step_logits):
            w = want[:, i]
            rel.append(float((got - w).norm() / w.norm()))
            err.append(float((got - w).abs().max()))
            agree += int((got.argmax(-1) == w.argmax(-1)).sum())
        check(max(rel) <= DECODE_REL_L2,
              f"decode vs teacher-forced: relative L2 error {max(rel)}")
    emit(serve={
        "arch": ARCH, "params": n_params, "dtype": "bfloat16",
        "batch": SERVE_BATCH, "prompt": PROMPT, "decode_steps": NEW_TOKENS,
        "launches_per_prefill": launches,
        "prefill_tok_per_s": SERVE_BATCH * PROMPT / prefill_s,
        "decode_tok_per_s": SERVE_BATCH * NEW_TOKENS / decode_s,
        "init_s": init_s, "cold_prefill_s": cold_prefill_s,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "teacher_forced_s": teacher_s, "peak_mem_gb": peak_gb,
        "vs_teacher_forced": {"max_rel_l2": max(rel),
                              "max_abs_err": max(err),
                              "max_abs_logit": float(want.abs().max()),
                              "argmax_agree": agree / (SERVE_BATCH *
                                                       len(step_logits)),
                              "rel_l2_limit": DECODE_REL_L2}})
    return launches


def phase_blocks(device):
    """Phase 6: one full-width rec and one attn block in float32, the card
    with its kernels against the CPU with the plain versions."""
    import copy

    from repro_torch.configs.base import load_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone, common

    cfg = load_config(ARCH).model
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(1, BLOCK_S, cfg.d_model, generator=gen)
    positions = torch.arange(BLOCK_S)
    out = {}
    for kind, counter in (("rec", ds), ("attn", fa)):
        p_cpu = common.Params(common.init_tree(
            backbone.block_specs(kind, cfg), gen, torch.float32, "cpu"))
        p_card = copy.deepcopy(p_cpu).to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            want, wcache = backbone.apply_block(kind, p_cpu, x, cfg,
                                                positions,
                                                collect_cache=True)
            cpu_s = time.perf_counter() - t0
            before = counter.launches
            t0 = time.perf_counter()
            got, gcache = backbone.apply_block(
                kind, p_card, x.to(device), cfg, positions.to(device),
                collect_cache=True)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        check(counter.launches == before + 1,
              f"{kind} block: {counter.launches - before} kernel launches")
        worst = 0.0
        for name, g, w in [("out", got, want)] + [
                (f"cache{i}", g, w) for i, (g, w) in
                enumerate(zip(gcache, wcache))]:
            nw = max_abs_err(g, w) / float(w.abs().max())
            check(nw <= BLOCK_TOL[kind],
                  f"{kind} block {name}: card vs CPU normwise {nw}")
            worst = max(worst, nw)
        out[kind] = {"normwise_err": worst, "limit": BLOCK_TOL[kind],
                     "cpu_s": cpu_s, "card_s": card_s}
    emit(blocks={"S": BLOCK_S, "d_model": cfg.d_model, "dtype": "float32",
                 **out})


def serving_kernel_entry(name, replaces, launches, max_err, times, **extra):
    """A ``kernels`` line entry: times at the batch-1 serving shape, the
    batch-2 ones (the path's own batch) beside them."""
    one, two = times[1], times[SERVE_BATCH]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": one["ms"],
            "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
            "bound_by": one["bound_by"], "library_ms": one["library_ms"],
            "shape": one["shape"], "ms_batch2": two["ms"],
            "plain_ms_batch2": two["plain_ms"],
            "bound_ms_batch2": two["bound_ms"],
            "library_ms_batch2": two["library_ms"], **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.streaming.workload import REGIMES, generate

    t_start = time.perf_counter()
    build_kernels()
    worst, times = phase_kernel(device)

    t0 = time.perf_counter()
    spec = dataclasses.replace(REGIMES["iiot"], n_keys=N_KEYS,
                               n_events=N_EVENTS)
    stream = generate(spec, seed=0)
    emit(workload={"regime": "iiot", "keys": N_KEYS, "events": N_EVENTS,
                   "gen_s": time.perf_counter() - t0})
    launches = phase_stream(device, stream)
    phase_parity(device, stream)
    t0 = time.perf_counter()
    scoring = phase_scoring(device, stream)
    emit(scoring_phase_s=time.perf_counter() - t0)
    attn_worst, serving_times = phase_serving_kernels(device)
    serve_launches = phase_serve(device)
    phase_blocks(device)
    backends = {b: sdpa_backends(device, b) for b in (1, SERVE_BATCH)}
    emit(sdpa_backends=backends)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    rows4096, rows256 = times[4096], times[256]
    t4096, t256 = rows4096["keyed"], rows256["keyed"]
    emit(kernels=[{
        "name": "thinning_rmw", "route": "cuda",
        "source": "src/repro_torch/csrc/thinning_rmw.cu",
        "replaces": "src/repro/kernels/thinning_rmw.py:36",
        "launches": launches, "max_abs_err": worst,
        "launches_scoring_keyed": scoring["keyed"],
        "launches_scoring_rows_entry": scoring["rows_entry"],
        "ms": t4096["ms"], "plain_ms": t4096["plain_ms"],
        "bound_ms": t4096["bound_ms"], "bound_by": t4096["bound_by"],
        "library_ms": None,
        "bitwise_vs_plain_cpu": True, "entry": "keyed, decision only",
        **keyed_shape(),
        "us_b4096": 1e3 * t4096["ms"], "us_b256": 1e3 * t256["ms"],
        "plain_us_b4096": 1e3 * t4096["plain_ms"],
        "bound_us_b4096": 1e3 * t4096["bound_ms"],
        "bound_us_b256": 1e3 * t256["bound_ms"],
        "wrapper_us_b4096": 1e3 * t4096["wrapper_ms"],
        "write_back_chunk256_us": 1e3 * t4096["write_back_chunk256_ms"],
        "write_back_chunk256_bound_us":
            1e3 * t4096["write_back_chunk256_bound_ms"],
        "rows_entry_us_b4096": 1e3 * rows4096["ms"],
        "rows_entry_us_b256": 1e3 * rows256["ms"],
        "rows_entry_plain_us_b4096": 1e3 * rows4096["plain_ms"],
        "rows_entry_bound_us_b4096": 1e3 * rows4096["bound_ms"],
        "rows_entry_wrapper_us_b4096": 1e3 * rows4096["wrapper_ms"]},
        serving_kernel_entry(
            "decay_scan", "src/repro/kernels/decay_scan.py:33",
            serve_launches["decay_scan"], 0.0,
            serving_times["decay_scan"], bitwise_vs_plain_card=True),
        serving_kernel_entry(
            "flash_attention", "src/repro/kernels/flash_attention.py:37",
            serve_launches["flash_attention"],
            max(attn_worst.values()), serving_times["flash_attention"],
            max_abs_err_float32=attn_worst[torch.float32],
            max_abs_err_bfloat16=attn_worst[torch.bfloat16],
            library_backend=backends[1]["default"],
            library_backend_batch2=backends[SERVE_BATCH]["default"])])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

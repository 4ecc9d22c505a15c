#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

It builds the CUDA ``thinning_rmw`` kernel from this checkout's source
(``nvcc`` for ``sm_90a``, into ``build/``), then runs three phases; any
failure raises and the script exits non-zero.

1. Kernel: the kernel on the card against its plain PyTorch version on the
   CPU (which the CPU tests hold bitwise to the JAX reference), bitwise on
   all 9 outputs, over B x T x policy; then the kernel's and the plain
   version's times on the card at the engine's block shapes.
2. Stream: ``run_stream`` on the card at the paper's iiot key count
   (800,000 keys, 2,000,000 events, six decay windows, write budget
   Lambda*h = 0.1), fast mode at batch 4096: dense ``pp``, then ``pp`` and
   ``pp_vr`` through a 4-partition write-behind sink.  The kernel's launch
   count must equal the block count of each run.
3. Parity: exact mode on a 262,144-event prefix on the card and on the CPU
   (decisions, state and sink bytes identical); two fast-mode runs on the
   card (identical state); one fast block from a shared state on the card
   and on the CPU (identical decisions, state within 1e-5 relative).

Earlier lines print JSON records; the line before the last is the kernel
table, the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
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


def phase_kernel(device):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import thinning_rmw as trmw

    t0 = time.perf_counter()
    trmw.build()
    ptxas = [ln.strip() for ln in trmw.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(build={"seconds": trmw.build_seconds,
                "wall_s": time.perf_counter() - t0, "ptxas": ptxas})

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

    times = {}
    for B in (4096, 256):
        T, policy = 6, "pp"
        args = [torch.tensor(a, device=device) for a in trmw_inputs(
            np.random.default_rng(B), B, T)]
        kw = trmw_kw(policy, T)
        kernel = lambda: trmw.thinning_rmw_cuda(*args, **kw)
        plain = lambda: ref.thinning_rmw_ref(*args, **kw)
        times[B] = {
            "ms": graph_ms(kernel, 100, 20),
            "wrapper_ms": cuda_ms(kernel, 500),
            "plain_ms": cuda_ms(plain, 50),
            "bound_ms": 1e3 * max(trmw_bytes(B, T) / HBM_BYTES_PER_S,
                                  trmw_ops(B, T, policy) / F32_OPS_PER_S),
            "bound_by": ("bytes" if trmw_bytes(B, T) / HBM_BYTES_PER_S
                         >= trmw_ops(B, T, policy) / F32_OPS_PER_S
                         else "operations")}
    emit(kernel_times={str(B): v for B, v in times.items()})
    return worst, times


def phase_stream(device, stream):
    from repro_torch.core import EngineConfig, init_state, prng_key, run_stream
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.streaming.persistence import WriteBehindSink

    n_blocks = -(-len(stream.key) // BATCH)
    runs = [("pp", None), ("pp", 4), ("pp_vr", 4)]
    trmw.launches = 0                       # the main path starts here
    for policy, n_parts in runs:
        cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy=policy,
                           alpha=1.0 if policy == "pp_vr" else 0.0)
        state = init_state(N_KEYS, len(cfg.taus), device=device)
        sink = (WriteBehindSink(cfg, n_partitions=n_parts, device=device)
                if n_parts else None)
        before = trmw.launches
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
        launched = trmw.launches - before
        writes = int(writes.sum())
        check(launched == n_blocks,
              f"{launched} kernel launches for {n_blocks} blocks")
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
    return trmw.launches


def _store_bytes(sink):
    merged = {}
    for s in sink.stores:
        merged.update(s.data)
    return merged


def phase_parity(device, stream):
    from repro_torch.core import (EngineConfig, Event, init_state, make_step,
                                  prng_key, run_stream, state_from_numpy,
                                  state_to_numpy)
    from repro_torch.streaming.persistence import WriteBehindSink

    keys, qs, ts = (stream.key[:PREFIX], stream.q[:PREFIX],
                    stream.t[:PREFIX])
    rounds = max(int(np.bincount(keys[i:i + EXACT_BATCH]).max())
                 for i in range(0, PREFIX, EXACT_BATCH))
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp_vr",
                       alpha=1.0, exact_rounds=rounds)
    out = []
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
    (gs, gi, gb, gt, gw), (cs, ci, cb, ct, _) = out
    for name, a, b in zip(("z", "p", "lam_hat", "features"), gi, ci):
        check(bitwise_equal(a, b), f"exact {name}: cuda != cpu")
    for name, a, b in zip(gs._fields, gs, cs):
        check(np.array_equal(a.view(np.uint8), b.view(np.uint8)),
              f"exact state {name}: cuda != cpu")
    check(gb == cb and len(gb) > 0, "exact sink bytes: cuda != cpu")
    emit(parity_exact={"events": PREFIX, "batch": EXACT_BATCH,
                       "exact_rounds": rounds, "policy": "pp_vr",
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.streaming.workload import REGIMES, generate

    t_start = time.perf_counter()
    worst, times = phase_kernel(device)

    t0 = time.perf_counter()
    spec = dataclasses.replace(REGIMES["iiot"], n_keys=N_KEYS,
                               n_events=N_EVENTS)
    stream = generate(spec, seed=0)
    emit(workload={"regime": "iiot", "keys": N_KEYS, "events": N_EVENTS,
                   "gen_s": time.perf_counter() - t0})
    launches = phase_stream(device, stream)
    phase_parity(device, stream)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    t4096, t256 = times[4096], times[256]
    emit(kernels=[{
        "name": "thinning_rmw", "route": "cuda",
        "source": "src/repro_torch/csrc/thinning_rmw.cu",
        "replaces": "src/repro/kernels/thinning_rmw.py:36",
        "launches": launches, "max_abs_err": worst,
        "ms": t4096["ms"], "plain_ms": t4096["plain_ms"],
        "bound_ms": t4096["bound_ms"], "bound_by": t4096["bound_by"],
        "library_ms": None,
        "bitwise_vs_plain_cpu": True,
        "us_b4096": 1e3 * t4096["ms"], "us_b256": 1e3 * t256["ms"],
        "plain_us_b4096": 1e3 * t4096["plain_ms"],
        "bound_us_b4096": 1e3 * t4096["bound_ms"],
        "wrapper_us_b4096": 1e3 * t4096["wrapper_ms"]}])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

It builds the port's five CUDA kernel sources from this checkout
(``thinning_rmw``, ``segment_fold`` (fast mode's fold), ``decay_scan``
with its backward, ``flash_attention``, ``flash_attention_bwd``: one
``nvcc`` each for ``sm_90a``, all started
together, into ``build/``), checks with ``cuobjdump`` that the bfloat16
attention kernels (the forward, and the backward's dK/dV and dQ kernels)
hold ``HGMMA`` (tensor-core) instructions, then runs fourteen phases; any
failure raises (in a rank too) and the script exits non-zero.

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
   262,144-event prefix on the card (the launches a chunk; phase 9's
   reference), and on its first 65,536 events on the card and on the CPU
   (decisions, state and sink bytes identical); two fast-mode runs on the card (identical
   state); one fast block from a shared state on the card and on the CPU
   (identical decisions, state within 1e-5 relative).
4. Kernels of the serving path: ``decay_scan`` on the card bitwise against
   its plain loop on the card over T x C x (with, without h0);
   ``flash_attention`` against its plain version on the card over MHA,
   GQA, MQA, causal, window, softcap, non-causal and ragged shapes, the
   serving shapes at batch 1 and 2, and the attention of each phase-10
   and phase-11 model (head widths 64, 80 and 128, GQA groups of 1 to 12,
   global causal and non-causal, Command-R+'s at batch 1, Llama-3.2-
   Vision's cross-attention of 4096 queries over 1600 vision tokens and a
   small ragged non-causal Sq > Skv case), in float32 (rtol =
   atol = 2e-4, the JAX suite's) and bfloat16 (``|got - want| <=
   2^-6 |want| + 2^-7 m``, with m the largest ``|want|`` of the same
   query row: two bfloat16 ulps of each value, plus a floor tied to the
   row's scale, since a window of 2048 keys averages random values down
   to a few hundredths while a row with one key keeps them whole); then
   each kernel's, its plain version's and (attention only) PyTorch's
   ``scaled_dot_product_attention``'s times at the serving shapes, and at
   each phase-10 and phase-11 model's shapes (the scan at Mamba-2's [16,
   1,310,720] is in the bitwise grid too).
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
   CPU's ``exp``.  Then a full-width ``qwen3-4b`` ``attn`` block
   (qk-norm, D 128, GQA groups of 4; 1e-4) and a ``mamba2-2.7b`` ``ssd``
   block (nine chunks of 256; 1e-3, since ``exp(segsum)`` and the chunk
   decays carry the one-ulp ``exp`` differences into the states as the
   RG-LRU's input does).

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
8. Online frontend (it runs after phase 7, on phase 2's stream): the
   same deployment served through ``serving.frontend`` at batch 256 with
   a 2 ms deadline, each run from a fresh dense 800,000-key state, on the
   first 262,144 events (the one cut, recorded as ``reduced``): (a)
   capacity, every request at 0 on ``RealClock``, fast, serial, memory
   sink — bitwise equal to ``run_stream`` at batch 256 (decisions,
   features, scores through ``score_at_width``, store bytes, final
   state); (b) Poisson arrivals at 0.5x and 0.8x of (a)'s capacity
   through ``ScoringPipeline.serve`` — latency quantiles, mean batch,
   deadline share; bitwise equal to a closed-loop replay at the run's own
   dispatch boundaries; (c) exact mode at 0.5x on the first 65,536 events
   with ``exact_rounds`` the most events of one key in any 256
   consecutive events — bitwise equal to the exact ``run_stream``, 1 +
   rounds write-back launches a dispatch; (d) 100,000 resident slots under
   threaded admission, every request at 0 — bitwise equal to (a); (e) the
   SIGKILL victim on the card, fast and exact, its recovered store equal
   to ``faults.run_reference`` on the card; (f) (a)'s final state saved
   by ``CheckpointManager``, restored onto the card and repartitioned 1 ->
   4 -> 1 shards, bitwise.  The keyed kernel must launch once per fast
   dispatch; no plain step may run on a CUDA tensor.

9. Sharded engine (it runs after phase 8, on phase 2's stream): the
   same deployment as 4 ranks on ``cuda:0``, one process a shard, gloo
   collectives on host tensors (NCCL refuses two ranks on one card),
   started by ``distributed.spawn.run_ranks`` after the kernels are built
   (ranks only load them), at ``batch_per_shard=1024`` (4 x 1024 = phase
   2's block), 200,000 x 22 float32 rows a rank; the stream goes to the
   ranks as memory-mapped ``.npy`` files.  (a) dense, fast, block
   layout: the stream-order gather run (z and p bitwise, features within
   1e-6 and the permuted state bitwise against the one-card engine on the
   card fed the same routed blocks with global keys, on rank 0), then
   the timed run with ``collect_info=False``: per-rank and aggregate
   events/s and the ranks' start time; keyed launches on each rank equal
   the global block count.  (b) exact mode on phase 3's prefix, block
   (durable sink) and virtual layouts, ``exact_rounds`` the most events
   of one key in a shard's block: decisions, state and store bytes
   bitwise equal to phase 3's card run, ``4 + exact_rounds`` write-back
   launches a block on each rank.  (c) (a) through a sink: dense, then
   25,000 resident slots a rank (12.5 % in all) serial and at
   ``pipeline_depth=2``, each bitwise equal to dense in z, features and
   store bytes, with evictions and rehydrations.  (d) fresh ranks
   ``hydrate_from_dir`` (b)'s durable partitions: persisted columns
   bitwise equal to the live state; ``materialize_cold`` over every
   touched key equals ``materialize``.  (e) (a)'s 4-shard state saved by
   ``CheckpointManager(mesh=)``, restored onto 2 ranks and onto one card
   through ``repartition_profile_state``, bitwise.  (f) (b)'s block run
   on a 1-rank NCCL mesh (CUDA-tensor collectives): bitwise equal to
   phase 3.  No rank runs a plain step on a CUDA tensor.

10. The dense, SSM and audio families (it runs after phase 6), one
   model at a time with fresh seeded bfloat16 weights on the card, freed
   before the next: ``qwen3-4b`` and ``mamba2-2.7b`` at full width and
   depth serve a warm-up request, then batch 2 with a 4096-token prompt
   and 32 greedy steps; ``hubert-xlarge`` encodes 2 x 4096 frames of width
   512 (logits [2, 4096, 512], finite, vocab padding masked);
   ``yi-9b``, ``smollm-360m`` and ``command-r-plus-104b`` with 12 of its
   64 layers (the one cut, recorded as ``reduced``: 214 GB in bfloat16 at
   full depth) serve one request of 4096 tokens and 8 steps at batch 2.
   Each prefill (encode) must launch ``flash_attention`` once per ``attn``
   layer and ``decay_scan`` once per ``ssd`` layer, each logit must be
   finite, parameters and caches must stay on the card; ``qwen3-4b``'s
   decode logits must agree with a teacher-forced forward to a relative L2
   error of 0.1, as in phase 5.  ``mamba2-2.7b``'s are checked on a
   second, short request (a 96-token prompt and 32 steps, then a forward
   over 128 tokens: one chunk), since the SSD prefill needs whole chunks;
   in bfloat16 its recurrent decode drifts from the chunked forward by
   about 0.1 on random weights, as the JAX reference's does, so that drift
   is printed and the gate is the same request in float32, within 1e-3.
   Each record carries the card's name and power limit.

11. The MoE and vision families (it runs after phase 10), one model at
   a time with fresh seeded bfloat16 weights on the card, freed before the
   next; the gates the reference starts at 0 (cross-attention's tanh
   gates, the shared experts' sigmoid gate) are drawn from the seed, so
   those paths reach the logits.  (a) ``qwen2-moe-a2.7b`` at full width
   and depth (24 layers, 60 of 64 experts routed top-4, 4 shared;
   15,146,305,536 parameters) serves a warm-up request, then batch 2 with
   a 4096-token prompt and 32 greedy steps; (b) ``kimi-k2-1t-a32b`` at
   full width with 2 of its 61 layers (its dense layer and one MoE layer
   of 384 experts, top-8; 19,967,682,560 parameters: 2.06 TB at full
   depth, ``reduced``) and (c) ``llama-3.2-vision-90b`` at full width with
   25 of its 100 layers (20 self- and 5 cross-attention; 23,492,714,506
   parameters: 175 GB at full depth, ``reduced``) with seeded
   ``image_embeds`` [2, 1600, 8192] serve 2 x 4096 tokens and 8 steps.
   Each prefill must call ``flash_attention`` once per ``attn``, ``moe``
   and ``cross`` layer, causal over the prompt and non-causal over the
   1600 vision tokens, in the plan's order; each MoE layer's
   ``moe_drop_frac`` is printed; logits finite, parameters and caches on
   the card.  Each model's decode is checked against a teacher-forced
   forward on a short request (96 + 32 tokens at batch 2: 256 tokens, so
   the capacity floor of 256 lets no MoE choice drop on either side), in
   float32 within 1e-3 and in bfloat16, within 0.1 for Llama; routing is
   discontinuous, so in bfloat16 the two paths' roundings flip near-tied
   experts of some tokens and the MoE models' bfloat16 drift is printed,
   not gated.  (d) ``moe_ep`` as 4 gloo ranks on the card (16 of Qwen2-
   MoE's 64 experts a rank) and on a 1-rank NCCL mesh, on one full-width
   MoE layer and tokens [2, 4096, 2048]: at capacity factor 8 equal to the
   dense ``moe`` within the bfloat16 attention limit of phase 4, no drops,
   exactly 2 all-to-alls a call on every rank; at the config's 1.25 both
   drop fractions are printed, with the times of both.

12. Training (it runs after phase 11): (a) ``decay_scan_bwd`` bitwise
   against its plain reverse loop on the card over phase 4's scan grid,
   Mamba-2's shape and short and one-stage T (its ring-less path below
   128 steps); ``flash_attention_bwd`` against the float32 plain
   backward over phase 4's cases up to 1000 tokens, both training
   shapes and three shapes whose bfloat16 dK/dV grid splits the
   query-head group over blocks, normwise within 1e-4 (float32) and 2e-2
   (bfloat16); then both kernels' times at the training shapes beside the
   bound, the plain backward and SDPA's cuDNN forward + backward and
   backward alone (``library_bwd_ms``; ``is_causal`` where there is no
   window), with the split count.  (b) A full-width ``rec``, ``attn`` and
   ``ssd`` block's gradients in float32, card against CPU.  (c)
   RecurrentGemma-2B at full width and depth and (d) SmolLM-360M train a
   few steps on the card (bfloat16; AdamW with float32 master weights,
   then Adafactor with a bfloat16 accumulator): launches a step equal to
   the plan's (a backward call counts once, the reduction of a split
   group included), a falling loss, s/step, tok/s, peak memory.
13. Training under a mesh (after phase 12): (a) SmolLM-360M at full
   width, 16 of its 32 layers (bfloat16, AdamW with float32 master
   weights; cut for the script's time since phase 14 (d)-(f)) takes 3
   steps on phase 12's batch (2 x 4096 tokens) on a ("data", "model") =
   (2, 2) mesh of 4 gloo ranks sharing the card, its state placed by the
   train rules (``launch.shardings.init_train_state``; 15 heads and 5 KV
   heads replicate on "model", ff and vocab shard), the batch sharded
   over "data"; (b) RecurrentGemma-2B at full width with one pattern
   group (rec, rec, attn) the same way, and again computed in float32.
   Each rank gathers every layer's parameters over "data" and runs the
   model on its row tensor-parallel over "model": SmolLM's ff and vocab
   split, its heads whole; RecurrentGemma's RG-LRU channels
   (``decay_scan`` on 1280 of 2560) and its 10 heads against the whole
   KV head split.  Rank 0 then runs the same steps in one process with
   the batch split as the data ranks split it (each row a micro-batch:
   the witness) and whole.  Gates: every rank's launches the plan's, its
   state on the card, its argument bytes equal to its placements' count,
   the ranks' losses equal, and against the witness the losses, every
   step's grad norm and the float32 masters' update within
   ``MESH_GATES`` of the run's compute dtype.
   Then the kernels' ops on DTensors through their sharding rules on the
   same 4 ranks: Qwen3-4B's attention with rows over "data" and heads
   over "model" (16 query and 4 KV heads a rank), RecurrentGemma's
   training scan with channels over both, forward and backward, each
   rank's shard against its slice of the plain call on the card (bit for
   bit, attention's dK/dV within ``SPLIT_ORDER_TOL`` where the split
   count differs).  (c) SmolLM on a 1-rank NCCL (1, 1) mesh, bit for bit
   one process's steps.  Collectives (``CommDebugMode``) and s/step are
   printed.
14. Tensor parallelism over "model" (after phase 13), 4 gloo ranks
   sharing the card: (a) Qwen3-4B at full width, 2 of 36 layers (4 until
   phase 14 (d)-(f) came; cut for the script's time), 3 AdamW
   steps (as phase 13's: bfloat16, and again in float32) on phase 13's
   batch on ("data", "model") = (2, 2), each rank on its 16 heads, 4 KV
   heads and half the ff and vocab, held to one process that splits the batch as the data
   ranks do at phase 13's gates, with s/step and argument bytes against
   the placements; (b) Qwen3-4B at full width, 8 of 36 layers (all until
   phase 14 (d)-(f) came; the script's time), on (1, 4): one
   process serves a 2 x 4096 prompt and 8 greedy steps first, then the
   mesh does (8 heads, 2 KV heads, a quarter of ff and vocab and of every
   cache's ``kv_seq`` slots a rank) fed the same tokens: each step's
   logits within ``TP_LOGIT_REL_L2`` of one process's, any differing
   greedy token a near tie, a decode step's collective bytes the same
   every step and within ``_tp_decode_budget`` (O(B H D), no cache slot
   moves); (c) each rank's attention and scan calls at its local shapes
   against their plain versions.  The MoE on "model": (d) Qwen2-MoE-A2.7B
   at full width, 2 of 24 layers, 3 AdamW steps on the same batch and
   mesh (bfloat16, and again computed in float32), each rank on half the
   slots of 32 of the 64 experts (the buffer's capacity split over
   "data"), half the shared expert's ff and 8 of 16 heads, the routing
   the whole batch's (statistics, capacity and slots summed over the data
   ranks), held to one process on the whole batch (the single program; a
   witness split as the data ranks split would route each half alone) at
   ``MOE_TP_GATES``: in float32 ``MESH_GATES`` and every MoE call's drop
   fraction the same count of kept choices on both sides, in bfloat16
   gates read from sound and planted runs; the first step's router
   gradients gated too; s/step, argument bytes against placements and
   the peak memory printed; (e) Qwen2-MoE serves on (1, 4) (16 experts a
   rank), one process first, a 2 x 4096 prompt and 8 greedy steps fed
   the same tokens: bfloat16 at full depth (each step's logits within
   ``MOE_SERVE_BF16_REL_L2`` of one process's, read from sound and
   planted runs, any differing greedy token a near tie, a decode step's
   bytes the same
   every step and within ``_tp_decode_budget`` plus one float32
   all-reduce of [B, 1, D] a MoE layer, beside the bytes of the whole-MoE
   gather it replaces) and computed in float32 at 4 layers within 1e-3;
   (f) the attention kernels at (d)'s and (e)'s local shapes against
   their plain versions, timed beside the bound and SDPA.

After phase 11 the ``scaled_dot_product_attention`` call of phase 4 is
timed under each backend that accepts its boolean mask, and the backend
its default dispatch picked is named (matched by the kernels it
launches); so is ``scaled_dot_product_attention`` at each phase-10 and
phase-11 model's attention shape (``is_causal`` or non-causal, no
mask).

Earlier lines print JSON records (phase 8's and 9's carry the card's name
and power limit); the line before the last is the kernel table, the last is
``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# phase 13's gradient norms reduce leaves sharded over both mesh dims:
# DTensor warns at each that it all-reduces one dim after the other
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)

import numpy as np  # noqa: E402
import torch  # noqa: E402

POLICIES = ("pp", "pp_vr", "full", "fixed", "unfiltered")
N_KEYS, N_EVENTS, BATCH = 800_000, 2_000_000, 4096
PREFIX, EXACT_BATCH = 262_144, 1024
PARITY_EVENTS = 65_536      # the exact run the CPU repeats (PREFIX took 65 s)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
ARCH = "recurrentgemma-2b"
N_PARAMS = 2_894_574_080
SERVE_BATCH, PROMPT, NEW_TOKENS = 2, 4096, 32
SCAN_T, SCAN_C = (1, 7, 256, 4096), (1, 100, 2560, 5120)
SSD_SCAN = (PROMPT // 256, SERVE_BATCH * 80 * 128 * 64)   # Mamba-2 chunks
# the attention of each dense or audio model's prefill (batch 2, a
# 4096-token prompt): (H, Kh, D, causal).  The parity grid holds
# Command-R+'s at batch 1: its plain version's scores take 6.4 GB a row.
DENSE_ATTN = {"qwen3-4b": (32, 8, 128, True),
              "hubert-xlarge": (16, 16, 80, False),
              "smollm-360m": (15, 5, 64, True),
              "yi-9b": (32, 4, 128, True),
              "command-r-plus-104b": (96, 8, 128, True)}
# the attention of each MoE or vision model's prefill (phase 11, batch 2,
# a 4096-token prompt): (H, Kh, Skv, D, causal); Kimi-K2 and Llama's self
# attention share one shape, Llama's cross-attention reads the 1600 vision
# tokens
MOE_VISION_ATTN = {"qwen2-moe-a2.7b": (16, 16, PROMPT, 128, True),
                   "kimi-k2-1t-a32b+llama-3.2-vision-90b":
                       (64, 8, PROMPT, 128, True),
                   "llama-3.2-vision-90b/cross": (64, 8, 1600, 128, False)}
GRID_BATCH = {"command-r-plus-104b": 1}
# (B, H, Kh, Sq, Skv, D, causal, window, softcap)
ATTN_CASES = [(2, 4, 4, 64, 64, 32, True, 0, 0.0),       # MHA
              (2, 4, 2, 64, 64, 64, True, 32, 0.0),      # GQA, window
              (1, 8, 1, 128, 128, 64, True, 0, 20.0),    # MQA, softcap
              (2, 4, 2, 96, 96, 64, False, 0, 0.0),      # ragged, non-causal
              (2, 4, 2, 96, 160, 64, True, 48, 0.0),     # Sq < Skv
              (1, 10, 1, 300, 300, 256, True, 0, 0.0),   # D 256, ragged
              (2, 10, 1, 1000, 1000, 256, True, 256, 30.0),
              (1, 10, 1, 4096, 4096, 256, True, 2048, 0.0),   # serving,
              (2, 10, 1, 4096, 4096, 256, True, 2048, 0.0),   # batch 1, 2
              # the dense and audio families: D 80 (the second 64-column
              # TMA box mostly past D) and 128, GQA groups of 4, 8 and 12,
              # global causal and non-causal, ragged, then serving shapes
              (2, 8, 2, 300, 300, 80, True, 0, 0.0),
              (2, 8, 2, 300, 300, 80, False, 0, 0.0),
              (2, 16, 2, 333, 333, 128, True, 0, 0.0),
              (2, 24, 2, 333, 333, 128, False, 0, 0.0),
              (2, 24, 2, 200, 333, 128, True, 0, 0.0)] + \
    [(GRID_BATCH.get(a, SERVE_BATCH), h, kh, PROMPT, PROMPT, d, c, 0, 0.0)
     for a, (h, kh, d, c) in DENSE_ATTN.items()] + \
    [(2, 8, 2, 333, 100, 128, False, 0, 0.0)] + \
    [(SERVE_BATCH, h, kh, PROMPT, skv, d, c, 0, 0.0)
     for h, kh, skv, d, c in MOE_VISION_ATTN.values()]
F32_TOL = 2e-4                         # rtol = atol
BF16_RTOL, BF16_FLOOR = 2.0 ** -6, 2.0 ** -7   # of |want|, of its row's max
DECODE_REL_L2 = 0.1
BLOCK_TOL = {"rec": 1e-3, "attn": 1e-4, "ssd": 1e-3}
BLOCK_S = 2304                         # > the window; nine SSD chunks
BLOCK_CASES = [(ARCH, "rec", "decay_scan"), (ARCH, "attn", "flash_attention"),
               ("qwen3-4b", "attn", "flash_attention"),
               ("mamba2-2.7b", "ssd", "decay_scan")]
# phase 10: (arch, layers kept or None for all, batch, prompt or frames,
# decode steps); Command-R+ keeps 12 of its 64 layers (214 GB in bf16 at
# full depth, ~50 GB at 12)
FAMILIES = [("qwen3-4b", None, SERVE_BATCH, PROMPT, NEW_TOKENS),
            ("mamba2-2.7b", None, SERVE_BATCH, PROMPT, NEW_TOKENS),
            ("hubert-xlarge", None, SERVE_BATCH, PROMPT, 0),
            ("yi-9b", None, SERVE_BATCH, PROMPT, 8),
            ("smollm-360m", None, SERVE_BATCH, PROMPT, 8),
            ("command-r-plus-104b", 12, SERVE_BATCH, PROMPT, 8)]
TEACHER_FORCED = ("qwen3-4b", "mamba2-2.7b")
SSD_CHECK_PROMPT = 96          # + 32 fed tokens = one SSD chunk of 128
# a decode against its teacher-forced forward, both in float32 (Mamba-2,
# the MoE models): float32 rounding (2^-24) amplified as much as the
# bfloat16 run's drift is amplified (0.1 from 2^-8) stays near 1e-6; 1e-3
# keeps the margin and still sees any wrong position, chunk, state or
# routing (errors of order 1)
F32_REL_L2 = 1e-3
# phase 11: (arch, layers kept or None for all, decode steps, parameters);
# Kimi-K2 keeps its dense layer and one MoE layer of 61 (2.06 TB in bf16 at
# full depth, 74.1 GB at 3 layers), Llama-3.2-Vision 20 self- and 5
# cross-attention layers of 100 (175 GB at full depth)
MOE_VISION = [("qwen2-moe-a2.7b", None, NEW_TOKENS, 15_146_305_536),
              ("kimi-k2-1t-a32b", 2, 8, 19_967_682_560),
              ("llama-3.2-vision-90b", 25, 8, 23_492_714_506)]
# the teacher-forced request of phase 11: 2 x (96 + 32) = 256 tokens, so
# no MoE choice can pass the capacity floor of 256 in the prefill, the
# decode or the forward
MOE_CHECK_PROMPT = 96
EP_RANKS, EP_TIMEOUT_S = 4, 600.0      # phase 11 (d)
EP_NO_DROP_CF = 8.0                    # the JAX test's capacity factor
# phase 11 (e): forced capacities (slots an expert) of the dense moe on
# 2 x 4096 tokens, which bring 8192 x 4 / 60 = 546 choices an expert on
# average, and the dtypes each is run in
MOE_DROP_CASES = ((256, torch.float32), (512, torch.float32),
                  (256, torch.bfloat16))
N_SLOTS, SINK_GROUP, SCORER_HIDDEN = 100_000, 4, 64
WORKER_EVENTS = 16_384
FE_BATCH, FE_WAIT_S = 256, 2e-3        # the JAX bench_serving.py defaults
FE_EVENTS, FE_EXACT_EVENTS = PREFIX, 65_536
FE_LOADS = (0.5, 0.8)                  # of phase 8 (a)'s capacity
SHARDS, SHARD_BATCH = 4, 1024          # 4 x 1024 = phase 2's 4096
SHARD_SLOTS, SHARD_TIMEOUT_S = N_SLOTS // 4, 600.0
# phase 12: the training runs' batch (2 x 4096 tokens); the backward
# kernels' shapes on their paths (RecurrentGemma's attention at its
# micro-batch of 1, SmolLM's at batch 2; the scan at RecurrentGemma's
# micro-batch and Mamba-2's chunk recurrence); the backward grid (phase
# 4's cases up to 1000 tokens, then the two training shapes) and its
# normwise limits against a float32 plain backward on the same inputs:
# float32 sums in another order; bfloat16 rounds P and dS to bfloat16
# before the products that read them and the outputs to bfloat16 (each
# ~2^-9 relative, summed over thousands of terms)
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_ATTN = {ARCH: (1, 10, 1, TRAIN_SEQ, 256, 2048),   # (B, H, Kh, S, D, W)
              "smollm-360m": (TRAIN_BATCH, 15, 5, TRAIN_SEQ, 64, 0)}
TRAIN_SCANS = {ARCH: (TRAIN_SEQ, 2560), "mamba2-2.7b": SSD_SCAN}
TRAIN_ATTN_CASES = [c for c in ATTN_CASES if c[3] <= 1000] + \
    [(B, H, Kh, S, S, D, True, W, 0.0)
     for B, H, Kh, S, D, W in TRAIN_ATTN.values()] + \
    [(1, 12, 1, 2000, 2000, 64, True, 100, 0.0),     # the bf16 dK/dV grid
     (1, 10, 1, 2500, 2500, 256, True, 300, 10.0),   # splits the group
     (2, 6, 1, 500, 700, 128, False, 0, 0.0)]        # (G not a multiple of
                                                     # the splits, windows
                                                     # ending inside a key
                                                     # tile, Skv % 64 != 0)
TRAIN_ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# calls a timing of the attention backward and its SDPA yardstick averages
# (phase 12 (a)): host-launched autograd calls jitter, so the comparison
# reads device time over this many calls
YARD_REPS = 20
TRAIN_BLOCK_CASES = [(ARCH, "rec", "decay_scan"),
                     (ARCH, "attn", "flash_attention"),
                     ("mamba2-2.7b", "ssd", "decay_scan")]
# (label, arch, steps, TrainConfig overrides besides warmup_steps=1)
# Phase 13's and 14 (a)'s bounds, by compute dtype: (loss rtol, grad norm
# gap, update gap).  The witness is one process on the card that splits
# the batch as the 2 data ranks do: each row a micro-batch (``grad_accum``
# 2), the two halves' gradients summed in float32.
#
# float32 (the extra runs): the mesh's split sums differ from the
# witness's whole ones by float32 reassociation, so these are the bf16
# bounds of a mesh whose "model" axis replicated (the split batch's only
# difference a bf16 rounding of each gradient entry, 2^-9 of its size):
# the grad norm within 2^-9, doubled for the sums' order and step 2's
# weights: 2^-8.  The norm is the gate that sees a gradient's size:
# clipping (norms of 30-90 against a clip of 1) and Adam's m/sqrt(v) both
# cancel a gradient scaled by a constant, so a wrong 1/n or token share
# moves the norm alone.  Losses: steps 0 and 1 run on the initial weights
# (step 0's lr is 0): 1e-5.  Step 2's loss also moves with the updates'
# difference: within rtol + update gap x |step 1's loss - step 2's|.  The
# float32 masters' move after 3 steps (L2 of the difference over L2 of
# the witness's move): Adam's m/sqrt(v), ~sign(g), alike where |g| is
# well above its noise, each entry within ~2^-8: 2^-7.
#
# bfloat16 (the runs users train in): the "model" axis splits the
# products, and each rank's column shard of a bf16 product, its partial
# sums and its share of the backward's input gradient round at other
# places than the witness's whole product, so more entries carry a bf16
# rounding than the bound above counts.  These gates come from readings
# (``scripts/torch_tp_gate_readings.py`` on the card): the largest gap of
# the sound runs and the smallest of planted tensor-parallel faults (one
# rank's partial sum of one row-parallel product dropped once a step; one
# column-parallel product's input gradient left unsummed once a step),
# each limit set between the two (NVIDIA H100 80GB HBM3, 700.00 W):
# losses of steps 0-1, sound at most 2.73e-5 (SmolLM; Qwen3-4B 4.1e-6,
# RecurrentGemma 3.6e-6), the dropped partial sum 2.63e-3: 1e-4; the
# update, sound at most 2.89e-2 (SmolLM's 32 layers; RecurrentGemma
# 1.05e-2, Qwen3-4B 1.15e-2), the unsummed gradient 0.109 and the dropped
# partial sum 0.936 (Qwen3-4B): 2^-4.  The norm keeps 2^-8 (sound at most
# 1.3e-4, the dropped partial sum 5.8e-2; the unsummed gradient, 7.4e-4,
# shows in the update alone).
TP_BF16_LOSS_RTOL, TP_BF16_UPDATE_GAP = 1e-4, 2.0 ** -4
MESH_GATES = {"float32": (1e-5, 2.0 ** -8, 2.0 ** -7),
              "bfloat16": (TP_BF16_LOSS_RTOL, 2.0 ** -8, TP_BF16_UPDATE_GAP)}
TRAIN_RUNS = [("recurrentgemma", ARCH, 4, {}),
              ("smollm_adamw", "smollm-360m", 4, {}),
              ("smollm_adafactor", "smollm-360m", 2,
               {"optimizer": "adafactor", "master_weights": False})]


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

    kernels = (trmw.KERNEL, trmw.FOLD_KERNEL, decay_scan.KERNEL,
               flash_attention.KERNEL, flash_attention.BWD_KERNEL)
    t0 = time.perf_counter()
    _build.build_all(kernels)
    wall = time.perf_counter() - t0
    sass = sass_counts(flash_attention.KERNEL.library_path(),
                       "flash_attention_tc", ("HGMMA", "HMMA"))
    check(sass["HGMMA"] > 0, f"no HGMMA in the bf16 attention kernel: {sass}")
    bwd_sass = {name: sass_counts(flash_attention.BWD_KERNEL.library_path(),
                                  name, ("HGMMA", "HMMA"))
                for name in ("attn_bwd_dkdv_tc", "attn_bwd_dq_tc")}
    check(all(c["HGMMA"] > 0 for c in bwd_sass.values()),
          f"no HGMMA in a bf16 attention backward kernel: {bwd_sass}")
    emit(build={"wall_s": wall, "kernels": {
        k.name: {"seconds": k.build_seconds,
                 "ptxas": [ln.strip() for ln in k.build_log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "C7512" in ln]}
        for k in kernels}, "flash_attention_tc_sass": sass,
        "flash_attention_bwd_sass": bwd_sass})


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
    for dev, n in ((device, PREFIX), (device, PARITY_EVENTS),
                   (torch.device("cpu"), PARITY_EVENTS)):
        sink = WriteBehindSink(cfg, n_partitions=4, device=dev)
        t0 = time.perf_counter()
        state, info = run_stream(cfg, init_state(N_KEYS, len(cfg.taus),
                                                 device=dev),
                                 keys[:n], qs[:n], ts[:n], batch=EXACT_BATCH,
                                 mode="exact", rng=prng_key(7), sink=sink)
        sink.flush()
        sink.close()
        out.append((state_to_numpy(state), [x.cpu() for x in info[:4]],
                    _store_bytes(sink), time.perf_counter() - t0,
                    int(info.writes)))
        if not out[1:]:
            check_no_plain_steps("exact mode")
            launched = trmw.keyed_launches
    (gs, gi, gb, gt, gw), (ps, pi, pb, pt, _), (cs, ci, cb, ct, _) = out
    n_chunks = PREFIX // EXACT_BATCH * (-(-EXACT_BATCH // 256) + rounds)
    check(launched == n_chunks,
          f"exact mode: {launched} keyed launches for {n_chunks} chunks")
    for name, a, b in zip(("z", "p", "lam_hat", "features"), pi, ci):
        check(bitwise_equal(a, b), f"exact {name}: cuda != cpu")
    for name, a, b in zip(ps._fields, ps, cs):
        check(np.array_equal(a.view(np.uint8), b.view(np.uint8)),
              f"exact state {name}: cuda != cpu")
    check(pb == cb and len(pb) > 0, "exact sink bytes: cuda != cpu")
    emit(parity_exact={"events": PREFIX, "batch": EXACT_BATCH,
                       "exact_rounds": rounds, "policy": "pp_vr",
                       "keyed_write_back_launches": launched,
                       "writes": gw, "rows_stored": len(gb),
                       "cuda_s": gt, "cpu_parity_events": PARITY_EVENTS,
                       "bitwise": True, "parity_cuda_s": pt, "cpu_s": ct})
    exact_ref = (gs, gi, gb)      # phase 9 (b) and (f) hold to the card's

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
    return exact_ref


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


def card_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def max_per_key_in_window(keys, width):
    """The most events one key has among any ``width`` consecutive events
    — the ``exact_rounds`` that no batching of at most ``width`` events
    exceeds."""
    keys = np.asarray(keys, np.int64)
    n = keys.size
    pos = np.arange(n, dtype=np.int64)
    order = np.lexsort((pos, keys))
    combo = keys[order] * n + pos[order]              # ascending
    lo = keys[order] * n + np.maximum(pos[order] - (width - 1), 0)
    return int((np.arange(n) - np.searchsorted(combo, lo) + 1).max())


def phase_frontend(device, stream):
    """Phase 8: the online scoring frontend at the iiot deployment's full
    state size — capacity, open loop, exact mode, resident threaded
    admission, the crash victim on the card, checkpoints."""
    import signal
    import tempfile

    from repro_torch.checkpoint import (CheckpointManager,
                                        repartition_profile_state)
    from repro_torch.core import init_state, prng_key, run_stream
    from repro_torch.features.spec import ProfileSpec
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.serving import pipeline
    from repro_torch.serving.frontend import (ServingFrontend,
                                              make_requests,
                                              poisson_arrivals,
                                              score_at_width)
    from repro_torch.streaming import faults
    from repro_torch.streaming.durable import DurableStore

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    card = card_name_and_limit()
    n = FE_EVENTS
    keys, qs, ts = (x[:n] for x in (stream.key, stream.q, stream.t))
    spec = ProfileSpec(kde_bandwidth=3600.0, write_budget_per_min=0.1 / 60,
                       policy="pp")
    cfg = spec.engine_config()
    T = len(cfg.taus)
    pipe = pipeline.ScoringPipeline.build(spec, N_KEYS, mode="fast",
                                          device=device)
    pipe.scorer = pipeline.init_scorer(torch.Generator().manual_seed(0),
                                       spec.feature_dim,
                                       hidden=SCORER_HIDDEN, device=device)
    rng = prng_key(0)
    fields = ("z", "p", "lam_hat", "features")
    emit(frontend_setup={
        "card": card, "regime": "iiot", "keys": N_KEYS,
        "state_mb": N_KEYS * (4 + 3 * T) * 4 / 1e6, "policy": "pp",
        "windows": len(cfg.taus), "lambda_h": 0.1, "batch": FE_BATCH,
        "max_wait_s": FE_WAIT_S, "scorer_hidden": SCORER_HIDDEN,
        "slots_d": N_SLOTS, "reduced": {
            "events": f"the first {n} of the {len(stream.key)}-event "
                      f"stream (phase 3's parity prefix)",
            "exact_events": f"(c) the first {FE_EXACT_EVENTS}"}})

    def serve_run(step, run, k, launches_per_dispatch=1):
        """Time one frontend run (its outputs reach the host before it
        returns); check its launches; return its record."""
        sink = pipe.make_sink()
        torch.cuda.synchronize()
        before = trmw.keyed_launches
        t0 = time.perf_counter()
        res = run(sink)
        wall = time.perf_counter() - t0
        snap = sink.flush()
        sink.close()
        launched = trmw.keyed_launches - before
        st = res.stats
        check(launched == launches_per_dispatch * st.dispatches,
              f"{step}: {launched} keyed launches for {st.dispatches} "
              f"dispatches")
        check(st.events == k and np.array_equal(np.sort(res.order),
                                                np.arange(k)),
              f"{step}: requests dropped or duplicated")
        check(bool(np.isfinite(res.scores).all())
              and bool(np.isfinite(res.features).all()),
              f"{step}: non-finite outputs")
        makespan = max(b.t_complete for b in res.batches)
        q = res.latency_quantiles()
        rec = {"step": step, "card": card, "events": k,
               "dispatches": st.dispatches, "full_batches": st.full_batches,
               "deadline_batches": st.deadline_batches,
               "mean_batch": st.events / st.dispatches,
               "max_queue": st.max_queue, "keyed_launches": launched,
               "makespan_s": makespan, "events_per_s": k / makespan,
               "first_dispatch_s": res.batches[0].t_dispatch,
               "wall_s": wall, "p50_ms": 1e3 * q["p50"],
               "p99_ms": 1e3 * q["p99"], "p999_ms": 1e3 * q["p999"],
               "puts": snap["puts"], "puts_per_event": snap["puts"] / k,
               "durable_gets": snap["gets"], "gets_per_event": snap["gets"] / k}
        return res, rec, launched

    def same(a, b, what, k=n):
        for f in fields:
            check(np.array_equal(getattr(a, f)[:k].view(np.uint8),
                                 getattr(b, f)[:k].view(np.uint8)),
                  f"{what}: {f} differs")

    # warm-up: a short burst, so the timed runs do not pay for the
    # first dispatch's allocations and cuBLAS set-up
    w = 4 * FE_BATCH
    wsink = pipe.make_sink()
    pipe.serve(keys[:w], qs[:w], ts[:w], arrival_s=np.zeros(w),
               batch=FE_BATCH, max_wait_s=FE_WAIT_S, rng=rng, sink=wsink)
    wsink.close()

    reset_counts()                          # the frontend path starts here
    keyed = 0
    # (a) capacity: every request at 0, so every batch is full; the
    # frontend is built directly to keep its final state for (f)
    requests = make_requests(keys, qs, ts, np.zeros(n))
    a_run = {}

    def run_a(sink):
        fe = ServingFrontend(cfg, init_state(N_KEYS, T, device=device),
                             batch=FE_BATCH, max_wait_s=FE_WAIT_S,
                             mode="fast", rng=rng, sink=sink,
                             scorer=pipe.scorer)
        res = fe.run(requests)
        sink.flush()
        a_run.update(fe=fe, stored=_store_bytes(sink))
        return res

    res_a, rec, launched = serve_run("a_capacity", run_a, n)
    fe, a_bytes = a_run["fe"], a_run["stored"]
    keyed += launched
    check(res_a.stats.full_batches == n // FE_BATCH, "(a): a batch was cut")
    capacity = rec["events_per_s"]
    sink_c = pipe.make_sink()
    state_c, info = run_stream(cfg, init_state(N_KEYS, T, device=device),
                               keys, qs, ts, batch=FE_BATCH, mode="fast",
                               rng=rng, sink=sink_c)
    sink_c.flush()
    closed = {f: getattr(info, f).cpu().numpy() for f in fields}
    closed_scores = np.concatenate([
        score_at_width(pipe.scorer, info.features[i:i + FE_BATCH], FE_BATCH)
        for i in range(0, n, FE_BATCH)])
    for f in fields:
        check(np.array_equal(getattr(res_a, f).view(np.uint8),
                             closed[f].view(np.uint8)),
              f"(a) vs run_stream: {f} differs")
    check(np.array_equal(res_a.scores.view(np.uint32),
                         closed_scores.view(np.uint32)),
          "(a) vs run_stream: scores differ")
    check(a_bytes == _store_bytes(sink_c) and len(a_bytes) > 0,
          "(a) vs run_stream: stored bytes differ")
    sink_c.close()
    for name, x, y in zip(state_c._fields, fe.state, state_c):
        check(bitwise_equal(x, y), f"(a) vs run_stream: state {name}")
    del info, state_c
    rec["bitwise_vs_run_stream"] = True
    emit(frontend=rec)

    # (b) open loop: Poisson arrivals at fractions of (a)'s capacity; the
    # replay runs the frontend's own dispatch boundaries closed-loop
    for i, frac in enumerate(FE_LOADS):
        rate = frac * capacity
        arrivals = poisson_arrivals(n, rate, seed=8 + i)
        res, rec, launched = serve_run(
            f"b_open_loop_{frac}", lambda sink: pipe.serve(
                keys, qs, ts, arrival_s=arrivals, batch=FE_BATCH,
                max_wait_s=FE_WAIT_S, rng=rng, sink=sink), n)
        keyed += launched
        state = init_state(N_KEYS, T, device=device)
        want = {f: np.zeros_like(getattr(res, f)) for f in fields}
        want_scores = np.zeros_like(res.scores)
        pos = 0
        for b in res.batches:
            rids = res.order[pos:pos + b.size]
            pos += b.size
            state, info = run_stream(cfg, state, keys[rids], qs[rids],
                                     ts[rids], batch=FE_BATCH, mode="fast",
                                     rng=rng)
            for f in fields:
                want[f][rids] = getattr(info, f).cpu().numpy()
            want_scores[rids] = score_at_width(pipe.scorer, info.features,
                                               FE_BATCH)
        for f in fields:
            check(np.array_equal(getattr(res, f).view(np.uint8),
                                 want[f].view(np.uint8)),
                  f"(b) {frac}: {f} differs from the replay")
        check(np.array_equal(res.scores.view(np.uint32),
                             want_scores.view(np.uint32)),
              f"(b) {frac}: scores differ from the replay")
        rec.update(offered_per_s=rate, load=frac,
                   deadline_share=rec["deadline_batches"] / rec["dispatches"],
                   bitwise_vs_replay_at_own_boundaries=True)
        emit(frontend=rec)
        del state, info

    # (c) exact mode at half capacity; exact_rounds covers any batch cut
    k = FE_EXACT_EVENTS
    rounds = max_per_key_in_window(keys[:k], FE_BATCH)
    epipe = pipeline.ScoringPipeline.build(spec, N_KEYS, mode="exact",
                                           device=device,
                                           exact_rounds=rounds)
    epipe.scorer = pipe.scorer
    ecfg = epipe.engine.cfg
    arrivals = poisson_arrivals(k, FE_LOADS[0] * capacity, seed=10)
    res, rec, write_back = serve_run(
        "c_exact", lambda sink: epipe.serve(
            keys[:k], qs[:k], ts[:k], arrival_s=arrivals, batch=FE_BATCH,
            max_wait_s=FE_WAIT_S, rng=rng, sink=sink), k,
        launches_per_dispatch=1 + rounds)
    _, info = run_stream(ecfg, init_state(N_KEYS, T, device=device),
                         keys[:k], qs[:k], ts[:k], batch=FE_BATCH,
                         mode="exact", rng=rng)
    for f in fields:
        check(np.array_equal(getattr(res, f).view(np.uint8),
                             getattr(info, f).cpu().numpy().view(np.uint8)),
              f"(c) vs exact run_stream: {f} differs")
    rec.update(exact_rounds=rounds, write_back_launches=write_back,
               offered_per_s=FE_LOADS[0] * capacity,
               bitwise_vs_run_stream=True)
    emit(frontend=rec)
    del info

    # (d) resident, threaded admission, every request at 0
    res, rec, launched = serve_run(
        "d_resident_threaded", lambda sink: pipe.serve(
            keys, qs, ts, arrival_s=np.zeros(n), batch=FE_BATCH,
            max_wait_s=FE_WAIT_S, rng=rng, sink=sink, residency=N_SLOTS,
            admission="threaded"), n)
    keyed += launched
    same(res, res_a, "(d) vs (a)")
    check(np.array_equal(res.scores.view(np.uint32),
                         res_a.scores.view(np.uint32)),
          "(d) vs (a): scores differ")
    st = res.stats
    rec.update(slots=N_SLOTS, prefetch_issued=st.prefetch_issued,
               prefetch_hits=st.prefetch_hits,
               prefetch_rehydrations=st.prefetch_rehydrations,
               demand_reads=st.demand_reads, bitwise_vs_a=True)
    emit(frontend=rec)
    check_no_plain_steps("the frontend phase")

    # (e) the SIGKILL victim on the card, recovered against the card
    for mode in ("fast", "exact"):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            rc, acked, err = faults.spawn_kill_mid_flush(
                os.path.join(d, "victim"), policy="pp", mode=mode,
                kill_at_write=2, device="cuda")
            victim_s = time.perf_counter() - t0
            check(rc == -signal.SIGKILL and acked > 0,
                  f"(e) {mode}: victim exited {rc} after {acked} events: "
                  f"{err[-2000:]}")
            with DurableStore(os.path.join(d, "victim")) as rec_store:
                ref = faults.run_reference("pp", mode, acked, device="cuda")
                check(rec_store.data == ref.data and len(ref.data) > 0,
                      f"(e) {mode}: the recovered store differs")
                torn = rec_store.durable.torn_tails
        emit(frontend={"step": f"e_crash_{mode}", "card": card,
                       "rc": rc, "acked_events": acked, "torn_tails": torn,
                       "rows": len(ref.data), "victim_s": victim_s,
                       "recovered_bitwise": True})

    # (f) checkpoint (a)'s final state, restore it onto the card, and
    # repartition 1 -> 4 -> 1 shards
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_io=False)
        t0 = time.perf_counter()
        mgr.save(1, fe.state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = mgr.restore(fe.state, device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    for name, x, y in zip(fe.state._fields, restored, fe.state):
        check(x.device == device and bitwise_equal(x, y),
              f"(f) restored {name} differs")
    t0 = time.perf_counter()
    grown = repartition_profile_state(restored, old_shards=1, new_shards=4,
                                      device=device)
    back = repartition_profile_state(grown, old_shards=4, new_shards=1,
                                     num_keys=N_KEYS, device=device)
    torch.cuda.synchronize()
    repartition_s = time.perf_counter() - t0
    e_local = -(-N_KEYS // 4)
    ks = torch.arange(N_KEYS, device=device)
    rows = (ks % 4) * e_local + ks // 4
    for name, g, x, y in zip(fe.state._fields, grown, back, restored):
        check(bitwise_equal(g[rows], y) and bitwise_equal(x, y),
              f"(f) repartition 1 -> 4 -> 1: {name} differs")
    emit(frontend={"step": "f_checkpoint", "card": card,
                   "state_mb": sum(x.numel() * 4 for x in fe.state) / 1e6,
                   "save_s": save_s, "restore_s": restore_s,
                   "repartition_1_4_1_s": repartition_s,
                   "restored_bitwise": True, "repartition_bitwise": True})
    check_no_plain_steps("the frontend phase")
    return {"keyed": keyed, "write_back": write_back}


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


def device_ms(fn, reps: int, sessions: int = 2):
    """Device milliseconds per call of ``fn``: the summed durations of the
    GPU kernels (and memory operations) that ``reps`` calls launch, under
    ``torch.profiler`` after a warm-up, so host time between them is left
    out; None where the profiler records no device activity.  The larger
    of ``sessions`` profiles: a session can miss a kernel's records (one
    missed cuDNN's forward kernel on every call), never add one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            ms = sum(spans) / 1e3 / reps
            best = ms if best is None else max(best, ms)
    return best


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

    gen = torch.Generator(device=device).manual_seed(8)
    S, W = PROMPT, 2048
    q, k, v = (torch.randn(batch, h, S, 256, generator=gen, device=device,
                           dtype=torch.bfloat16) for h in (10, 1, 1))
    pos = torch.arange(S, device=device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    call = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)
    return time_backends(call, with_math=True)


def time_backends(call, with_math: bool) -> dict:
    """``call`` (one ``scaled_dot_product_attention``) timed under each
    backend alone (``None`` where the backend refuses the inputs), and the
    backend the default dispatch picks, named by the kernels it launches
    (when the math backend is not timed, it is the one left)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    times, kernels = {}, {}
    for backend in backends + ([SDPBackend.MATH] if with_math else []):
        try:
            with sdpa_kernel([backend]):
                kernels[backend.name] = device_kernels(call)
                times[backend.name] = cuda_ms(call, 10)
        except RuntimeError:
            times[backend.name] = None
    default = device_kernels(call)
    picked = [name for name, ks in kernels.items() if ks == default]
    return {"ms": times,
            "default": picked[0] if picked else
            (None if with_math else "MATH"),
            "default_kernels": sorted(name[:100] for name in default)}


def model_attention_shapes():
    """(label, H, Kh, Skv, D, causal) of each phase-10 and phase-11 model's
    prefill attention at batch 2 over a 4096-token prompt."""
    return [(a, h, kh, PROMPT, d, c) for a, (h, kh, d, c)
            in DENSE_ATTN.items()] + \
        [(a, *shape) for a, shape in MOE_VISION_ATTN.items()]


def sdpa_dense_backends(device) -> dict:
    """``scaled_dot_product_attention`` at each phase-10 and phase-11
    model's prefill shape (``is_causal`` or none, no mask, ``enable_gqa``)
    through ``time_backends``; the math backend is left out (the plain
    version's time stands for it).  Run after the serving phases, like
    ``sdpa_backends``."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(9)
    out = {}
    for arch, H, Kh, Skv, D, causal in model_attention_shapes():
        q = torch.randn(SERVE_BATCH, H, PROMPT, D, generator=gen,
                        device=device, dtype=torch.bfloat16)
        k, v = (torch.randn(SERVE_BATCH, Kh, Skv, D, generator=gen,
                            device=device, dtype=torch.bfloat16)
                for _ in range(2))
        out[arch] = time_backends(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
            with_math=False)
        del q, k, v
    return out


def phase_serving_kernels(device):
    """Phase 4: decay_scan and flash_attention against their plain
    versions on the card, then their times at the serving shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(4)
    cases = 0
    for T, C in [(T, C) for T in SCAN_T for C in SCAN_C] + [SSD_SCAN]:
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
        del q, k, v, mask

    # the new paths' shapes: Mamba-2's chunk recurrence (the chunk decay
    # broadcast over N x P makes ``a`` a full [T, C] read) and each
    # phase-10 and phase-11 model's prefill attention
    T, C = SSD_SCAN
    a = torch.rand(T, C, generator=gen, device=device)
    u = torch.randn(T, C, generator=gen, device=device)
    times["decay_scan"]["mamba2-2.7b"] = {
        "shape": [T, C], "ms": graph_ms(lambda: ds.decay_scan_cuda(a, u),
                                        10, 5),
        "plain_ms": cuda_ms(lambda: ref.decay_scan_ref(a, u), 3),
        "bound_ms": 1e3 * 12 * T * C / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": None}
    del a, u
    for arch, H, Kh, Skv, D, causal in model_attention_shapes():
        B, S = SERVE_BATCH, PROMPT
        q = torch.randn(B, H, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(B, Kh, Skv, D, generator=gen, device=device,
                            dtype=torch.bfloat16) for _ in range(2))
        bound, by = attention_bound(B, H, Kh, S, Skv, D, causal, 0, 2)
        times["flash_attention"][arch] = {
            "shape": [B, H, Kh, S, Skv, D], "causal": causal,
            "dtype": "bfloat16",
            "ms": cuda_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal), 10),
            "plain_ms": cuda_ms(lambda: ref.attention_ref(
                q, k, v, causal=causal), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 10),
            "bound_ms": bound, "bound_by": by}
        del q, k, v
        torch.cuda.empty_cache()
    emit(serving_kernel_times=times)
    return worst, times


def on_device(tensors, device) -> bool:
    return all(t.device == device for t in tensors)


def drive_request(run, params, prompts, steps, dtype=torch.bfloat16,
                  image_embeds=None, layer_metrics=None):
    """One request on the serving path: the prefill of ``prompts`` (with
    ``image_embeds`` for the vision family; each layer's MoE metrics into
    ``layer_metrics``), then ``steps`` greedy decode steps, computed in
    ``dtype``.  The kernels' counts are set to 0 just before and read just
    after.  Returns the logits of each step (the prefill's first), the
    tokens fed, the last state, the prefill's and the decode's seconds and
    the launch counts."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import make_serve_step, sample_token

    vocab = run.model.vocab_size
    prefill = make_serve_step(run, "prefill", compute_dtype=dtype,
                              max_len=prompts.shape[1] + steps)
    decode = make_serve_step(run, "decode", compute_dtype=dtype)
    ds.launches = fa.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, prompts, image_embeds, layer_metrics)
    tok = sample_token(logits, None, temperature=0.0, vocab_size=vocab)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_logits, fed = [logits], []
    t0 = time.perf_counter()
    for _ in range(steps):
        fed.append(tok)
        logits, state = decode(params, state, tok)
        tok = sample_token(logits, None, temperature=0.0, vocab_size=vocab)
        step_logits.append(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {"decay_scan": ds.launches, "flash_attention": fa.launches}
    return step_logits, fed, state, prefill_s, decode_s, launches


def teacher_forced(params, cfg, prompts, fed, step_logits, expected, *,
                   dtype=torch.bfloat16, limit=DECODE_REL_L2,
                   image_embeds=None):
    """Each step's logits against a forward over prompt + fed tokens in
    ``dtype``, at the positions the prefill and the decode steps predicted
    from, within a relative L2 error of ``limit`` (None: measured only);
    the forward must launch the kernels ``expected`` times."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone

    ds.launches = fa.launches = 0
    P = prompts.shape[1]
    t0 = time.perf_counter()
    seq = torch.cat([prompts] + fed, dim=1)
    hidden = backbone.forward_hidden(params, cfg, seq, compute_dtype=dtype,
                                     image_embeds=image_embeds)
    want = backbone.logits_from_hidden(params, cfg,
                                       hidden[:, P - 1:P + len(fed)])
    torch.cuda.synchronize()
    teacher_s = time.perf_counter() - t0
    launches = {"decay_scan": ds.launches, "flash_attention": fa.launches}
    check(launches == expected, f"{cfg.name}: teacher-forced forward "
          f"launched {launches}, expected {expected}")
    rel, err, agree = [], [], 0
    V = cfg.vocab_size                  # the padding's -1e30 left out
    for i, got in enumerate(step_logits):
        got, w = got[:, :V], want[:, i, :V]
        rel.append(float((got - w).norm() / w.norm()))
        err.append(float((got - w).abs().max()))
        agree += int((got.argmax(-1) == w.argmax(-1)).sum())
    check(limit is None or max(rel) <= limit, f"{cfg.name}: decode vs "
          f"teacher-forced ({dtype}): relative L2 error {max(rel)}")
    return teacher_s, {"dtype": str(dtype).split(".")[-1],
                       "max_rel_l2": max(rel), "rel_l2_by_step": rel,
                       "max_abs_err": max(err),
                       "max_abs_logit": float(want[..., :V].abs().max()),
                       "argmax_agree": agree / (prompts.shape[0]
                                                * len(step_logits)),
                       "rel_l2_limit": limit}


def kernel_launches(cfg) -> dict:
    """The launches one prefill (or forward) of ``cfg`` must make: one
    scan per ``rec`` and ``ssd`` layer, one attention per ``attn``,
    ``moe`` and ``cross`` layer."""
    from repro_torch.models import backbone

    kinds = backbone.layer_plan(cfg).kinds
    return {"decay_scan": kinds.count("rec") + kinds.count("ssd"),
            "flash_attention": sum(kinds.count(k)
                                   for k in ("attn", "moe", "cross"))}


def seeded_model(run, device, seed):
    """Fresh seeded bfloat16 weights on the card, and the seconds taken."""
    from repro_torch.models import backbone

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = backbone.init_params(run.model, gen, torch.bfloat16, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in params.parameters())
    check(n_params == backbone.count_params(run.model),
          f"{run.model.name}: {n_params} parameters")
    check(on_device(params.parameters(), device),
          f"{run.model.name}: a parameter is off card")
    return params, gen, n_params, init_s


def serve_on_card(run, params, prompts, steps, device, image_embeds=None,
                  layer_metrics=None):
    """A warm-up request (the model's first prefill also pays for the
    allocator's growth and cuBLAS's first calls: its time is the cold
    one), then the main request, checked for its launches, finite logits
    and parameters and caches on the card.  Returns the main request's
    ``drive_request`` result and its record."""
    cfg = run.model
    with torch.inference_mode():
        cold_prefill_s = drive_request(run, params, prompts, 1,
                                       image_embeds=image_embeds)[3]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        out = drive_request(run, params, prompts, steps,
                            image_embeds=image_embeds,
                            layer_metrics=layer_metrics)
    step_logits, _, state, prefill_s, decode_s, launches = out
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    check(launches == kernel_launches(cfg),
          f"{cfg.name}: launches {launches} for one prefill, expected "
          f"{kernel_launches(cfg)}")
    check(all(bool(torch.isfinite(x).all()) for x in step_logits),
          f"{cfg.name}: non-finite logits")
    caches = [x for c in state.layers for x in c]
    check(on_device(caches, device), f"{cfg.name}: a cache left the card")
    check(on_device(params.parameters(), device),
          f"{cfg.name}: a parameter left the card")
    B, S = prompts.shape
    return out, {"launches_per_prefill": launches,
                 "cold_prefill_s": cold_prefill_s,
                 "prefill_tok_per_s": B * S / prefill_s,
                 "decode_tok_per_s": B * steps / decode_s,
                 "prefill_s": prefill_s, "decode_s": decode_s,
                 "peak_mem_gb": peak_gb}


def phase_serve(device):
    """Phase 5: full-width, full-depth recurrentgemma-2b serving 2
    requests at batch 2 on the card, checked against a teacher-forced
    forward."""
    from repro_torch.configs.base import load_config

    run = load_config(ARCH)
    cfg = run.model
    params, gen, n_params, init_s = seeded_model(run, device, 0)
    check(n_params == N_PARAMS, f"{n_params} parameters")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                            generator=gen, device=device)
    out, rec = serve_on_card(run, params, prompts, NEW_TOKENS, device)
    step_logits, fed = out[:2]
    with torch.inference_mode():
        teacher_s, agree = teacher_forced(params, cfg, prompts, fed,
                                          step_logits, kernel_launches(cfg))
    emit(serve={
        "arch": ARCH, "params": n_params, "dtype": "bfloat16",
        "batch": SERVE_BATCH, "prompt": PROMPT, "decode_steps": NEW_TOKENS,
        **rec, "init_s": init_s, "teacher_forced_s": teacher_s,
        "vs_teacher_forced": agree})
    return rec["launches_per_prefill"]


def phase_blocks(device):
    """Phase 6: one full-width block of each kind in float32, the card
    with its kernels against the CPU with the plain versions: RG-LRU and
    local attention (recurrentgemma-2b), attention with qk-norm, D 128 and
    GQA groups of 4 (qwen3-4b), SSD (mamba2-2.7b, nine chunks)."""
    import copy

    from repro_torch.configs.base import load_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone, common

    gen = torch.Generator().manual_seed(6)
    positions = torch.arange(BLOCK_S)
    out = {}
    for arch, kind, counter in BLOCK_CASES:
        cfg = load_config(arch).model
        counter = {"decay_scan": ds, "flash_attention": fa}[counter]
        x = torch.randn(1, BLOCK_S, cfg.d_model, generator=gen)
        p_cpu = common.Params(common.init_tree(
            backbone.block_specs(kind, cfg), gen, torch.float32, "cpu"))
        p_card = copy.deepcopy(p_cpu).to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            want, _, wcache = backbone.apply_block(kind, p_cpu, x, cfg,
                                                   positions,
                                                   collect_cache=True)
            cpu_s = time.perf_counter() - t0
            before = counter.launches
            t0 = time.perf_counter()
            got, _, gcache = backbone.apply_block(
                kind, p_card, x.to(device), cfg, positions.to(device),
                collect_cache=True)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        check(counter.launches == before + 1,
              f"{arch} {kind} block: {counter.launches - before} kernel "
              f"launches")
        worst = 0.0
        for name, g, w in [("out", got, want)] + [
                (f"cache{i}", g, w) for i, (g, w) in
                enumerate(zip(gcache, wcache))]:
            nw = max_abs_err(g, w) / float(w.abs().max())
            check(nw <= BLOCK_TOL[kind],
                  f"{arch} {kind} block {name}: card vs CPU normwise {nw}")
            worst = max(worst, nw)
        key = kind if arch == ARCH else f"{arch}/{kind}"
        out[key] = {"normwise_err": worst, "limit": BLOCK_TOL[kind],
                    "d_model": cfg.d_model, "cpu_s": cpu_s,
                    "card_s": card_s}
    emit(blocks={"S": BLOCK_S, "dtype": "float32", **out})


def phase_families(device):
    """Phase 10: the dense, SSM and audio families served on the card in
    bfloat16 with fresh seeded weights, one model at a time (each freed
    before the next).  Returns the launches of each model's main path."""
    import dataclasses as dc

    from repro_torch.configs.base import load_config
    from repro_torch.models import backbone

    card = card_name_and_limit()
    launches = {}
    for arch, layers, batch, length, steps in FAMILIES:
        run = load_config(arch)
        full = run.model
        if layers is not None:
            run = dc.replace(run, model=dc.replace(full, num_layers=layers))
        cfg = run.model
        params, gen, n_params, init_s = seeded_model(run, device, 10)
        rec = {"arch": arch, "family": cfg.family, "params": n_params,
               "dtype": "bfloat16", "batch": batch, "length": length,
               "init_s": init_s, "card": card}
        if layers is not None:
            rec["reduced"] = {"num_layers": [full.num_layers, layers],
                              "params_full_depth":
                                  backbone.count_params(full)}
        if not cfg.causal:
            rec.update(encode_on_card(run, params, gen, batch, length,
                                      device))
        else:
            prompts = torch.randint(0, cfg.vocab_size, (batch, length),
                                    generator=gen, device=device)
            out, serve_rec = serve_on_card(run, params, prompts, steps,
                                           device)
            rec.update(serve_rec, decode_steps=steps)
            if arch in TEACHER_FORCED:
                rec.update(check_teacher_forced(run, params, gen, out,
                                                prompts, device))
            del out, prompts
        launches[arch] = rec.get("launches_per_prefill",
                                 rec.get("launches_per_encode"))
        emit(family_serve=rec)
        del params
        torch.cuda.empty_cache()
    return launches


def check_teacher_forced(run, params, gen, out, prompts, device):
    """The decode logits against a teacher-forced forward, in bfloat16
    within ``DECODE_REL_L2``, as phase 5.

    Mamba-2 differs in two ways.  Its SSD prefill needs S a multiple of
    min(ssm_chunk, S), which prompt + 31 fed tokens is not, so it is
    checked on a second, short request at full width whose prompt + fed
    tokens make one chunk (no padding, the chunking unchanged).  And in
    bfloat16 its recurrent decode (a float32 state) drifts from the
    chunked forward (products rounded to bfloat16) by more than
    ``DECODE_REL_L2`` on random weights, in the JAX reference as in the
    port (``tests/test_torch_mamba2.py::
    test_bf16_decode_drift_is_the_references``).  So its bfloat16 drift
    is measured and printed, and the gate is the same request computed in
    float32, where decode and forward agree to rounding: ``F32_REL_L2``
    (``short_request_checks``)."""
    cfg = run.model
    expected = kernel_launches(cfg)
    if cfg.family != "ssm":
        step_logits, fed = out[:2]
        with torch.inference_mode():
            teacher_s, agree = teacher_forced(params, cfg, prompts, fed,
                                              step_logits, expected)
        return {"teacher_forced_s": teacher_s,
                "teacher_forced_tokens": prompts.shape[1] + len(fed),
                "vs_teacher_forced": agree}
    prompts = torch.randint(0, cfg.vocab_size,
                            (prompts.shape[0], SSD_CHECK_PROMPT),
                            generator=gen, device=device)
    return short_request_checks(run, params, prompts, None)


def short_request_checks(run, params, prompts, bf16_limit,
                         image_embeds=None):
    """A short request (``prompts``, then ``NEW_TOKENS`` greedy steps)
    against its teacher-forced forward twice: in bfloat16 within
    ``bf16_limit`` (None: the drift is measured and printed only), and in
    float32 (the bfloat16 weights upcast in each product) within
    ``F32_REL_L2``.  Each run must launch the kernels as the plan says.

    Routing is discontinuous: the two sides round the hidden states apart,
    and where the router is near a tie one picks other experts than the
    other, an order-1 change that later layers carry to every later
    position.  So a MoE model's forward takes the request's own expert
    choices (``router_calls``), and the limit holds every step; each token
    and layer where the forward's own top k differs must be a near tie
    (``routing_flips``); the drift of a forward that routes for itself is
    printed beside it."""
    from repro_torch.models import backbone

    cfg = run.model
    expected = kernel_launches(cfg)
    B, P = prompts.shape
    L = backbone.layer_plan(cfg).kinds.count("moe")
    rec = {"teacher_forced_tokens": P + NEW_TOKENS}
    for dtype, limit in ((torch.bfloat16, bf16_limit),
                         (torch.float32, F32_REL_L2)):
        name = str(dtype).split(".")[-1]
        with torch.inference_mode(), router_calls() as serve:
            step_logits, fed, _, _, _, launches = drive_request(
                run, params, prompts, NEW_TOKENS, dtype, image_embeds)
        check(launches == expected,
              f"{cfg.name}: short request launched {launches}")
        forced = serve_routing(serve, L, B, P, NEW_TOKENS) if L else None
        with torch.inference_mode(), router_calls(
                None if forced is None else forced[1]) as forward:
            teacher_s, agree = teacher_forced(
                params, cfg, prompts, fed, step_logits, expected,
                dtype=dtype, limit=limit, image_embeds=image_embeds)
        if L:
            agree["routing"] = routing_flips(*forced, forward, B,
                                             P + NEW_TOKENS)
            with torch.inference_mode():
                agree["free_routing"] = teacher_forced(
                    params, cfg, prompts, fed, step_logits, expected,
                    dtype=dtype, limit=None, image_embeds=image_embeds)[1]
        rec[f"teacher_forced_s_{name}"] = teacher_s
        rec[f"vs_teacher_forced_{name}"] = agree
    return rec


@contextlib.contextmanager
def router_calls(forced=None):
    """The router logits over the logical experts (float32, [T, E]) and
    the expert ids it chose ([T, k]) at every ``ffn.route_over`` call in
    the block, in order.  With ``forced`` (one [T, k] id tensor a call),
    the i-th call goes on with ``forced[i]``'s experts instead of its own,
    weighted by its own probabilities renormalised over them; the record
    keeps its own choice."""
    from repro_torch.models import ffn

    calls, inner = [], ffn.route_over

    def recorded(logits, num_experts, top_k, groups):
        gate_w, eid, aux, z = inner(logits, num_experts, top_k, groups)
        logits = logits[:, :num_experts]
        calls.append((logits, eid))
        if forced is not None:
            eid = forced[len(calls) - 1]
            gate_w = torch.softmax(logits, dim=-1).gather(1, eid)
            gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True),
                                              1e-9)
        return gate_w, eid, aux, z
    ffn.route_over = recorded
    try:
        yield calls
    finally:
        ffn.route_over = inner


def serve_routing(serve, L, B, P, N):
    """A request's router calls (its prefill over B x P tokens, then N
    decode steps of B tokens, one call a MoE layer each) as one call a
    layer over the P + N positions, in the forward's token order: (router
    logits [B (P + N), E] a layer, expert ids [B (P + N), k] a layer)."""
    check(len(serve) == L * (N + 1),
          f"{len(serve)} router calls for {L} MoE layers and {N} steps")

    def by_layer(l, j):
        parts = [serve[l][j].view(B, P, -1)] + [
            serve[L * (n + 1) + l][j].view(B, 1, -1) for n in range(N)]
        return torch.cat(parts, 1).flatten(0, 1)
    return ([by_layer(l, 0) for l in range(L)],
            [by_layer(l, 1) for l in range(L)])


def routing_flips(s_logits, s_ids, forward, B, Q) -> dict:
    """The request's routing (``serve_routing``) against the choices the
    forward would have made on its own router logits (``forward``: its
    ``router_calls``, one a layer over the B x Q tokens).  A flip is a
    (token, layer) where the two top-k sets differ.  Each flip must be a
    near tie: the forward's logits of the swapped experts differ by at
    most twice the largest difference of the two sides' logits there, as
    they must if each side took the top k of its own logits, and those
    logits agree within ``DECODE_REL_L2``."""
    gaps, diffs, rels, where = [], [], [], []
    for l, (s, ids, (f, fids)) in enumerate(zip(s_logits, s_ids, forward)):
        flipped = (ids.sort(-1).values != fids.sort(-1).values).any(-1)
        for t in flipped.nonzero().flatten().tolist():
            S, F = set(ids[t].tolist()), set(fids[t].tolist())
            gaps.append(float(f[t, sorted(F - S)].min()
                              - f[t, sorted(S - F)].max()))
            diffs.append(float((s[t] - f[t]).abs().max()))
            rels.append(float((s[t] - f[t]).norm() / f[t].norm()))
            where.append([t // Q, t % Q, l])          # row, position, layer
            check(gaps[-1] <= 2 * diffs[-1] + 1e-6 * float(f[t].abs().max())
                  and rels[-1] <= DECODE_REL_L2,
                  f"routing flip at (row, position, layer) {where[-1]} is "
                  f"no near tie: gap {gaps[-1]}, logits differ by "
                  f"{diffs[-1]} ({rels[-1]} relative)")
    return {"flips": len(where), "flips_at": where,
            "max_router_logit_gap": max(gaps, default=0.0),
            "max_router_logit_diff": max(diffs, default=0.0),
            "max_router_rel_l2": max(rels, default=0.0)}


def encode_on_card(run, params, gen, batch, length, device):
    """The encoder's request: ``batch`` x ``length`` random frames, once
    cold, then the timed encode with the kernels' counts set to 0 just
    before and read just after.  Logits must be finite, of shape
    [batch, length, padded vocab], and the vocab padding masked."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone
    from repro_torch.serving.engine import make_serve_step

    cfg = run.model
    encode = make_serve_step(run, "prefill", compute_dtype=torch.bfloat16)
    frames = torch.randn(batch, length, cfg.frame_dim, generator=gen,
                         device=device, dtype=torch.bfloat16)
    with torch.inference_mode():
        t0 = time.perf_counter()
        encode(params, frames)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
        ds.launches = fa.launches = 0
        t0 = time.perf_counter()
        logits = encode(params, frames)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        launches = {"decay_scan": ds.launches,
                    "flash_attention": fa.launches}
    Vp = backbone.padded_vocab(cfg)
    check(launches == kernel_launches(cfg),
          f"{cfg.name}: launches {launches} for one encode")
    check(tuple(logits.shape) == (batch, length, Vp),
          f"{cfg.name}: logits of shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"{cfg.name}: non-finite logits")
    check(bool((logits[..., cfg.vocab_size:] == -1e30).all()),
          f"{cfg.name}: vocab padding not masked")
    return {"launches_per_encode": launches,
            "logits_shape": list(logits.shape), "cold_encode_s": cold_s,
            "encode_s": encode_s, "frames_per_s": batch * length / encode_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9}


# ------------------------------------- phase 11: MoE and vision families
def draw_gates(params, gen) -> None:
    """The gates the reference starts at 0, drawn from ``gen`` instead:
    the cross layers' tanh gates from U(0.5, 1.5) (at 0 they would
    multiply cross-attention and its MLP by 0) and the shared experts'
    sigmoid gate from N(0, 1/d), so both reach the logits."""
    with torch.no_grad():
        for layer in params["layers"]:
            for name in ("gate_attn", "gate_mlp"):
                if name in layer:
                    layer[name].uniform_(0.5, 1.5, generator=gen)
            if "moe" in layer and "shared_gate" in layer["moe"]:
                g = layer["moe"]["shared_gate"]
                g.normal_(0.0, g.shape[0] ** -0.5, generator=gen)


@contextlib.contextmanager
def attention_calls():
    """(causal, Skv) of every ``ops.flash_attention`` call in the block,
    in order; the calls go on to the kernel."""
    from repro_torch.kernels import ops

    calls, inner = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((bool(kw["causal"]), int(k.shape[2])))
        return inner(q, k, v, **kw)
    ops.flash_attention = recorded
    try:
        yield calls
    finally:
        ops.flash_attention = inner


def phase_moe_vision(device):
    """Phase 11 (a)-(c): the MoE and vision families served on the card in
    bfloat16 with fresh seeded weights (non-zero gates), one model at a
    time, each freed before the next.  Returns the launches of each
    model's main path."""
    import dataclasses as dc

    from repro_torch.configs.base import load_config
    from repro_torch.models import backbone

    card = card_name_and_limit()
    launches = {}
    for arch, layers, steps, want_params in MOE_VISION:
        run = load_config(arch)
        full = run.model
        if layers is not None:
            run = dc.replace(run, model=dc.replace(full, num_layers=layers))
        cfg = run.model
        params, gen, n_params, init_s = seeded_model(run, device, 11)
        check(n_params == want_params, f"{arch}: {n_params} parameters")
        draw_gates(params, gen)
        kinds = backbone.layer_plan(cfg).kinds
        rec = {"arch": arch, "family": cfg.family, "params": n_params,
               "active_params": backbone.active_params(cfg),
               "dtype": "bfloat16", "batch": SERVE_BATCH, "prompt": PROMPT,
               "decode_steps": steps, "init_s": init_s, "card": card}
        if layers is not None:
            rec["reduced"] = {"num_layers": [full.num_layers, layers],
                              "params_full_depth":
                                  backbone.count_params(full)}
        image = None
        if cfg.family == "vlm":
            image = torch.randn(SERVE_BATCH, cfg.num_vision_tokens,
                                cfg.d_model, generator=gen, device=device,
                                dtype=torch.bfloat16)
            rec["image_embeds"] = list(image.shape)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                generator=gen, device=device)
        metrics = []
        with attention_calls() as calls:
            out, serve_rec = serve_on_card(run, params, prompts, steps,
                                           device, image, metrics)
        rec.update(serve_rec)
        # the main prefill's calls: causal over the prompt in every attn
        # and moe layer, non-causal over the vision tokens in every cross
        want = [(k != "cross", cfg.num_vision_tokens if k == "cross"
                 else PROMPT) for k in kinds]
        got = calls[-len(want):]
        check(got == want, f"{arch}: attention calls {got}")
        rec["attention_launches"] = {
            "causal": sum(c for c, _ in got),
            "non_causal": sum(not c for c, _ in got),
            "non_causal_skv": sorted({n for c, n in got if not c})}
        if "moe" in kinds:
            rec["moe_drop_frac_by_layer"] = [
                float(m["moe_drop_frac"]) for m, k in zip(metrics, kinds)
                if k == "moe"]
        del out
        short = torch.randint(0, cfg.vocab_size,
                              (SERVE_BATCH, MOE_CHECK_PROMPT),
                              generator=gen, device=device)
        rec.update(short_request_checks(run, params, short, DECODE_REL_L2,
                                        image))
        launches[arch] = rec["launches_per_prefill"]
        emit(moe_vision_serve=rec)
        del params, image, prompts, short
        torch.cuda.empty_cache()
    return launches


def ep_layer(cfg, device, seed):
    """One MoE layer of ``cfg`` at full width in bfloat16 (its shared
    expert's gate drawn too) and tokens [2, 4096, d], drawn from ``seed``
    on ``device``: the same in every process that asks the same card."""
    from repro_torch.models import common, ffn

    gen = torch.Generator(device=device).manual_seed(seed)
    tree = common.init_tree(
        ffn.moe_specs(cfg.d_model, cfg.moe_d_ff, cfg.num_experts_padded,
                      cfg.num_shared_experts), gen, torch.bfloat16, device)
    tree["shared_gate"].normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    x = torch.randn(SERVE_BATCH, PROMPT, cfg.d_model, generator=gen,
                    device=device, dtype=torch.bfloat16)
    return tree, x


def _p11_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase11_ep_rank(mesh, p):
    """(d) on one rank: ``moe_ep`` over a ``("model",)`` mesh of every
    rank, with the rank's experts, at ``EP_NO_DROP_CF`` (after a warm-up
    call) and at the config's capacity factor."""
    import torch.distributed as dist

    from repro_torch.configs.base import load_config
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import moe_ep

    cfg = load_config(p["arch"]).model
    device = torch.device(p["device"])
    tree, x = ep_layer(cfg, device, p["seed"])
    m = make_model_mesh(dist.get_world_size(), backend=p["backend"],
                        device=p["device"])
    local = moe_ep.local_experts(tree, m)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, mesh=m)
    out = {"rank": dist.get_rank()}
    with torch.inference_mode():
        moe_ep.moe_ep(local, x, capacity_factor=EP_NO_DROP_CF, **kw)
        for name, cf in (("no_drop", EP_NO_DROP_CF),
                         ("config", cfg.capacity_factor)):
            collectives.barrier(m.get_group("model"))
            _p11_sync(device)
            collectives.all_to_all_calls = 0
            t0 = time.perf_counter()
            y, met = moe_ep.moe_ep(local, x, capacity_factor=cf, **kw)
            _p11_sync(device)
            out[name] = {"s": time.perf_counter() - t0,
                         "all_to_all": collectives.all_to_all_calls,
                         **{k: float(v) for k, v in met.items()}}
            if name == "no_drop" and out["rank"] == 0:
                out["y"] = y.cpu()
    return out


def grid_moe_layer(cfg, device, seed, dtype):
    """One MoE layer of ``cfg`` at full width in ``dtype`` (seeded experts,
    shared expert and its gate) and tokens [2, 4096, d] whose router
    inputs lie on a grid of quarters in [-1, 1] and router weights on a
    grid of 64ths in [-1/16, 1/16]: every product is a multiple of 2^-8
    and every sum stays under 2^7, so the router's float32 logits are
    exact on the card and on the CPU alike, in any summation order.  Both
    then choose the same experts (ties, which the grid makes common,
    broken toward the lower index on both), and any difference in the keep
    set is the dispatch's."""
    from repro_torch.models import common, ffn

    gen = torch.Generator(device=device).manual_seed(seed)
    tree = common.init_tree(
        ffn.moe_specs(cfg.d_model, cfg.moe_d_ff, cfg.num_experts_padded,
                      cfg.num_shared_experts), gen, dtype, device)
    tree["shared_gate"].normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    tree["router"].copy_(torch.randint(-4, 5, tree["router"].shape,
                                       generator=gen, device=device) / 64)
    x = torch.randint(-4, 5, (SERVE_BATCH, PROMPT, cfg.d_model),
                      generator=gen, device=device).to(dtype) / 4
    return tree, x


def phase_moe_drops(device):
    """Phase 11 (e): the dense ``ffn.moe`` of a full-width Qwen2-MoE layer
    on 2 x 4096 tokens with drops forced (``deterministic_capacity``), the
    card against the CPU on the same weights and tokens
    (``grid_moe_layer``): the same expert ids, the same sorted order,
    the same keep set and drop fraction, and outputs within phase 4's
    limits (float32: 2e-4 of |want| + 2e-4; bfloat16: 2^-6 of |want| +
    2^-7 of the row's largest)."""
    from repro_torch.configs.base import load_config
    from repro_torch.models import ffn

    cfg = load_config(MOE_VISION[0][0]).model
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k)
    cpu = torch.device("cpu")
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        tree, x = grid_moe_layer(cfg, device, 13, dtype)
        tree_c = {k: ({n: w.cpu() for n, w in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in tree.items()}
        x_c = x.cpu()
        with torch.inference_mode():
            picks = []
            for t, xx in ((tree, x), (tree_c, x_c)):
                _, eid, _, _ = ffn.route(xx.reshape(-1, cfg.d_model),
                                         t["router"], **kw)
                picks.append(eid)
            check(torch.equal(picks[0].cpu(), picks[1]),
                  f"moe drops ({dtype}): the card's experts differ")
            for cap in [c for c, d in MOE_DROP_CASES if d == dtype]:
                slots = [ffn.sort_slots(e, cap) for e in picks]
                check(all(torch.equal(a.cpu(), b) for a, b in
                          zip(slots[0], slots[1])),
                      f"moe drops ({dtype}, cap {cap}): the card's order, "
                      f"slots or keep set differ")
                t0 = time.perf_counter()
                got, gm = ffn.moe(tree, x, deterministic_capacity=cap, **kw)
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                want, wm = ffn.moe(tree_c, x_c, deterministic_capacity=cap,
                                   **kw)
                cpu_s = time.perf_counter() - t0
                drop = float(gm["moe_drop_frac"])
                check(drop == float(wm["moe_drop_frac"]) and drop > 0,
                      f"moe drops ({dtype}, cap {cap}): drop fraction "
                      f"{drop} on the card, {float(wm['moe_drop_frac'])} "
                      f"on the CPU")
                ratio = float(((got.cpu().float() - want.float()).abs()
                               / attention_limit(want)).max())
                check(ratio <= 1.0 and bool(torch.isfinite(got).all()),
                      f"moe drops ({dtype}, cap {cap}): card vs CPU at "
                      f"{ratio} of the limit")
                recs.append({"dtype": str(dtype).split(".")[-1],
                             "capacity": cap, "moe_drop_frac": drop,
                             "max_err_over_limit": ratio,
                             "max_abs_err": max_abs_err(got.float(),
                                                        want.float()),
                             "card_s": card_s, "cpu_s": cpu_s})
        del tree, tree_c, x, x_c
        torch.cuda.empty_cache()
    emit(moe_drops={"arch": cfg.name, "card": card_name_and_limit(),
                    "tokens": [SERVE_BATCH, PROMPT, cfg.d_model],
                    "experts": [cfg.num_experts, cfg.num_experts_padded],
                    "top_k": cfg.top_k, "cases": recs})


def phase_moe_ep(device):
    """Phase 11 (d): ``moe_ep`` as ``EP_RANKS`` gloo ranks on the card (16
    of Qwen2-MoE's 64 experts a rank) and on a 1-rank NCCL mesh, against
    the dense ``ffn.moe`` on the card on the same layer and tokens."""
    from repro_torch.configs.base import load_config
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.models import ffn

    arch = MOE_VISION[0][0]
    cfg = load_config(arch).model
    tree, x = ep_layer(cfg, device, 12)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k)
    dense = {}
    with torch.inference_mode():
        ffn.moe(tree, x, capacity_factor=EP_NO_DROP_CF, **kw)
        for name, cf in (("no_drop", EP_NO_DROP_CF),
                         ("config", cfg.capacity_factor)):
            _p11_sync(device)
            t0 = time.perf_counter()
            y, met = ffn.moe(tree, x, capacity_factor=cf, **kw)
            _p11_sync(device)
            dense[name] = {"s": time.perf_counter() - t0,
                           **{k: float(v) for k, v in met.items()}}
            if name == "no_drop":
                want = y
    del tree
    dev = str(device) if device.type != "cuda" \
        else f"cuda:{device.index or 0}"
    card = card_name_and_limit()
    p = {"arch": arch, "seed": 12, "device": dev}
    runs = {}
    for ranks, backend in ((EP_RANKS, "gloo"),
                           (1, "nccl" if device.type == "cuda" else "gloo")):
        t_spawn = time.time()
        out = run_ranks(phase11_ep_rank, ranks, {**p, "backend": backend},
                        backend=backend, device=dev, timeout_s=EP_TIMEOUT_S)
        spawn_s = time.time() - t_spawn
        y = out[0]["y"].to(device)
        ratio = float(((y.float() - want.float()).abs()
                       / attention_limit(want)).max())
        calls = [r[c]["all_to_all"] for r in out
                 for c in ("no_drop", "config")]
        key = f"{ranks}_{backend}"
        check(calls == [2] * (2 * ranks),
              f"moe_ep {key}: all-to-alls a call per rank {calls}")
        check(ratio <= 1.0 and bool(torch.isfinite(y).all()),
              f"moe_ep {key} != dense moe: {ratio} of the bf16 limit")
        check(out[0]["no_drop"]["moe_drop_frac"] == 0.0
              == dense["no_drop"]["moe_drop_frac"],
              f"moe_ep {key}: drops at capacity factor {EP_NO_DROP_CF}")
        runs[key] = {
            "ranks": ranks, "backend": backend, "spawn_s": spawn_s,
            "max_err_over_bf16_limit": ratio,
            "max_abs_err": max_abs_err(y.float(), want.float()),
            "all_to_all_per_call": calls,
            **{c: {"s_by_rank": [r[c]["s"] for r in out],
                   **{k: out[0][c][k] for k in
                      ("moe_drop_frac", "moe_aux_loss", "moe_z_loss")}}
               for c in ("no_drop", "config")}}
        del y
    emit(moe_ep={"arch": arch, "card": card, "device": dev,
                 "tokens": list(x.shape), "experts": cfg.num_experts_padded,
                 "experts_per_rank": cfg.num_experts_padded // EP_RANKS,
                 "capacity_factors": [EP_NO_DROP_CF, cfg.capacity_factor],
                 "dense": dense, **runs})
    return runs


# ------------------------------------------------ phase 9: sharded engine
def shard_block_rounds(keys, shard, n, batch_per_shard):
    """The most events of one key in one shard's block of the routed
    stream: the ``exact_rounds`` of a sharded exact run."""
    from repro_torch.features.engine import route_stream_blocks

    packed, _, _, valid, _, n_blocks = route_stream_blocks(
        shard, keys, keys, keys, n, batch_per_shard)
    blk = np.repeat(np.arange(n_blocks, dtype=np.int64), n * batch_per_shard)
    ids = blk[valid] * (int(keys.max()) + 1) + packed[valid]
    return int(np.unique(ids, return_counts=True)[1].max())


def flat_rows(eng, n_keys):
    """Each global entity's row in the flat ``shard * E_local + local``
    layout of ``eng``."""
    shard, local = eng.route(np.arange(n_keys))
    return shard.astype(np.int64) * eng.entities_per_shard + local


def _p9_stream(p):
    return tuple(np.load(p[f], mmap_mode="r") for f in ("key", "q", "t"))


def _p9_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _p9_start(group, device):
    """A common start line for the ranks' timed runs."""
    from repro_torch.distributed import collectives
    _p9_sync(device)
    collectives.barrier(group)
    return time.perf_counter()


def _p9_host(st):
    return [x.cpu().numpy() for x in st]


def _p9_same_info(a, b, what, fields=("z", "p", "lam_hat", "features")):
    for f in fields:
        check(bitwise_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")


def _p9_dense_vs_one_card(eng, st, info, keys, qs, ts, p):
    """(a)'s parity, on rank 0: the one-card engine on the card, fed the
    same routed blocks with global keys; z and p bitwise, features within
    1e-6, state bitwise after the layout's permutation."""
    from repro_torch.core import Event, init_state, make_step, prng_key
    from repro_torch.distributed import collectives
    from repro_torch.features.engine import route_stream_blocks

    n, B, dev = eng.n_shards, p["batch"], eng.device
    full = [collectives.gather_rows(x, eng.group) for x in st]
    if eng.shard != 0:
        return None
    shard, _ = eng.route(np.asarray(keys))
    gk, gq, gt, gv, slot, n_blocks = route_stream_blocks(
        shard, np.asarray(keys), np.asarray(qs), np.asarray(ts), n, B)
    blocks = [torch.from_numpy(x.reshape(n_blocks, n * B)).to(dev)
              for x in (gk.astype(np.int64), gq, gt, gv)]
    step = make_step(eng.cfg, "fast")
    ref = init_state(p["n_keys"], len(eng.cfg.taus), device=dev)
    outs = []
    for b in range(n_blocks):
        ref, o = step(ref, Event(*(x[b] for x in blocks)), prng_key(0))
        outs.append(o)
    idx = torch.from_numpy(slot).to(dev)
    flat = lambda f: torch.stack([getattr(o, f) for o in outs]).reshape(
        (n_blocks * n * B,) + tuple(getattr(outs[0], f).shape[1:]))[idx]
    for f in ("z", "p"):
        check(bitwise_equal(getattr(info, f), flat(f)),
              f"(a) vs one card: {f} differs")
    err = max_abs_err(info.features, flat("features"))
    check(err <= 1e-6, f"(a) vs one card: features differ by {err}")
    perm = flat_rows(eng, p["n_keys"])
    for name, a, b in zip(st._fields, full, _p9_host(ref)):
        check(np.array_equal(a[perm].view(np.uint8), b.view(np.uint8)),
              f"(a) vs one card: state {name} differs")
    return {"features_max_abs_err": err, "state_bitwise": True,
            "z_p_bitwise": True}


def phase9_ranks(mesh, p):
    """One rank of phase 9's main spawn: (a) dense, (c) resident, (b)
    exact and the (e) checkpoint save; it checks what it can see and
    returns its records."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import EngineConfig, prng_key
    from repro_torch.features.engine import ShardedFeatureEngine
    from repro_torch.kernels import thinning_rmw as trmw
    from repro_torch.streaming.residency import ResidencyMap

    t_enter = time.time()
    keys, qs, ts = _p9_stream(p)
    B, G, n_keys = p["batch"], p["sink_group"], p["n_keys"]
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp")
    eng = ShardedFeatureEngine(cfg, n_keys, mesh=mesh, mode="fast")
    dev, group, r = eng.device, eng.group, eng.shard
    stats = eng.stream_layout_stats(keys, B)
    n_blocks = stats["n_blocks"]
    own = int(np.count_nonzero(eng.route(np.asarray(keys))[0] == r))
    rec = {"rank": r, "t_enter": t_enter, "device": str(dev),
           "events_own": own, "blocks": n_blocks}
    w = p["warm"]
    eng.run_stream(eng.init_state(), keys[:w], qs[:w], ts[:w],
                   batch_per_shard=B, rng=prng_key(0), collect_info=False)

    # (a) dense, fast, block layout: the stream-order gather run first
    reset_counts()                      # the sharded main path starts here
    t0 = _p9_start(group, dev)
    st, info = eng.run_stream(eng.init_state(), keys, qs, ts,
                              batch_per_shard=B, rng=prng_key(0))
    _p9_sync(dev)
    rec["gather_run_s"] = time.perf_counter() - t0
    rec["keyed_a"] = trmw.keyed_launches
    check(trmw.keyed_launches == n_blocks,
          f"rank {r}: {trmw.keyed_launches} keyed launches for {n_blocks} "
          f"blocks")
    check(info.z.shape == (len(keys),) and bool(
        torch.isfinite(info.features).all()), "(a): bad stream-order info")
    rec["parity_a"] = _p9_dense_vs_one_card(eng, st, info, keys, qs, ts, p)
    writes = int(info.writes)
    del info
    reset_counts()
    t0 = _p9_start(group, dev)
    st2, wr = eng.run_stream(eng.init_state(), keys, qs, ts,
                             batch_per_shard=B, rng=prng_key(0),
                             collect_info=False)
    _p9_sync(dev)
    rec["run_s"] = time.perf_counter() - t0
    rec["keyed_timed"] = trmw.keyed_launches
    check(trmw.keyed_launches == n_blocks,
          f"rank {r}: {trmw.keyed_launches} keyed launches in the timed run")
    check(int(wr.sum()) == writes, "(a): the two runs' writes differ")
    for name, a, b in zip(st._fields, st, st2):
        check(bitwise_equal(a, b), f"(a): the two runs' {name} differ")
    del st2
    rec["writes_a"] = writes
    # (e) save (a)'s 4-shard state: rank 0 gathers and writes
    t0 = time.perf_counter()
    CheckpointManager(p["ckpt"], async_io=False).save(1, st, mesh=mesh)
    rec["ckpt_save_s"] = time.perf_counter() - t0
    np.save(os.path.join(p["dir"], f"state_a-{r}.npy"),
            np.concatenate([x.reshape(len(x), -1) for x in _p9_host(st)],
                           axis=1))
    del st

    # (c) the same run through a sink: dense, resident serial, depth 2
    runs = {}
    for name, slots, depth in (("dense_sink", None, 1),
                               ("resident", p["slots"], 1),
                               ("resident_depth2", p["slots"], 2)):
        sink = eng.make_sink()
        maps = None if slots is None else [
            ResidencyMap(eng.num_entities, slots) for _ in range(SHARDS)]
        before = trmw.keyed_launches
        t0 = _p9_start(group, dev)
        _, inf = eng.run_stream(
            eng.init_state() if slots is None
            else eng.init_resident_state(slots), keys, qs, ts,
            batch_per_shard=B, rng=prng_key(0), sink=sink, sink_group=G,
            residency=maps, pipeline_depth=depth)
        _p9_sync(dev)
        dev_s = time.perf_counter() - t0
        snap = sink.flush()
        wall = time.perf_counter() - t0
        data = dict(sink.stores[0].data)
        sink.close()
        launched = trmw.keyed_launches - before
        check(launched == n_blocks,
              f"(c) {name}: {launched} keyed launches for {n_blocks}")
        rr = {"wall_s": wall, "device_done_s": dev_s,
              "keyed": launched, "puts": snap["puts"],
              "gets": snap["gets"], "rows": len(data)}
        if maps is not None:
            rs = maps[r].stats.snapshot()
            touched = len(np.unique(np.asarray(keys)[
                eng.route(np.asarray(keys))[0] == r]))
            rr.update(residency=rs, touched_keys=touched,
                      rehydrations=rs["misses"] - touched)
            check(rs["evictions"] > 0 and rs["misses"] > touched
                  and rs["splits"] == 0,
                  f"(c) {name}: the resident run did not churn: {rs}")
            _p9_same_info(runs["dense_sink"]["info"], inf,
                          f"(c) {name} vs dense", ("z", "features"))
            check(data == runs["dense_sink"]["data"],
                  f"(c) {name}: store bytes differ from dense")
        runs[name] = {"info": inf, "data": data, "rec": rr}
    rec["c"] = {k: v["rec"] for k, v in runs.items()}
    del runs

    # (b) exact mode on the prefix, block (durable sink) and virtual
    n = p["prefix"]
    pk, pq, pt = (np.asarray(x[:n]) for x in (keys, qs, ts))
    rec["b"] = {}
    for layout in ("block", "virtual"):
        rounds = p["rounds_b"][layout]
        bcfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp_vr",
                            alpha=1.0, exact_rounds=rounds)
        beng = ShardedFeatureEngine(
            bcfg, n_keys, mesh=mesh, mode="exact", layout=layout,
            key_weights=np.bincount(pk, minlength=n_keys))
        sink = beng.make_sink(backend="durable",
                              store_dir=p["dir_b"]) \
            if layout == "block" else beng.make_sink()
        nb = beng.stream_layout_stats(pk, B)["n_blocks"]
        before = trmw.keyed_launches
        t0 = _p9_start(group, dev)
        bst, binf = beng.run_stream(beng.init_state(), pk, pq, pt,
                                    batch_per_shard=B, rng=prng_key(7),
                                    sink=sink)
        sink.flush()
        _p9_sync(dev)
        wall = time.perf_counter() - t0
        launched = trmw.keyed_launches - before
        want = nb * (-(-B // 256) + rounds)
        check(launched == want, f"(b) {layout}: {launched} write-back "
              f"launches for {want} chunks")
        data = dict(sink.stores[0].data)
        sink.close()
        host = _p9_host(bst)
        if layout == "block":
            np.savez(os.path.join(p["dir"], f"live_b-{r}.npz"), *host)
        rec["b"][layout] = {
            "state": host, "bytes": data, "wall_s": wall, "blocks": nb,
            "write_back": launched, "exact_rounds": rounds,
            "info": [getattr(binf, f).cpu().numpy() for f in
                     ("z", "p", "lam_hat", "features")] if r == 0 else None,
            "writes": int(binf.writes),
            "row_of_key": flat_rows(beng, n_keys)}
    check_no_plain_steps(f"phase 9 rank {r}")
    return rec


def phase9_restart_ranks(mesh, p):
    """(d) in fresh ranks: rebuild each rank's rows from its durable
    partition; ``materialize_cold`` against ``materialize``."""
    from repro_torch.core import EngineConfig, state_from_numpy
    from repro_torch.features.engine import ShardedFeatureEngine

    t_enter = time.time()
    n_keys, pk = p["n_keys"], np.asarray(_p9_stream(p)[0][:p["prefix"]])
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp_vr",
                       alpha=1.0, exact_rounds=p["rounds_b"]["block"])
    eng = ShardedFeatureEngine(cfg, n_keys, mesh=mesh, mode="exact")
    r, dev = eng.shard, eng.device
    with np.load(os.path.join(p["dir"], f"live_b-{r}.npz")) as z:
        live = state_from_numpy(*(z[f"arr_{i}"] for i in range(5)),
                                device=dev)
    t0 = time.perf_counter()
    hyd = eng.hydrate_from_dir(p["dir_b"])
    _p9_sync(dev)
    hydrate_s = time.perf_counter() - t0
    for name in ("last_t", "v_f", "agg"):
        check(bitwise_equal(getattr(hyd, name), getattr(live, name)),
              f"(d) rank {r}: hydrated {name} differs from the live state")
    touched = np.unique(pk)
    t_s = float(np.asarray(_p9_stream(p)[2][p["prefix"] - 1])) + 1.0
    warm = eng.materialize(live, touched, t_s)
    stores = eng.reopen_stores(p["dir_b"])
    t0 = time.perf_counter()
    cold = eng.materialize_cold(stores, touched, t_s)
    _p9_sync(dev)
    cold_s = time.perf_counter() - t0
    recovery_s = sum(s.durable.recovery_s for s in stores)
    for s in stores:
        s.close()
    check(bitwise_equal(warm, cold) and bool(torch.isfinite(warm).all()),
          f"(d) rank {r}: materialize_cold differs from materialize")
    return {"rank": r, "t_enter": t_enter, "hydrate_s": hydrate_s,
            "cold_s": cold_s, "recovery_s": recovery_s,
            "keys_scored": int(touched.size)}


def phase9_restore_ranks(mesh, p):
    """(e) onto ``mesh.size()`` ranks: rank 0 reads the 4-shard checkpoint,
    every rank gets its rows of the new layout."""
    from repro_torch.checkpoint import (CheckpointManager,
                                        repartition_profile_state)
    from repro_torch.core import EngineConfig, init_state

    full, t0 = None, time.perf_counter()
    if mesh.get_local_rank("data") == 0:
        full = CheckpointManager(p["ckpt"], async_io=False).restore(
            init_state(p["n_keys"], len(EngineConfig().taus),
                       device="cpu"))
    st = repartition_profile_state(full, old_shards=SHARDS,
                                   new_shards=mesh.size(),
                                   num_keys=p["n_keys"], mesh=mesh)
    _p9_sync(st.last_t.device)
    return {"state": _p9_host(st), "s": time.perf_counter() - t0,
            "device": str(st.last_t.device)}


def phase9_nccl_rank(mesh, p):
    """(f) (b)'s block run on a 1-rank NCCL mesh: the collectives move
    CUDA tensors."""
    import torch.distributed as dist

    from repro_torch.core import EngineConfig, prng_key
    from repro_torch.features.engine import ShardedFeatureEngine

    check(dist.get_backend() == p["f_backend"], "(f): not an NCCL group")
    n = p["prefix"]
    pk, pq, pt = (np.asarray(x[:n]) for x in _p9_stream(p))
    cfg = EngineConfig(h=3600.0, budget=0.1 / 3600.0, policy="pp_vr",
                       alpha=1.0, exact_rounds=p["rounds_b"]["block"])
    eng = ShardedFeatureEngine(cfg, p["n_keys"], mesh=mesh, mode="exact")
    sink = eng.make_sink()
    st, info = eng.run_stream(eng.init_state(), pk, pq, pt,
                              batch_per_shard=p["batch"], rng=prng_key(7),
                              sink=sink)
    sink.flush()
    sink.close()
    check(info.z.device == eng.device, "(f): info left the card")
    return {"state": _p9_host(st), "bytes": dict(sink.stores[0].data),
            "info": [getattr(info, f).cpu().numpy() for f in
                     ("z", "p", "lam_hat", "features")]}


def phase_sharded(device, stream, exact_ref):
    """Phase 9: the sharded feature engine as 4 gloo ranks on one card."""
    import tempfile

    from repro_torch.checkpoint import (CheckpointManager,
                                        repartition_profile_state)
    from repro_torch.core import EngineConfig, init_state
    from repro_torch.distributed import rebalance
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.features.engine import stream_block_counts

    card = card_name_and_limit()
    dev = str(device) if device.type != "cuda" \
        else f"cuda:{device.index or 0}"
    with tempfile.TemporaryDirectory() as d:
        p = {f: os.path.join(d, f"{f}.npy") for f in ("key", "q", "t")}
        for f in ("key", "q", "t"):
            np.save(p[f], getattr(stream, f))
        keys = stream.key
        pk = keys[:PREFIX]
        vlay = rebalance.build_layout(
            N_KEYS, SHARDS, key_weights=np.bincount(pk, minlength=N_KEYS))
        rounds_b = {
            "block": shard_block_rounds(pk, pk % SHARDS, SHARDS,
                                        SHARD_BATCH),
            "virtual": shard_block_rounds(
                pk, np.asarray(vlay.shard_of_key)[pk], SHARDS, SHARD_BATCH)}
        p.update(dir=d, dir_b=os.path.join(d, "stores_b"),
                 ckpt=os.path.join(d, "ckpt"), n_keys=N_KEYS,
                 batch=SHARD_BATCH, sink_group=SINK_GROUP,
                 slots=SHARD_SLOTS, prefix=PREFIX,
                 warm=min(65_536, len(keys) // 4), rounds_b=rounds_b,
                 f_backend="nccl" if device.type == "cuda" else "gloo")
        t_spawn = time.time()
        ranks = run_ranks(phase9_ranks, SHARDS, p, backend="gloo",
                          device=dev, timeout_s=SHARD_TIMEOUT_S)
        spawn_s = time.time() - t_spawn
        start_s = max(x["t_enter"] for x in ranks) - t_spawn
        n = len(keys)
        # what the virtual layout would step (host count, for the record)
        full_lay = rebalance.build_layout(
            N_KEYS, SHARDS, key_weights=np.bincount(keys, minlength=N_KEYS))
        _, blocks_virtual = stream_block_counts(
            np.asarray(full_lay.shard_of_key)[keys], SHARDS, SHARD_BATCH)
        run_s = max(x["run_s"] for x in ranks)
        gather_s = max(x["gather_run_s"] for x in ranks)
        n_blocks = ranks[0]["blocks"]
        emit(sharded={
            "step": "a_dense", "card": card, "ranks": SHARDS,
            "backend": "gloo", "device": dev, "events": n, "keys": N_KEYS,
            "batch_per_shard": SHARD_BATCH, "blocks": n_blocks,
            "rows_per_rank": -(-N_KEYS // SHARDS),
            "rank_start_s": start_s, "spawn_total_s": spawn_s,
            "events_per_s": n / run_s, "run_s": run_s,
            "padded_fraction": 1.0 - n / (n_blocks * SHARDS * SHARD_BATCH),
            "blocks_virtual_layout": blocks_virtual,
            "per_rank": [{"rank": x["rank"], "events": x["events_own"],
                          "run_s": x["run_s"],
                          "events_per_s": x["events_own"] / x["run_s"],
                          "keyed_launches": x["keyed_timed"]}
                         for x in ranks],
            "gather_run_s": gather_s,
            "gather_run_events_per_s": n / gather_s,
            "writes": ranks[0]["writes_a"],
            "parity_vs_one_card": ranks[0]["parity_a"],
            "ckpt_save_s": ranks[0]["ckpt_save_s"]})
        for step in ("dense_sink", "resident", "resident_depth2"):
            recs = [x["c"][step] for x in ranks]
            wall = max(x["wall_s"] for x in recs)
            emit(sharded={
                "step": f"c_{step}", "card": card, "events": n,
                "slots_per_rank": None if step == "dense_sink"
                else SHARD_SLOTS, "sink_group": SINK_GROUP,
                "events_per_s": n / wall, "wall_s": wall,
                "puts": sum(x["puts"] for x in recs),
                "gets_per_event": sum(x["gets"] for x in recs) / n,
                "evictions": sum(x.get("residency", {}).get("evictions", 0)
                                 for x in recs),
                "rehydrations": sum(x.get("rehydrations", 0) for x in recs),
                "bitwise_vs_dense_sink": step != "dense_sink"})

        # (b) against phase 3's single-card exact run
        ref_state, ref_info, ref_bytes = exact_ref
        for layout in ("block", "virtual"):
            recs = [x["b"][layout] for x in ranks]
            full = [np.concatenate([x["state"][i] for x in recs])
                    for i in range(5)]
            perm = recs[0]["row_of_key"]
            for name, a, b in zip(ref_state._fields, full, ref_state):
                check(np.array_equal(a[perm].view(np.uint8),
                                     b.view(np.uint8)),
                      f"(b) {layout}: state {name} differs from phase 3")
            for name, a, b in zip(("z", "p", "lam_hat", "features"),
                                  recs[0]["info"], ref_info):
                check(np.array_equal(a.view(np.uint8),
                                     b.numpy().view(np.uint8)),
                      f"(b) {layout}: {name} differs from phase 3")
            merged = {}
            for x in recs:
                merged.update(x["bytes"])
            check(merged == ref_bytes and len(merged) > 0,
                  f"(b) {layout}: store bytes differ from phase 3")
            emit(sharded={
                "step": f"b_exact_{layout}", "card": card,
                "events": PREFIX, "blocks": recs[0]["blocks"],
                "exact_rounds": recs[0]["exact_rounds"],
                "write_back_launches": [x["write_back"] for x in recs],
                "wall_s": max(x["wall_s"] for x in recs),
                "writes": recs[0]["writes"], "rows_stored": len(merged),
                "bitwise_vs_phase3": True})
        write_back = sum(x["b"][lay]["write_back"] for x in ranks
                         for lay in ("block", "virtual"))
        keyed = sum(x["keyed_a"] + x["keyed_timed"]
                    + sum(x["c"][s]["keyed"] for s in x["c"]) for x in ranks)

        # (d) fresh ranks rebuild from the durable partitions
        t_spawn = time.time()
        rest = run_ranks(phase9_restart_ranks, SHARDS, p, backend="gloo",
                         device=dev, timeout_s=SHARD_TIMEOUT_S)
        emit(sharded={
            "step": "d_restart", "card": card,
            "rank_start_s": max(x["t_enter"] for x in rest) - t_spawn,
            "hydrate_s": max(x["hydrate_s"] for x in rest),
            "cold_s": max(x["cold_s"] for x in rest),
            "recovery_s": [x["recovery_s"] for x in rest],
            "keys_scored": rest[0]["keys_scored"],
            "hydrated_bitwise": True, "cold_bitwise": True})

        # (e) the 4-shard checkpoint onto 2 ranks and onto one card
        state_a = np.concatenate(
            [np.load(os.path.join(d, f"state_a-{r}.npy"))
             for r in range(SHARDS)])
        e_local = -(-N_KEYS // SHARDS)
        ks = np.arange(N_KEYS)
        one_card = state_a[(ks % SHARDS) * e_local + ks // SHARDS]
        two = run_ranks(phase9_restore_ranks, 2, p, backend="gloo",
                        device=dev, timeout_s=SHARD_TIMEOUT_S)
        e2 = -(-N_KEYS // 2)
        got2 = np.concatenate([np.concatenate(
            [x.reshape(len(x), -1) for x in t["state"]], axis=1)
            for t in two])
        check(np.array_equal(got2[(ks % 2) * e2 + ks // 2].view(np.uint8),
                             one_card.view(np.uint8)),
              "(e) 4 -> 2 ranks: restored rows differ")
        t0 = time.perf_counter()
        mono = repartition_profile_state(
            CheckpointManager(p["ckpt"], async_io=False).restore(
                init_state(N_KEYS, len(EngineConfig().taus),
                           device="cpu")),
            old_shards=SHARDS, new_shards=1, num_keys=N_KEYS, device=device)
        _p9_sync(device)
        one_s = time.perf_counter() - t0
        got1 = np.concatenate([x.cpu().numpy().reshape(N_KEYS, -1)
                               for x in mono], axis=1)
        check(np.array_equal(got1.view(np.uint8), one_card.view(np.uint8)),
              "(e) 4 -> 1: restored state differs")
        emit(sharded={"step": "e_checkpoint", "card": card,
                      "state_mb": state_a.nbytes / 1e6,
                      "save_4_ranks_s": ranks[0]["ckpt_save_s"],
                      "restore_2_ranks_s": max(t["s"] for t in two),
                      "restore_2_devices": [t["device"] for t in two],
                      "restore_1_card_s": one_s, "bitwise": True})

        # (f) (b)'s block run on a 1-rank NCCL mesh
        (nc,) = run_ranks(phase9_nccl_rank, 1, p, backend=p["f_backend"],
                          device=dev, timeout_s=SHARD_TIMEOUT_S)
        for name, a, b in zip(ref_state._fields, nc["state"], ref_state):
            check(np.array_equal(a.view(np.uint8), b.view(np.uint8)),
                  f"(f) NCCL: state {name} differs from mesh=None")
        for name, a, b in zip(("z", "p", "lam_hat", "features"),
                              nc["info"], ref_info):
            check(np.array_equal(a.view(np.uint8), b.numpy().view(np.uint8)),
                  f"(f) NCCL: {name} differs from mesh=None")
        check(nc["bytes"] == ref_bytes, "(f) NCCL: store bytes differ")
        emit(sharded={"step": "f_nccl_1_rank", "card": card,
                      "bitwise_vs_mesh_none": True})
    return {"keyed": keyed, "write_back": write_back}


# ------------------------------------------------------------ phase 12
def attention_bwd_bound(B, H, Kh, Sq, Skv, D, causal, window, itemsize):
    """(bound_ms, bound_by) of the attention backward: five products of
    2 D FLOP per unmasked pair and head (S = Q K^T, dP = dO V^T, dV, dK,
    dQ) at the bf16 tensor-core rate, against q, o, do, k, v and the lse
    read once and dq, dk, dv written once."""
    ops = 10 * D * B * H * window_pairs(Sq, Skv, causal, window)
    nbytes = itemsize * D * (4 * B * H * Sq + 4 * B * Kh * Skv) \
        + 4 * B * H * Sq
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def scan_bwd_bound(T, C):
    """(bound_ms, bound_by) of the reverse scan: a, g and h read, dh and
    da written, 20 bytes an element; one multiply-add pair and one more
    multiply an element, far below the float32 rate."""
    return 1e3 * 20 * T * C / HBM_BYTES_PER_S, "bytes"


def normwise(got, want) -> float:
    """max |got - want| over max |want|, in float64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def phase_train_kernels(device):
    """Phase 12 (a): the two backward kernels against their plain
    backwards on the card, then their times at the training shapes beside
    the bound, the plain backward's time and PyTorch's yardstick (SDPA,
    cuDNN backend, with ``is_causal`` where there is no window: forward +
    backward through autograd, and the backward alone on a retained
    graph).  The attention backward, its forward and the yardstick are
    each timed by device time (``device_ms``: the profiler's kernel
    durations, the ``library_*`` and ``*device_ms`` fields) and by CUDA
    events (``ms``, ``library_*events_ms``) over ``YARD_REPS`` calls; the
    comparison reads device time."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(12)
    cases = 0
    # the short path below 128 steps and the ring from one full stage
    short = [(100, 2560), (127, 37), (128, 2560)]
    for T, C in [(T, C) for T in SCAN_T for C in SCAN_C] + [SSD_SCAN] + \
            short:
        a = torch.rand(T, C, generator=gen, device=device)
        u = torch.randn(T, C, generator=gen, device=device)
        g = torch.randn(T, C, generator=gen, device=device)
        for h0 in (None, torch.randn(C, generator=gen, device=device)):
            h = ds.decay_scan_cuda(a, u, h0)
            got = ds.decay_scan_bwd_cuda(a, h, g, h0)
            want = ref.decay_scan_bwd_ref(a, h, g, h0)
            torch.cuda.synchronize()
            for name, x, y in zip(("da", "du", "dh0"), got, want):
                check((x is None) == (y is None) and
                      (x is None or bitwise_equal(x, y)),
                      f"decay_scan_bwd {name} != plain at T={T} C={C} "
                      f"h0={h0 is not None}")
            cases += 1
        del a, u, g, h, got, want
    emit(decay_scan_bwd_grid={"cases": cases, "bitwise_vs_plain_card": True})

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    records, failed = [], []
    for B, H, Kh, Sq, Skv, D, causal, window, softcap in TRAIN_ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, D, generator=gen, device=device)
            k = torch.randn(B, Kh, Skv, D, generator=gen, device=device)
            v = torch.randn(B, Kh, Skv, D, generator=gen, device=device)
            do = torch.randn(B, H, Sq, D, generator=gen, device=device)
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            kw = dict(causal=causal, window=window, softcap=softcap)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            want = ref.attention_bwd_ref(
                *(x.float() for x in (q, k, v, o, lse, do)), **kw)
            torch.cuda.synchronize()
            limit = TRAIN_ATTN_TOL[dtype]
            errs = {n: normwise(x, y) for n, x, y in
                    zip(("dq", "dk", "dv"), got, want)}
            rec = {"shape": [B, H, Kh, Sq, Skv, D], **kw,
                   "dtype": str(dtype).split(".")[-1],
                   "normwise": errs, "limit": limit,
                   "max_abs_err": max(max_abs_err(x.float(), y)
                                      for x, y in zip(got, want))}
            records.append(rec)
            if not (max(errs.values()) <= limit and
                    all(bool(torch.isfinite(x).all()) for x in got)):
                failed.append(rec)
            worst[dtype] = max(worst[dtype], rec["max_abs_err"])
            del q, k, v, do, o, lse, got, want
            torch.cuda.empty_cache()
    emit(flash_attention_bwd_grid={"cases": records})
    check(not failed, f"flash_attention_bwd != plain: {failed}")

    times = {"decay_scan_bwd": {}, "flash_attention_bwd": {}}
    for label, (T, C) in TRAIN_SCANS.items():
        a = torch.rand(T, C, generator=gen, device=device)
        u = torch.randn(T, C, generator=gen, device=device)
        g = torch.randn(T, C, generator=gen, device=device)
        h = ds.decay_scan_cuda(a, u)
        bound, by = scan_bwd_bound(T, C)
        times["decay_scan_bwd"][label] = {
            "shape": [T, C],
            "ms": graph_ms(lambda: ds.decay_scan_bwd_cuda(a, h, g), 10, 5),
            "plain_ms": cuda_ms(lambda: ref.decay_scan_bwd_ref(a, h, g), 1),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        del a, u, g, h
    for label, (B, H, Kh, S, D, W) in TRAIN_ATTN.items():
        q = torch.randn(B, H, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(B, Kh, S, D, generator=gen, device=device,
                            dtype=torch.bfloat16) for _ in range(2))
        do = torch.randn_like(q)
        kw = dict(causal=True, window=W)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        bound, by = attention_bwd_bound(B, H, Kh, S, S, D, True, W, 2)
        # SDPA with the same masks: is_causal alone where there is no
        # window (its fastest call), else the boolean causal-window mask
        mask = None
        if W:
            pos = torch.arange(S, device=device)
            mask = (pos[:, None] >= pos[None, :]) & \
                (pos[:, None] - pos[None, :] < W)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        def sdpa_times():
            """Forward + backward, the backward alone (on a retained
            graph) and the forward alone by device time; the first two
            also by CUDA events."""
            out = sdpa()
            bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                              retain_graph=True)
            return {"library_ms": device_ms(sdpa_fwd_bwd, YARD_REPS),
                    "library_bwd_ms": device_ms(bwd, YARD_REPS),
                    "library_fwd_ms": device_ms(sdpa, YARD_REPS),
                    "library_events_ms": cuda_ms(sdpa_fwd_bwd, YARD_REPS),
                    "library_bwd_events_ms": cuda_ms(bwd, YARD_REPS)}

        try:
            with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
                library = sdpa_times()
            library["library"] = "cudnn"
        except RuntimeError as e:      # the backend refuses: the default
            library = sdpa_times()
            library["library"] = f"default (cuDNN refused: {str(e)[:120]})"
        library["library"] += ", is_causal" if mask is None else \
            ", boolean mask"
        fwd = lambda: fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        rec = {"shape": [B, H, Kh, S, S, D], "window": W, "dtype": "bfloat16",
               "ms": cuda_ms(bwd, YARD_REPS), "device_ms":
               device_ms(bwd, YARD_REPS),
               "plain_ms": cuda_ms(lambda: ref.attention_bwd_ref(
                   q, k, v, o, lse, do, **kw), 1),
               "fwd_with_lse_ms": cuda_ms(fwd, YARD_REPS),
               "fwd_with_lse_device_ms": device_ms(fwd, YARD_REPS),
               **library, "splits": fa.bwd_splits(q, k),
               "bound_ms": bound, "bound_by": by}
        rec["fwd_plus_bwd_ms"] = rec["fwd_with_lse_ms"] + rec["ms"]
        if rec["device_ms"] is not None:
            rec["fwd_plus_bwd_device_ms"] = \
                rec["fwd_with_lse_device_ms"] + rec["device_ms"]
        times["flash_attention_bwd"][label] = rec
        del q, k, v, do, o, lse, qg, kg, vg, mask
        torch.cuda.empty_cache()
    emit(train_kernel_times=times, card=card_name_and_limit())
    return worst, times


def phase_train_blocks(device):
    """Phase 12 (b): the gradients of a scalar loss (the output times a
    fixed random cotangent, summed) through one full-width block in
    float32 at S = 2304, the card with its forward and backward kernels
    against the CPU with the plain versions: every parameter's and the
    input's gradient normwise within phase 6's limits (rec 1e-3, attn
    1e-4, ssd 1e-3).  The attn block's card gradients then go through the
    thinned gradient sync on the card (``thinned_sync_on_card``)."""
    from repro_torch.configs.base import load_config
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone, common

    gen = torch.Generator().manual_seed(13)
    positions = torch.arange(BLOCK_S)
    out = {}
    for arch, kind, counter in TRAIN_BLOCK_CASES:
        cfg = load_config(arch).model
        counter = {"decay_scan": ds, "flash_attention": fa}[counter]
        x = torch.randn(1, BLOCK_S, cfg.d_model, generator=gen)
        ct = torch.randn(1, BLOCK_S, cfg.d_model, generator=gen)
        tree = common.init_tree(backbone.block_specs(kind, cfg), gen,
                                torch.float32, "cpu")
        grads = {}
        for where in ("cpu", device):
            p = common.trainable(common.tree_map(
                lambda t: t.to(where), tree))
            xg = x.to(where).detach().requires_grad_()
            before = (counter.launches, counter.bwd_launches)
            t0 = time.perf_counter()
            y, _, _ = backbone.apply_block(kind, p, xg, cfg,
                                           positions.to(where))
            (y * ct.to(where)).sum().backward()
            if where == device:
                torch.cuda.synchronize()
                check((counter.launches, counter.bwd_launches) ==
                      (before[0] + 1, before[1] + 1),
                      f"{arch} {kind} block: launches "
                      f"{counter.launches - before[0]} forward, "
                      f"{counter.bwd_launches - before[1]} backward")
            grads[str(where)] = ([xg.grad] + [t.grad for t in
                                              common.tree_leaves(p)],
                                 time.perf_counter() - t0)
        (want, cpu_s), (got, card_s) = grads["cpu"], grads[str(device)]
        errs = [normwise(g, w) for g, w in zip(got, want)]
        check(max(errs) <= BLOCK_TOL[kind], f"{arch} {kind} block "
              f"gradients: card vs CPU normwise {max(errs)}")
        key = kind if arch == ARCH else f"{arch}/{kind}"
        out[key] = {"normwise_err": max(errs), "input_grad_err": errs[0],
                    "leaves": len(errs), "limit": BLOCK_TOL[kind],
                    "cpu_s": cpu_s, "card_s": card_s}
        if kind == "attn":
            out[key]["thinned_sync"] = thinned_sync_on_card(got[1:])
    emit(train_blocks={"S": BLOCK_S, "dtype": "float32", **out})


def thinned_sync_on_card(grads) -> dict:
    """The thinned gradient sync on a block's gradients on the card
    against the same gradients on the CPU, in both modes: each leaf's
    uniforms (jax.random's bits, drawn on the card) bitwise equal, the
    same blocks kept, and the synced gradients within 1e-5 normwise (the
    block RMS reductions sum in another order)."""
    from repro_torch.kernels import threefry
    from repro_torch.train import compression as cmp

    key = threefry.prng_key(3)
    host = [g.cpu() for g in grads]
    block = cmp.ThinnedSyncConfig().block
    for k, g in zip(threefry.split(key, len(grads)), grads):
        nb = -(-g.numel() // block)
        check(bitwise_equal(threefry.uniform(k, nb, g.device),
                            threefry.uniform(k, nb)),
              f"thinned sync: uniforms on the card != CPU at {nb} blocks")
    out = {"leaves": len(grads), "blocks": sum(
        -(-g.numel() // block) for g in grads)}
    for mode in ("ht", "ef"):
        cfg = cmp.ThinnedSyncConfig(mode=mode)
        got, _, m_card = cmp.thin_gradients(grads, cmp.init_state(grads),
                                            key, cfg)
        want, _, m_cpu = cmp.thin_gradients(host, cmp.init_state(host),
                                            key, cfg)
        err = max(normwise(a, b) for a, b in zip(got, want))
        kept = float(m_card["sync_volume_fraction"])
        check(kept == float(m_cpu["sync_volume_fraction"]) and err <= 1e-5,
              f"thinned sync {mode}: card kept {kept}, CPU "
              f"{float(m_cpu['sync_volume_fraction'])}, normwise {err}")
        out[mode] = {"kept": kept, "normwise_err": err}
    return out


def train_launches(run) -> dict:
    """The kernel launches one optimizer step must make: per microbatch,
    each ``rec``/``ssd`` layer one scan and each ``attn``/``moe``/
    ``cross`` layer one attention forward, the pattern groups' twice under
    remat (the recompute; the prefix and suffix layers are not
    rematerialised, as in the reference), and one backward each."""
    from repro_torch.models import backbone

    plan = backbone.layer_plan(run.model)
    groups = 2 if run.train.remat else 1
    out = {}
    for name, kinds in (("decay_scan", ("rec", "ssd")),
                        ("flash_attention", ("attn", "moe", "cross"))):
        edge = sum(k in kinds for k in plan.prefix + plan.suffix)
        body = sum(k in kinds for k in plan.pattern) * plan.n_groups
        n = run.train.grad_accum
        out[name] = n * (edge + groups * body)
        out[name + "_bwd"] = n * (edge + body)
    return out


def train_on_card(run, device, steps, seed, label, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ):
    """``steps`` optimizer steps of ``run`` on the card from fresh seeded
    weights on one repeated synthetic batch (the CLI's Zipf tokens), the
    kernels' counts set to 0 just before the steps and read just after.
    Gates: every loss and grad norm finite, the loss of the final
    parameters (one more forward on the batch) below the first step's
    (step 0's lr is 0, so step 1's loss equals step 0's), the launches the
    plan's, parameters and optimizer state on the card.  Returns
    (launches, record)."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import backbone
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer

    cfg = run.model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    mem_before_gb = torch.cuda.memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    state = trainer.init_train_state(
        run, torch.Generator(device=device).manual_seed(seed), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    data = synthetic_batch(cfg, np.random.default_rng(seed), batch, seq,
                           device)
    step = trainer.make_train_step(run, total_steps=steps)
    losses, norms, lrs, step_s = [], [], [], []
    ds.launches = ds.bwd_launches = fa.launches = fa.bwd_launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, data)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        step_s.append(time.perf_counter() - t0)
    launches = {"decay_scan": ds.launches, "decay_scan_bwd": ds.bwd_launches,
                "flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    plan = {k: steps * v for k, v in train_launches(run).items()}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    with torch.no_grad():
        final = float(backbone.train_loss(
            state.params, cfg, data,
            compute_dtype=trainer.DTYPES[run.train.compute_dtype])[0])
    check(all(np.isfinite(losses + norms + [final])),
          f"{label}: non-finite loss or grad norm: {losses}, {norms}")
    check(final < losses[0], f"{label}: loss did not fall: {losses}, "
          f"final {final}")
    check(launches == plan, f"{label}: launches {launches}, plan {plan}")
    check(on_device(tree_leaves(state), device),
          f"{label}: a parameter or optimizer state left the card")
    tokens = batch * seq
    warm = step_s[1:] or step_s
    rec = {"arch": cfg.name, "params": n_params, "layers": cfg.num_layers,
           "optimizer": run.train.optimizer,
           "param_dtype": run.train.param_dtype,
           "master_weights": state.master is not None,
           "grad_accum": run.train.grad_accum, "remat": run.train.remat,
           "batch": batch, "seq": seq, "steps": steps, "losses": losses,
           "final_loss": final,
           "grad_norms": norms, "lrs": lrs, "step_s": step_s,
           "warm_s_per_step": sum(warm) / len(warm),
           "warm_tok_per_s": tokens * len(warm) / sum(warm),
           "peak_mem_gb": peak_gb, "mem_before_gb": mem_before_gb,
           "init_s": init_s,
           "launches": launches, "launches_plan": plan,
           "card": card_name_and_limit()}
    emit(**{f"train_{label}": rec})
    del state, data, step
    torch.cuda.empty_cache()
    return launches, rec


def phase_train(device):
    """Phase 12 (c) and (d): RecurrentGemma-2B at full width and depth
    (bf16, AdamW with a float32 master copy, grad_accum 2, remat, batch 2
    x 4096 tokens, warmup 1, 4 steps), then SmolLM-360M at full width and
    depth (4 steps with AdamW, 2 with Adafactor).  Returns the launches of
    each run."""
    import dataclasses as dc

    from repro_torch.configs.base import load_config

    out = {}
    for label, arch, steps, overrides in TRAIN_RUNS:
        run = load_config(arch)
        run = dc.replace(run, train=dc.replace(run.train, warmup_steps=1,
                                                **overrides))
        out[label] = train_on_card(run, device, steps, seed=12, label=label)
    return out


def train_kernel_entries(worst, times, runs):
    """The two backward kernels' entries of the ``kernels`` line: times at
    RecurrentGemma-2B's training shape (micro-batch 1), SmolLM's beside
    them, launches from phase 12's training runs."""
    scan = times["decay_scan_bwd"][ARCH]
    attn = times["flash_attention_bwd"][ARCH]
    launches = lambda k: {label: n[k] for label, (n, _) in runs.items()}
    return [
        {"name": "decay_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/decay_scan.cu",
         "replaces": "src/repro/kernels/decay_scan.py:33",
         "launches": runs["recurrentgemma"][0]["decay_scan_bwd"],
         "max_abs_err": 0.0, "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None, "shape": scan["shape"],
         "bitwise_vs_plain_card": True,
         "launches_by_run": launches("decay_scan_bwd"),
         "mamba2-2.7b": times["decay_scan_bwd"]["mamba2-2.7b"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": runs["recurrentgemma"][0]["flash_attention_bwd"],
         "max_abs_err": max(worst.values()),
         "max_abs_err_float32": worst[torch.float32],
         "max_abs_err_bfloat16": worst[torch.bfloat16],
         "ms": attn["ms"], "plain_ms": attn["plain_ms"],
         "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
         "library_ms": attn["library_ms"],
         "library_bwd_ms": attn["library_bwd_ms"], "library": attn["library"],
         "library_fwd_ms": attn["library_fwd_ms"],
         "library_events_ms": attn["library_events_ms"],
         "library_bwd_events_ms": attn["library_bwd_events_ms"],
         "device_ms": attn["device_ms"],
         "fwd_plus_bwd_ms": attn["fwd_plus_bwd_ms"],
         "fwd_plus_bwd_device_ms": attn.get("fwd_plus_bwd_device_ms"),
         "shape": attn["shape"],
         "window": attn["window"],
         "launches_by_run": launches("flash_attention_bwd"),
         "smollm-360m": times["flash_attention_bwd"]["smollm-360m"]}]


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


def new_path_launches(family_launches, kernel) -> dict:
    """Phase 10's, 11's, 13's or 14's launch counts of ``kernel``, by model
    or run, where it ran."""
    return {arch: n[kernel] for arch, n in family_launches.items()
            if n.get(kernel)}


# ---------------------------------------- phase 13: training under a mesh
# (label, arch, layers kept (None: all), TrainConfig overrides besides
# warmup_steps=1): SmolLM-360M at full width, 16 of its 32 layers (the
# script's time: phase 14 (d)-(f) take ~215 s), and
# RecurrentGemma-2B at full width with one pattern group (rec, rec, attn)
# and micro-batches of the whole batch (its grad_accum of 2 would leave one
# row a micro-batch, which 2 data ranks do not divide: the rules would
# replicate it); both in bfloat16, as users train, at MESH_GATES'
# bfloat16 bounds, and RecurrentGemma again computed in float32 at the
# float32 bounds, a tighter check of the same split compute (SmolLM's
# float32 run, host-staged collectives a layer, is left out for the
# script's time)
MESH_F32 = {"compute_dtype": "float32"}
MESH_RUNS = [("smollm", "smollm-360m", 16, {}),
             ("recurrentgemma_1group", ARCH, 3, {"grad_accum": 1}),
             ("recurrentgemma_1group_f32", ARCH, 3,
              {"grad_accum": 1, **MESH_F32})]
MESH_SHAPE, MESH_STEPS, MESH_SEED = (2, 2), 3, 13
MESH_TIMEOUT_S = 900.0


def mesh_run(arch, layers, overrides):
    import dataclasses as dc

    from repro_torch.configs.base import load_config
    run = load_config(arch)
    run = dc.replace(run, train=dc.replace(run.train, warmup_steps=1,
                                            **overrides))
    if layers is not None:
        run = dc.replace(run, model=dc.replace(run.model, num_layers=layers))
    return run


def placement_bytes(tree) -> int:
    """A rank's bytes of a DTensor tree as its placements count them:
    each leaf's elements over the sizes of the mesh dims that shard it."""
    from repro_torch.models.common import tree_leaves
    total = 0
    for x in tree_leaves(tree):
        n = x.numel()
        for i, pl in enumerate(x.placements):
            if pl.is_shard():
                n //= x.device_mesh.size(i)
        total += n * x.element_size()
    return total


def _mesh_counts():
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    return {"decay_scan": ds.launches, "decay_scan_bwd": ds.bwd_launches,
            "flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches}


def _reset_mesh_counts():
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    ds.launches = ds.bwd_launches = fa.launches = fa.bwd_launches = 0


def _steps_one_process(run, device, data):
    """``MESH_STEPS`` single-process steps from ``MESH_SEED``'s weights:
    (losses, grad norms, the float32 masters after, the masters before)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer

    state = trainer.init_train_state(
        run, torch.Generator(device=device).manual_seed(MESH_SEED),
        device=device)
    before = [m.detach().clone() for m in tree_leaves(_masters(state))]
    step = trainer.make_train_step(run, total_steps=MESH_STEPS)
    losses, norms = [], []
    for _ in range(MESH_STEPS):
        state, m = step(state, data)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, [m.detach() for m in
                           tree_leaves(_masters(state))], before


def _masters(state):
    """The float32 copy an update is read on: the master weights, or the
    parameters where they are float32 themselves."""
    return state.master if state.master is not None else state.params


def _steps_on_mesh(run, device, data, mesh):
    """``MESH_STEPS`` steps of ``run`` with the state and batch placed on
    ``mesh`` by the train rules, the kernel counts set to 0 just before
    and read just after.  Returns (record, the masters gathered whole on
    the host of rank 0, None on the other ranks)."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch import shardings
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer

    with dctx.mesh_context(mesh, sharding.make_rules(fsdp=True)):
        state = shardings.init_train_state(
            run, torch.Generator(device=device).manual_seed(MESH_SEED),
            mesh, device)
        _p11_sync(device)
        batch = shardings.distribute_batch(data, run, mesh)
        sharded = (state.params, state.master, state.opt, state.sync,
                   batch)          # every argument but the step counter
        args = shardings.argument_bytes(*sharded)
        placed = placement_bytes(sharded)
        step = trainer.make_train_step(run, total_steps=MESH_STEPS)
        losses, norms, step_s = [], [], []
        comm = CommDebugMode()
        _p11_sync(device)
        _reset_mesh_counts()
        with comm:
            for _ in range(MESH_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                _p11_sync(device)
                step_s.append(time.perf_counter() - t0)
        launches = _mesh_counts()
        masters = []
        for m in tree_leaves(_masters(state)):      # a leaf at a time
            w = collectives.whole(m).detach()
            masters.append(w.cpu() if dist.get_rank() == 0 else None)
            del w
        masters = masters if dist.get_rank() == 0 else None
        on_card = all(x.to_local().device == device
                      for x in tree_leaves(state.params))
    rec = {"losses": losses, "grad_norms": norms, "step_s": step_s,
           "launches": launches,
           "plan": {k: MESH_STEPS * v for k, v in
                    train_launches(run).items()},
           "argument_bytes": args, "placement_bytes": placed,
           "collectives": {str(k): v for k, v in
                           comm.get_comm_counts().items()},
           "on_card": on_card}
    return rec, masters


def _update_gap(got, want, before) -> float:
    """L2 of the two runs' masters' difference over L2 of the single
    process's move (``got`` may lie on the host)."""
    num = sum(float(torch.sum((a.to(b.device).double() - b.double()) ** 2))
              for a, b in zip(got, want))
    den = sum(float(torch.sum((b.double() - c.double()) ** 2))
              for b, c in zip(want, before))
    return (num / den) ** 0.5


# the kernels' ops on DTensors: Qwen3-4B's attention (2 rows, 32 query and
# 8 KV heads, D 128, 4096 tokens, causal) with its rows over "data" and
# its heads over "model", and RecurrentGemma-2B's training scan [4096, 2560]
# with its channels over both; each rank's shard held against its slice
# of the plain call on whole tensors on the card.  A rank computes its own
# rows, heads or channels whole, so every result is bit for bit the same
# but attention's dK/dV where the rank's shorter grid splits a KV head's
# query-head group over more blocks than the whole call does
# (``flash_attention.bwd_splits``): its float32 partial sums then add in
# another order before one bfloat16 rounding, so each entry moves by at
# most a bfloat16 ulp, at most 2^-7 of its size: normwise (the largest
# difference over the largest entry) at most 2^-7.
SHARDED_ATTN = (2, 32, 8, TRAIN_SEQ, 128)
SHARDED_SCAN = (TRAIN_SEQ, 2560)
SPLIT_ORDER_TOL = 2.0 ** -7


def _sharded_ops(mesh, device) -> dict:
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(MESH_SEED)
    B, H, Kh, S, D = SHARDED_ATTN
    q, do = (torch.randn(B, H, S, D, generator=gen, device=device,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Kh, S, D, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    T, C = SHARDED_SCAN
    a = torch.rand(T, C, generator=gen, device=device)
    u, dh = (torch.randn(T, C, generator=gen, device=device)
             for _ in range(2))

    def run(attn, scan, do, dh):
        o = ops.flash_attention(*attn, causal=True)
        o.backward(do)
        h = ops.decay_scan(*scan)
        h.backward(dh)
        return [o.detach(), h.detach()] + [x.grad for x in attn + scan]

    leaves = lambda *xs: [x.clone().requires_grad_(True) for x in xs]
    want = run(leaves(q, k, v), leaves(a, u), do, dh)
    attn_pl, scan_pl = [Shard(0), Shard(1)], [Shard(1), Shard(1)]

    def put(x, pl, grad=True):
        d = distribute_tensor(x, mesh, pl, src_data_rank=None)
        return d.requires_grad_(True) if grad else d

    _reset_mesh_counts()
    got = run([put(x, attn_pl) for x in (q, k, v)],
              [put(x, scan_pl) for x in (a, u)], put(do, attn_pl, False),
              put(dh, scan_pl, False))
    launched = _mesh_counts()
    pls = [attn_pl, scan_pl, attn_pl, attn_pl, attn_pl, scan_pl, scan_pl]
    names = ["o", "h", "dq", "dk", "dv", "da", "du"]
    splits = [fa.bwd_splits(q, k), fa.bwd_splits(q[:1, :H // 2],
                                                 k[:1, :Kh // 2])] \
        if device.type == "cuda" else [1, 1]
    errs, same = {}, {}
    for name, g, w, pl in zip(names, got, want, pls):
        mine = distribute_tensor(w, mesh, pl, src_data_rank=None).to_local()
        same[name] = bool(torch.equal(g.to_local(), mine))
        errs[name] = normwise(g.to_local(), mine)
        check(list(g.placements) == pl,
              f"(13 ops) {name} came back as {g.placements}, not {pl}")
    return {"bitwise": same, "normwise": errs, "splits": splits,
            "launches": launched,
            "local_attention": list(got[0].to_local().shape),
            "local_scan": list(got[1].to_local().shape)}


def phase13_rank(mesh, p):
    """(a), (b) on each of 4 gloo ranks sharing the card: the runs on the
    ("data", "model") = (2, 2) mesh over the ranks' group; rank 0 then
    runs the same steps in one process, with the batch split as the data
    ranks split it (the witness) and whole, and compares.  Then the
    kernels' ops on DTensors sharded over the mesh."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch

    device = torch.device(p["device"])
    m2 = make_mesh(MESH_SHAPE, ("data", "model"), device_type=device.type)
    out = {}
    for label, arch, layers, overrides in MESH_RUNS:
        run = mesh_run(arch, layers, overrides)
        data = synthetic_batch(run.model, np.random.default_rng(MESH_SEED),
                               TRAIN_BATCH, TRAIN_SEQ, device)
        rec, masters = _steps_on_mesh(run, device, data, m2)
        dist.barrier()
        if dist.get_rank() == 0:
            for key, accum in (("split", MESH_SHAPE[0]), ("whole", 1)):
                one = dc.replace(run, train=dc.replace(run.train,
                                                       grad_accum=accum))
                losses, norms, want, before = _steps_one_process(
                    one, device, data)
                rec[key] = {"losses": losses, "grad_norms": norms,
                            "update_gap": _update_gap(masters, want,
                                                      before)}
                del want, before
        del masters
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        out[label] = rec
    out["sharded_ops"] = _sharded_ops(m2, device)
    return out


def phase13_nccl_rank(mesh, p):
    """(c) on one NCCL rank: SmolLM's steps on a (1, 1) mesh, equal to the
    same steps in one process bit for bit (a one-rank group's collectives
    copy, the loss's share is 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch

    device = torch.device(p["device"])
    check(dist.get_backend() == ("nccl" if device.type == "cuda" else
                                 "gloo"), "(c): not an NCCL group")
    m1 = make_mesh((1, 1), ("data", "model"), device_type=device.type)
    run = mesh_run("smollm-360m", None, {})
    data = synthetic_batch(run.model, np.random.default_rng(MESH_SEED),
                           TRAIN_BATCH, TRAIN_SEQ, device)
    rec, masters = _steps_on_mesh(run, device, data, m1)
    losses, norms, want, before = _steps_one_process(run, device, data)
    rec["bitwise"] = bool(losses == rec["losses"] and norms ==
                          rec["grad_norms"] and all(
                              torch.equal(a.to(b.device), b) for a, b in
                              zip(masters, want)))
    rec["update_gap"] = _update_gap(masters, want, before)
    return rec


def _rel(a, b) -> float:
    return abs(a / b - 1)


def train_gaps(head, split, run, gates=None) -> tuple:
    """A mesh run's record ``head`` against its witness ``split``: the
    losses', grad norms' and masters' gaps beside ``run``'s compute
    dtype's ``MESH_GATES`` (or ``gates``: (loss rtol, norm gap, update
    gap)), and the gates they fail."""
    rtol, norm_lim, update_lim = (gates or MESH_GATES)[
        run.train.compute_dtype][:3]
    got, want = head["losses"], split["losses"]
    loss_limit = [rtol] * 2 + [rtol + update_lim * abs(want[1] - want[2])
                               / abs(want[2])]
    loss_gap = [_rel(a, b) for a, b in zip(got, want)]
    norm_gap = [_rel(a, b) for a, b in
                zip(head["grad_norms"], split["grad_norms"])]
    fails = []
    if not all(np.isfinite(got + head["grad_norms"])):
        fails.append("non-finite loss or grad norm")
    if not all(g <= lim for g, lim in zip(loss_gap, loss_limit)):
        fails.append(f"losses {got} vs the witness {want} (limits "
                     f"{loss_limit})")
    if max(norm_gap) > norm_lim:
        fails.append(f"grad norms {head['grad_norms']} vs the witness "
                     f"{split['grad_norms']} (limit {norm_lim})")
    if split["update_gap"] > update_lim:
        fails.append(f"update gap {split['update_gap']} (limit "
                     f"{update_lim})")
    return {"compute_dtype": run.train.compute_dtype, "loss_gap": loss_gap,
            "loss_limit": loss_limit, "norm_gap": norm_gap,
            "norm_limit": norm_lim, "update_gap": split["update_gap"],
            "update_limit": update_lim}, fails


def phase_mesh_train(device):
    """Phase 13: training under a mesh.  (a) SmolLM-360M at full width, 16
    of 32 layers, bf16 with a float32 master copy, AdamW, 3 steps on phase
    12's
    batch (2 x 4096 tokens) on a ("data", "model") = (2, 2) mesh of 4
    gloo ranks sharing the card, with the train rules (SmolLM's 15 heads
    and 5 KV heads replicate on "model", its ff and vocab dims shard);
    (b) RecurrentGemma-2B at full width, one pattern group, the same way,
    in bf16 and again computed in float32 (``MESH_RUNS``).  Each rank runs
    the model on its data row, every layer's parameters gathered over
    "data" and split over "model" (tensor parallelism: phase 14); the
    kernels' DTensor sharding rules are driven apart: attention's rows
    over "data" and heads over "model", the scan's channels over both,
    against the plain calls (``_sharded_ops``).  (c) SmolLM on a 1-rank NCCL (1, 1)
    mesh, bitwise equal to one process.  Gates: the launches the plan's on
    every rank, the state on the card, each rank's argument bytes equal to
    its placements' count, the ranks' losses equal, and against the
    witness (one process, the batch split as the data ranks split it) the
    losses, every step's grad norm and the masters' update within the
    run's compute dtype's ``MESH_GATES``; the sharded ops as
    ``SHARDED_ATTN``'s comment says; (c) bit for bit.  Every gate of (a)
    and (b) is read before the record prints."""
    from repro_torch.distributed.spawn import run_ranks

    dev = str(device) if device.type != "cuda" \
        else f"cuda:{device.index or 0}"
    card = card_name_and_limit()
    t0 = time.time()
    ranks = run_ranks(phase13_rank, 4, {"device": dev}, backend="gloo",
                      device=dev, timeout_s=MESH_TIMEOUT_S)
    gloo_s = time.time() - t0
    out, fails_all = {}, []
    for label, arch, layers, overrides in MESH_RUNS:
        recs = [r[label] for r in ranks]
        head = recs[0]
        for i, r in enumerate(recs):
            check(r["launches"] == r["plan"],
                  f"(13 {label}) rank {i}: launches {r['launches']}, plan "
                  f"{r['plan']}")
            check(r["argument_bytes"] == r["placement_bytes"],
                  f"(13 {label}) rank {i}: argument bytes "
                  f"{r['argument_bytes']} != placements' "
                  f"{r['placement_bytes']}")
            check(r["on_card"], f"(13 {label}) rank {i}: state off the card")
            check(r["losses"] == head["losses"],
                  f"(13 {label}): ranks disagree on the loss")
        gaps, fails = train_gaps(head, head["split"],
                                 mesh_run(arch, layers, overrides))
        fails_all += [f"(13 {label}): {f}" for f in fails]
        out[label] = {"arch": arch, "layers": layers, **overrides,
                      "mesh": list(MESH_SHAPE), "ranks": 4,
                      "backend": "gloo", **gaps,
                      "by_rank_argument_bytes": [r["argument_bytes"]
                                                 for r in recs],
                      "by_rank_step_s": [r["step_s"] for r in recs],
                      **{k: head[k] for k in
                         ("losses", "grad_norms", "split", "whole",
                          "launches", "plan", "placement_bytes",
                          "collectives")}}
    ops_recs = [r["sharded_ops"] for r in ranks]
    for i, r in enumerate(ops_recs):
        check(all(n == 1 for n in r["launches"].values()),
              f"(13 ops) rank {i}: launches on DTensors {r['launches']}, "
              f"not one of each kernel")
        same_split = r["splits"][0] == r["splits"][1]
        for name, err in r["normwise"].items():
            exact = same_split or name not in ("dk", "dv")
            check(r["bitwise"][name] if exact else err <= SPLIT_ORDER_TOL,
                  f"(13 ops) rank {i}: {name} off the plain call by {err} "
                  f"(splits {r['splits']})")
    out["sharded_ops"] = {"attention": list(SHARDED_ATTN),
                          "scan": list(SHARDED_SCAN), "by_rank": ops_recs}
    t0 = time.time()
    (nc,) = run_ranks(phase13_nccl_rank, 1, {"device": dev},
                      backend="nccl" if device.type == "cuda" else "gloo",
                      device=dev, timeout_s=MESH_TIMEOUT_S)
    nccl_s = time.time() - t0
    check(nc["bitwise"], f"(13 c): the (1, 1) NCCL mesh's steps differ "
          f"from one process (update gap {nc['update_gap']})")
    check(nc["launches"] == nc["plan"], f"(13 c): launches "
          f"{nc['launches']}, plan {nc['plan']}")
    check(nc["argument_bytes"] == nc["placement_bytes"],
          "(13 c): argument bytes != placements'")
    out["nccl_1x1"] = {k: nc[k] for k in
                       ("losses", "grad_norms", "bitwise", "update_gap",
                        "launches", "plan", "argument_bytes",
                        "collectives", "step_s")}
    emit(mesh_train={**out, "gloo_phase_s": gloo_s, "nccl_phase_s": nccl_s,
                     "card": card, "failed": fails_all})
    check(not fails_all, "; ".join(fails_all))
    return {**{label: out[label]["launches"] for label, *_ in MESH_RUNS},
            "nccl_1x1": nc["launches"]}


# ------------------------------ phase 14: tensor parallelism on "model"
# (a) Qwen3-4B at full width, 2 of its 36 layers, trains 3 steps on a
# ("data", "model") = (2, 2) mesh of 4 gloo ranks: each rank computes its
# 16 of 32 heads, 4 of 8 KV heads, half the ff and half the vocab; held to
# one process that splits the batch as the data ranks do at phase 13's
# gates, in bfloat16 and again computed in float32 (``TP_TRAIN_RUNS``).
# (b) Qwen3-4B at full width, 8 of its 36 layers, serves on a (1, 4) mesh:
# each rank its 8 heads, 2 KV heads, a quarter of ff and vocab, and a
# quarter of every KV cache's slots (``kv_seq``), which a decode step
# attends where they lie.  The one-process serve of the same weights runs
# first; the mesh's decode is fed its tokens, so each step's logits meet.
TP_TRAIN = ("qwen3-4b", 2)
TP_TRAIN_RUNS = [("bf16", {"grad_accum": 1}),
                 ("f32", {"grad_accum": 1, **MESH_F32})]
TP_SERVE, TP_SERVE_MESH, TP_DECODE_STEPS = "qwen3-4b", (1, 4), 8
TP_SERVE_LAYERS = 8         # of 36 (all until phase 14 (d)-(f)): time
TP_SEED = 14
TP_TIMEOUT_S = 900.0
# (d) Qwen2-MoE-A2.7B at full width, 2 of its 24 layers (AdamW state of
# ~18 B a parameter: 1.83 B parameters, ~33 GB for the one-process witness
# and as much over the four ranks), trains 3 steps on phase 13's batch on
# (2, 2), bf16, and again in float32 with float32 parameters (a float32
# gradient: no bfloat16 accumulation of the Zipf batch's frequent
# embedding rows, which parts a whole-batch witness from the data
# ranks' split sums; ``MOE_TP_GATES``): each rank computes its data
# rank's half of the slots of 32 of the 64 experts (the capacity dim on
# "data"), half the shared expert's ff and its 8 of 16 heads; the
# routing is the whole batch's (its statistics, capacity and slots summed
# over the data ranks), so the witness is one process on the whole batch.
# (e) Qwen2-MoE serves on (1, 4) (16 experts, 4 heads, a quarter of the
# shared ff, vocab and cache slots a rank): bf16 at full depth, and
# computed in float32 at 4 layers (bf16 weights); one process first.
MOE_TP = "qwen2-moe-a2.7b"
MOE_TP_LAYERS = 2
# (d)'s gates by compute dtype: (loss rtol, grad norm gap, update gap,
# first-step router gradient gap, drop-fraction gap), against one process
# on the whole batch (the routing must be the whole batch's).  The router
# has a gate of its own: its aux and z path, the same on every rank, is
# summed once, and no loss gate sees a fault there (the router is 2^-14 of
# the parameters).  Float32 (float32 parameters): MESH_GATES; the drops
# (Zipf rows pile onto few experts: 64-83 % of the choices drop) the same
# count where the parameters are the same (steps 0-1), within 2^-10 after.
# bfloat16: the witness accumulates each bf16 gradient over the 8192 rows
# where each data rank accumulates 4096 (phase 13's reason for a split
# witness: the Zipf batch's frequent embedding rows stagnate), and the two
# sides' roundings flip near-tied experts, each flip moving which tokens
# an expert's capacity cuts off.  Its gates come from readings of
# ``scripts/torch_tp_gate_readings.py --moe-only`` (NVIDIA H100 80GB HBM3,
# 700.00 W), sound / planted (a rank's expert partial sum dropped; the
# router's aux gradient summed 2 times; each data rank routing alone):
# losses of steps 0-1 5.7e-5 / 5.8e-4, 5.7e-5, 4.3e-4 (the aux fault moves
# none): 1e-4; the norm 0.0121 (float32 compute with bf16 parameters reads
# 0.0119: the accumulation, not the compute) / 0.0295, 0.0136, 0.0128:
# 2^-6; the update 0.057 / 0.596, 0.087, 0.454: 2^-3; the router gradient
# 0.0099 / 0.502, 0.335, 0.417: 2^-5; the drops 0.0031 / 0.014, 0.036,
# 0.080: 2^-7.
MOE_TP_GATES = {"float32": (*MESH_GATES["float32"], 2.0 ** -7,
                            2.0 ** -10),
                "bfloat16": (TP_BF16_LOSS_RTOL, 2.0 ** -6, 2.0 ** -3,
                             2.0 ** -5, 2.0 ** -7)}
# (label, layers, TrainConfig overrides): the float32 run keeps one layer
# (float32 parameters move twice the bytes through the host-staged
# collectives; the script's time)
MOE_TP_TRAIN_RUNS = [("bf16", MOE_TP_LAYERS, {"grad_accum": 1}),
                     ("f32", 1, {"grad_accum": 1, "param_dtype": "float32",
                                 **MESH_F32})]
MOE_TP_SERVE = [("bf16", None, torch.bfloat16), ("f32", 4, torch.float32)]
MOE_TP_SEED = 15
# The mesh's logits against one process's, relative L2 a step: both are
# bfloat16 computations of the same logits that round at different places
# (a rank's column shard of a product can take another cuBLAS kernel, so
# its float32 sums add in another order before the one rounding; the
# row-parallel partial sums meet in float32 before theirs, the attention
# kernel runs each head alone).  The limit lies between readings of
# ``scripts/torch_tp_gate_readings.py`` (NVIDIA H100 80GB HBM3, 700.00
# W): the sound run at most 0.0207 a step (the same digits in every run:
# the computation is deterministic), planted faults at least 0.0299 (one
# layer's decode leaving out the last rank's cache slots) and 0.151 (one
# rank's partial sum of one layer's row-parallel product dropped).  A
# greedy token that differs is a near tie: one process's logit gap
# between the two tokens at most twice the largest logit difference of
# its row.
TP_LOGIT_REL_L2 = 0.025
# Phase 14 (e)'s bfloat16 Qwen2-MoE serve at full depth against one
# process, relative L2 a step: routing is discontinuous, so a near-tied
# expert that flips moves a row's logits further than phase 14 (b)'s dense
# drift.  Read as that limit: the sound run at most 0.145 a step, one
# rank's expert partial sum of the first MoE layer dropped
# (``moe_partial_dropped``) at least 0.256 (``scripts/
# torch_tp_gate_readings.py --moe-only``, NVIDIA H100 80GB HBM3, 700.00 W).
MOE_SERVE_BF16_REL_L2 = 0.2


def _tp_serve_params(run, device, mesh, rules, seed=TP_SEED):
    """The served model's seeded bfloat16 weights in the JAX layout, each
    leaf drawn whole (the one-process draws, in the same order) and cut
    at once to this rank's shard: no rank holds the whole model.  The
    ranks draw each leaf in turn (a full-depth MoE's stacked expert leaf
    is 8.9 GB), each giving its whole copy back to the card before the
    next draws."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import context as dctx
    from repro_torch.launch.shardings import own_storage
    from repro_torch.models import backbone, common

    gen = torch.Generator(device=device).manual_seed(seed)

    def one(spec):
        out = None
        for turn in range(dist.get_world_size()):
            if turn == dist.get_rank():
                x = common.init_param(spec, gen, torch.bfloat16, device)
                out = own_storage(distribute_tensor(
                    x, mesh, dctx.placements_for(
                        mesh, x.shape, spec.logical_axes(), rules),
                    src_data_rank=None))
                del x
                _free(device)
            dist.barrier()
        return out
    return common.map_specs(one, backbone.train_specs(run.model))


def serve_run(arch, layers=None):
    """``arch``'s config, cut to ``layers`` (None: all)."""
    import dataclasses as dc

    from repro_torch.configs.base import load_config
    run = load_config(arch)
    if layers is not None:
        run = dc.replace(run, model=dc.replace(run.model, num_layers=layers))
    return run


def tp_serve_reference(device, arch=TP_SERVE, layers=None,
                       dtype=torch.bfloat16, seed=TP_SEED):
    """(b)'s (and (e)'s) one-process serve: the same seeded weights whole
    on the card, a 2 x 4096 prefill and 8 greedy steps computed in
    ``dtype``; the logits of each step (on the host), the tokens fed, the
    seconds.  The weights are freed after."""
    from repro_torch.models import backbone, common

    run = serve_run(arch, layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = backbone.serving_params(common.map_specs(
        lambda s: common.init_param(s, gen, torch.bfloat16, device),
        backbone.train_specs(run.model)), run.model)
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, run.model.vocab_size, (SERVE_BATCH, PROMPT))).to(device)
    with torch.inference_mode():
        drive_request(run, params, prompts, 1, dtype)   # warm-up request
        logits, fed, _, pre_s, dec_s, launches = drive_request(
            run, params, prompts, TP_DECODE_STEPS, dtype)
    out = {"logits": [x.float().cpu() for x in logits],
           "fed": [t.cpu() for t in fed], "prompts": prompts.cpu(),
           "prefill_s": pre_s, "decode_s": dec_s, "launches": launches}
    del params, logits
    torch.cuda.empty_cache()
    return out


def _tp_dtype(name: str) -> torch.dtype:
    """A (c) attention shape's dtype: its run's compute dtype."""
    return torch.float32 if name.endswith("_f32") else torch.bfloat16


def _tp_kernels(device, shapes) -> dict:
    """(c) on a rank: each kernel's call at this rank's local shapes on
    the TP path, against its plain version on the same inputs: attention
    forward and backward at (a)'s local heads (bfloat16, and float32 as
    (a)'s float32 run), the forward at (b)'s prefill, the scan and its
    backward at phase 13 (b)'s local RG-LRU channels."""
    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(TP_SEED + 1)
    out = {}
    for name, (B, H, Kh, S, D) in shapes["attention"].items():
        dt = _tp_dtype(name)
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device,
                                     dtype=dt)
        q, k, v = rnd(B, H, S, D), rnd(B, Kh, S, D), rnd(B, Kh, S, D)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True,
                                         return_lse=True)
        wo, wl = ref.attention_ref(q, k, v, causal=True, return_lse=True)
        rec = {"shape": [B, H, Kh, S, D], "dtype": str(dt).split(".")[-1],
               "o_normwise": normwise(o, wo),
               "lse_max_abs": float((lse - wl).abs().max()),
               "o_within_limit": bool(((o.float() - wo.float()).abs()
                                       <= attention_limit(wo)).all())}
        if name.startswith("train"):
            do = rnd(B, H, S, D)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                              causal=True)
            want = ref.attention_bwd_ref(q.float(), k.float(), v.float(),
                                         o.float(), lse, do.float(),
                                         causal=True)
            rec["bwd_normwise"] = {n: normwise(g.float(), w) for n, g, w in
                                   zip(("dq", "dk", "dv"), got, want)}
        out[name] = rec
        del q, k, v
    T, C = shapes["scan"]
    a = torch.rand(T, C, generator=gen, device=device)
    u, g = (torch.randn(T, C, generator=gen, device=device)
            for _ in range(2))
    h = ds.decay_scan_cuda(a, u)
    da, du, _ = ds.decay_scan_bwd_cuda(a, h, g)
    wda, wdu, _ = ref.decay_scan_bwd_ref(a, h, g)
    out["scan"] = {"shape": [T, C],
                   "bitwise": bool(torch.equal(h, ref.decay_scan_ref(a, u))),
                   "bwd_bitwise": bool(torch.equal(da, wda)
                                       and torch.equal(du, wdu))}
    torch.cuda.empty_cache()
    return out


def _tp_kernel_times(device, shapes) -> dict:
    """Rank 0 alone (the other ranks wait): each kernel at its local shape
    on the TP path, its plain version, the library call where there is
    one, and the bound (the larger of the bytes over the memory rate and
    the operations over the dtype's peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decay_scan as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(TP_SEED + 2)
    out = {}
    for name, (B, H, Kh, S, D) in shapes["attention"].items():
        dt = _tp_dtype(name)
        q, k, v = (torch.randn(B, h, S, D, generator=gen, device=device,
                               dtype=dt) for h in (H, Kh, Kh))
        ops = 4 * D * B * H * window_pairs(S, S, True, 0)
        nbytes = q.element_size() * D * (2 * B * H * S + 2 * B * Kh * S)
        rate = F32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
        out[name] = {
            "shape": [B, H, Kh, S, D], "dtype": str(dt).split(".")[-1],
            "ms": cuda_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=True), 10),
            "plain_ms": cuda_ms(lambda: ref.attention_ref(
                q, k, v, causal=True), 2),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        del q, k, v
    T, C = shapes["scan"]
    a = torch.rand(T, C, generator=gen, device=device)
    u = torch.randn(T, C, generator=gen, device=device)
    ms, by = bound(12 * T * C, 2 * T * C)
    out["scan"] = {"shape": [T, C],
                   "ms": cuda_ms(lambda: ds.decay_scan_cuda(a, u), 10),
                   "plain_ms": cuda_ms(lambda: ref.decay_scan_ref(a, u), 1),
                   "library_ms": None, "bound_ms": ms, "bound_by": by}
    torch.cuda.empty_cache()
    return out


def tp_train(device, overrides) -> dict:
    """(a) on a rank: Qwen3-4B's steps on the (2, 2) mesh with ``overrides``
    (``TP_TRAIN_RUNS``); rank 0 adds the witness's ("split")."""
    import dataclasses as dc

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch

    arch, layers = TP_TRAIN
    run = mesh_run(arch, layers, overrides)
    m22 = make_mesh(MESH_SHAPE, ("data", "model"), device_type=device.type)
    data = synthetic_batch(run.model, np.random.default_rng(MESH_SEED),
                           TRAIN_BATCH, TRAIN_SEQ, device)
    rec, masters = _steps_on_mesh(run, device, data, m22)
    dist.barrier()
    if dist.get_rank() == 0:
        one = dc.replace(run, train=dc.replace(run.train,
                                               grad_accum=MESH_SHAPE[0]))
        losses, norms, want, before = _steps_one_process(one, device, data)
        rec["split"] = {"losses": losses, "grad_norms": norms,
                        "update_gap": _update_gap(masters, want, before)}
        del want, before
    del masters, data
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def tp_serve(device, p, arch=TP_SERVE, layers=None, dtype=torch.bfloat16,
             seed=TP_SEED) -> dict:
    """(b) (and (e)) on a rank: the model's prefill and decode on the (1,
    4) mesh, computed in ``dtype``, fed the one-process serve's tokens
    (``p``); each step's logits on rank 0, every decode step's collective
    bytes."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import make_serve_step

    run = serve_run(arch, layers)
    m14 = make_mesh(TP_SERVE_MESH, ("data", "model"),
                    device_type=device.type)
    rules = sharding.make_rules(fsdp=False)
    with dctx.mesh_context(m14, rules), torch.inference_mode():
        params = _tp_serve_params(run, device, m14, rules, seed)
        _p11_sync(device)
        prompts = p["prompts"].to(device)
        fed = [t.to(device) for t in p["fed"]]
        prefill = make_serve_step(run, "prefill", compute_dtype=dtype,
                                  max_len=PROMPT + TP_DECODE_STEPS)
        decode = make_serve_step(run, "decode", compute_dtype=dtype)
        _reset_mesh_counts()
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts)
        _p11_sync(device)
        prefill_s = time.perf_counter() - t0
        prefill_launches = fa.launches
        step_logits, moved, step_s = [logits.float().cpu()], [], []
        for tok in fed:
            collectives.tp_bytes.clear()
            t0 = time.perf_counter()
            logits, state = decode(params, state, tok)
            _p11_sync(device)
            step_s.append(time.perf_counter() - t0)
            moved.append(dict(collectives.tp_bytes))
            step_logits.append(logits.float().cpu())
        cache = state.layers[0].k
        out = {
            "prefill_s": prefill_s, "decode_step_s": step_s,
            "prefill_launches": prefill_launches,
            "decode_launches": fa.launches - prefill_launches,
            "decode_bytes": moved,
            "cache_slice": list(cache.shape),
            "cache_bytes_per_layer": 2 * cache.numel() * cache.element_size(),
            "cache_on_card": all(c.k.device == device for c in state.layers),
            "logits": step_logits if dist.get_rank() == 0 else None}
        del params, state
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _peak_gb(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 \
        if device.type == "cuda" else 0.0


def _free(device):
    """This process's cached card memory back to the card (the ranks share
    it)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def moe_drop_calls():
    """Each ``ffn.moe`` call's drop fraction in the block, in order (under
    remat a pattern layer's forward, then its recompute in the
    backward)."""
    from repro_torch.models import ffn

    calls, inner = [], ffn.moe

    def recorded(*a, **k):
        y, m = inner(*a, **k)
        calls.append(float(m["moe_drop_frac"]))
        return y, m
    ffn.moe = recorded
    try:
        yield calls
    finally:
        ffn.moe = inner


@contextlib.contextmanager
def first_router_grads(run):
    """The first step's router gradients in the block (each pattern
    group's stacked router leaf, whole, float32, on the host), as the
    step takes them from the parameters."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import collectives
    from repro_torch.models import backbone, common
    from repro_torch.train import trainer

    axes = [s.logical_axes() for s in
            common.tree_leaves_specs(backbone.train_specs(run.model))]
    idx = [i for i, a in enumerate(axes)
           if a == ("layers", "embed", "experts")]
    got, inner = [], trainer._take_grads

    def spy(leaves, acc_dtype):
        if not got:
            for i in idx:
                g = leaves[i].grad
                g = collectives.whole(g) if isinstance(g, DTensor) else g
                # a copy: the clip scales the gradients in place
                got.append(g.detach().to("cpu", torch.float32, copy=True))
        return inner(leaves, acc_dtype)
    trainer._take_grads = spy
    try:
        yield got
    finally:
        trainer._take_grads = inner


def moe_tp_train(device, layers, overrides) -> dict:
    """(d) on a rank: Qwen2-MoE's steps (``layers`` of them) on the (2, 2)
    mesh with ``overrides`` (``MOE_TP_TRAIN_RUNS``), each MoE call's drop
    fraction and
    the peak memory; rank 0 adds the witness's (one process on the whole
    batch: "whole")."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch

    run = mesh_run(MOE_TP, layers, overrides)
    m22 = make_mesh(MESH_SHAPE, ("data", "model"), device_type=device.type)
    data = synthetic_batch(run.model, np.random.default_rng(MESH_SEED),
                           TRAIN_BATCH, TRAIN_SEQ, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with moe_drop_calls() as drops, first_router_grads(run) as router:
        rec, masters = _steps_on_mesh(run, device, data, m22)
    rec["drops"], rec["peak_gb"] = drops, _peak_gb(device)
    _free(device)
    dist.barrier()
    if dist.get_rank() == 0:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with moe_drop_calls() as whole_drops, \
                first_router_grads(run) as whole_router:
            losses, norms, want, before = _steps_one_process(run, device,
                                                             data)
        rec["whole"] = {"losses": losses, "grad_norms": norms,
                        "update_gap": _update_gap(masters, want, before),
                        "drops": whole_drops, "peak_gb": _peak_gb(device),
                        "router_grad_gap": max(normwise(a, b) for a, b in
                                               zip(router, whole_router))}
        del want, before
    del masters, data
    _free(device)
    dist.barrier()
    return rec


def moe_layer_bitwise(device) -> dict:
    """(e) on a rank: one full-width Qwen2-MoE layer without its shared
    expert, bf16, tokens [2, 4096, 2048], on the (1, 4) mesh (the rank's
    16 experts, their partial sums added in float32 and rounded once)
    against the whole layer in this process: how many outputs are not
    bit for bit one process's."""
    from repro_torch.configs.base import load_config
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ffn

    cfg = load_config(MOE_TP).model
    tree, x = ep_layer(cfg, device, MOE_TP_SEED)
    tree = {k: v for k, v in tree.items() if k not in ("shared",
                                                       "shared_gate")}
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    m14 = make_mesh(TP_SERVE_MESH, ("data", "model"),
                    device_type=device.type)
    with torch.inference_mode():
        want, _ = ffn.moe(tree, x, **kw)
        with dctx.tp_context(m14, sharding.make_rules(fsdp=False)):
            sl = dctx.local_slice("experts", cfg.num_experts_padded)
            local = {k: v[:, sl] if k == "router" else v[sl]
                     for k, v in tree.items()}
            got, _ = ffn.moe(local, x, sizes=ffn.MoESizes(
                cfg.num_experts_padded, cfg.moe_d_ff), **kw)
        rows = (got != want).any(-1)
        out = {"outputs": want.numel(),
               "not_bitwise": int((got != want).sum()),
               "rows_not_bitwise": int(rows.sum()), "rows": rows.numel(),
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "finite": bool(torch.isfinite(got).all())}
    del tree, x, want, got
    _free(device)
    return out


def phase14_rank(mesh, p):
    """(a)-(f) on each of 4 gloo ranks sharing the card."""
    import torch.distributed as dist

    device = torch.device(p["device"])
    clock = [time.time()]
    part_s = {}

    def lap(name):
        part_s[name] = time.time() - clock[0]
        clock[0] = time.time()
    out = {"train": {label: tp_train(device, overrides)
                     for label, overrides in TP_TRAIN_RUNS}}
    lap("a")
    out["serve"] = tp_serve(device, p, TP_SERVE, TP_SERVE_LAYERS)
    _free(device)
    lap("b")
    out["moe_train"] = {label: moe_tp_train(device, layers, overrides)
                        for label, layers, overrides in MOE_TP_TRAIN_RUNS}
    lap("d")
    out["moe_serve"] = {}
    for label, layers, dtype in MOE_TP_SERVE:
        out["moe_serve"][label] = tp_serve(device, p["moe_serve"][label],
                                           MOE_TP, layers, dtype,
                                           MOE_TP_SEED)
        _free(device)
        lap(f"e_{label}")
    out["moe_bitwise"] = moe_layer_bitwise(device)
    lap("e_bitwise")
    # (c) the kernels at this rank's local shapes, then timed on rank 0
    out["kernels"] = _tp_kernels(device, p["kernel_shapes"])
    dist.barrier()
    if dist.get_rank() == 0 and device.type == "cuda":
        out["kernel_times"] = _tp_kernel_times(device, p["kernel_shapes"])
    dist.barrier()
    lap("c_f")
    out["part_s"] = part_s
    return out


def _tp_decode_budget(cfg, B) -> int:
    """A decode step's tensor-parallel payload bytes, O(B H D) a layer
    whatever the cache: the heads' queries and the new token's K/V (bf16),
    the rows' statistics and the combined output (float32), the two
    output sums and the embedding's (float32, widened), the head_dim
    norms' shards and the vocab-split logits (float32), each counted at
    its largest rank's share or whole."""
    H, Kh, D, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    layer = B * (H * D * 2 + 2 * Kh * D * 2 + H * 4 + H * D * 4 + 2 * d * 4) \
        + 2 * D * 2
    from repro_torch.models import backbone
    return cfg.num_layers * layer + B * d * 4 + \
        B * backbone.padded_vocab(cfg) * 4


def _moe_decode_budget(cfg, B) -> tuple:
    """(e)'s decode budget: ``_tp_decode_budget`` and one float32
    all-reduce of the step's rows [B, 1, D] a MoE layer (the experts' and
    the shared expert's partial sums), and the bytes a rank received a
    step before, when every MoE layer's parameters were gathered whole
    over the 4 ranks (bfloat16, (M - 1) / M of the block)."""
    from repro_torch.models import backbone, common, ffn

    n_moe = backbone.layer_plan(cfg).kinds.count("moe")
    M = TP_SERVE_MESH[1]
    block = common.count_params(ffn.moe_specs(
        cfg.d_model, cfg.moe_d_ff, cfg.num_experts_padded,
        cfg.num_shared_experts))
    return (_tp_decode_budget(cfg, B) + n_moe * B * cfg.d_model * 4,
            n_moe * block * 2 * (M - 1) // M)


def _drop_gap(mesh, whole) -> float:
    """The largest difference of a MoE call's drop fraction on the mesh
    and in one process (every call's; inf where the calls differ)."""
    if len(mesh) != len(whole):
        return float("inf")
    return max((abs(a - b) for a, b in zip(mesh, whole)), default=0.0)


def logit_gaps(got, want, V) -> tuple:
    """The mesh's logits of each step against one process's: relative L2
    a step, the greedy tokens that differ, and the gates failed (a
    non-finite logit, a differing token that is no near tie, a step past
    ``TP_LOGIT_REL_L2``)."""
    rel, flips, fails = [], [], []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g[:, :V], w[:, :V]
        rel.append(float((g - w).norm() / w.norm()))
        if not bool(torch.isfinite(g).all()):
            fails.append(f"step {i}: non-finite logits")
        err = (g - w).abs().max(-1).values
        for b in range(g.shape[0]):
            mine, theirs = int(g[b].argmax()), int(w[b].argmax())
            if mine != theirs:
                gap = float(w[b, theirs] - w[b, mine])
                flips.append({"step": i, "row": b, "gap": gap,
                              "max_abs_err": float(err[b])})
                if gap > 2 * float(err[b]):
                    fails.append(f"step {i} row {b}: a greedy token differs "
                                 f"by a logit gap {gap}, not a near tie "
                                 f"(max error {float(err[b])})")
    if max(rel) > TP_LOGIT_REL_L2:
        fails.append(f"logits vs one process: relative L2 {rel} (limit "
                     f"{TP_LOGIT_REL_L2})")
    return rel, flips, fails


def phase_tp(device):
    """Phase 14: tensor parallelism over the mesh's "model" axis, 4 gloo
    ranks sharing the card.  (a) Qwen3-4B at full width, 2 of 36 layers,
    3 AdamW steps (bf16 parameters, float32 masters; computed in bf16 and
    again in float32: ``TP_TRAIN_RUNS``) on phase 13's batch on (2, 2):
    the launches the plan's on every rank, argument bytes the placements',
    the ranks' losses equal, and against one process that splits the batch
    as the data ranks do the losses, grad norms and masters' update within
    phase 13's gates (``MESH_GATES`` of the run's compute dtype).  (b)
    Qwen3-4B at full width, 8 of 36 layers, on (1, 4): a 2 x 4096 prefill
    (8 attention launches a rank, on its 8 heads) and 8
    decode steps over caches split by ``kv_seq``, fed one process's tokens:
    each step's logits within ``TP_LOGIT_REL_L2`` of one process's, a
    differing greedy token a near tie, every decode step's collective
    bytes the same and within ``_tp_decode_budget`` (no slot moves), the
    caches on the card.  (c) each rank's kernel calls at its local shapes
    against their plain versions.  (d)-(f) the MoE on "model" (the module
    docstring): Qwen2-MoE trained against one process on the whole batch
    at ``MOE_TP_GATES``, served against one process, its attention
    kernels at their local shapes."""
    from repro_torch.configs.base import load_config
    from repro_torch.distributed.spawn import run_ranks

    dev = str(device) if device.type != "cuda" \
        else f"cuda:{device.index or 0}"
    card = card_name_and_limit()
    fails = []

    def gate(ok, what):     # every gate read before the record prints
        if not ok:
            fails.append(what)
    t0 = time.time()
    ref = tp_serve_reference(device, TP_SERVE, TP_SERVE_LAYERS)
    moe_ref = {label: tp_serve_reference(device, MOE_TP, layers, dtype,
                                         MOE_TP_SEED)
               for label, layers, dtype in MOE_TP_SERVE}
    ref_s = time.time() - t0
    cfg = serve_run(TP_SERVE, TP_SERVE_LAYERS).model
    mcfg = load_config(MOE_TP).model

    def local(c, B, M, S):
        return (B, c.num_heads // M, c.num_kv_heads // M, S, c.head_dim)
    shapes = {"attention": {
        **{name: local(cfg, TRAIN_BATCH // MESH_SHAPE[0], MESH_SHAPE[1],
                       TRAIN_SEQ) for name in ("train", "train_f32")},
        "prefill": local(cfg, SERVE_BATCH, TP_SERVE_MESH[1], PROMPT),
        **{name: local(mcfg, TRAIN_BATCH // MESH_SHAPE[0], MESH_SHAPE[1],
                       TRAIN_SEQ) for name in ("train_moe", "train_moe_f32")},
        "prefill_moe": local(mcfg, SERVE_BATCH, TP_SERVE_MESH[1], PROMPT)},
        "scan": (TRAIN_SEQ, TRAIN_BATCH // MESH_SHAPE[0] * 2560
                 // MESH_SHAPE[1])}
    t0 = time.time()
    ranks = run_ranks(phase14_rank, 4, {
        "device": dev, "prompts": ref["prompts"], "fed": ref["fed"],
        "moe_serve": {k: {"prompts": v["prompts"], "fed": v["fed"]}
                      for k, v in moe_ref.items()},
        "kernel_shapes": shapes}, backend="gloo", device=dev,
        timeout_s=TP_TIMEOUT_S)
    ranks_s = time.time() - t0
    out = {"card": card, "reference_s": ref_s, "ranks_s": ranks_s,
           "part_s_rank0": ranks[0]["part_s"]}

    # (a)
    out["train"], train_launches = {}, {}
    for label, overrides in TP_TRAIN_RUNS:
        recs = [r["train"][label] for r in ranks]
        head = recs[0]
        for i, r in enumerate(recs):
            gate(r["launches"] == r["plan"], f"(14 a {label}) rank {i}: "
                 f"launches {r['launches']}, plan {r['plan']}")
            gate(r["argument_bytes"] == r["placement_bytes"],
                 f"(14 a {label}) rank {i}: argument bytes != placements'")
            gate(r["on_card"], f"(14 a {label}) rank {i}: state off the "
                 f"card")
            gate(r["losses"] == head["losses"],
                 f"(14 a {label}): ranks disagree on the loss")
        gaps, bad = train_gaps(head, head["split"],
                               mesh_run(*TP_TRAIN, overrides))
        for f in bad:
            gate(False, f"(14 a {label}): {f}")
        train_launches[f"train_{label}"] = head["launches"]
        out["train"][label] = {
            "arch": TP_TRAIN[0], "layers": TP_TRAIN[1], **overrides,
            "mesh": list(MESH_SHAPE), **gaps,
            "by_rank_step_s": [r["step_s"] for r in recs],
            "by_rank_argument_bytes": [r["argument_bytes"] for r in recs],
            **{k: head[k] for k in ("losses", "grad_norms", "split",
                                    "launches", "plan", "placement_bytes",
                                    "collectives")}}

    # (b)
    srv = [r["serve"] for r in ranks]
    n_attn = kernel_launches(cfg)["flash_attention"]
    budget = _tp_decode_budget(cfg, SERVE_BATCH)
    for i, r in enumerate(srv):
        gate(r["prefill_launches"] == n_attn, f"(14 b) rank {i}: "
              f"{r['prefill_launches']} attention launches a prefill, "
              f"not {n_attn}")
        gate(r["cache_on_card"], f"(14 b) rank {i}: a cache left the card")
        per_step = [sum(b.values()) for b in r["decode_bytes"]]
        gate(len(set(per_step)) == 1 and per_step[0] <= budget,
              f"(14 b) rank {i}: decode step bytes {per_step}, budget "
              f"{budget}")
    rel, flips, bad = logit_gaps(srv[0]["logits"], ref["logits"],
                                 cfg.vocab_size)
    for f in bad:
        gate(False, f"(14 b) {f}")
    serve_prefill = srv[0]["prefill_launches"]
    out["serve"] = {"arch": TP_SERVE, "mesh": list(TP_SERVE_MESH),
                    "prompt": [SERVE_BATCH, PROMPT],
                    "steps": TP_DECODE_STEPS, "rel_l2_by_step": rel,
                    "rel_l2_limit": TP_LOGIT_REL_L2, "flips": flips,
                    "decode_bytes_budget": budget,
                    "decode_bytes_by_rank": [r["decode_bytes"][0]
                                             for r in srv],
                    "cache_slice": srv[0]["cache_slice"],
                    "cache_bytes_per_layer": srv[0]["cache_bytes_per_layer"],
                    "prefill_s_by_rank": [r["prefill_s"] for r in srv],
                    "decode_step_s_rank0": srv[0]["decode_step_s"],
                    "one_process": {k: ref[k] for k in
                                    ("prefill_s", "decode_s", "launches")}}

    # (d)
    out["moe_train"] = {}
    for label, layers, overrides in MOE_TP_TRAIN_RUNS:
        recs = [r["moe_train"][label] for r in ranks]
        head = recs[0]
        run = mesh_run(MOE_TP, layers, overrides)
        for i, r in enumerate(recs):
            gate(r["launches"] == r["plan"], f"(14 d {label}) rank {i}: "
                 f"launches {r['launches']}, plan {r['plan']}")
            gate(r["argument_bytes"] == r["placement_bytes"],
                 f"(14 d {label}) rank {i}: argument bytes != placements'")
            gate(r["on_card"], f"(14 d {label}) rank {i}: state off the "
                 f"card")
            gate(r["losses"] == head["losses"] and r["drops"] ==
                 head["drops"], f"(14 d {label}): ranks disagree on the "
                 f"loss or the drops")
        gaps, bad = train_gaps(head, head["whole"], run, MOE_TP_GATES)
        for f in bad:
            gate(False, f"(14 d {label}): {f}")
        *_, rlim, dlim = MOE_TP_GATES[run.train.compute_dtype]
        drop_gap = _drop_gap(head["drops"], head["whole"]["drops"])
        gate(drop_gap <= dlim + 0.5 / (TRAIN_BATCH * TRAIN_SEQ
                                       * run.model.top_k),
             f"(14 d {label}): drop fractions {head['drops']} vs one "
             f"process {head['whole']['drops']} (limit {dlim})")
        gate(head["whole"]["router_grad_gap"] <= rlim, f"(14 d {label}): "
             f"router gradient gap {head['whole']['router_grad_gap']} "
             f"(limit {rlim})")
        train_launches[f"moe_train_{label}"] = head["launches"]
        out["moe_train"][label] = {
            "arch": MOE_TP, "layers": layers, **overrides,
            "reduced": {"num_layers": [mcfg.num_layers, layers]},
            "mesh": list(MESH_SHAPE), "witness": "one process, whole batch",
            **gaps, "router_grad_gap": head["whole"]["router_grad_gap"],
            "router_grad_limit": rlim, "drop_gap": drop_gap,
            "drop_gap_limit": dlim, "drops_mesh": head["drops"],
            "drops_one_process": head["whole"]["drops"],
            "peak_gb_by_rank": [r["peak_gb"] for r in recs],
            "peak_gb_one_process": head["whole"]["peak_gb"],
            "by_rank_step_s": [r["step_s"] for r in recs],
            "by_rank_argument_bytes": [r["argument_bytes"] for r in recs],
            **{k: head[k] for k in ("losses", "grad_norms", "whole",
                                    "launches", "plan", "placement_bytes",
                                    "collectives")}}

    # (e)
    out["moe_serve"] = {}
    moe_launches = {}
    for label, layers, dtype in MOE_TP_SERVE:
        srv = [r["moe_serve"][label] for r in ranks]
        rcfg = serve_run(MOE_TP, layers).model
        n_attn = kernel_launches(rcfg)["flash_attention"]
        budget, whole_gather = _moe_decode_budget(rcfg, SERVE_BATCH)
        for i, r in enumerate(srv):
            gate(r["prefill_launches"] == n_attn, f"(14 e {label}) rank "
                 f"{i}: {r['prefill_launches']} attention launches a "
                 f"prefill, not {n_attn}")
            gate(r["cache_on_card"], f"(14 e {label}) rank {i}: a cache "
                 f"left the card")
            per_step = [sum(b.values()) for b in r["decode_bytes"]]
            gate(len(set(per_step)) == 1, f"(14 e {label}) rank {i}: "
                 f"decode step bytes {per_step} vary")
            if dtype == torch.bfloat16:
                gate(per_step[0] <= budget, f"(14 e {label}) rank {i}: "
                     f"decode step bytes {per_step[0]}, budget {budget}")
        rel, flips, bad = logit_gaps(srv[0]["logits"],
                                     moe_ref[label]["logits"],
                                     rcfg.vocab_size)
        # bfloat16: routing is discontinuous and the two sides round at
        # other places, so near-tied experts flip: the drift is held at
        # its read limit, each differing greedy token a near tie; float32
        # within phase 11's float32 bound
        limit = MOE_SERVE_BF16_REL_L2 if dtype == torch.bfloat16 \
            else F32_REL_L2
        for f in bad:
            if "relative L2" not in f:
                gate(False, f"(14 e {label}) {f}")
        gate(max(rel) <= limit, f"(14 e {label}) logits vs one process: "
             f"relative L2 {rel} (limit {limit})")
        moe_launches[f"moe_serve_prefill_{label}"] = {
            "flash_attention": srv[0]["prefill_launches"]}
        out["moe_serve"][label] = {
            "arch": MOE_TP, "layers": rcfg.num_layers,
            "dtype": str(dtype).split(".")[-1], "weights": "bfloat16",
            "mesh": list(TP_SERVE_MESH), "prompt": [SERVE_BATCH, PROMPT],
            "steps": TP_DECODE_STEPS, "rel_l2_by_step": rel,
            "rel_l2_limit": limit, "flips": flips,
            "decode_bytes_budget": budget if dtype == torch.bfloat16
            else None,
            "decode_bytes_per_step_by_rank": [
                sum(r["decode_bytes"][0].values()) for r in srv],
            "decode_bytes_by_kind_rank0": srv[0]["decode_bytes"][0],
            "whole_block_gather_bytes_before": whole_gather,
            "cache_slice": srv[0]["cache_slice"],
            "prefill_s_by_rank": [r["prefill_s"] for r in srv],
            "decode_step_s_rank0": srv[0]["decode_step_s"],
            "one_process": {k: moe_ref[label][k] for k in
                            ("prefill_s", "decode_s", "launches")}}
        if layers is not None:
            out["moe_serve"][label]["reduced"] = {
                "num_layers": [mcfg.num_layers, layers]}
    bw = [r["moe_bitwise"] for r in ranks]
    for i, r in enumerate(bw):
        gate(r["finite"], f"(14 e) rank {i}: the split MoE layer's output "
             f"is not finite")
    out["moe_serve"]["experts_combine_bitwise_by_rank"] = bw

    # (c), (f)
    kern = [r["kernels"] for r in ranks]
    for i, k in enumerate(kern):
        for name, rec in k.items():
            if name == "scan":
                gate(rec["bitwise"] and rec["bwd_bitwise"], f"(14 c) rank "
                      f"{i}: decay_scan at {rec['shape']} != plain")
                continue
            gate(rec["o_within_limit"], f"(14 c) rank {i}: attention "
                  f"{name} at {rec['shape']} outside its limit")
            for n, e in rec.get("bwd_normwise", {}).items():
                gate(e <= TRAIN_ATTN_TOL[_tp_dtype(name)], f"(14 c) rank "
                      f"{i}: {n} at {rec['shape']} off by {e}")
    out["kernels"] = {"shapes": shapes, "by_rank": kern,
                      "times_rank0": ranks[0].get("kernel_times")}
    out["failed"] = fails
    emit(tensor_parallel=out)
    check(not fails, "; ".join(fails))
    return {**train_launches, **moe_launches,
            "serve_prefill": {"flash_attention": serve_prefill}}


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
    exact_ref = phase_parity(device, stream)
    t0 = time.perf_counter()
    scoring = phase_scoring(device, stream)
    emit(scoring_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    frontend = phase_frontend(device, stream)
    emit(frontend_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sharded = phase_sharded(device, stream, exact_ref)
    emit(sharded_phase_s=time.perf_counter() - t0,
         card=card_name_and_limit())
    del exact_ref
    attn_worst, serving_times = phase_serving_kernels(device)
    serve_launches = phase_serve(device)
    phase_blocks(device)
    t0 = time.perf_counter()
    family_launches = phase_families(device)
    emit(families_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    family_launches.update(phase_moe_vision(device))
    phase_moe_ep(device)
    phase_moe_drops(device)
    emit(moe_vision_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_worst, train_times = phase_train_kernels(device)
    phase_train_blocks(device)
    train_runs = phase_train(device)
    emit(train_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh_launches = phase_mesh_train(device)
    emit(mesh_train_phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tp_launches = phase_tp(device)
    emit(tp_phase_s=time.perf_counter() - t0)
    backends = {b: sdpa_backends(device, b) for b in (1, SERVE_BATCH)}
    dense_backends = sdpa_dense_backends(device)
    emit(sdpa_backends=backends, sdpa_dense_backends=dense_backends)

    smi = card_name_and_limit()
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
        "launches_frontend_keyed": frontend["keyed"],
        "launches_frontend_write_back": frontend["write_back"],
        "launches_sharded_keyed": sharded["keyed"],
        "launches_sharded_write_back": sharded["write_back"],
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
            serving_times["decay_scan"], bitwise_vs_plain_card=True,
            launches_families=new_path_launches(family_launches,
                                                "decay_scan"),
            launches_mesh=new_path_launches(mesh_launches, "decay_scan"),
            launches_tp=new_path_launches(tp_launches, "decay_scan"),
            families=serving_times["decay_scan"]["mamba2-2.7b"]),
        serving_kernel_entry(
            "flash_attention", "src/repro/kernels/flash_attention.py:37",
            serve_launches["flash_attention"],
            max(attn_worst.values()), serving_times["flash_attention"],
            max_abs_err_float32=attn_worst[torch.float32],
            max_abs_err_bfloat16=attn_worst[torch.bfloat16],
            library_backend=backends[1]["default"],
            library_backend_batch2=backends[SERVE_BATCH]["default"],
            launches_families=new_path_launches(family_launches,
                                                "flash_attention"),
            launches_mesh=new_path_launches(mesh_launches,
                                            "flash_attention"),
            launches_tp=new_path_launches(tp_launches, "flash_attention"),
            families={arch: {**serving_times["flash_attention"][arch],
                             "library_backend": dense_backends[arch][
                                 "default"]}
                      for arch, *_ in model_attention_shapes()}),
        *({**e, "launches_mesh": new_path_launches(mesh_launches,
                                                    e["name"]),
           "launches_tp": new_path_launches(tp_launches, e["name"])}
          for e in train_kernel_entries(train_worst, train_times,
                                        train_runs))])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

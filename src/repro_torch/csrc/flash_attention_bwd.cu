// Backward of the blockwise (flash) GQA attention of flash_attention.cu: the
// FlashAttention-2 backward, recomputing the weights from the forward's row
// log-sum-exp.
//
// The Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, pallas_call at line 114) has no
// VJP: the JAX package trains through its jnp `chunked_attention` and lets
// JAX differentiate it. The port trains through the CUDA forward, so this
// is its gradient, behind `torch.autograd.Function` in kernels/ops.py. The
// plain PyTorch version of the same function is `attention_bwd_ref` in
// src/repro_torch/kernels/ref.py.
//
// Semantics, as the forward's: q [B, H, Sq, D], k and v [B, Kh, Skv, D],
// query head h reads KV head h / (H / Kh); s = D^-0.5 q.k in float32, then
// c tanh(s / c) under a softcap c; the causal (q_pos >= k_pos) and window
// (q_pos - k_pos < w) masks with positions counted from 0. Given the
// forward's output o, its lse [B, H, Sq] (float32) and the gradient do:
//
//   P  = exp(s - lse) on the kept pairs, 0 elsewhere
//   dV = P^T dO              (summed over the G query heads of a KV head)
//   dP = dO V^T,   Delta = rowsum(dO o)
//   dS = P (dP - Delta), times 1 - tanh^2(s / c) under a softcap
//   dQ = D^-0.5 dS K,   dK = D^-0.5 dS^T Q   (dK summed over the group)
//
// Kernels of one backward (outputs in the inputs' dtype, every sum in
// float32): `attn_bwd_delta` (Delta, one warp a row), a dK/dV kernel, for
// bfloat16 the fixed-order reduction of a split group, then a dQ kernel.
// No two blocks write one output and nothing is accumulated by atomics, so
// the same inputs give the same bits on every call.
//
// bfloat16: tensor cores (`attn_bwd_dkdv_tc`, `attn_bwd_dq_tc`, sm_90a),
// laid out as the forward's kernel is (hopper.cuh): three warpgroups a
// block, the producer (warpgroup 2, 40 registers) issuing TMA into
// 128-byte swizzled shared memory, two consumer warpgroups (232 registers)
// running wgmma with float32 accumulators in registers. No operand is
// gathered by scalar loads and no tile is transposed in memory:
// * dK/dV, one block per (64-key tile, b * Kh, split of the G query heads
//   of the KV head). K and V stay in shared memory for the block's life;
//   the producer streams the (head, 64-row query tile) pairs that the masks
//   leave for the keys through a two-stage ring: Q and dO by TMA, lse and
//   Delta by its first warp's ordinary loads (a row starts at any float,
//   where TMA needs 16-byte aligned starts).
//   Warpgroup 0 computes S^T = K Q^T (both operands K-major from shared
//   memory), P^T = exp(S^T - lse) in registers and dV += P^T dO with P^T as
//   the register A operand and dO read MN-major (the descriptor's
//   transpose bit); it hands P^T dcap (the softcap's derivative) to
//   warpgroup 1 through 16 KB of shared memory, in accumulator order, under
//   two named barriers. Warpgroup 1 computes dP^T = V dO^T, dS^T = P^T
//   dcap (dP^T - Delta) and dK += dS^T Q the same way. So each warpgroup
//   keeps one [64 x D] float32 accumulator (128 registers a thread at D
//   256) and runs two of the four products. Computing S^T rather than S
//   makes the transposed operands come out of the accumulator as they are.
//   At D 64 a warpgroup's dK and dV accumulators and both score tiles fit
//   its registers, and the hand-over (a warpgroup waiting for the other's
//   softmax every tile) measured 2.3 us a tile, 1.09 ms at SmolLM's shape:
//   there a block holds 128 keys and each consumer runs all four products
//   on its own 64 (S^T and dP^T in one commit group, dV and dK in the
//   next).
//   Shared memory at D 256: K + V 64 KB, two stages of Q + dO 128 KB, P 16
//   KB: 209 KB.
// * Where the grid is short (MQA: RecurrentGemma's 64 key tiles x 1 KV
//   head for 132 SMs) the query-head group is split over blocks so that
//   about two blocks a SM are launched (5 splits there: 320 blocks; at
//   SmolLM's 640 blocks no split). Each split writes its float32 partial
//   dK and dV into a workspace the wrapper allocates, and
//   `attn_bwd_reduce` sums the splits in split order and casts to bf16.
// * dQ, one block per (128-row query tile, b * h), each consumer owning 64
//   rows and its Q and dO tiles; the producer streams K and V tiles (64
//   keys, 32 at D 256 so that two stages fit beside Q and dO) through a
//   two-stage ring. A consumer computes S = Q K^T and dP = dO V^T, dS in
//   registers, and dQ += dS K with K read MN-major.
// S and dP are computed in both kernels: 7 products where 5 would do. The
// alternative, dQ accumulated across the dK/dV blocks into a float32
// workspace by atomics (or `cp.reduce.async.bulk`), sums in an order that
// changes from run to run; it is not taken without a measurement that it
// pays. Where TMA cannot describe the tensors (D not a multiple of 8, a
// base not 16-byte aligned) the producer warpgroup copies the tiles into
// the same swizzled layout with ordinary loads (`kTma = false`).
// * float32 (`attn_bwd_dkdv`, `attn_bwd_dq`): scalar FMAs (a tensor-core
//   float32 product would be TF32), 32-row query tiles converted to
//   float32 in shared memory, a thread owning 4 entries of the S / dP tile
//   and 8 rows x D/64 columns of the dK and dV (or dQ) accumulators.
//
// The rounding of P and dS to bf16 before their products is why the
// bfloat16 results are held to a float32 plain backward within a bound
// (2e-2 normwise) and not to its rounding.
//
// Bound. The work is 5 products of 2 D FLOP over the kept (q, k) pairs of
// every head: at RecurrentGemma's training shape (B = 1, H = 10, Kh = 1,
// S = 4096, D = 256, causal, window 2048) 6,292,480 pairs a head, 161
// GFLOP, 163 us at the 989 TFLOP/s of bf16 tensor cores (2.4 ms at the 67
// TFLOP/s of float32 outside them); reading q, k, v, o, do, lse and writing
// dq, dk, dv once is ~60 MB, 18 us at 3.35 TB/s: bounded by operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBr = 32;          // query rows a tile
constexpr int kBc = 32;          // keys a tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// Rows row0 .. row0 + rows_tile - 1 of a [rows, D] float32 matrix into a
// [rows_tile][kD + 1] shared tile, zero past `rows` and past D.
template <int kD>
__device__ void load_tile(float* dst, const float* __restrict__ src,
                          int row0, int rows, int D, int rows_tile) {
  for (int e = threadIdx.x; e < rows_tile * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    const int gr = row0 + r;
    dst[r * (kD + 1) + c] =
        (gr < rows && c < D) ? src[static_cast<size_t>(gr) * D + c] : 0.0f;
  }
}

// ------------------------------------------------------------------ Delta
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, long rows, int D) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) +
                   threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// S = Q K^T and dP = dO V^T for the 4 entries (i, j0 + 8 jj) a thread
// owns, then P and dS (the softcap's derivative folded in). Ps may be null
// (the dQ kernel needs dS alone).
template <int kD>
__device__ __forceinline__ void scores_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Skv, float scale, int causal, int window,
    float softcap) {
  constexpr int ld = kD + 1;
  const int i = threadIdx.x / 8;
  const int j0 = threadIdx.x % 8;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    const float qv = Qs[i * ld + d];
    const float dov = dOs[i * ld + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + 8 * jj;
      s[jj] = fmaf(qv, Ks[j * ld + d], s[jj]);
      dp[jj] = fmaf(dov, Vs[j * ld + d], dp[jj]);
    }
  }
  const int qp = q0 + i;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = j0 + 8 * jj;
    const int kp = k0 + j;
    bool keep = qp < Sq && kp < Skv;
    if (causal) keep = keep && qp >= kp;
    if (window > 0) keep = keep && (qp - kp) < window;
    float x = s[jj] * scale;
    float dcap = 1.0f;
    if (softcap > 0.0f) {
      const float th = tanhf(x / softcap);
      x = th * softcap;
      dcap = 1.0f - th * th;
    }
    const float p = keep ? expf(x - lse_s[i]) : 0.0f;
    const float ds = p * (dp[jj] - delta_s[i]) * dcap;
    if (Ps != nullptr) Ps[i * (kBc + 1) + j] = p;
    dSs[i * (kBc + 1) + j] = ds;
  }
}

// ------------------------------------------------------------------ dK, dV
template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, int H, int Kh, int Sq, int Skv, int D,
              float scale, int causal, int window, float softcap) {
  constexpr int ld = kD + 1;
  constexpr int kCols = kD / 64;   // accumulator columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBc][kD + 1]
  float* Vs = Ks + kBc * ld;             // [kBc][kD + 1]
  float* Qs = Vs + kBc * ld;             // [kBr][kD + 1]
  float* dOs = Qs + kBr * ld;            // [kBr][kD + 1]
  float* Ps = dOs + kBr * ld;            // [kBr][kBc + 1]
  float* dSs = Ps + kBr * (kBc + 1);     // [kBr][kBc + 1]
  float* lse_s = dSs + kBr * (kBc + 1);  // [kBr]
  float* delta_s = lse_s + kBr;          // [kBr]

  const int tid = threadIdx.x;
  const int bk = blockIdx.y;             // b * Kh + kv head
  const int b = bk / Kh, kvh = bk % Kh;
  const int G = H / Kh;
  const int k0 = blockIdx.x * kBc;
  const float* kt = k + static_cast<size_t>(bk) * Skv * D;
  const float* vt = v + static_cast<size_t>(bk) * Skv * D;
  load_tile<kD>(Ks, kt, k0, Skv, D, kBc);
  load_tile<kD>(Vs, vt, k0, Skv, D, kBc);

  // query rows that the masks leave for keys k0 .. k0 + kBc - 1
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kBc - 1 + window) : Sq;

  const int jr = (tid / 64) * 8;         // rows jr .. jr + 7 of dK, dV
  const int cx = tid % 64;               // columns cx + 64 c
  float acc_k[8][kCols], acc_v[8][kCols];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kvh * G + g;
    const float* qh = q + static_cast<size_t>(bh) * Sq * D;
    const float* dh = dout + static_cast<size_t>(bh) * Sq * D;
    for (int q0 = (q_lo / kBr) * kBr; q0 < q_hi; q0 += kBr) {
      __syncthreads();                   // the last tile's reads are done
      load_tile<kD>(Qs, qh, q0, Sq, D, kBr);
      load_tile<kD>(dOs, dh, q0, Sq, D, kBr);
      if (tid < kBr) {
        const int r = q0 + tid;
        const size_t at = static_cast<size_t>(bh) * Sq + r;
        lse_s[tid] = r < Sq ? lse[at] : 0.0f;
        delta_s[tid] = r < Sq ? delta[at] : 0.0f;
      }
      __syncthreads();
      scores_tile<kD>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0,
                         Sq, Skv, scale, causal, window, softcap);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kBr; ++i) {
        float dov[kCols], qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = dOs[i * ld + cx + 64 * c];
          qv[c] = Qs[i * ld + cx + 64 * c];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float p = Ps[i * (kBc + 1) + jr + r];
          const float ds = dSs[i * (kBc + 1) + jr + r];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[r][c] = fmaf(p, dov[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(ds, qv[c], acc_k[r][c]);
          }
        }
      }
    }
  }

  float* dkt = dk + static_cast<size_t>(bk) * Skv * D;
  float* dvt = dv + static_cast<size_t>(bk) * Skv * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int kp = k0 + jr + r;
    if (kp >= Skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = cx + 64 * c;
      if (col < D) {
        dkt[static_cast<size_t>(kp) * D + col] =
            acc_k[r][c] * scale;
        dvt[static_cast<size_t>(kp) * D + col] = acc_v[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------- dQ
template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Kh, int Sq, int Skv, int D,
            float scale, int causal, int window, float softcap) {
  constexpr int ld = kD + 1;
  constexpr int kCols = kD / 64;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBr][kD + 1]
  float* dOs = Qs + kBr * ld;            // [kBr][kD + 1]
  float* Ks = dOs + kBr * ld;            // [kBc][kD + 1]
  float* Vs = Ks + kBc * ld;             // [kBc][kD + 1]
  float* dSs = Vs + kBc * ld;            // [kBr][kBc + 1]
  float* lse_s = dSs + kBr * (kBc + 1);  // [kBr]
  float* delta_s = lse_s + kBr;          // [kBr]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q0 = blockIdx.x * kBr;
  const float* kt = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vt = v + static_cast<size_t>(kvh) * Skv * D;
  load_tile<kD>(Qs, q + static_cast<size_t>(bh) * Sq * D, q0, Sq, D, kBr);
  load_tile<kD>(dOs, dout + static_cast<size_t>(bh) * Sq * D, q0, Sq, D,
                   kBr);
  if (tid < kBr) {
    const int r = q0 + tid;
    const size_t at = static_cast<size_t>(bh) * Sq + r;
    lse_s[tid] = r < Sq ? lse[at] : 0.0f;
    delta_s[tid] = r < Sq ? delta[at] : 0.0f;
  }

  // keys that the masks leave for rows q0 .. q0 + kBr - 1
  const int q_last = min(Sq, q0 + kBr) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  const int ir = (tid / 64) * 8;         // rows ir .. ir + 7 of dQ
  const int cx = tid % 64;
  float acc[8][kCols];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

  for (int k0 = (k_lo / kBc) * kBc; k0 < k_hi; k0 += kBc) {
    __syncthreads();                     // the last tile's reads are done
    load_tile<kD>(Ks, kt, k0, Skv, D, kBc);
    load_tile<kD>(Vs, vt, k0, Skv, D, kBc);
    __syncthreads();
    scores_tile<kD>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0,
                       Sq, Skv, scale, causal, window, softcap);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kBc; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[j * ld + cx + 64 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float ds = dSs[(ir + r) * (kBc + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }

  float* dqt = dq + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int qp = q0 + ir + r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = cx + 64 * c;
      if (col < D)
        dqt[static_cast<size_t>(qp) * D + col] = acc[r][c] * scale;
    }
  }
}

// ------------------------------------------ bfloat16: wgmma + TMA kernels

constexpr int kChunk = 64 * 128;     // [64 rows x 64 bf16], 128B-swizzled
constexpr int kTcRows = 64;          // keys (dK/dV) or query rows (dQ) a
                                     // consumer warpgroup
constexpr int kTcStages = 2;
// Consumer warpgroups 0 and 1, then the producer warpgroup. `setmaxnreg`
// takes the producer down to 40 registers and gives the consumers 232
// (40 + 2 x 232 <= 512 a lane of the SM's sub-partition).
constexpr int kTcThreads = 3 * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
// the consumers' named barriers in the dK/dV kernel (0 is __syncthreads)
constexpr int kPReady = 1, kPFree = 2, kConsumerThreads = 256;
constexpr int kSplitBlocksPerSm = 2; // the group split fills this many
                                     // dK/dV blocks a SM

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Rows row0 .. row0 + R - 1 of a row-major [rows x D] matrix into a
// swizzled [R x ND] tile (ND / 64 chunks of [R x 64], R * 128 bytes each),
// zero past `rows` and past D: the layout TMA writes. The producer
// warpgroup's 128 threads share the work (t = 0 .. 127).
template <int ND, int R>
__device__ void copy_tile(uint8_t* dst, const bf16* __restrict__ src,
                          int row0, int rows, int D, int t) {
  for (int e = t; e < R * ND; e += 128) {
    const int r = e / ND, c = e % ND;
    const int gr = row0 + r;
    const bf16 x = (gr < rows && c < D)
                       ? src[static_cast<size_t>(gr) * D + c]
                       : __float2bfloat16_rn(0.0f);
    const int byte = (c % 64) * 2;
    const int off = (c / 64) * (R * 128) + r * 128 +
                    (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
    *reinterpret_cast<bf16*>(dst + off) = x;
  }
}

// 64 floats of a row vector (lse or Delta) from index i0, zero past n
__device__ __forceinline__ void copy_row(float* dst,
                                         const float* __restrict__ src,
                                         size_t i0, size_t n, int t) {
  if (t < 64) dst[t] = i0 + t < n ? src[i0 + t] : 0.0f;
}

// Store a consumer warpgroup's [64 x ND] float32 accumulator (this
// thread's rows row0 and row0 + 8, columns 8 j + col0 (+1); hopper.cuh)
// times `mult` into a row-major [rows x D] bf16 or float32 matrix, the
// rows past `rows` and columns past D left out.
template <int ND, typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[ND / 2],
                                          int row0, int rows, int D,
                                          int col0, float mult) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= rows) continue;
    T* orow = out + static_cast<size_t>(r) * D;
#pragma unroll
    for (int jj = 0; jj < ND / 8; ++jj) {
      const int col = 8 * jj + col0;
      const float x0 = acc[4 * jj + 2 * i] * mult;
      const float x1 = acc[4 * jj + 2 * i + 1] * mult;
      if constexpr (std::is_same<T, bf16>::value) {
        if ((D & 1) == 0 && col + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
          continue;
        }
        if (col < D) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(x1);
      } else {
        if ((D & 1) == 0 && col + 1 < D) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
          continue;
        }
        if (col < D) orow[col] = x0;
        if (col + 1 < D) orow[col + 1] = x1;
      }
    }
  }
}

// The masks of a (query, key) pair.
__device__ __forceinline__ bool kept(int qp, int kp, int Sq, int Skv,
                                     int causal, int window) {
  bool keep = qp < Sq && kp < Skv;
  if (causal) keep = keep && qp >= kp;
  if (window > 0) keep = keep && (qp - kp) < window;
  return keep;
}

// ------------------------------------------------------------ dK and dV
// Shared memory, in bytes from a 1024-aligned base: K and V (the block's
// keys), the Q / dO ring, the lse / Delta ring (64 floats each a stage),
// P dcap handed from warpgroup 0 to 1 ([32][128] float32, thread-major;
// not at D 64), then the mbarriers.
template <int ND>
struct KvLayout {
  // At D 64 a warpgroup's dK and dV accumulators and both score tiles fit
  // its registers: each consumer owns 64 keys of its own and runs all four
  // products (no hand-over), so a block holds 128 keys. Wider D splits
  // the products of one 64-key tile over the two warpgroups.
  static constexpr bool kPair = ND == 64;
  static constexpr int kKeys = kPair ? 128 : 64;     // keys a block
  static constexpr int kTile = (ND / 64) * kChunk;   // [64 x ND]
  static constexpr int kK = 0;                       // [kKeys x ND]
  static constexpr int kV = kKeys / 64 * kTile;
  static constexpr int kQ = 2 * kV;                  // + s * 2 kTile; dO
                                                     // + kTile after Q
  static constexpr int kRows = kQ + kTcStages * 2 * kTile;   // + s * 512
  static constexpr int kP = kRows + kTcStages * 512;
  static constexpr int kBar = kP + (kPair ? 0 : 32 * 128 * 4);
  // kv_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kTcStages);
};

template <int ND, bool kTma>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, float* __restrict__ ws, int B, int H,
                 int Kh, int Sq, int Skv, int D, float scale, int causal,
                 int window, float softcap, int splits) {
  using L = KvLayout<ND>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBar;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + kTcStages + s); };

  const int tid = threadIdx.x;
  // warp-uniform role index: the roles must stay the arms of one if/else
  // for ptxas to give each its `setmaxnreg` budget
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128;
  // block -> (key tile, b * Kh + KV head, split of the group), the key
  // tile slowest: under the causal mask the first key tiles see the most
  // query tiles and start first
  const int per_tile = B * Kh * splits;
  const int k0 = static_cast<int>(blockIdx.x) / per_tile * L::kKeys;
  const int bk = static_cast<int>(blockIdx.x) % per_tile / splits;
  const int sp = static_cast<int>(blockIdx.x) % splits;
  const int b = bk / Kh, kvh = bk % Kh, G = H / Kh;
  const int g_lo = sp * G / splits, g_hi = (sp + 1) * G / splits;
  // query tiles that the masks leave for the block's keys, for each of
  // the split's query heads
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + L::kKeys - 1 + window) : Sq;
  const int t_first = q_lo / kTcRows;
  const int nq = max(0, (q_hi + kTcRows - 1) / kTcRows - t_first);
  const int n = (g_hi - g_lo) * nq;

  if (tid == 0) {
    // with TMA: the expect_tx arrival, and (for a stage) the 32 lanes of
    // the producer's first warp that copy lse and Delta
    hopper::mbar_init(bar_kv, kTma ? 1 : 128);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(full(s), kTma ? 1 + 32 : 128);
      hopper::mbar_init(empty(s), 8);             // one per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg < 2 && L::kPair) {
    // --------------------------------------- consumers, one 64-key tile each
    // S^T = K Q^T and dP^T = V dO^T, P^T and dS^T = P^T dcap (dP^T -
    // Delta) in registers, dV += P^T dO and dK += dS^T Q.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = t / 32, lane = t % 32;
    const int kb = k0 + kTcRows * wg;            // this warpgroup's keys
    const int key0 = kb + 16 * w + lane / 4;     // and key0 + 8
    const int col0 = 2 * (lane % 4);             // query 8 jj + col0 (+1)
    const uint32_t k_tile = base + L::kK + wg * L::kTile;
    const uint32_t v_tile = base + L::kV + wg * L::kTile;

    float dva[ND / 2], dka[ND / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) dva[i] = dka[i] = 0.0f;

    hopper::mbar_wait(bar_kv, 0);
    for (int j = 0; j < n; ++j) {
      const int s = j % kTcStages;
      const uint32_t parity = (j / kTcStages) & 1;
      const int q0 = (t_first + j % nq) * kTcRows;
      const uint32_t q_tile = hopper::opaque(base + L::kQ + s * 2 * L::kTile);
      const uint32_t do_tile = q_tile + L::kTile;
      const uint32_t ka = hopper::opaque(k_tile);
      const uint32_t va = hopper::opaque(v_tile);
      const float* rows =
          reinterpret_cast<const float*>(sbase + L::kRows + s * 512);
      const bool masked = kb + kTcRows > Skv || q0 + kTcRows > Sq ||
                          (causal && q0 < kb + kTcRows - 1) ||
                          (window > 0 && q0 + kTcRows - 1 - kb >= window);

      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      hopper::mbar_wait(full(s), parity);
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ND / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
        hopper::wgmma_m64n64k16_ss(sc, hopper::desc_sw128(ka + off, 16, 1024),
                                   hopper::desc_sw128(q_tile + off, 16, 1024),
                                   1);
        hopper::wgmma_m64n64k16_ss(dp, hopper::desc_sw128(va + off, 16, 1024),
                                   hopper::desc_sw128(do_tile + off, 16,
                                                      1024),
                                   1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + col0 + i % 2;
        float x = sc[i] * scale, dcap = 1.0f;
        if (softcap > 0.0f) {
          const float th = tanhf(x / softcap);
          x = th * softcap;
          dcap = 1.0f - th * th;
        }
        float p = exp2f((x - rows[qc]) * kLog2e);
        if (masked && !kept(q0 + qc, key0 + 8 * ((i / 2) % 2), Sq, Skv,
                            causal, window))
          p = 0.0f;
        sc[i] = p;
        dp[i] = p * dcap * (dp[i] - rows[64 + qc]);
      }

      uint32_t fp[4][4], fs[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fp[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          fs[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs_tb<ND>(
            dva, fp[kk],
            hopper::desc_sw128(do_tile + kk * 16 * 128, kChunk, 1024), 1);
        hopper::wgmma_rs_tb<ND>(
            dka, fs[kk],
            hopper::desc_sw128(q_tile + kk * 16 * 128, kChunk, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    const size_t at = static_cast<size_t>(bk) * Skv * D;
    if (splits == 1) {
      store_acc<ND>(dv + at, dva, key0, Skv, D, col0, 1.0f);
      store_acc<ND>(dk + at, dka, key0, Skv, D, col0, scale);
    } else {
      const size_t nel = static_cast<size_t>(B) * Kh * Skv * D;
      float* part = ws + 2 * static_cast<size_t>(sp) * nel + at;
      store_acc<ND>(part, dva, key0, Skv, D, col0, 1.0f);
      store_acc<ND>(part + nel, dka, key0, Skv, D, col0, 1.0f);
    }
  } else if (wg < 2) {
    // ----------------------------------- consumers, one 64-key tile shared
    // Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO. Warpgroup 1: dP^T =
    // V dO^T, dS^T = P^T dcap (dP^T - Delta), dK += dS^T Q. Both products
    // of a warpgroup are one instruction stream on other operands.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = t / 32, lane = t % 32;
    const int key0 = k0 + 16 * w + lane / 4;     // and key0 + 8
    const int col0 = 2 * (lane % 4);             // query 8 jj + col0 (+1)
    float* const pbuf = reinterpret_cast<float*>(sbase + L::kP);
    const uint32_t lhs_tile = base + (wg == 0 ? L::kK : L::kV);

    float acc[ND / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) acc[i] = 0.0f;

    hopper::mbar_wait(bar_kv, 0);
    for (int j = 0; j < n; ++j) {
      const int s = j % kTcStages;
      const uint32_t parity = (j / kTcStages) & 1;
      const int q0 = (t_first + j % nq) * kTcRows;
      // descriptors are cheap to rebuild; held across the loop they would
      // take registers from the accumulator
      const uint32_t q_tile = hopper::opaque(base + L::kQ + s * 2 * L::kTile);
      const uint32_t do_tile = q_tile + L::kTile;
      const uint32_t lhs = hopper::opaque(lhs_tile);
      const float* rows =
          reinterpret_cast<const float*>(sbase + L::kRows + s * 512);
      const bool masked = k0 + kTcRows > Skv || q0 + kTcRows > Sq ||
                          (causal && q0 < k0 + kTcRows - 1) ||
                          (window > 0 && q0 + kTcRows - 1 - k0 >= window);

      // S^T (warpgroup 0) or dP^T (1): [64 keys x 64 queries] over D
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      hopper::mbar_wait(full(s), parity);
      const uint32_t rhs = wg == 0 ? q_tile : do_tile;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ND / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
        hopper::wgmma_m64n64k16_ss(sc,
                                   hopper::desc_sw128(lhs + off, 16, 1024),
                                   hopper::desc_sw128(rhs + off, 16, 1024),
                                   1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      if (wg == 0) {
        // P^T = exp(s - lse) on the kept pairs; P^T dcap to warpgroup 1
        if (j > 0) hopper::named_barrier_sync(kPFree, kConsumerThreads);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = 8 * (i / 4) + col0 + i % 2;
          float x = sc[i] * scale, dcap = 1.0f;
          if (softcap > 0.0f) {
            const float th = tanhf(x / softcap);
            x = th * softcap;
            dcap = 1.0f - th * th;
          }
          float p = exp2f((x - rows[qc]) * kLog2e);
          if (masked && !kept(q0 + qc, key0 + 8 * ((i / 2) % 2), Sq, Skv,
                              causal, window))
            p = 0.0f;
          sc[i] = p;
          pbuf[i * 128 + t] = p * dcap;
        }
        hopper::named_barrier_arrive(kPReady, kConsumerThreads);
      } else {
        hopper::named_barrier_sync(kPReady, kConsumerThreads);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = 8 * (i / 4) + col0 + i % 2;
          sc[i] = pbuf[i * 128 + t] * (sc[i] - rows[64 + qc]);
        }
        if (j + 1 < n) hopper::named_barrier_arrive(kPFree, kConsumerThreads);
      }

      // P^T (or dS^T) rounded to bf16 as the A operand: the accumulator of
      // queries 16 kk .. 16 kk + 15 is the A fragment of step kk. The B
      // operand, dO (or Q) [64 queries x ND], is read MN-major.
      uint32_t fa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          fa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      const uint32_t rhs2 = hopper::opaque(wg == 0 ? do_tile : q_tile);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs_tb<ND>(
            acc, fa[kk], hopper::desc_sw128(rhs2 + kk * 16 * 128, kChunk, 1024),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // dV (warpgroup 0) or dK = scale dS^T Q (1): bf16 without a split,
    // else the unscaled float32 partial into the split's workspace slice
    const size_t at = static_cast<size_t>(bk) * Skv * D;
    if (splits == 1) {
      store_acc<ND>((wg == 0 ? dv : dk) + at, acc, key0, Skv, D, col0,
                    wg == 0 ? 1.0f : scale);
    } else {
      const size_t nel = static_cast<size_t>(B) * Kh * Skv * D;
      store_acc<ND>(ws + (2 * static_cast<size_t>(sp) + wg) * nel + at, acc,
                    key0, Skv, D, col0, 1.0f);
    }
  } else {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    const size_t n_rows = static_cast<size_t>(B) * H * Sq;
    if (kTma) {
      // lane 0 issues the tiles by TMA; the warp's 32 lanes copy lse and
      // Delta, whose rows start at any float (TMA needs 16-byte aligned
      // starts)
      if (t >= 32) return;
      if (t == 0) {
        hopper::mbar_arrive_expect_tx(bar_kv, 2 * L::kV);
        for (int r = 0; r < L::kKeys / kTcRows; ++r)
          for (int c = 0; c < ND / 64; ++c) {
            const int at = r * L::kTile + c * kChunk;
            hopper::tma_load_3d(base + L::kK + at, &kmap, bar_kv, c * 64,
                                k0 + r * kTcRows, bk);
            hopper::tma_load_3d(base + L::kV + at, &vmap, bar_kv, c * 64,
                                k0 + r * kTcRows, bk);
          }
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % kTcStages;
        const int bh = b * H + kvh * G + g_lo + j / nq;
        const int q0 = (t_first + j % nq) * kTcRows;
        if (j >= kTcStages)
          hopper::mbar_wait(empty(s), (j / kTcStages - 1) & 1);
        if (t == 0) {
          const uint32_t q_tile = base + L::kQ + s * 2 * L::kTile;
          hopper::mbar_arrive_expect_tx(full(s), 2 * L::kTile);
          for (int c = 0; c < ND / 64; ++c) {
            hopper::tma_load_3d(q_tile + c * kChunk, &qmap, full(s), c * 64,
                                q0, bh);
            hopper::tma_load_3d(q_tile + L::kTile + c * kChunk, &domap,
                                full(s), c * 64, q0, bh);
          }
        }
        float* rows = reinterpret_cast<float*>(sbase + L::kRows + s * 512);
        const size_t r0 = static_cast<size_t>(bh) * Sq + q0;
        for (int i = t; i < 64; i += 32) {
          copy_row(rows, lse, r0, n_rows, i);
          copy_row(rows + 64, delta, r0, n_rows, i);
        }
        hopper::mbar_arrive(full(s));
      }
    } else {
      const size_t kv_at = static_cast<size_t>(bk) * Skv * D;
      for (int r = 0; r < L::kKeys / kTcRows; ++r) {
        copy_tile<ND, kTcRows>(sbase + L::kK + r * L::kTile, k + kv_at,
                               k0 + r * kTcRows, Skv, D, t);
        copy_tile<ND, kTcRows>(sbase + L::kV + r * L::kTile, v + kv_at,
                               k0 + r * kTcRows, Skv, D, t);
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(bar_kv);
      for (int j = 0; j < n; ++j) {
        const int s = j % kTcStages;
        const int bh = b * H + kvh * G + g_lo + j / nq;
        const int q0 = (t_first + j % nq) * kTcRows;
        if (j >= kTcStages)
          hopper::mbar_wait(empty(s), (j / kTcStages - 1) & 1);
        uint8_t* q_tile = sbase + L::kQ + s * 2 * L::kTile;
        float* rows = reinterpret_cast<float*>(sbase + L::kRows + s * 512);
        const size_t q_at = static_cast<size_t>(bh) * Sq * D;
        copy_tile<ND, kTcRows>(q_tile, q + q_at, q0, Sq, D, t);
        copy_tile<ND, kTcRows>(q_tile + L::kTile, dout + q_at, q0, Sq, D, t);
        const size_t r0 = static_cast<size_t>(bh) * Sq + q0;
        copy_row(rows, lse, r0, n_rows, t);
        copy_row(rows + 64, delta, r0, n_rows, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(full(s));
      }
    }
  }
}

// The split's partial dV and dK summed in split order (no atomics: the
// same inputs give the same bits), dK times the scale, both to bf16.
__global__ void __launch_bounds__(256)
attn_bwd_reduce(const float* __restrict__ ws, bf16* __restrict__ dk,
                bf16* __restrict__ dv, size_t nel, int splits, float scale) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
       i < nel; i += static_cast<size_t>(gridDim.x) * 256) {
    float sv = ws[i], sk = ws[nel + i];
    for (int s = 1; s < splits; ++s) {
      sv += ws[2 * s * nel + i];
      sk += ws[(2 * s + 1) * nel + i];
    }
    dv[i] = __float2bfloat16_rn(sv);
    dk[i] = __float2bfloat16_rn(sk * scale);
  }
}

// ------------------------------------------------------------------- dQ
// Shared memory from a 1024-aligned base: each consumer's Q and dO tiles
// ([64 x ND]), the K / V ring (kBK keys a stage), then the mbarriers. At
// D 256 the K / V tiles hold 32 keys, so that a two-stage ring fits beside
// the 128 KB of Q and dO.
template <int ND>
struct DqLayout {
  static constexpr int kBK = ND == 256 ? 32 : 64;
  static constexpr int kQTile = (ND / 64) * kChunk;      // [64 x ND]
  static constexpr int kKChunk = kBK * 128;
  static constexpr int kKTile = (ND / 64) * kKChunk;     // [kBK x ND]
  static constexpr int kQ = 0;           // consumer g: Q at g * 2 kQTile,
                                         // dO kQTile after it
  static constexpr int kK = 4 * kQTile;  // stage s: K at + s * 2 kKTile,
                                         // V kKTile after it
  static constexpr int kBar = kK + kTcStages * 2 * kKTile;
  // q_full, full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kTcStages);
};

template <int ND, bool kTma>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq, int H,
               int Kh, int Sq, int Skv, int D, float scale, int causal,
               int window, float softcap) {
  using L = DqLayout<ND>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kTcStages + s); };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128;
  // one block per (128-row q tile, b * h), the q tile slowest and in
  // reverse: the heaviest tiles under the causal mask start first
  constexpr int kBQ = 2 * kTcRows;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_bh = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kBQ;
  const int bh = blockIdx.x % n_bh;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q_rows = min(kBQ, Sq - q0);
  // keys that the masks leave for rows q0 .. q0 + q_rows - 1
  int hi = Skv;
  if (causal) hi = min(hi, q0 + q_rows);
  const int k_first = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = hi > k_first ? (hi - k_first + BK - 1) / BK : 0;

  if (tid == 0) {
    const uint32_t arrivals = kTma ? 1 : 128;
    hopper::mbar_init(bar_q, arrivals);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(full(s), arrivals);
      hopper::mbar_init(empty(s), 8);             // one per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg < 2) {
    // ----------------------------------------------------------- consumers
    // Each owns 64 query rows: S = Q K^T and dP = dO V^T, dS = P dcap
    // (dP - Delta) in registers, dQ += dS K.
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = t / 32, lane = t % 32;
    const int rows_lo = q0 + wg * kTcRows;
    const int row0 = rows_lo + 16 * w + lane / 4;     // and row0 + 8
    const int col0 = 2 * (lane % 4);
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      const size_t at = static_cast<size_t>(bh) * Sq + r;
      lse_r[i] = r < Sq ? lse[at] : 0.0f;
      delta_r[i] = r < Sq ? delta[at] : 0.0f;
    }
    const uint32_t q_tile = base + L::kQ + wg * 2 * L::kQTile;

    float acc[ND / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) acc[i] = 0.0f;

    hopper::mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kTcStages;
      const uint32_t parity = (j / kTcStages) & 1;
      const int k0 = k_first + j * BK;
      const uint32_t q_at = hopper::opaque(q_tile);
      const uint32_t k_tile =
          hopper::opaque(base + L::kK + s * 2 * L::kKTile);
      const bool masked =
          k0 + BK > Skv || (causal && k0 + BK - 1 > rows_lo) ||
          (window > 0 && rows_lo + kTcRows - 1 - k0 >= window);

      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.0f;
      hopper::mbar_wait(full(s), parity);
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ND / 16; ++kk) {
        const uint32_t offq = (kk / 4) * kChunk + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * L::kKChunk + (kk % 4) * 32;
        hopper::wgmma_ss<BK>(sc, hopper::desc_sw128(q_at + offq, 16, 1024),
                             hopper::desc_sw128(k_tile + offk, 16, 1024), 1);
        hopper::wgmma_ss<BK>(
            dp, hopper::desc_sw128(q_at + L::kQTile + offq, 16, 1024),
            hopper::desc_sw128(k_tile + L::kKTile + offk, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        float x = sc[i] * scale, dcap = 1.0f;
        if (softcap > 0.0f) {
          const float th = tanhf(x / softcap);
          x = th * softcap;
          dcap = 1.0f - th * th;
        }
        float p = exp2f((x - lse_r[r]) * kLog2e);
        if (masked && !kept(row0 + 8 * r, k0 + 8 * (i / 4) + col0 + i % 2,
                            Sq, Skv, causal, window))
          p = 0.0f;
        sc[i] = p * dcap * (dp[i] - delta_r[r]);
      }

      // dS rounded to bf16 as the A operand; K [BK keys x ND] read
      // MN-major as B
      uint32_t fa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          fa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      const uint32_t k_at = hopper::opaque(k_tile);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs_tb<ND>(
            acc, fa[kk],
            hopper::desc_sw128(k_at + kk * 16 * 128, L::kKChunk, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
    store_acc<ND>(dq + static_cast<size_t>(bh) * Sq * D, acc, row0, Sq, D,
                  col0, scale);
  } else {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (kTma) {
      if (t != 0) return;
      hopper::mbar_arrive_expect_tx(bar_q, 4 * L::kQTile);
      for (int g = 0; g < 2; ++g)
        for (int c = 0; c < ND / 64; ++c) {
          const uint32_t dst = base + L::kQ + g * 2 * L::kQTile + c * kChunk;
          hopper::tma_load_3d(dst, &qmap, bar_q, c * 64, q0 + g * kTcRows,
                              bh);
          hopper::tma_load_3d(dst + L::kQTile, &domap, bar_q, c * 64,
                              q0 + g * kTcRows, bh);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages, k0 = k_first + j * BK;
        if (j >= kTcStages)
          hopper::mbar_wait(empty(s), (j / kTcStages - 1) & 1);
        const uint32_t k_tile = base + L::kK + s * 2 * L::kKTile;
        hopper::mbar_arrive_expect_tx(full(s), 2 * L::kKTile);
        for (int c = 0; c < ND / 64; ++c) {
          hopper::tma_load_3d(k_tile + c * L::kKChunk, &kmap, full(s),
                              c * 64, k0, kvh);
          hopper::tma_load_3d(k_tile + L::kKTile + c * L::kKChunk, &vmap,
                              full(s), c * 64, k0, kvh);
        }
      }
    } else {
      const size_t q_at = static_cast<size_t>(bh) * Sq * D;
      const size_t kv_at = static_cast<size_t>(kvh) * Skv * D;
      for (int g = 0; g < 2; ++g) {
        uint8_t* dst = sbase + L::kQ + g * 2 * L::kQTile;
        copy_tile<ND, kTcRows>(dst, q + q_at, q0 + g * kTcRows, Sq, D, t);
        copy_tile<ND, kTcRows>(dst + L::kQTile, dout + q_at,
                               q0 + g * kTcRows, Sq, D, t);
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages, k0 = k_first + j * BK;
        if (j >= kTcStages)
          hopper::mbar_wait(empty(s), (j / kTcStages - 1) & 1);
        uint8_t* k_tile = sbase + L::kK + s * 2 * L::kKTile;
        copy_tile<ND, BK>(k_tile, k + kv_at, k0, Skv, D, t);
        copy_tile<ND, BK>(k_tile + L::kKTile, v + kv_at, k0, Skv, D, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(full(s));
      }
    }
  }
}

// A [heads, rows, D] bf16 tensor read in [box_rows x 64] boxes into
// 128-byte swizzled shared memory; out-of-range elements read as zero.
bool tile_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
              int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hopper::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                   ptr, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// How many blocks share a KV head's query-head group in the dK/dV kernel:
// enough for kSplitBlocksPerSm blocks a SM, at most the group.
int tc_splits(int B, int H, int Kh, int Skv, int D) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int keys = D <= 64 ? KvLayout<64>::kKeys : KvLayout<128>::kKeys;
  const long blocks = static_cast<long>((Skv + keys - 1) / keys) * B * Kh;
  const long want = (kSplitBlocksPerSm * sms + blocks - 1) / blocks;
  return static_cast<int>(std::max(1L, std::min<long>(H / Kh, want)));
}

template <int ND, bool kTma>
int launch_tc_as(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, float* ws, int splits, int B,
                 int H, int Kh, int Sq, int Skv, int D, float scale,
                 int causal, int window, float softcap,
                 cudaStream_t stream) {
  constexpr int BK = DqLayout<ND>::kBK;
  // q, k, v, dout; then k and v in the dQ kernel's boxes
  CUtensorMap maps[6] = {};
  if (kTma && !(tile_map(&maps[0], q, D, Sq, B * H, kTcRows) &&
                tile_map(&maps[1], k, D, Skv, B * Kh, kTcRows) &&
                tile_map(&maps[2], v, D, Skv, B * Kh, kTcRows) &&
                tile_map(&maps[3], dout, D, Sq, B * H, kTcRows) &&
                tile_map(&maps[4], k, D, Skv, B * Kh, BK) &&
                tile_map(&maps[5], v, D, Skv, B * Kh, BK)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto dkdv = attn_bwd_dkdv_tc<ND, kTma>;
  auto dqk = attn_bwd_dq_tc<ND, kTma>;
  const int smem1 = KvLayout<ND>::kBytes + 1024;   // + room to align
  const int smem2 = DqLayout<ND>::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  constexpr int kKeys = KvLayout<ND>::kKeys;
  const int grid1 = (Skv + kKeys - 1) / kKeys * B * Kh * splits;
  dkdv<<<grid1, kTcThreads, smem1, stream>>>(
      maps[0], maps[1], maps[2], maps[3], qt, kt, vt, dt, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, B, H,
      Kh, Sq, Skv, D, scale, causal, window, softcap, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t nel = static_cast<size_t>(B) * Kh * Skv * D;
    const unsigned blocks = static_cast<unsigned>(
        std::min<size_t>((nel + 255) / 256, 132 * 16));
    attn_bwd_reduce<<<blocks, 256, 0, stream>>>(
        ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nel, splits,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid2 = (Sq + 2 * kTcRows - 1) / (2 * kTcRows) * B * H;
  dqk<<<grid2, kTcThreads, smem2, stream>>>(
      maps[0], maps[4], maps[5], maps[3], qt, kt, vt, dt, lse, delta,
      static_cast<bf16*>(dq), H, Kh, Sq, Skv, D, scale, causal, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int ND>
int launch_tc_nd(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, float* ws, int splits, int B,
                 int H, int Kh, int Sq, int Skv, int D, float scale,
                 int causal, int window, float softcap,
                 cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and row strides
  const bool tma = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  return tma ? launch_tc_as<ND, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                      ws, splits, B, H, Kh, Sq, Skv, D, scale,
                                      causal, window, softcap, stream)
             : launch_tc_as<ND, false>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       ws, splits, B, H, Kh, Sq, Skv, D,
                                       scale, causal, window, softcap,
                                       stream);
}

template <int kD>
size_t smem_dkdv() {
  return sizeof(float) * (2 * kBc * (kD + 1) + 2 * kBr * (kD + 1) +
                          2 * kBr * (kBc + 1) + 2 * kBr);
}
template <int kD>
size_t smem_dq() {
  return sizeof(float) * (2 * kBr * (kD + 1) + 2 * kBc * (kD + 1) +
                          kBr * (kBc + 1) + 2 * kBr);
}

template <int kD>
int launch_nd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int Kh, int Sq, int Skv, int D,
              float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  const size_t s1 = smem_dkdv<kD>(), s2 = smem_dq<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dt = static_cast<const float*>(dout);
  attn_bwd_dkdv<kD><<<dim3((Skv + kBc - 1) / kBc, B * Kh), kThreads, s1,
                      stream>>>(qt, kt, vt, dt, lse, delta,
                                static_cast<float*>(dk),
                                static_cast<float*>(dv), H, Kh, Sq, Skv, D,
                                scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq<kD><<<dim3((Sq + kBr - 1) / kBr, B * H), kThreads, s2,
                    stream>>>(qt, kt, vt, dt, lse, delta,
                              static_cast<float*>(dq), H, Kh, Sq, Skv, D,
                              scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* ws, int splits, int B, int H, int Kh,
           int Sq, int Skv, int D, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  const long rows = static_cast<long>(B) * H * Sq;
  const int per_block = kThreads / 32;
  attn_bwd_delta<T><<<static_cast<unsigned>((rows + per_block - 1) /
                                            per_block),
                      kThreads, 0, stream>>>(static_cast<const T*>(o),
                                             static_cast<const T*>(dout),
                                             delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<T, bf16>::value) {
    if (D <= 64)
      return launch_tc_nd<64>(q, k, v, dout, lse, delta, dq, dk, dv, ws,
                              splits, B, H, Kh, Sq, Skv, D, scale, causal,
                              window, softcap, stream);
    if (D <= 128)
      return launch_tc_nd<128>(q, k, v, dout, lse, delta, dq, dk, dv, ws,
                               splits, B, H, Kh, Sq, Skv, D, scale, causal,
                               window, softcap, stream);
    return launch_tc_nd<256>(q, k, v, dout, lse, delta, dq, dk, dv, ws,
                             splits, B, H, Kh, Sq, Skv, D, scale, causal,
                             window, softcap, stream);
  } else {
    if (D <= 64)
      return launch_nd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh,
                           Sq, Skv, D, scale, causal, window, softcap,
                           stream);
    if (D <= 128)
      return launch_nd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh,
                            Sq, Skv, D, scale, causal, window, softcap,
                            stream);
    return launch_nd<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh,
                          Sq, Skv, D, scale, causal, window, softcap, stream);
  }
}

}  // namespace

// How many blocks split each KV head's query-head group in the bfloat16
// dK/dV kernel for these shapes on the current device (1: no split, no
// workspace); the float32 path never splits. The caller allocates the
// workspace of a split, 2 x splits x B x Kh x Skv x D float32.
extern "C" int flash_attention_bwd_splits(int dtype, int B, int H, int Kh,
                                          int Skv, int D) {
  if (dtype != 1 || Kh < 1 || H % Kh != 0) return 1;
  return tc_splits(B, H, Kh, Skv, D);
}

// Plain C entry point for ctypes: the kernels of one backward, in order,
// on `stream`. dtype 0 is float32, 1 bfloat16 (q, k, v, o, dout and the
// outputs dq, dk, dv; lse and the scratch `delta` [B, H, Sq] float32).
// bfloat16 takes `splits` from flash_attention_bwd_splits and, when it is
// above 1, the float32 `workspace` it names (else null). Contiguous
// tensors, Sq, Skv >= 1, 1 <= D <= 256, H a multiple of Kh. Returns a CUDA
// error code (0 on success): that of a tensor map or a shared-memory
// attribute, else cudaGetLastError() after each launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* workspace, int dtype, int B, int H, int Kh, int Sq,
    int Skv, int D, float scale, int causal, int window, float softcap,
    int splits, void* stream) {
  if (D < 1 || D > kMaxD || Kh < 1 || H % Kh != 0 || splits < 1 ||
      splits > H / Kh || (dtype == 1 && splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, ws, 1, B, H,
                         Kh, Sq, Skv, D, scale, causal, window, softcap, s);
  if (dtype == 1)
    return launch<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, ws, splits, B,
                        H, Kh, Sq, Skv, D, scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

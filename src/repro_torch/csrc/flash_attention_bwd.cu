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
// Three kernels for one backward (outputs in the inputs' dtype, every sum
// in float32):
//   1. `attn_bwd_delta`: Delta, one warp a row.
//   2. dK/dV: one block per (b, KV head, 32-key tile); it loops over the
//      group's G query heads and the query tiles that the masks leave for
//      its keys, recomputing S and dP, and keeps its dK and dV tiles in
//      registers, so no two blocks write one output and no atomics are
//      needed.
//   3. dQ: one block per (b, head, query tile), looping over the 32-key
//      tiles the masks leave.
//
// Design. Right and simple first, 256 threads (8 warps) a block, tiles in
// shared memory with padded rows against bank conflicts:
// * bfloat16 (`attn_bwd_dkdv_mma`, `attn_bwd_dq_mma`): the five products
//   on the tensor cores with `mma.sync.m16n8k16` (bf16 in, float32 sums),
//   64-row query tiles. Each warp computes a 16 x 16 part of the 64 x 32
//   S and dP tiles from shared memory, turns it into P and dS in registers
//   and writes both to shared memory rounded to bfloat16 (as the forward
//   rounds P before its PV product), where the dV += P^T dO, dK += dS^T Q
//   and dQ += dS K products read them back as fragments (the transposed
//   operands by 16-bit loads). Each warp owns 16 keys x D/4 columns of dK
//   and dV (16 query rows x D/2 columns of dQ) in registers. The rounding
//   of P and dS is why the bfloat16 results are held to a float32 plain
//   backward within a bound and not to its rounding.
// * float32 (`attn_bwd_dkdv`, `attn_bwd_dq`): scalar FMAs (a tensor-core
//   float32 product would be TF32), 32-row query tiles converted to
//   float32 in shared memory, a thread owning 4 entries of the S / dP tile
//   and 8 rows x D/64 columns of the dK and dV (or dQ) accumulators.
// Both recompute S and dP in the two kernels (7 products against the
// minimum of 5), and at MQA (Kh = 1) the dK/dV kernel has only Skv / 32
// blocks. ldmatrix, wgmma, a deeper pipeline of tile loads and a split of
// the group over blocks are later work.
//
// Bound. The work is 5 products of 2 D FLOP over the kept (q, k) pairs of
// every head: at RecurrentGemma's training shape (B = 1, H = 10, Kh = 1,
// S = 4096, D = 256, causal, window 2048) 6,292,480 pairs a head, 161
// GFLOP, 163 us at the 989 TFLOP/s of bf16 tensor cores (2.4 ms at the 67
// TFLOP/s of float32 outside them); reading q, k, v, o, do, lse and writing
// dq, dk, dv once is ~60 MB, 18 us at 3.35 TB/s: bounded by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------- bfloat16: mma.sync kernels
// Tiles of bf16 in shared memory, rows padded by 8 elements (16 bytes) so
// the fragment loads below fall on distinct banks. The products run on the
// tensor cores with `mma.sync.m16n8k16` (bf16 in, float32 sums): 8 warps
// a block, each owning a 16 x 16 part of the 64 x 32 S / dP tile and a
// 16-row part of the block's dK and dV (or dQ) accumulators.
constexpr int kMBr = 64;         // query rows a tile
constexpr int kMBc = 32;         // keys a tile
constexpr int kPad = 8;          // bf16 elements of row padding
constexpr int kLdS = kMBc + kPad;

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// c += a b for one m16n8k16 tile (fragments in the PTX ISA's layout)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows row0 .. row0 + rows_tile - 1 of a [rows, D] bf16 matrix into a
// [rows_tile][kD + kPad] shared tile, zero past `rows` and past D; 16-byte
// loads where D is a multiple of 8 and the base is 16-byte aligned.
template <int kD>
__device__ void load_bf16_tile(bf16* dst, const bf16* __restrict__ src,
                               int row0, int rows, int D, int rows_tile,
                               bool vec) {
  constexpr int ld = kD + kPad;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = threadIdx.x; e < rows_tile * (kD / 8); e += kThreads) {
    const int r = e / (kD / 8), c = (e % (kD / 8)) * 8;
    const int gr = row0 + r;
    bf16* d = dst + r * ld + c;
    if (vec && gr < rows && c + 8 <= D) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(gr) * D + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (gr < rows && c + i < D)
                   ? src[static_cast<size_t>(gr) * D + c + i]
                   : zero;
    }
  }
}

// The warp's 16 x 16 part of S = Q K^T and dP = dO V^T (rows 16 wm, keys
// 16 wn of the 64 x 32 tile), then P and dS into shared memory as bf16
// ([kMBr][kLdS], Ps may be null).
template <int kD>
__device__ __forceinline__ void scores_mma(
    const bf16* Qs, const bf16* dOs, const bf16* Ks, const bf16* Vs,
    const float* lse_s, const float* delta_s, bf16* Ps, bf16* dSs, int q0,
    int k0, int Sq, int Skv, float scale, int causal, int window,
    float softcap) {
  constexpr int ld = kD + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll 4
  for (int ks = 0; ks < kD / 16; ++ks) {
    const bf16* qa = Qs + (16 * wm + g) * ld + 16 * ks + 2 * t;
    const bf16* da = dOs + (16 * wm + g) * ld + 16 * ks + 2 * t;
    const uint32_t aq[4] = {ld32(qa), ld32(qa + 8 * ld), ld32(qa + 8),
                            ld32(qa + 8 * ld + 8)};
    const uint32_t ad[4] = {ld32(da), ld32(da + 8 * ld), ld32(da + 8),
                            ld32(da + 8 * ld + 8)};
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int key = 16 * wn + 8 * nn + g;
      const bf16* kb = Ks + key * ld + 16 * ks + 2 * t;
      const bf16* vb = Vs + key * ld + 16 * ks + 2 * t;
      const uint32_t bk[2] = {ld32(kb), ld32(kb + 8)};
      const uint32_t bv[2] = {ld32(vb), ld32(vb + 8)};
      mma16816(s[nn], aq, bk);
      mma16816(dp[nn], ad, bv);
    }
  }
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wm + g + 8 * (e / 2);
      const int c = 16 * wn + 8 * nn + 2 * t + e % 2;
      const int qp = q0 + r, kp = k0 + c;
      bool keep = qp < Sq && kp < Skv;
      if (causal) keep = keep && qp >= kp;
      if (window > 0) keep = keep && (qp - kp) < window;
      float x = s[nn][e] * scale;
      float dcap = 1.0f;
      if (softcap > 0.0f) {
        const float th = tanhf(x / softcap);
        x = th * softcap;
        dcap = 1.0f - th * th;
      }
      const float p = keep ? expf(x - lse_s[r]) : 0.0f;
      const float ds = p * (dp[nn][e] - delta_s[r]) * dcap;
      if (Ps != nullptr) Ps[r * kLdS + c] = __float2bfloat16_rn(p);
      dSs[r * kLdS + c] = __float2bfloat16_rn(ds);
    }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int H, int Kh, int Sq, int Skv,
                  int D, float scale, int causal, int window, float softcap,
                  int vec) {
  constexpr int ld = kD + kPad;
  constexpr int kNt = kD / 32;       // n-tiles of a warp's dK, dV columns
  extern __shared__ __align__(16) uint8_t smem_u8[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u8);   // [kMBc][ld]
  bf16* Vs = Ks + kMBc * ld;                     // [kMBc][ld]
  bf16* Qs = Vs + kMBc * ld;                     // [kMBr][ld]
  bf16* dOs = Qs + kMBr * ld;                    // [kMBr][ld]
  bf16* Ps = dOs + kMBr * ld;                    // [kMBr][kLdS]
  bf16* dSs = Ps + kMBr * kLdS;                  // [kMBr][kLdS]
  float* lse_s = reinterpret_cast<float*>(dSs + kMBr * kLdS);   // [kMBr]
  float* delta_s = lse_s + kMBr;                                // [kMBr]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bk = blockIdx.y;             // b * Kh + kv head
  const int b = bk / Kh, kvh = bk % Kh;
  const int G = H / Kh;
  const int k0 = blockIdx.x * kMBc;
  load_bf16_tile<kD>(Ks, k + static_cast<size_t>(bk) * Skv * D, k0, Skv, D,
                     kMBc, vec);
  load_bf16_tile<kD>(Vs, v + static_cast<size_t>(bk) * Skv * D, k0, Skv, D,
                     kMBc, vec);

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kMBc - 1 + window) : Sq;

  // the warp's dK, dV part: keys 16 kh .. + 15, columns n0 .. n0 + kD / 4
  const int kh = warp % 2, n0 = (warp / 2) * (kD / 4);
  float acc_k[kNt][4] = {}, acc_v[kNt][4] = {};

  for (int hg = 0; hg < G; ++hg) {
    const int bh = b * H + kvh * G + hg;
    for (int q0 = (q_lo / kMBr) * kMBr; q0 < q_hi; q0 += kMBr) {
      __syncthreads();                   // the last tile's reads are done
      load_bf16_tile<kD>(Qs, q + static_cast<size_t>(bh) * Sq * D, q0, Sq,
                         D, kMBr, vec);
      load_bf16_tile<kD>(dOs, dout + static_cast<size_t>(bh) * Sq * D, q0,
                         Sq, D, kMBr, vec);
      if (tid < kMBr) {
        const int r = q0 + tid;
        const size_t at = static_cast<size_t>(bh) * Sq + r;
        lse_s[tid] = r < Sq ? lse[at] : 0.0f;
        delta_s[tid] = r < Sq ? delta[at] : 0.0f;
      }
      __syncthreads();
      scores_mma<kD>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                     Skv, scale, causal, window, softcap);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's 64 query rows
#pragma unroll
      for (int ks = 0; ks < kMBr / 16; ++ks) {
        const int i0 = 16 * ks + 2 * t, j = 16 * kh + g;
        const bf16* pp = Ps + i0 * kLdS + j;
        const bf16* sp = dSs + i0 * kLdS + j;
        const uint32_t ap[4] = {
            pack2(pp[0], pp[kLdS]), pack2(pp[8], pp[kLdS + 8]),
            pack2(pp[8 * kLdS], pp[9 * kLdS]),
            pack2(pp[8 * kLdS + 8], pp[9 * kLdS + 8])};
        const uint32_t as[4] = {
            pack2(sp[0], sp[kLdS]), pack2(sp[8], sp[kLdS + 8]),
            pack2(sp[8 * kLdS], sp[9 * kLdS]),
            pack2(sp[8 * kLdS + 8], sp[9 * kLdS + 8])};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = n0 + 8 * nt + g;
          const bf16* db = dOs + i0 * ld + col;
          const bf16* qb = Qs + i0 * ld + col;
          const uint32_t bd[2] = {pack2(db[0], db[ld]),
                                  pack2(db[8 * ld], db[9 * ld])};
          const uint32_t bq[2] = {pack2(qb[0], qb[ld]),
                                  pack2(qb[8 * ld], qb[9 * ld])};
          mma16816(acc_v[nt], ap, bd);
          mma16816(acc_k[nt], as, bq);
        }
      }
    }
  }

  bf16* dkt = dk + static_cast<size_t>(bk) * Skv * D;
  bf16* dvt = dv + static_cast<size_t>(bk) * Skv * D;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + 16 * kh + g + 8 * (e / 2);
      const int col = n0 + 8 * nt + 2 * t + e % 2;
      if (kp < Skv && col < D) {
        const size_t at = static_cast<size_t>(kp) * D + col;
        dkt[at] = __float2bfloat16_rn(acc_k[nt][e] * scale);
        dvt[at] = __float2bfloat16_rn(acc_v[nt][e]);
      }
    }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int H, int Kh, int Sq, int Skv, int D, float scale,
                int causal, int window, float softcap, int vec) {
  constexpr int ld = kD + kPad;
  constexpr int kNt = kD / 16;       // n-tiles of a warp's dQ columns
  extern __shared__ __align__(16) uint8_t smem_u8[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u8);   // [kMBr][ld]
  bf16* dOs = Qs + kMBr * ld;                    // [kMBr][ld]
  bf16* Ks = dOs + kMBr * ld;                    // [kMBc][ld]
  bf16* Vs = Ks + kMBc * ld;                     // [kMBc][ld]
  bf16* dSs = Vs + kMBc * ld;                    // [kMBr][kLdS]
  float* lse_s = reinterpret_cast<float*>(dSs + kMBr * kLdS);   // [kMBr]
  float* delta_s = lse_s + kMBr;                                // [kMBr]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q0 = blockIdx.x * kMBr;
  const bf16* kt = k + static_cast<size_t>(kvh) * Skv * D;
  const bf16* vt = v + static_cast<size_t>(kvh) * Skv * D;
  load_bf16_tile<kD>(Qs, q + static_cast<size_t>(bh) * Sq * D, q0, Sq, D,
                     kMBr, vec);
  load_bf16_tile<kD>(dOs, dout + static_cast<size_t>(bh) * Sq * D, q0, Sq,
                     D, kMBr, vec);
  if (tid < kMBr) {
    const int r = q0 + tid;
    const size_t at = static_cast<size_t>(bh) * Sq + r;
    lse_s[tid] = r < Sq ? lse[at] : 0.0f;
    delta_s[tid] = r < Sq ? delta[at] : 0.0f;
  }

  const int q_last = min(Sq, q0 + kMBr) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  // the warp's dQ part: rows 16 wm .. + 15, columns n0 .. n0 + kD / 2
  const int wm = warp % 4, n0 = (warp / 4) * (kD / 2);
  float acc[kNt][4] = {};

  for (int k0 = (k_lo / kMBc) * kMBc; k0 < k_hi; k0 += kMBc) {
    __syncthreads();                     // the last tile's reads are done
    load_bf16_tile<kD>(Ks, kt, k0, Skv, D, kMBc, vec);
    load_bf16_tile<kD>(Vs, vt, k0, Skv, D, kMBc, vec);
    __syncthreads();
    scores_mma<kD>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0,
                   Sq, Skv, scale, causal, window, softcap);
    __syncthreads();
    // dQ += dS K over the tile's 32 keys
#pragma unroll
    for (int ks = 0; ks < kMBc / 16; ++ks) {
      const bf16* sa = dSs + (16 * wm + g) * kLdS + 16 * ks + 2 * t;
      const uint32_t as[4] = {ld32(sa), ld32(sa + 8 * kLdS), ld32(sa + 8),
                              ld32(sa + 8 * kLdS + 8)};
      const int j0 = 16 * ks + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const bf16* kb = Ks + j0 * ld + n0 + 8 * nt + g;
        const uint32_t bk[2] = {pack2(kb[0], kb[ld]),
                                pack2(kb[8 * ld], kb[9 * ld])};
        mma16816(acc[nt], as, bk);
      }
    }
  }

  bf16* dqt = dq + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = q0 + 16 * wm + g + 8 * (e / 2);
      const int col = n0 + 8 * nt + 2 * t + e % 2;
      if (qp < Sq && col < D)
        dqt[static_cast<size_t>(qp) * D + col] =
            __float2bfloat16_rn(acc[nt][e] * scale);
    }
}

template <int kD>
size_t smem_mma_dkdv() {
  return sizeof(bf16) * (2 * kMBc * (kD + kPad) + 2 * kMBr * (kD + kPad) +
                         2 * kMBr * kLdS) + sizeof(float) * 2 * kMBr;
}
template <int kD>
size_t smem_mma_dq() {
  return sizeof(bf16) * (2 * kMBr * (kD + kPad) + 2 * kMBc * (kD + kPad) +
                         kMBr * kLdS) + sizeof(float) * 2 * kMBr;
}

template <int kD>
int launch_mma_nd(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int B, int H, int Kh, int Sq,
                  int Skv, int D, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
  const size_t s1 = smem_mma_dkdv<kD>(), s2 = smem_mma_dq<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_mma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq_mma<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  attn_bwd_dkdv_mma<kD><<<dim3((Skv + kMBc - 1) / kMBc, B * Kh), kThreads,
                          s1, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Kh, Sq, Skv, D, scale, causal, window,
      softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_mma<kD><<<dim3((Sq + kMBr - 1) / kMBr, B * H), kThreads, s2,
                        stream>>>(qt, kt, vt, dt, lse, delta,
                                  static_cast<bf16*>(dq), H, Kh, Sq, Skv, D,
                                  scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
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
           void* dk, void* dv, int B, int H, int Kh, int Sq, int Skv, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
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
      return launch_mma_nd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                               Kh, Sq, Skv, D, scale, causal, window,
                               softcap, stream);
    if (D <= 128)
      return launch_mma_nd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                                Kh, Sq, Skv, D, scale, causal, window,
                                softcap, stream);
    return launch_mma_nd<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                              Kh, Sq, Skv, D, scale, causal, window, softcap,
                              stream);
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

// Plain C entry point for ctypes: the three kernels of one backward, in
// order, on `stream`. dtype 0 is float32, 1 bfloat16 (q, k, v, o, dout and
// the outputs dq, dk, dv; lse and the scratch `delta` [B, H, Sq] float32).
// Contiguous tensors, Sq, Skv >= 1, 1 <= D <= 256, H a multiple of Kh.
// Returns a CUDA error code (0 on success): that of a shared-memory
// attribute, else cudaGetLastError() after each launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Kh, int Sq, int Skv, int D,
    float scale, int causal, int window, float softcap, void* stream) {
  if (D < 1 || D > kMaxD || Kh < 1 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Kh, Sq,
                         Skv, D, scale, causal, window, softcap, s);
  if (dtype == 1)
    return launch<bf16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Kh, Sq,
                        Skv, D, scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

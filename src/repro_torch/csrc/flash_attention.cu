// Blockwise online-softmax (flash) GQA attention with causal and local-window
// masks and a tanh logit softcap.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py (pallas_call at line 114). In the
// port it carries the attention prefill of every family (repro_torch/models/
// attention.py): local, global causal and, for the encoder, non-causal. The
// plain PyTorch version of the same function is `attention_ref` in
// src/repro_torch/kernels/ref.py.
//
// Semantics, as the Pallas kernel: q [B, H, Sq, D], k and v [B, Kh, Skv, D],
// query head h reads KV head h / (H / Kh) (no repeated K/V); scores are the
// float32 dot products times D^-0.5, then tanh(s / c) * c when the softcap c
// is positive; masked scores are -1e30 (causal: q_pos >= k_pos; window w:
// q_pos - k_pos < w, positions counted from 0 in both q and k); the online
// softmax keeps its running max, sum and accumulator in float32; the weights
// P are rounded to v's dtype before the PV product; the output is
// acc / max(l, 1e-30) rounded to q's dtype. Both paths visit only the KV
// tiles that the causal and window masks leave for their rows, and mask the
// ragged edges of Sq and Skv themselves: nothing is padded in memory.
//
// Which path a dtype takes, and why:
//
// * bfloat16: tensor cores (`flash_attention_tc`). One block of three
//   warpgroups per (128-row q tile, b * h), the heaviest q tiles first.
//   Warpgroup 2 is the producer: one thread loads Q once and then the K
//   and V tiles (64 keys each) into a two-stage ring, by TMA into 128-byte
//   swizzled shared memory, with mbarriers per stage for "K full", "V
//   full" and "empty". Warpgroups 0 and 1 each own 64 query rows. Per KV
//   tile a consumer computes S = Q K^T with wgmma m64n64k16 (Q and K from
//   shared memory), applies scale, softcap and (only on tiles that cross a
//   mask edge) the masks, updates its running max and sum, rescales O
//   (skipped when no row's max moved) and rounds P to bf16 in registers,
//   where P stays as the A operand of O += P V (wgmma m64nNk16, V read
//   MN-major from shared memory, N = D rounded up to 64, 128 or 256). The
//   two consumers take turns to start S (named barriers), so one's tensor
//   work overlaps the other's softmax. At D = 256 the O accumulator is 128
//   float32 registers a thread; `setmaxnreg` moves registers from the
//   producer (40) to the consumers (232). Where D is not a multiple of 8,
//   or a tensor is not 16-byte aligned, TMA cannot describe it: the
//   producer warpgroup then copies the tiles element by element into the
//   same swizzled layout (`kTma = false`). Either way the columns past D
//   and rows past Sq or Skv are zero in shared memory (TMA fills
//   out-of-range boxes with zero). The softmax exponentials are exp2f of
//   (s - max) * log2(e).
// * float32: scalar FMAs (`flash_attention_f32`). A tensor-core float32
//   product would be TF32, about three decimal digits, which the float32
//   parity limit (2e-4) rightly refuses. One block of 256 threads per
//   (b * h, 64-row q tile); Q, K and V tiles in shared memory as float32
//   (rows padded by one float against bank conflicts), 209 KB at D = 256; a
//   thread owns 4 query rows, 4 x 4 scores and 4 rows x D/16 columns of the
//   accumulator, and the 16 threads of a row group reduce with shuffles.
//
// Bound. At the serving shape (B = 1, H = 10, Kh = 1, S = 4096, D = 256,
// causal, window 2048) the masks leave 6,292,480 (q, k) pairs a head; two
// products of 4 D FLOP each make 64.4 GFLOP, 65 us at the 989 TFLOP/s of
// bf16 tensor cores, while reading q, k, v and writing the output once is
// 46 MB, 14 us at 3.35 TB/s: the kernel is bounded by operations. The
// 128-row q tiles visit about 8 % more pairs than the masks leave. On the
// scalar float32 path the card's rate is 67 TFLOP/s, so that path cannot
// come closer than about 1 ms.
//
// The parity limits are the same for both paths (float32 2e-4; bfloat16
// 2^-6 |want| + 2^-7 max |want row|): the tensor cores change only the
// order of the float32 sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------- float32: scalar path
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // key rows per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 16;  // accumulator columns per thread

size_t smem_bytes_f32(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int H, int Kh, int Sq, int Skv, int D, float scale,
                    int causal, int window, float softcap) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  const int ldp = kBK + 1;
  float* Qs = smem;                  // [kBQ][D + 1]
  float* Ks = Qs + kBQ * ldq;        // [kBK][D + 1]
  float* Vs = Ks + kBK * ldq;        // [kBK][D]
  float* Ps = Vs + kBK * D;          // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // column lane within the row group
  const int ty = tid >> 4;           // row group: rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q0 = blockIdx.x * kBQ;
  const int q_rows = min(kBQ, Sq - q0);
  const float* qt = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const float* kt = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vt = v + static_cast<size_t>(kvh) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    Qs[r * ldq + c] = r < q_rows ? qt[static_cast<size_t>(r) * D + c] : 0.0f;
  }

  // keys that the masks leave for rows q0 .. q0 + q_rows - 1
  int hi = Skv;
  if (causal) hi = min(hi, q0 + q_rows);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();                 // the last tile's reads are done
    const int k_rows = min(kBK, Skv - k0);
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const bool in = r < k_rows;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      Ks[r * ldq + c] = in ? kt[g] : 0.0f;
      Vs[r * D + c] = in ? vt[g] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        bool keep = kp < Skv;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && (qp - kp) < window;
        s[i][j] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_next);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_next);
        sum += p;
        Ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;     // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
      m[i] = m_next;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * ldp + j];
      const float* vr = Vs + j * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = vr[col];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int r = 4 * ty + i;
    if (r < q_rows) {
      const float denom = fmaxf(lsum, 1e-30f);
      float* orow = out + (static_cast<size_t>(bh) * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) orow[col] = o[i][c] / denom;
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Kh, int Sq, int Skv, int D, float scale, int causal,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Kh, Sq, Skv,
      D, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- bfloat16: tensor cores
using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;                 // q rows per consumer warpgroup
constexpr int kTcConsumers = 2;
constexpr int kTcBQ = kTcRows * kTcConsumers;
constexpr int kTcBK = 64;                   // keys per KV tile
constexpr int kTcStages = 2;
// The consumer warpgroups, then the producer warpgroup. Each SM
// sub-partition holds 16384 registers and one warp of every warpgroup, so
// without reallocation a thread gets 168; `setmaxnreg` takes the producer
// down to 40 and gives the consumers 232 (40 + 2 x 232 <= 512 a lane).
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunk = 64 * 128;            // [64 rows x 64 bf16], swizzled

// Shared memory, in bytes from a 1024-aligned base: Q (one [64 x ND] tile
// per consumer), the K and V rings, then the mbarriers.
template <int ND>
struct TcLayout {
  static constexpr int kTile = (ND / 64) * kChunk;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTcConsumers * kTile;
  static constexpr int kV = kK + kTcStages * kTile;
  static constexpr int kBar = kV + kTcStages * kTile;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kTcStages);
};

// Copy rows row0 .. row0 + 63 of a row-major [rows x D] matrix into a
// swizzled [64 x ND] tile, zero past `rows` and past D; the 128 threads
// of the producer warpgroup share the work (t = 0 .. 127).
template <int ND>
__device__ void copy_tile(uint8_t* dst, const bf16* __restrict__ src,
                          int row0, int rows, int D, int t) {
  for (int e = t; e < 64 * ND; e += 128) {
    const int r = e / ND, c = e % ND;
    const int gr = row0 + r;
    const bf16 x = (gr < rows && c < D)
                       ? src[static_cast<size_t>(gr) * D + c]
                       : __float2bfloat16_rn(0.0f);
    const int byte = (c % 64) * 2;
    const int off = (c / 64) * kChunk + r * 128 +
                    (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
    *reinterpret_cast<bf16*>(dst + off) = x;
  }
}

// Named barriers 1 and 2 order the consumers' turns to start S (0 is
// __syncthreads): a consumer waits on its own with bar.sync, which
// completes once the other consumer's 128 threads have arrived on it.
constexpr int kTurnBarrier = 1;
static_assert(kTcConsumers == 2, "the turns alternate between two consumers");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void named_barrier_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int ND, bool kTma>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                   int Kh, int Sq, int Skv, int D, float scale, int causal,
                   int window, float softcap) {
  using L = TcLayout<ND>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + kTcStages + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * kTcStages + s); };

  const int tid = threadIdx.x;
  // The warpgroup index, broadcast from lane 0 so that the compiler knows
  // it is uniform in a warp. The two roles must stay the two arms of one
  // if/else: only then does ptxas compile each arm to its own `setmaxnreg`
  // budget. An early return from the producer leaves the consumers at 168
  // registers, which spills O and serializes every wgmma.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128;
  // one block per (q tile, b * h), the q tile slowest and in reverse: the
  // heaviest tiles under the causal mask start first on every head, and
  // the light ones fill the last wave
  const int n_qt = (Sq + kTcBQ - 1) / kTcBQ;
  const int n_bh = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kTcBQ;
  const int bh = blockIdx.x % n_bh;
  const int kvh = (bh / H) * Kh + (bh % H) / (H / Kh);
  const int q_rows = min(kTcBQ, Sq - q0);
  // keys that the masks leave for rows q0 .. q0 + q_rows - 1
  int hi = Skv;
  if (causal) hi = min(hi, q0 + q_rows);
  const int k_first = window > 0 ? (max(0, q0 - window + 1) / kTcBK) * kTcBK
                                 : 0;
  const int n_tiles = hi > k_first ? (hi - k_first + kTcBK - 1) / kTcBK : 0;

  if (tid == 0) {
    const uint32_t full = kTma ? 1 : 128;
    hopper::mbar_init(bar_q, full);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(bar_k(s), full);
      hopper::mbar_init(bar_v(s), full);
      hopper::mbar_init(bar_e(s), 4 * kTcConsumers);   // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg < kTcConsumers) {
    // ------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int g = wg;
    const int w = t / 32, lane = t % 32;
    const int row0 = q0 + g * kTcRows + 16 * w + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_tile = base + L::kQ + g * L::kTile;

    float o[ND / 2];
#pragma unroll
    for (int i = 0; i < ND / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    if (g == 1) named_barrier_arrive(kTurnBarrier);   // consumer 0 first
    hopper::mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kTcStages;
      const uint32_t parity = (j / kTcStages) & 1;
      const int k0 = k_first + j * kTcBK;
      // descriptors are cheap to rebuild; held across the loop they would
      // take registers from the accumulators
      const uint32_t q_at = hopper::opaque(q_tile);
      const uint32_t k_tile = hopper::opaque(base + L::kK + s * L::kTile);
      const uint32_t v_tile = base + L::kV + s * L::kTile;

      // S = Q K^T over ND / 16 steps of 16 columns (zero past D)
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      hopper::mbar_wait(bar_k(s), parity);
      hopper::fence_regs(sc);
      // the consumers take turns to start S, so one's tensor-core work
      // overlaps the other's softmax
      named_barrier_sync(kTurnBarrier + g);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ND / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
        hopper::wgmma_m64n64k16_ss(
            sc, hopper::desc_sw128(q_at + off, 16, 1024),
            hopper::desc_sw128(k_tile + off, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      named_barrier_arrive(kTurnBarrier + 1 - g);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // scale, softcap, masks, online softmax; sc becomes P (float32). Most
      // tiles lie inside every mask for all 64 rows of the warpgroup and
      // skip the mask arithmetic.
      const int rows_lo = q0 + g * kTcRows;
      const bool masked =
          k0 + kTcBK > Skv || (causal && k0 + kTcBK - 1 > rows_lo) ||
          (window > 0 && rows_lo + kTcRows - 1 - k0 >= window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale;
        if (softcap > 0.0f) sc[i] = tanhf(sc[i] / softcap) * softcap;
      }
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qp = row0 + 8 * ((i / 2) % 2);
          const int kp = k0 + 8 * (i / 4) + col0 + i % 2;
          bool keep = kp < Skv;
          if (causal) keep = keep && qp >= kp;
          if (window > 0) keep = keep && (qp - kp) < window;
          if (!keep) sc[i] = kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, sc[4 * jj + 2 * i + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_next = fmaxf(m[i], mx);
        const float alpha = exp2f((m[i] - m_next) * kLog2e);
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * i + e;
            const float p = exp2f((sc[idx] - m_next) * kLog2e);
            sum += p;
            sc[idx] = p;
          }
        l[i] = l[i] * alpha + sum;     // this thread's share of the row sum
        m[i] = m_next;
        // O *= alpha, skipped when no row of the warp moved its max
        if (!__all_sync(0xffffffffu, alpha == 1.0f)) {
#pragma unroll
          for (int jj = 0; jj < ND / 8; ++jj) {
            o[4 * jj + 2 * i] *= alpha;
            o[4 * jj + 2 * i + 1] *= alpha;
          }
        }
      }

      // P rounded to bf16, as the A operand of O += P V: the accumulator of
      // columns 16 kk .. 16 kk + 15 is the A fragment of step kk
      uint32_t pa[kTcBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      hopper::mbar_wait(bar_v(s), parity);
      const uint32_t v_at = hopper::opaque(v_tile);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        hopper::wgmma_rs_tb<ND>(
            o, pa[kk], hopper::desc_sw128(v_at + kk * 16 * 128, kChunk, 1024),
            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar_e(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lsum = l[i];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int r = row0 + 8 * i;
      if (r < Sq) {
        const float denom = fmaxf(lsum, 1e-30f);
        bf16* orow = out + (static_cast<size_t>(bh) * Sq + r) * D;
#pragma unroll
        for (int jj = 0; jj < ND / 8; ++jj) {
          const int col = 8 * jj + col0;
          const float x0 = o[4 * jj + 2 * i] / denom;
          const float x1 = o[4 * jj + 2 * i + 1] / denom;
          if ((D & 1) == 0 && col + 1 < D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < D) orow[col] = __float2bfloat16_rn(x0);
            if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (kTma) {
      if (t != 0) return;
      hopper::mbar_arrive_expect_tx(bar_q, kTcConsumers * L::kTile);
      for (int g = 0; g < kTcConsumers; ++g)
        for (int c = 0; c < ND / 64; ++c)
          hopper::tma_load_3d(base + L::kQ + g * L::kTile + c * kChunk,
                              &qmap, bar_q, c * 64, q0 + g * kTcRows, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages, k0 = k_first + j * kTcBK;
        if (j >= kTcStages)
          hopper::mbar_wait(bar_e(s), (j / kTcStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(bar_k(s), L::kTile);
        for (int c = 0; c < ND / 64; ++c)
          hopper::tma_load_3d(base + L::kK + s * L::kTile + c * kChunk,
                              &kmap, bar_k(s), c * 64, k0, kvh);
        hopper::mbar_arrive_expect_tx(bar_v(s), L::kTile);
        for (int c = 0; c < ND / 64; ++c)
          hopper::tma_load_3d(base + L::kV + s * L::kTile + c * kChunk,
                              &vmap, bar_v(s), c * 64, k0, kvh);
      }
    } else {
      const bf16* qh = q + static_cast<size_t>(bh) * Sq * D;
      const bf16* kh = k + static_cast<size_t>(kvh) * Skv * D;
      const bf16* vh = v + static_cast<size_t>(kvh) * Skv * D;
      for (int g = 0; g < kTcConsumers; ++g)
        copy_tile<ND>(sbase + L::kQ + g * L::kTile, qh, q0 + g * kTcRows, Sq,
                      D, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages, k0 = k_first + j * kTcBK;
        if (j >= kTcStages)
          hopper::mbar_wait(bar_e(s), (j / kTcStages - 1) & 1);
        copy_tile<ND>(sbase + L::kK + s * L::kTile, kh, k0, Skv, D, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(bar_k(s));
        copy_tile<ND>(sbase + L::kV + s * L::kTile, vh, k0, Skv, D, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(bar_v(s));
      }
    }
  }
}

// A [heads, rows, D] bf16 tensor read in [64 x 64] boxes into 128-byte
// swizzled shared memory; out-of-range elements read as zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int rows,
                int heads) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hopper::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                   ptr, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int ND, bool kTma>
int launch_tc_as(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int Kh, int Sq, int Skv, int D, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  if (kTma && !(tensor_map(&maps[0], q, D, Sq, B * H) &&
                tensor_map(&maps[1], k, D, Skv, B * Kh) &&
                tensor_map(&maps[2], v, D, Skv, B * Kh)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_tc<ND, kTma>;
  const int smem = TcLayout<ND>::kBytes + 1024;   // + room to align to 1024
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (Sq + kTcBQ - 1) / kTcBQ * B * H;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, Kh, Sq, Skv, D, scale, causal, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int ND>
int launch_tc_nd(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int Kh, int Sq, int Skv, int D, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and row strides
  const bool tma = D % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  return tma ? launch_tc_as<ND, true>(q, k, v, out, B, H, Kh, Sq, Skv, D,
                                      scale, causal, window, softcap, stream)
             : launch_tc_as<ND, false>(q, k, v, out, B, H, Kh, Sq, Skv, D,
                                       scale, causal, window, softcap,
                                       stream);
}

int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int Kh, int Sq, int Skv, int D, float scale, int causal,
              int window, float softcap, cudaStream_t stream) {
  if (D <= 64)
    return launch_tc_nd<64>(q, k, v, out, B, H, Kh, Sq, Skv, D, scale,
                            causal, window, softcap, stream);
  if (D <= 128)
    return launch_tc_nd<128>(q, k, v, out, B, H, Kh, Sq, Skv, D, scale,
                             causal, window, softcap, stream);
  return launch_tc_nd<256>(q, k, v, out, B, H, Kh, Sq, Skv, D, scale, causal,
                           window, softcap, stream);
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 is float32 (scalar path), 1 is
// bfloat16 (tensor cores). The caller passes contiguous tensors with
// Sq, Skv >= 1, 1 <= D <= 256 and H a multiple of Kh. Returns a CUDA error
// code (0 on success): that of the tensor maps or the shared-memory
// attribute, else cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int H, int Kh, int Sq, int Skv,
                                      int D, float scale, int causal,
                                      int window, float softcap,
                                      void* stream) {
  if (D < 1 || D > kMaxD || Kh < 1 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, Kh, Sq, Skv, D, scale, causal,
                      window, softcap, s);
  if (dtype == 1)
    return launch_tc(q, k, v, out, B, H, Kh, Sq, Skv, D, scale, causal,
                     window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

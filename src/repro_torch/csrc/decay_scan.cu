// First-order linear (decayed) scan: h[t] = a[t] * h[t-1] + u[t], h[-1] = h0.
//
// Replaces the Pallas TPU kernel `_decay_scan_kernel` / `decay_scan_pallas`
// in src/repro/kernels/decay_scan.py (pallas_call at line 70). In the port it
// carries the RG-LRU recurrence of the prefill (repro_torch/models/rglru.py)
// and Mamba-2's inter-chunk state passing (repro_torch/models/mamba2.py).
// The plain PyTorch version of the same function is `decay_scan_ref` in
// src/repro_torch/kernels/ref.py.
//
// Numerics. Each step is one IEEE float32 product then one IEEE float32 sum,
// __fmul_rn then __fadd_rn (never contracted into an FMA), with denormals
// kept: the plain version's `a[t] * h` and `+ u[t]` as two separate torch
// ops. Every channel's chain runs in order, so the kernel is bitwise equal
// to the plain version.
//
// Bound. The scan must read a and u (8 bytes per element) and write h (4):
// 12 bytes per element, 126 MB at T = 4096 and C = 2560 (one 2560-wide
// RG-LRU block at batch 1), 37.6 us at 3.35 TB/s; 75 us at C = 5120
// (batch 2). Its one multiply and one add per element are far below the
// float32 rate. The chain itself, 4096 dependent multiply-add pairs of
// ~8 cycles, takes ~17 us: below the byte bound, so the design's job is to
// keep enough bytes in flight.
//
// Design. A block owns kWidth = 16 neighbouring channels for all T (160
// blocks at C = 2560, 320 at C = 5120, so every SM has work) and has two
// warps. Warp 1 streams the block's [T, 16] slabs of a and u through a
// ring of kStages = 4 shared-memory stages of kSteps = 128 time steps,
// three stages (48 KB) ahead of the chain. Each stage is two 2-D TMA boxes
// started by one thread and counted on the stage's "full" mbarrier; TMA
// fills the ragged T and C edges with zero. Warp 0 runs the chains, one
// lane per channel, reading only shared memory, stores each h[t] from
// registers (a half warp writes one 64-byte row segment), and frees the
// stage on its "empty" mbarrier. Where TMA cannot describe the arrays (C
// not a multiple of 4, or a base not 16-byte aligned) warp 1 copies the
// stages with ordinary loads instead (`kTma = false`). A chunked
// (parallel-in-time) scan would not be bitwise equal to the sequential
// chain.
//
// Backward (`decay_scan_bwd`, the gradient the training path takes through
// the scan; the Pallas kernel has none and JAX differentiates its
// associative scan). Given a, the forward's states h and the gradient g of
// h, it walks time in reverse: dh[t] = g[t] + a[t+1] * dh[t+1] (a[T] = 0),
// writes dh (which is also du), da[t] = dh[t] * h[t-1] (h[-1] = h0, or 0)
// and dh0 = a[0] * dh[0], each product and sum rounded once (__fmul_rn,
// __fadd_rn), bitwise equal to `decay_scan_bwd_ref`. Bound: it reads a, g
// and h and writes dh and da, 20 bytes an element: 210 MB at [4096, 2560],
// 62.6 us at 3.35 TB/s.
//
// Backward design. The chain must stay sequential (a chunked scan rounds
// in another order), so a block's time is its chain's: T steps of the
// lane that carries dh. The first version put everything on that lane
// (three shared loads, the recurrence, da, two strided 4-byte global
// stores a step) and walked [4096, 2560] at ~80 cycles a step, at a third
// of the card's bandwidth. Now the chain lane does only the recurrence:
// * warp 0 streams [kSteps x kWidth] boxes of a, g and h by TMA through a
//   kStages ring, from the last time block to the first;
// * warp 1 runs the chains (one lane a channel) on shared memory alone:
//   carry = g + a_next * carry, written over g in place, then frees the
//   stage for the epilogue on its "chained" mbarrier;
// * warps 2 and 3 compute da = dh * h[t-1] over the whole stage (h[t0-1],
//   in the stage still to come, once from device memory), write it over a
//   (which the chain has finished reading), and one thread stores the dh
//   and da boxes as whole rows with TMA bulk tensor stores (the box's part
//   past T or C is not written), then frees the stage for the loader once
//   TMA has read it. Without TMA (C not a multiple of 4, a base not 16-byte
//   aligned) warp 0 copies the stages in and warps 2-3 store them with
//   ordinary loads and stores.
// Lanes 16-31 of the chain warp stay idle: the chain is latency-bound, so a
// wider block would only halve the blocks (80 for 132 SMs at C = 2560).
// At T < kSteps (Mamba-2's chunk recurrence, T = 16 over 1,310,720
// channels) a ring would run one partial stage a block; there
// `decay_scan_bwd_short` gives each of 256 threads a block one channel and
// reads and writes device memory directly, coalesced across the channels.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// Chosen by measurement (PERF.md): width 32 is a little faster at
// C = 2560 but leaves 80 blocks for 132 SMs.
constexpr int kWidth = 16;          // channels a block, one lane each
constexpr int kThreads = 64;        // warp 0: chains; warp 1: loads
constexpr int kSteps = 128;         // time steps a stage
constexpr int kStages = 4;          // ring depth
constexpr int kBox = kSteps * kWidth;            // floats of a (or u) a stage
constexpr int kBarOffset = sizeof(float) * kStages * 2 * kBox;
constexpr size_t kSmemBytes = kBarOffset + 8 * 2 * kStages + 128;

template <bool kTma>
__global__ void __launch_bounds__(kThreads)
decay_scan_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap umap,
                  const float* __restrict__ a, const float* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int T, int C) {
  // [kStages][a, u][kSteps][kWidth] floats, then full[kStages],
  // empty[kStages]; 128-byte aligned for TMA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  float* const ring = reinterpret_cast<float*>(smem_raw + (base - raw));
  auto full = [&](int s) { return base + kBarOffset + 8u * s; };
  auto empty = [&](int s) { return base + kBarOffset + 8u * (kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kWidth;
  const int n_stages = (T + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), kTma ? 1 : 32);
      hopper::mbar_init(empty(s), 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 1) {
    // --------------------------------------------------------- loader
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % kStages;
      if (st >= kStages) hopper::mbar_wait(empty(s), (st / kStages - 1) & 1);
      float* sa = ring + s * 2 * kBox;
      if (kTma) {
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(full(s), 2 * kBox * sizeof(float));
          hopper::tma_load_2d(hopper::smem_u32(sa), &amap, full(s), c0,
                              st * kSteps);
          hopper::tma_load_2d(hopper::smem_u32(sa + kBox), &umap, full(s),
                              c0, st * kSteps);
        }
      } else {
        for (int e = lane; e < kBox; e += 32) {
          const int t = st * kSteps + e / kWidth, c = c0 + e % kWidth;
          const bool in = t < T && c < C;
          const size_t g = static_cast<size_t>(t) * C + c;
          sa[e] = in ? a[g] : 0.0f;
          sa[kBox + e] = in ? u[g] : 0.0f;
        }
        hopper::mbar_arrive(full(s));
      }
    }
    return;
  }

  // ------------------------------------------------------------ chains
  const int c = c0 + lane;
  const bool mine = lane < kWidth && c < C;
  float h = (mine && h0 != nullptr) ? h0[c] : 0.0f;
  for (int st = 0; st < n_stages; ++st) {
    const int s = st % kStages;
    hopper::mbar_wait(full(s), (st / kStages) & 1);
    if (lane < kWidth) {
      const float* sa = ring + s * 2 * kBox + lane;
      const float* su = sa + kBox;
      const int t0 = st * kSteps;
      float* o = out + static_cast<size_t>(t0) * C + c;
      if (t0 + kSteps <= T) {
#pragma unroll 16
        for (int r = 0; r < kSteps; ++r) {
          h = __fadd_rn(__fmul_rn(sa[r * kWidth], h), su[r * kWidth]);
          if (mine) o[static_cast<size_t>(r) * C] = h;
        }
      } else {
        for (int r = 0; r < T - t0; ++r) {
          h = __fadd_rn(__fmul_rn(sa[r * kWidth], h), su[r * kWidth]);
          if (mine) o[static_cast<size_t>(r) * C] = h;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));
  }
}

// ------------------------------------------------------------- backward
constexpr int kBwdThreads = 128;    // warp 0 loads, 1 chains, 2-3 da + stores
constexpr int kEpilogue = 64;       // threads of warps 2 and 3
constexpr int kEpilogueBarrier = 1; // their named barrier
constexpr int kBwdBarOffset = sizeof(float) * kStages * 3 * kBox;
constexpr size_t kBwdSmemBytes = kBwdBarOffset + 8 * 3 * kStages + 128;
constexpr int kShortThreads = 256;  // channels a block of the short path

template <bool kTma>
__global__ void __launch_bounds__(kBwdThreads)
decay_scan_bwd_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap dhmap,
                      const __grid_constant__ CUtensorMap damap,
                      const float* __restrict__ a,
                      const float* __restrict__ g,
                      const float* __restrict__ h,
                      const float* __restrict__ h0, float* __restrict__ dh,
                      float* __restrict__ da, float* __restrict__ dh0,
                      int T, int C) {
  // [kStages][a, g, h][kSteps][kWidth] floats (g becomes dh, a becomes
  // da), then full[kStages], chained[kStages], empty[kStages]; 128-byte
  // aligned for TMA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  float* const ring = reinterpret_cast<float*>(smem_raw + (base - raw));
  auto full = [&](int s) { return base + kBwdBarOffset + 8u * s; };
  auto chained = [&](int s) {
    return base + kBwdBarOffset + 8u * (kStages + s);
  };
  auto empty = [&](int s) {
    return base + kBwdBarOffset + 8u * (2 * kStages + s);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kWidth;
  const int n_stages = (T + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), kTma ? 1 : 32);
      hopper::mbar_init(chained(s), 32);
      hopper::mbar_init(empty(s), 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // --------------------------------------------------------- loader
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % kStages;
      const int t0 = (n_stages - 1 - st) * kSteps;     // last block first
      if (st >= kStages) hopper::mbar_wait(empty(s), (st / kStages - 1) & 1);
      float* sa = ring + s * 3 * kBox;
      if (kTma) {
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(full(s), 3 * kBox * sizeof(float));
          hopper::tma_load_2d(hopper::smem_u32(sa), &amap, full(s), c0, t0);
          hopper::tma_load_2d(hopper::smem_u32(sa + kBox), &gmap, full(s),
                              c0, t0);
          hopper::tma_load_2d(hopper::smem_u32(sa + 2 * kBox), &hmap,
                              full(s), c0, t0);
        }
      } else {
        for (int e = lane; e < kBox; e += 32) {
          const int t = t0 + e / kWidth, c = c0 + e % kWidth;
          const bool in = t < T && c < C;
          const size_t i = static_cast<size_t>(t) * C + c;
          sa[e] = in ? a[i] : 0.0f;
          sa[kBox + e] = in ? g[i] : 0.0f;
          sa[2 * kBox + e] = in ? h[i] : 0.0f;
        }
        hopper::mbar_arrive(full(s));
      }
    }
  } else if (warp == 1) {
    // ------------------------------------------------------------ chains
    const int c = c0 + lane;
    float carry = 0.0f;       // dh[t + 1]
    float a_next = 0.0f;      // a[t + 1]
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % kStages;
      const int t0 = (n_stages - 1 - st) * kSteps;
      hopper::mbar_wait(full(s), (st / kStages) & 1);
      if (lane < kWidth) {
        const float* sa = ring + s * 3 * kBox + lane;
        float* sg = const_cast<float*>(sa) + kBox;
        if (t0 + kSteps <= T) {
#pragma unroll 16
          for (int r = kSteps - 1; r >= 0; --r) {
            carry = __fadd_rn(sg[r * kWidth], __fmul_rn(a_next, carry));
            sg[r * kWidth] = carry;
            a_next = sa[r * kWidth];
          }
        } else {
          for (int r = T - t0 - 1; r >= 0; --r) {
            carry = __fadd_rn(sg[r * kWidth], __fmul_rn(a_next, carry));
            sg[r * kWidth] = carry;
            a_next = sa[r * kWidth];
          }
        }
      }
      if (kTma) hopper::fence_proxy_async();   // dh goes out by TMA
      hopper::mbar_arrive(chained(s));
    }
    if (lane < kWidth && c < C && dh0 != nullptr)
      dh0[c] = __fmul_rn(a_next, carry);
  } else {
    // ----------------------------------------- da and the stores of a stage
    const int e0 = threadIdx.x - 2 * 32;
    for (int st = 0; st < n_stages; ++st) {
      const int s = st % kStages;
      const int t0 = (n_stages - 1 - st) * kSteps;
      float* sa = ring + s * 3 * kBox;        // a, then da
      const float* sg = sa + kBox;            // dh
      const float* sh = sa + 2 * kBox;
      // h[t0 - 1]: the last state of the stage still to come
      float h_before = 0.0f;
      if (e0 < kWidth && c0 + e0 < C) {
        if (t0 > 0) h_before = h[static_cast<size_t>(t0 - 1) * C + c0 + e0];
        else if (h0 != nullptr) h_before = h0[c0 + e0];
      }
      hopper::mbar_wait(chained(s), (st / kStages) & 1);
      // element e0 + kEpilogue j is row (e0 + 64 j) / 16, column e0 % 16:
      // row 0 is j = 0 with e0 < kWidth, whose thread holds h_before
      for (int e = e0; e < kBox; e += kEpilogue) {
        const float hp = e < kWidth ? h_before : sh[e - kWidth];
        sa[e] = __fmul_rn(sg[e], hp);
      }
      if (kTma) {
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(kEpilogueBarrier, kEpilogue);
        if (e0 == 0) {
          hopper::tma_store_2d(&dhmap, hopper::smem_u32(sg), c0, t0);
          hopper::tma_store_2d(&damap, hopper::smem_u32(sa), c0, t0);
          hopper::bulk_commit();
          hopper::bulk_wait_read<0>();
          hopper::mbar_arrive(empty(s));
        }
      } else {
        for (int e = e0; e < kBox; e += kEpilogue) {
          const int t = t0 + e / kWidth, c = c0 + e % kWidth;
          if (t < T && c < C) {
            const size_t i = static_cast<size_t>(t) * C + c;
            dh[i] = sg[e];
            da[i] = sa[e];
          }
        }
        hopper::named_barrier_sync(kEpilogueBarrier, kEpilogue);
        if (e0 == 0) hopper::mbar_arrive(empty(s));
      }
    }
    if (kTma && e0 == 0) hopper::bulk_wait<0>();
  }
}

// T < kSteps: one thread a channel, walking its T steps in reverse on
// device memory (neighbouring threads on neighbouring channels).
__global__ void __launch_bounds__(kShortThreads)
decay_scan_bwd_short(const float* __restrict__ a, const float* __restrict__ g,
                     const float* __restrict__ h,
                     const float* __restrict__ h0, float* __restrict__ dh,
                     float* __restrict__ da, float* __restrict__ dh0, int T,
                     int C) {
  const int c = blockIdx.x * kShortThreads + threadIdx.x;
  if (c >= C) return;
  float carry = 0.0f, a_next = 0.0f;
#pragma unroll 4
  for (int r = T - 1; r >= 0; --r) {
    const size_t i = static_cast<size_t>(r) * C + c;
    carry = __fadd_rn(g[i], __fmul_rn(a_next, carry));
    dh[i] = carry;
    const float hp = r > 0 ? h[i - C] : (h0 != nullptr ? h0[c] : 0.0f);
    da[i] = __fmul_rn(carry, hp);
    a_next = a[i];
  }
  if (dh0 != nullptr) dh0[c] = __fmul_rn(a_next, carry);
}

// A [T, C] float32 array read in [kSteps x kWidth] boxes.
bool tensor_map(CUtensorMap* map, const float* ptr, int T, int C) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t box[2] = {kWidth, kSteps};
  return hopper::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                   ptr, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool kTma>
int launch(const float* a, const float* u, const float* h0, float* out,
           int T, int C, cudaStream_t stream) {
  CUtensorMap maps[2] = {};
  if (kTma && !(tensor_map(&maps[0], a, T, C) &&
                tensor_map(&maps[1], u, T, C)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decay_scan_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + kWidth - 1) / kWidth;
  decay_scan_kernel<kTma><<<blocks, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], a, u, h0, out, T, C);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTma>
int launch_bwd(const float* a, const float* g, const float* h,
               const float* h0, float* dh, float* da, float* dh0, int T,
               int C, cudaStream_t stream) {
  CUtensorMap maps[5] = {};
  if (kTma && !(tensor_map(&maps[0], a, T, C) &&
                tensor_map(&maps[1], g, T, C) &&
                tensor_map(&maps[2], h, T, C) &&
                tensor_map(&maps[3], dh, T, C) &&
                tensor_map(&maps[4], da, T, C)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decay_scan_bwd_kernel<kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + kWidth - 1) / kWidth;
  decay_scan_bwd_kernel<kTma><<<blocks, kBwdThreads, kBwdSmemBytes,
                                stream>>>(maps[0], maps[1], maps[2], maps[3],
                                          maps[4], a, g, h, h0, dh, da, dh0,
                                          T, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. `h0` may be null (a zero start). Returns
// the error of the tensor maps or the shared-memory attribute, else
// cudaGetLastError() after the launch (0 on success); a refused launch
// never runs, so the caller must check it.
extern "C" int decay_scan_launch(const float* a, const float* u,
                                 const float* h0, float* out, int T, int C,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA needs 16-byte aligned bases and row strides
  const bool tma = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(u)) & 15) == 0;
  return tma ? launch<true>(a, u, h0, out, T, C, s)
             : launch<false>(a, u, h0, out, T, C, s);
}

// The backward's entry point: a, g (the gradient of h) and h the forward's
// states, [T, C]; `h0` may be null (a zero start), and `dh0` is written only
// when it is not null. Writes dh (= du) and da, [T, C]. Returns as
// `decay_scan_launch` does.
extern "C" int decay_scan_bwd_launch(const float* a, const float* g,
                                     const float* h, const float* h0,
                                     float* dh, float* da, float* dh0, int T,
                                     int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < kSteps) {
    const int blocks = (C + kShortThreads - 1) / kShortThreads;
    decay_scan_bwd_short<<<blocks, kShortThreads, 0, s>>>(a, g, h, h0, dh,
                                                          da, dh0, T, C);
    return static_cast<int>(cudaGetLastError());
  }
  const bool tma = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                   reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(h) |
                                   reinterpret_cast<uintptr_t>(dh) |
                                   reinterpret_cast<uintptr_t>(da)) & 15) == 0;
  return tma ? launch_bwd<true>(a, g, h, h0, dh, da, dh0, T, C, s)
             : launch_bwd<false>(a, g, h, h0, dh, da, dh0, T, C, s);
}

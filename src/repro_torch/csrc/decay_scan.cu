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

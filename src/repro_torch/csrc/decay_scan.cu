// First-order linear (decayed) scan: h[t] = a[t] * h[t-1] + u[t], h[-1] = h0.
//
// Replaces the Pallas TPU kernel `_decay_scan_kernel` / `decay_scan_pallas`
// in src/repro/kernels/decay_scan.py (pallas_call at line 70). In the port it
// carries the RG-LRU recurrence of the prefill (repro_torch/models/rglru.py).
// The plain PyTorch version of the same function is `decay_scan_ref` in
// src/repro_torch/kernels/ref.py.
//
// Numerics. Each step is one IEEE float32 product then one IEEE float32 sum,
// __fmul_rn then __fadd_rn (never contracted into an FMA), with denormals
// kept: the plain version's `a[t] * h` and `+ u[t]` as two separate torch
// ops. The kernel is therefore bitwise equal to the plain version.
//
// Design. One thread per channel, and the time loop inside the thread: what
// the Pallas kernel's sequential ("arbitrary") time grid dimension becomes.
// Neighbouring threads read neighbouring channels of the same t, so every
// load and store of a warp is one 128-byte line. The loads of a and u do not
// depend on the carry, so the unrolled loop keeps several steps' loads in
// flight while the carry chain runs.
//
// Bound. The scan must read a and u (8 bytes per element) and write h (4):
// 12 bytes per element, 126 MB at T = 4096 and C = 2560 (one 2560-wide
// RG-LRU block at batch 1), 37.6 us at 3.35 TB/s; 75 us at C = 5120
// (batch 2). Its one multiply and one add per element are far below the
// float32 rate. One thread per channel gives 5120 threads, 40 blocks of 128
// on 132 SMs, so the kernel cannot keep enough loads in flight to reach the
// byte bound: the time is the latency of each thread's T-step chain. A
// chunked scan (local scans, then the carry through the product of a) would
// fill the card but is not bitwise equal to the sequential scan; that is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decay_scan_kernel(const float* __restrict__ a, const float* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int T, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float h = h0 != nullptr ? h0[c] : 0.0f;
  const size_t stride = static_cast<size_t>(C);
  size_t idx = static_cast<size_t>(c);
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    h = __fadd_rn(__fmul_rn(a[idx], h), u[idx]);
    out[idx] = h;
    idx += stride;
  }
}

}  // namespace

// Plain C entry point for ctypes. `h0` may be null (a zero start). Returns
// cudaGetLastError() after the launch (0 on success); a refused launch never
// runs, so the caller must check it.
extern "C" int decay_scan_launch(const float* a, const float* u,
                                 const float* h0, float* out, int T, int C,
                                 void* stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  decay_scan_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, u, h0, out, T,
                                                           C);
  return static_cast<int>(cudaGetLastError());
}

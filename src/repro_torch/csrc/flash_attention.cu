// Blockwise online-softmax (flash) GQA attention with causal and local-window
// masks and a tanh logit softcap.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py (pallas_call at line 114). In the
// port it carries the local-attention prefill (repro_torch/models/
// attention.py). The plain PyTorch version of the same function is
// `attention_ref` in src/repro_torch/kernels/ref.py.
//
// Semantics, as the Pallas kernel: q [B, H, Sq, D], k and v [B, Kh, Skv, D],
// query head h reads KV head h / (H / Kh) (no repeated K/V); scores are the
// float32 dot products times D^-0.5, then tanh(s / c) * c when the softcap c
// is positive; masked scores are -1e30 (causal: q_pos >= k_pos; window w:
// q_pos - k_pos < w, positions counted from 0 in both q and k); the online
// softmax keeps its running max, sum and accumulator in float32; the weights
// P are rounded to v's dtype before the PV product; the output is
// acc / max(l, 1e-30) rounded to q's dtype. float32 and bfloat16 inputs.
//
// Design. One block of 256 threads per (b*h, 64-row q tile). It loops over
// the 64-row KV tiles that the causal and window masks leave for its rows:
// the bounds come from the tile index, so fully masked tiles are never read
// (the Pallas grid visits them only to mask them). Rows past Skv are masked
// in the kernel and read as zero, so nothing is padded. The Q, K and V
// tiles are held in shared memory as float32 (rows padded by one float, so
// a warp's column reads hit distinct banks): 209 KB at D = 256, set as
// dynamic shared memory. A thread owns 4 query rows; for S = Q K^T it
// computes 4 x 4 scores, for O += P V 4 rows x D/16 columns of the
// accumulator in registers. The 16 threads of a row group sit in one half
// warp and reduce the row max with shuffles. The products are scalar
// float32 FMAs: exact for bfloat16 inputs, and the float32 comparison on
// the card stays free of TF32 rounding. Tensor-core products (mma.sync or
// wgmma) and TMA loads are later work.
//
// Bound. At the serving shape (B = 1, H = 10, Kh = 1, S = 4096, D = 256,
// causal, window 2048) the masks leave 6,292,480 (q, k) pairs a head; two
// products of 4 D FLOP each make 64.4 GFLOP, 65 us at the 989 TFLOP/s of
// bf16 tensor cores, while reading q, k, v and writing the output once is
// 46 MB, 14 us at 3.35 TB/s: the kernel is bounded by operations. On the
// scalar float32 path the card's rate is 67 TFLOP/s, so this design cannot
// come closer than about 1 ms there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // key rows per tile
constexpr int kThreads = 256;      // 16 row groups x 16 threads
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 16;  // accumulator columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Kh, int Sq, int Skv, int D, float scale,
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
  const T* qt = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const T* kt = k + static_cast<size_t>(kvh) * Skv * D;
  const T* vt = v + static_cast<size_t>(kvh) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    Qs[r * ldq + c] = r < q_rows ? to_f32(qt[static_cast<size_t>(r) * D + c])
                                 : 0.0f;
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
      Ks[r * ldq + c] = in ? to_f32(kt[g]) : 0.0f;
      Vs[r * D + c] = in ? to_f32(vt[g]) : 0.0f;
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
        // P is rounded to v's dtype before the PV product
        Ps[(4 * ty + i) * ldp + tx + 16 * j] = to_f32(from_f32<T>(p));
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
      T* orow = out + (static_cast<size_t>(bh) * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) orow[col] = from_f32<T>(o[i][c] / denom);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Kh, int Sq, int Skv, int D, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Kh, Sq, Skv, D,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 is float32, 1 is bfloat16. The
// caller passes contiguous tensors with Sq, Skv >= 1, 1 <= D <= 256 and H a
// multiple of Kh. Returns a CUDA error code (0 on success): that of the
// shared-memory attribute, else cudaGetLastError() after the launch.
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
    return launch<float>(q, k, v, out, B, H, Kh, Sq, Skv, D, scale, causal,
                         window, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, Kh, Sq, Skv, D, scale,
                                 causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

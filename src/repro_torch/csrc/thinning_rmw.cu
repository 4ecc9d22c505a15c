// Fused persistence-path read-modify-write over gathered profile rows.
//
// Replaces the Pallas TPU kernel `_kernel` / `thinning_rmw_pallas` in
// src/repro/kernels/thinning_rmw.py (pallas_call at line 151). It computes
// what the JAX reference `repro.kernels.ref.thinning_rmw_ref` computes, bit
// for bit: lazy decay of the [T, 3] aggregates, the features
// [cnt, sum, mean, std], the KDE intensity, the inclusion probability of the
// five policies, z = u < p and valid, the Horvitz-Thompson update and the
// full-stream control column. The plain PyTorch version of the same function
// is src/repro_torch/kernels/ref.py.
//
// Numerics. Every operation is one IEEE-rounded float32 step in the
// reference's order: products are __fmul_rn (never contracted into an FMA),
// sums __fadd_rn/__fsub_rn, quotients __fdiv_rn, roots __fsqrt_rn, and
// `exp` is the reference's Cody-Waite + degree-6 polynomial (det_exp), not
// the hardware exp. The build passes -fmad=false -ftz=true -prec-div=true
// -prec-sqrt=true; -ftz matches the denormal flushing of XLA's CPU backend.
// Constants are the float32 roundings of the reference's double constants,
// written as exact hex literals; host-side constants (1/h, budget, -alpha,
// ...) arrive already rounded to float32.
//
// Design. One thread per row over a 1-D grid with a masked ragged edge.
// The tau loop streams: each tau's decayed aggregates are recomputed where
// they are needed (once for the pp_vr standardization window, once for the
// features and the update) instead of being held in per-thread arrays, so
// there is no limit on T and no local-memory spill. It reads the same 10
// inputs and writes the same 9 outputs as the Pallas kernel (z as a byte),
// launches on the caller's stream, allocates nothing and does not
// synchronise.
//
// Bound. Per row the kernel must read (8 + 3T) floats and write (6 + 7T)
// floats plus the z byte: 297 bytes at T = 6, so 1.2 MB for a 4096-row
// block, about 0.36 us at 3.35 TB/s; its arithmetic (some 350 float32
// operations per row) would take a twentieth of that. At the engine's block
// sizes (256 to 4096 rows, 1 to 16 thread blocks) neither bound is reached:
// the time is the latency of one thread's chain of dependent operations
// (T + 2 det_exps, some 20 correctly rounded divisions). Spreading a row's
// taus over threads, and fusing the row gather, the threefry uniforms and
// the scatter back into the kernel, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Policy { kPP = 0, kPPVR = 1, kFull = 2, kFixed = 3, kUnfiltered = 4 };

// float32 roundings of the reference's double constants.
constexpr float kLog2e = 0x1.715476p+0f;    // 1.4426950408889634
constexpr float kLn2Hi = 0x1.63p-1f;        // 0.693359375
constexpr float kLn2Lo = -0x1.bd0106p-13f;  // -2.12194440e-4
constexpr float kP0 = 0x1.a0d2cep-13f;      // 1.9875691500e-4
constexpr float kP1 = 0x1.6e879cp-10f;      // 1.3981999507e-3
constexpr float kP2 = 0x1.111210p-7f;       // 8.3334519073e-3
constexpr float kP3 = 0x1.555382p-5f;       // 4.1665795894e-2
constexpr float kP4 = 0x1.555554p-3f;       // 1.6666665459e-1
constexpr float kP5 = 0x1.0p-1f;            // 5.0000001201e-1
constexpr float kExpLo = -87.0f;
constexpr float kExpHi = 88.0f;
constexpr float kFreshBelow = -0x1.93e594p+99f;  // -1e30
constexpr float k1em30 = 0x1.4484c0p-100f;       // 1e-30
constexpr float k1em12 = 0x1.197998p-40f;        // 1e-12
constexpr float k1em8 = 0x1.5798eep-27f;         // 1e-8
constexpr float k1e8 = 0x1.7d7840p+26f;          // 1e8
constexpr float k1em6 = 0x1.0c6f7ap-20f;         // 1e-6
constexpr float kOneMinus1em6 = 0x1.ffffdep-1f;  // 1.0 - 1e-6

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// repro.kernels.detmath.det_exp, step for step.
__device__ __forceinline__ float det_exp(float x) {
  const float xc = clampf(x, kExpLo, kExpHi);
  const float kf = rintf(__fmul_rn(xc, kLog2e));  // round half to even
  float r = __fsub_rn(xc, __fmul_rn(kf, kLn2Hi));
  r = __fsub_rn(r, __fmul_rn(kf, kLn2Lo));
  float y = kP0;
  y = __fadd_rn(__fmul_rn(y, r), kP1);
  y = __fadd_rn(__fmul_rn(y, r), kP2);
  y = __fadd_rn(__fmul_rn(y, r), kP3);
  y = __fadd_rn(__fmul_rn(y, r), kP4);
  y = __fadd_rn(__fmul_rn(y, r), kP5);
  const float rr = __fmul_rn(r, r);
  y = __fadd_rn(__fadd_rn(__fmul_rn(y, rr), r), 1.0f);
  const float two_k = __int_as_float((static_cast<int>(kf) + 127) << 23);
  const float out = __fmul_rn(y, two_k);
  return x < kExpLo ? 0.0f : out;
}

// One tau's aggregates decayed to decision time, and their mean/variance.
struct TauStats {
  float cnt, sm, sq, mean, var;
};

__device__ __forceinline__ TauStats tau_stats(const float* a, float dt,
                                              float tau, bool fresh) {
  const float neg_inv_tau = __fdiv_rn(-1.0f, tau);
  const float beta = fresh ? 0.0f : det_exp(__fmul_rn(dt, neg_inv_tau));
  TauStats s;
  s.cnt = __fmul_rn(a[0], beta);
  s.sm = __fmul_rn(a[1], beta);
  s.sq = __fmul_rn(a[2], beta);
  const float cnt_floor = fmaxf(s.cnt, k1em12);
  s.mean = __fdiv_rn(s.sm, cnt_floor);
  s.var = fmaxf(__fsub_rn(__fdiv_rn(s.sq, cnt_floor),
                          __fmul_rn(s.mean, s.mean)), 0.0f);
  return s;
}

__global__ void thinning_rmw_kernel(
    const float* __restrict__ taus, const float* __restrict__ last_t,
    const float* __restrict__ v_f, const float* __restrict__ agg,
    const float* __restrict__ q, const float* __restrict__ t,
    const float* __restrict__ u, const float* __restrict__ valid,
    const float* __restrict__ v_full, const float* __restrict__ last_t_full,
    float* __restrict__ new_last_t, float* __restrict__ new_v_f,
    float* __restrict__ new_agg, uint8_t* __restrict__ z_out,
    float* __restrict__ p_out, float* __restrict__ feats,
    float* __restrict__ lam_out, float* __restrict__ new_v_full,
    float* __restrict__ new_last_t_full, int B, int T, int policy,
    float neg_inv_h, float inv_h, float budget, float neg_alpha,
    float fixed_rate, int mu_tau_index, float min_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const float lt = last_t[i], vf = v_f[i], qi = q[i], ti = t[i], ui = u[i];
  const float vfl = v_full[i], ltf = last_t_full[i];
  const bool vi = valid[i] > 0.5f;
  const float* row = agg + static_cast<int64_t>(i) * 3 * T;
  float* new_row = new_agg + static_cast<int64_t>(i) * 3 * T;
  float* feat_row = feats + static_cast<int64_t>(i) * 4 * T;

  const bool fresh = lt < kFreshBelow;
  const float dt = fresh ? 0.0f : fmaxf(__fsub_rn(ti, lt), 0.0f);
  const bool fresh_full = ltf < kFreshBelow;
  const float dt_full = fresh_full ? 0.0f : fmaxf(__fsub_rn(ti, ltf), 0.0f);
  const float beta_h = fresh ? 0.0f : det_exp(__fmul_rn(dt, neg_inv_h));
  const float beta_hf =
      fresh_full ? 0.0f : det_exp(__fmul_rn(dt_full, neg_inv_h));

  // intensity estimate + inclusion probability (Eq. 2 / Eq. 4 / Eq. 5)
  const float lam =
      policy == kFull
          ? __fmul_rn(__fadd_rn(1.0f, __fmul_rn(beta_hf, vfl)), inv_h)
          : __fmul_rn(__fadd_rn(1.0f, __fmul_rn(beta_h, vf)), inv_h);
  const float base = fminf(__fdiv_rn(budget, fmaxf(lam, k1em30)), 1.0f);
  float p;
  if (policy == kUnfiltered) {
    p = 1.0f;
  } else if (policy == kFixed) {
    p = fixed_rate;
  } else if (policy == kPPVR) {
    const TauStats s = tau_stats(row + 3 * mu_tau_index, dt,
                                 taus[mu_tau_index], fresh);
    const bool cold = s.cnt < 1.0f;
    const float mu_w = cold ? 0.0f : s.mean;
    const float sg = cold ? k1e8 : __fadd_rn(__fsqrt_rn(s.var), k1em8);
    const float zs =
        clampf(__fdiv_rn(__fsub_rn(qi, mu_w), fmaxf(sg, k1em8)), -8.0f, 8.0f);
    const float b = clampf(base, k1em6, kOneMinus1em6);
    // log-free sigmoid(logit(b) + alpha * zs), as in the reference
    const float odds = __fdiv_rn(__fsub_rn(1.0f, b), b);
    const float e_tilt = det_exp(__fmul_rn(zs, neg_alpha));
    p = base >= kOneMinus1em6
            ? 1.0f
            : __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(odds, e_tilt)));
  } else {  // pp, and the decision half of full
    p = base;
  }
  p = clampf(p, min_p, 1.0f);

  const bool zi = (ui < p) && vi;
  const float inv_p = zi ? __fdiv_rn(1.0f, p) : 0.0f;
  const float q2 = __fmul_rn(qi, qi);
  for (int j = 0; j < T; ++j) {
    const TauStats s = tau_stats(row + 3 * j, dt, taus[j], fresh);
    feat_row[j] = s.cnt;
    feat_row[T + j] = s.sm;
    feat_row[2 * T + j] = s.mean;
    feat_row[3 * T + j] = __fsqrt_rn(s.var);
    // Horvitz-Thompson masked update (only z rows change)
    if (zi) {
      new_row[3 * j] = __fadd_rn(s.cnt, inv_p);
      new_row[3 * j + 1] = __fadd_rn(s.sm, __fmul_rn(inv_p, qi));
      new_row[3 * j + 2] = __fadd_rn(s.sq, __fmul_rn(inv_p, q2));
    } else {
      new_row[3 * j] = row[3 * j];
      new_row[3 * j + 1] = row[3 * j + 1];
      new_row[3 * j + 2] = row[3 * j + 2];
    }
  }
  z_out[i] = zi ? 1 : 0;
  p_out[i] = p;
  lam_out[i] = lam;
  new_v_f[i] = zi ? __fadd_rn(inv_p, __fmul_rn(beta_h, vf)) : vf;
  new_last_t[i] = zi ? ti : lt;
  // full-stream control column (every valid event, unconditional)
  new_v_full[i] = vi ? __fadd_rn(1.0f, __fmul_rn(beta_hf, vfl)) : vfl;
  new_last_t_full[i] = vi ? ti : ltf;
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the
// launch (0 on success); a refused launch never runs, so the caller must
// check it.
extern "C" int thinning_rmw_launch(
    const float* taus, const float* last_t, const float* v_f,
    const float* agg, const float* q, const float* t, const float* u,
    const float* valid, const float* v_full, const float* last_t_full,
    float* new_last_t, float* new_v_f, float* new_agg, uint8_t* z,
    float* p, float* feats, float* lam, float* new_v_full,
    float* new_last_t_full, int B, int T, int policy, float neg_inv_h,
    float inv_h, float budget, float neg_alpha, float fixed_rate,
    int mu_tau_index, float min_p, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (B + kThreads - 1) / kThreads;
  thinning_rmw_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      taus, last_t, v_f, agg, q, t, u, valid, v_full, last_t_full,
      new_last_t, new_v_f, new_agg, z, p, feats, lam, new_v_full,
      new_last_t_full, B, T, policy, neg_inv_h, inv_h, budget, neg_alpha,
      fixed_rate, mu_tau_index, min_p);
  return static_cast<int>(cudaGetLastError());
}

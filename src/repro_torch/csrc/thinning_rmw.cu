// Fused persistence-path read-modify-write, keyed: one launch per step.
//
// Replaces the Pallas TPU kernel `_kernel` / `thinning_rmw_pallas` in
// src/repro/kernels/thinning_rmw.py (pallas_call at line 151), together
// with the two steps the JAX package leaves to XLA around it: the row
// gather (`_gather_rows`, src/repro/core/engine.py:92) and the counter-RNG
// uniforms (`uniform_for_events`, src/repro/core/thinning.py:80); in exact
// mode also the conflict-free scatter back into the state
// (src/repro/core/engine.py:176-206). It computes what the JAX reference
// `repro.kernels.ref.thinning_rmw_ref` computes, bit for bit: lazy decay of
// the [T, 3] aggregates, the features [cnt, sum, mean, std], the KDE
// intensity, the inclusion probability of the five policies, z = u < p and
// valid, the Horvitz-Thompson update and the full-stream control column.
// The plain PyTorch versions are `thinning_rmw_ref` (rows in) and
// `thinning_rmw_keyed_ref` (keys in), src/repro_torch/kernels/ref.py.
//
// Three modes, one template:
//   kRows       gathered rows and u in, the 9 outputs out (the contract of
//               `ops.thinning_rmw`; the row index is the identity);
//   kDecide     keys in: rows read from the state tables at key[i], the
//               uniform drawn in the kernel, only z, p, lam and the features
//               written (the fast step's decision stage);
//   kWriteBack  as kDecide, for the rows named by a lane index, and the
//               updated rows written back into the state in place (the
//               exact step's conflict-free chunk).
//
// Numerics. Every float operation is one IEEE-rounded float32 step in the
// reference's order: products are __fmul_rn (never contracted into an FMA),
// sums __fadd_rn/__fsub_rn, quotients __fdiv_rn, roots __fsqrt_rn, and
// `exp` is the reference's Cody-Waite + degree-6 polynomial (det_exp), not
// the hardware exp. The build passes -fmad=false -ftz=true -prec-div=true
// -prec-sqrt=true; -ftz matches the denormal flushing of XLA's CPU backend.
// Constants are the float32 roundings of the reference's double constants,
// written as exact hex literals; host-side constants (1/h, budget, -alpha,
// ...) arrive already rounded to float32. The uniform is threefry-2x32 in
// native uint32 with __funnelshift_l rotations, as jax.random computes it:
// integer arithmetic, so exact.
//
// Design. The first version ran one thread per row: 16 blocks at B = 4096
// (12 % of the SMs), a dependent chain of T + 2 det_exps and some 20
// divisions per thread, 13 us whatever B was. Here
//   * a group of kLanes lanes owns one row; lane j owns tau j (and j +
//     kLanes, ... for T > kLanes): it loads that tau's 3 aggregates once,
//     decays them once, writes its 4 features and its 3 updated
//     aggregates. A row's T det_exps run side by side, and the grid holds
//     kLanes times the threads;
//   * -1/tau is computed once per block into shared memory (the same
//     correctly rounded quotient of the same operands, so the same bits);
//   * the per-row scalar chain (dt, the two KDE decays, lam, p, 1/p) runs
//     redundantly in every lane of the group, which is cheaper than a
//     broadcast; under pp_vr the group takes the standardisation window's
//     count, mean and variance from the lane that owns it (__shfl_sync of
//     width kLanes) instead of decaying that tau a second time;
//   * the three threefry-2x32 blocks of the uniform need only the entity
//     and t, so they run while the row's loads are in flight;
//   * in kWriteBack every lane of a group reads the row before one lane
//     writes its scalar columns (__syncwarp on the group's mask between the
//     two); lane j writes only the aggregates it read. Inactive rows (empty
//     slots, invalid events) write nothing, since their key is not theirs
//     to write; active keys are distinct within one launch (the exact
//     step's schedule guarantees it).
// The tau-parallel shape and the block size are plain constants below;
// PERF.md records the sweep of kLanes in {4, 8} x kRows in {32, 64}.
//
// Bound (B = 4096, T = 6, decision only): each event reads key 8, q 4, t
// 4, valid 1 and its row (4 + 3T) * 4 bytes, writes z 1, p 4, lam 4 and
// 16T of features: 210 bytes, 0.86 MB, 0.26 us at 3.35 TB/s. Its
// operations (some 350 float32 and 240 integer threefry operations per
// row, counted at the same 67 T/s) take a seventh of that. What is left
// above the bound at these sizes is the launch and the latency of one
// group's chain (3 threefrys, 3-4 det_exps, some 10 divisions) behind two
// dependent loads (key, then the row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Policy { kPP = 0, kPPVR = 1, kFull = 2, kFixed = 3, kUnfiltered = 4 };
enum Mode { kRows = 0, kDecide = 1, kWriteBack = 2 };

// Tau-parallel shape: lanes per row (a power of two, at most 32), rows per
// block, and how many of a lane's taus stay in registers between the
// decision and the update (taus beyond kKeep * kLanes are decayed again).
constexpr int kLanes = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kKeep = 2;
constexpr int kThreads = kLanes * kRowsPerBlock;
static_assert(kLanes > 0 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "kLanes must be a power of two <= 32");

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
constexpr float kFreshSentinel = -0x1.2ced32p+126f;  // -1e38
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

// ---- counter RNG: threefry-2x32, 20 rounds, as jax.random -------------

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// uniform_for_events: fold_in(fold_in(key, entity), time bits), then the
// scalar uniform's xor of the two words, top 23 bits as a mantissa.
__device__ __forceinline__ float event_uniform(uint32_t k0, uint32_t k1,
                                               uint32_t entity, float t) {
  const uint2 a = threefry2x32(k0, k1, 0u, entity);
  const uint2 b = threefry2x32(a.x, a.y, 0u, __float_as_uint(t));
  const uint2 c = threefry2x32(b.x, b.y, 0u, 0u);
  return __fsub_rn(__uint_as_float(((c.x ^ c.y) >> 9) | 0x3F800000u), 1.0f);
}

// ---- the fused pass ------------------------------------------------------

// One tau's aggregates decayed to decision time, and their mean/variance.
struct TauStats {
  float cnt, sm, sq, mean, var;
};

__device__ __forceinline__ TauStats tau_stats(float a0, float a1, float a2,
                                              float dt, float neg_inv_tau,
                                              bool fresh) {
  const float beta = fresh ? 0.0f : det_exp(__fmul_rn(dt, neg_inv_tau));
  TauStats s;
  s.cnt = __fmul_rn(a0, beta);
  s.sm = __fmul_rn(a1, beta);
  s.sq = __fmul_rn(a2, beta);
  const float cnt_floor = fmaxf(s.cnt, k1em12);
  s.mean = __fdiv_rn(s.sm, cnt_floor);
  s.var = fmaxf(__fsub_rn(__fdiv_rn(s.sq, cnt_floor),
                          __fmul_rn(s.mean, s.mean)), 0.0f);
  return s;
}

struct Params {
  const float* taus;
  // Tables: the state [N] / [N, T, 3] (keyed modes; written in place in
  // kWriteBack), or the gathered rows [B] / [B, 3T] (kRows).
  float* last_t;
  float* v_f;
  float* agg;
  float* v_full;
  float* last_t_full;
  // Events [L]; lanes [n_rows] or null (row i is event i).
  const int64_t* key;
  const int64_t* ent;
  const int64_t* lanes;
  const float* q;
  const float* t;
  const float* u;          // kRows only
  const float* valid_f;    // kRows: 0/1 floats
  const uint8_t* valid_b;  // keyed: bools
  // Outputs, at the event's slot.
  uint8_t* z;
  float* p;
  float* feats;
  float* lam;
  float* new_last_t;  // kRows only: the functional row outputs
  float* new_v_f;
  float* new_agg;
  float* new_v_full;
  float* new_last_t_full;
  int n_rows, n_events, T, policy, mu_tau_index;
  float neg_inv_h, inv_h, budget, neg_alpha, fixed_rate, min_p;
  uint32_t k0, k1;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
    thinning_rmw_kernel(const Params P) {
  extern __shared__ float s_neg_inv_tau[];
  for (int j = threadIdx.x; j < P.T; j += blockDim.x)
    s_neg_inv_tau[j] = __fdiv_rn(-1.0f, P.taus[j]);
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  if (row >= P.n_rows) return;  // a whole group leaves together
  const int g = threadIdx.x % kLanes;
  const unsigned group_mask =
      (kLanes == 32 ? 0xFFFFFFFFu : ((1u << kLanes) - 1u))
      << ((threadIdx.x % 32) & ~(kLanes - 1));
  const int T = P.T;

  // Which event this row is, and which table row it reads.
  int64_t ev = row, r = row;
  bool vi;
  if (M == kRows) {
    vi = P.valid_f[row] > 0.5f;
  } else {
    if (P.lanes != nullptr) ev = P.lanes[row];
    const bool inside = ev < P.n_events;
    if (!inside) ev = 0;
    vi = inside && P.valid_b[ev] != 0;
    if (M == kWriteBack && !vi) return;  // an inactive row writes nothing
    r = vi ? P.key[ev] : 0;
  }
  const float qi = P.q[ev], ti = P.t[ev];
  float lt = P.last_t[r], ltf = P.last_t_full[r];
  const float vf = P.v_f[r], vfl = P.v_full[r];
  if (M != kRows) {  // _gather_rows' sentinel map
    lt = isfinite(lt) ? lt : kFreshSentinel;
    ltf = isfinite(ltf) ? ltf : kFreshSentinel;
  }
  float* row_agg = P.agg + r * 3 * T;
  float a[kKeep][3];
#pragma unroll
  for (int it = 0; it < kKeep; ++it) {
    const int j = g + it * kLanes;
    if (j < T) {
      a[it][0] = row_agg[3 * j];
      a[it][1] = row_agg[3 * j + 1];
      a[it][2] = row_agg[3 * j + 2];
    }
  }
  const float ui =
      M == kRows ? P.u[row]
                 : event_uniform(P.k0, P.k1,
                                 vi ? static_cast<uint32_t>(P.ent[ev]) : 0u,
                                 ti);

  // Per-row scalar chain, in every lane of the group.
  const bool fresh = lt < kFreshBelow;
  const float dt = fresh ? 0.0f : fmaxf(__fsub_rn(ti, lt), 0.0f);
  const bool fresh_full = ltf < kFreshBelow;
  const float dt_full = fresh_full ? 0.0f : fmaxf(__fsub_rn(ti, ltf), 0.0f);
  const float beta_h = fresh ? 0.0f : det_exp(__fmul_rn(dt, P.neg_inv_h));
  const float beta_hf =
      fresh_full ? 0.0f : det_exp(__fmul_rn(dt_full, P.neg_inv_h));
  const float lam =
      P.policy == kFull
          ? __fmul_rn(__fadd_rn(1.0f, __fmul_rn(beta_hf, vfl)), P.inv_h)
          : __fmul_rn(__fadd_rn(1.0f, __fmul_rn(beta_h, vf)), P.inv_h);
  const float base = fminf(__fdiv_rn(P.budget, fmaxf(lam, k1em30)), 1.0f);

  // Each lane's taus: decayed aggregates and features.
  float* feat_row = P.feats + ev * 4 * T;
  TauStats s[kKeep];
  float mu_cnt = 0.0f, mu_mean = 0.0f, mu_var = 0.0f;
  auto features = [&](int j, const TauStats& st) {
    feat_row[j] = st.cnt;
    feat_row[T + j] = st.sm;
    feat_row[2 * T + j] = st.mean;
    feat_row[3 * T + j] = __fsqrt_rn(st.var);
    if (j == P.mu_tau_index) {
      mu_cnt = st.cnt;
      mu_mean = st.mean;
      mu_var = st.var;
    }
  };
#pragma unroll
  for (int it = 0; it < kKeep; ++it) {
    const int j = g + it * kLanes;
    if (j < T) {
      s[it] = tau_stats(a[it][0], a[it][1], a[it][2], dt, s_neg_inv_tau[j],
                        fresh);
      features(j, s[it]);
    }
  }
  for (int j = g + kKeep * kLanes; j < T; j += kLanes) {
    features(j, tau_stats(row_agg[3 * j], row_agg[3 * j + 1],
                          row_agg[3 * j + 2], dt, s_neg_inv_tau[j], fresh));
  }

  // Inclusion probability (Eq. 2 / Eq. 4 / Eq. 5).
  float p;
  if (P.policy == kUnfiltered) {
    p = 1.0f;
  } else if (P.policy == kFixed) {
    p = P.fixed_rate;
  } else if (P.policy == kPPVR) {
    const int owner = P.mu_tau_index % kLanes;
    const float cnt = __shfl_sync(group_mask, mu_cnt, owner, kLanes);
    const float mean = __shfl_sync(group_mask, mu_mean, owner, kLanes);
    const float var = __shfl_sync(group_mask, mu_var, owner, kLanes);
    const bool cold = cnt < 1.0f;
    const float mu_w = cold ? 0.0f : mean;
    const float sg = cold ? k1e8 : __fadd_rn(__fsqrt_rn(var), k1em8);
    const float zs =
        clampf(__fdiv_rn(__fsub_rn(qi, mu_w), fmaxf(sg, k1em8)), -8.0f, 8.0f);
    const float b = clampf(base, k1em6, kOneMinus1em6);
    // log-free sigmoid(logit(b) + alpha * zs), as in the reference
    const float odds = __fdiv_rn(__fsub_rn(1.0f, b), b);
    const float e_tilt = det_exp(__fmul_rn(zs, P.neg_alpha));
    p = base >= kOneMinus1em6
            ? 1.0f
            : __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(odds, e_tilt)));
  } else {  // pp, and the decision half of full
    p = base;
  }
  p = clampf(p, P.min_p, 1.0f);
  const bool zi = (ui < p) && vi;

  if (g == 0) {
    P.z[ev] = zi ? 1 : 0;
    P.p[ev] = p;
    P.lam[ev] = lam;
  }
  if (M == kDecide) return;

  // Horvitz-Thompson update of the lane's taus (only z rows change).
  const float inv_p = zi ? __fdiv_rn(1.0f, p) : 0.0f;
  const float q2 = __fmul_rn(qi, qi);
  float* out_agg = M == kRows ? P.new_agg + r * 3 * T : row_agg;
  auto update = [&](int j, const TauStats& st, float a0, float a1, float a2) {
    if (zi) {
      out_agg[3 * j] = __fadd_rn(st.cnt, inv_p);
      out_agg[3 * j + 1] = __fadd_rn(st.sm, __fmul_rn(inv_p, qi));
      out_agg[3 * j + 2] = __fadd_rn(st.sq, __fmul_rn(inv_p, q2));
    } else if (M == kRows) {
      out_agg[3 * j] = a0;
      out_agg[3 * j + 1] = a1;
      out_agg[3 * j + 2] = a2;
    }
  };
  if (M == kWriteBack) __syncwarp(group_mask);  // the row is read: write
#pragma unroll
  for (int it = 0; it < kKeep; ++it) {
    const int j = g + it * kLanes;
    if (j < T) update(j, s[it], a[it][0], a[it][1], a[it][2]);
  }
  for (int j = g + kKeep * kLanes; j < T; j += kLanes) {
    const float a0 = row_agg[3 * j], a1 = row_agg[3 * j + 1],
                a2 = row_agg[3 * j + 2];
    update(j, tau_stats(a0, a1, a2, dt, s_neg_inv_tau[j], fresh), a0, a1,
           a2);
  }
  if (g != 0) return;
  const float v_f_new = __fadd_rn(inv_p, __fmul_rn(beta_h, vf));
  // full-stream control column (every valid event, unconditional)
  const float v_full_new = __fadd_rn(1.0f, __fmul_rn(beta_hf, vfl));
  if (M == kRows) {
    P.new_v_f[row] = zi ? v_f_new : vf;
    P.new_last_t[row] = zi ? ti : lt;
    P.new_v_full[row] = vi ? v_full_new : vfl;
    P.new_last_t_full[row] = vi ? ti : ltf;
  } else {  // kWriteBack: the row is active
    if (zi) {
      P.v_f[r] = v_f_new;
      P.last_t[r] = ti;
    }
    P.v_full[r] = v_full_new;
    P.last_t_full[r] = ti;
  }
}

int launch(int mode, const Params& P, void* stream) {
  if (P.n_rows == 0) return 0;
  const int blocks = (P.n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(float) * static_cast<size_t>(P.T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kRows)
    thinning_rmw_kernel<kRows><<<blocks, kThreads, smem, s>>>(P);
  else if (mode == kDecide)
    thinning_rmw_kernel<kDecide><<<blocks, kThreads, smem, s>>>(P);
  else
    thinning_rmw_kernel<kWriteBack><<<blocks, kThreads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 on success); a refused launch never runs, so the caller
// must check it.

// Gathered rows in (`valid` as 0/1 floats), the 9 outputs out.
extern "C" int thinning_rmw_launch(
    const float* taus, const float* last_t, const float* v_f,
    const float* agg, const float* q, const float* t, const float* u,
    const float* valid, const float* v_full, const float* last_t_full,
    float* new_last_t, float* new_v_f, float* new_agg, uint8_t* z,
    float* p, float* feats, float* lam, float* new_v_full,
    float* new_last_t_full, int B, int T, int policy, int mu_tau_index,
    float neg_inv_h, float inv_h, float budget, float neg_alpha,
    float fixed_rate, float min_p, void* stream) {
  Params P = {};
  P.taus = taus;
  P.last_t = const_cast<float*>(last_t);  // read only in kRows
  P.v_f = const_cast<float*>(v_f);
  P.agg = const_cast<float*>(agg);
  P.v_full = const_cast<float*>(v_full);
  P.last_t_full = const_cast<float*>(last_t_full);
  P.q = q;
  P.t = t;
  P.u = u;
  P.valid_f = valid;
  P.z = z;
  P.p = p;
  P.feats = feats;
  P.lam = lam;
  P.new_last_t = new_last_t;
  P.new_v_f = new_v_f;
  P.new_agg = new_agg;
  P.new_v_full = new_v_full;
  P.new_last_t_full = new_last_t_full;
  P.n_rows = P.n_events = B;
  P.T = T;
  P.policy = policy;
  P.mu_tau_index = mu_tau_index;
  P.neg_inv_h = neg_inv_h;
  P.inv_h = inv_h;
  P.budget = budget;
  P.neg_alpha = neg_alpha;
  P.fixed_rate = fixed_rate;
  P.min_p = min_p;
  return launch(kRows, P, stream);
}

// Keys in: the state tables read at key[lane] (and, with write_back,
// written in place); z/p/feats/lam at the event's slot. `lanes` may be
// null (row i is event i).
extern "C" int thinning_rmw_keyed_launch(
    const float* taus, float* last_t, float* v_f, float* agg, float* v_full,
    float* last_t_full, const int64_t* key, const int64_t* ent,
    const int64_t* lanes, const float* q, const float* t,
    const uint8_t* valid, uint8_t* z, float* p, float* feats, float* lam,
    int n_rows, int n_events, int T, int policy, int mu_tau_index,
    int write_back, float neg_inv_h, float inv_h, float budget,
    float neg_alpha, float fixed_rate, float min_p, uint32_t k0,
    uint32_t k1, void* stream) {
  Params P = {};
  P.taus = taus;
  P.last_t = last_t;
  P.v_f = v_f;
  P.agg = agg;
  P.v_full = v_full;
  P.last_t_full = last_t_full;
  P.key = key;
  P.ent = ent;
  P.lanes = lanes;
  P.q = q;
  P.t = t;
  P.valid_b = valid;
  P.z = z;
  P.p = p;
  P.feats = feats;
  P.lam = lam;
  P.n_rows = n_rows;
  P.n_events = n_events;
  P.T = T;
  P.policy = policy;
  P.mu_tau_index = mu_tau_index;
  P.neg_inv_h = neg_inv_h;
  P.inv_h = inv_h;
  P.budget = budget;
  P.neg_alpha = neg_alpha;
  P.fixed_rate = fixed_rate;
  P.min_p = min_p;
  P.k0 = k0;
  P.k1 = k1;
  return launch(write_back ? kWriteBack : kDecide, P, stream);
}

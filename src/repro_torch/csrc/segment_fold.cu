// Closed-form segment fold of a fast block, over the rows the block touches.
//
// Replaces no TPU kernel: the JAX package leaves fast mode's fold to XLA
// (`_step_fast`, src/repro/core/engine.py:271-311: scatter-max of the
// persisted times, scatter-add segment sums into (num_e + 1)-row scratch
// tables, and a decay of the whole table). The port first ran it as torch
// operations over whole tables (the plain version, `segment_fold_ref` in
// src/repro_torch/kernels/ref.py), whose `index_put_(accumulate=True)` sums
// took most of a block's device time: index_put_ sorts the indices and
// gives each distinct index to one warp, which walks that index's
// duplicates in turn, and every lane that did not persist points at the
// spare row (about 90 % of a 4096-lane block under `pp`). Its temporaries
// were whole tables (57.6 MB each at 800,000 rows) to change at most B rows.
//
// What it computes, per key with at least one valid lane in the block:
//   persisted lanes (z), if any, at their latest time t*:
//     v_f    <- sum (1/p_i) e^{-(t*-t_i)/h} + e^{-(t*-last_t)/h} v_f
//     agg[j,c] <- sum (1/p_i) e^{-(t*-t_i)/tau_j} w_c(q_i)
//                 + e^{-(t*-last_t)/tau_j} agg[j,c],   w = (1, q, q^2)
//     last_t <- t*
//   every valid lane, at their latest time tf*:
//     v_full <- sum e^{-(tf*-t_i)/h} + e^{-(tf*-last_t_full)/h} v_full
//     last_t_full <- tf*
// Keys with no persisted lane keep v_f, agg and last_t bit for bit; rows no
// valid lane names are neither read nor written. A fresh row's time is
// -inf, so its decay is 0 (`intensity.decay`: a non-finite gap decays to 0,
// a negative one is clamped to 0).
//
// Design. Two launches a block, O(B) scratch, no float atomics:
//   1. `segment_rank_kernel`: each lane's rank among the block's (row,
//      lane) pairs (invalid lanes after every valid one, in lane order), by
//      counting the smaller pairs (and the pairs of the same row: the
//      segment's length): each block stages the pairs in shared memory a
//      tile at a time and ranks 32 lanes, its 16 warps splitting the count.
//      B^2 comparisons (16.8 M at B = 4096) spread over B / 32 blocks,
//      where a block-wide sort runs log^2 B synchronised stages on one SM
//      (a bitonic sort in shared memory took 52 us at B = 4096). It writes
//      the sorted lanes, their rows (-1 for an invalid lane) and lengths.
//   2. `segment_fold_kernel`: one warp a sorted position; the warp at a
//      segment's head (its row differs from the previous position's) folds
//      the segment, the others leave. Lane l takes the members l, l + 32,
//      ... in order, reading 4 of its members at once: one pass for the
//      latest times, one that sums each contribution into the lane's 3T +
//      2 columns (a persisted member k, counted in member order, into lane
//      k mod 32's); then lane c adds column c over the lanes in lane order
//      and writes that column of the row. The hottest key's warp sets the
//      launch's time: with a key on 500 of 4096 lanes, reading the members
//      once a column (T + 3 passes) took 43 us, two passes of dependent
//      reads 27 us, against 6 us for a block of distinct keys.
// Each key's sums are thus taken in an order that depends only on which
// lanes the block gave that key: not on the row id, the table's size or
// the other keys. So two runs are bitwise equal, and a resident-slot table
// gives bitwise the rows of the dense one. Each row is owned by one warp.
//
// Numerics: float32, each operation rounded once (-fmad=false), exp is
// CUDA's expf; the plain version (torch's exp, segment sums in index order)
// agrees to a relative tolerance.
//
// Bound (B = 4096, T = 6): the lanes' key, t, q, p, valid and z (22 bytes
// each), the sorted lanes, rows and lengths (12 bytes each, written and
// read) and the touched rows' 4 + 3T floats read and written (at most B
// rows, 176 bytes a row): about 0.9 MB, 0.27 us at 3.35 TB/s. The ranking's B^2
// comparisons take a few us more of integer work; at these sizes the two
// launches and the latency of the dependent loads (sorted position, then
// the members and the row) dominate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRankWarps = 16;     // warps of a ranking block; 32 lanes each
constexpr int kRankTile = 4096;    // pairs staged in shared memory at once
constexpr int kFoldThreads = 128;
constexpr int kStride = kFoldThreads + 1;  // a column of per-thread sums
constexpr int kPerLane = 4;        // members a fold lane reads at once
constexpr unsigned kFull = 0xFFFFFFFFu;

// (row, lane), invalid lanes after every row (rows are below 2^31).
__device__ __forceinline__ uint64_t pair_of(const int64_t* key,
                                            const uint8_t* valid, int i) {
  const uint64_t row =
      valid[i] ? static_cast<uint64_t>(key[i]) : 0xFFFFFFFFull;
  return (row << 32) | static_cast<uint32_t>(i);
}

__global__ void __launch_bounds__(kRankWarps * 32)
    segment_rank_kernel(const int64_t* __restrict__ key,
                        const uint8_t* __restrict__ valid, int B,
                        int* __restrict__ order, int* __restrict__ srow,
                        int* __restrict__ slen) {
  __shared__ uint64_t tile[kRankTile];
  __shared__ int partial[kRankWarps][2][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  const uint64_t mine = i < B ? pair_of(key, valid, i) : ~0ull;
  const uint32_t mine_row = static_cast<uint32_t>(mine >> 32);
  int below = 0, same = 0;
  for (int t0 = 0; t0 < B; t0 += kRankTile) {
    const int len = min(kRankTile, B - t0);
#pragma unroll 8
    for (int j = threadIdx.x; j < len; j += blockDim.x)
      tile[j] = pair_of(key, valid, t0 + j);
    __syncthreads();
    const int per = (len + kRankWarps - 1) / kRankWarps;
    const int hi = min((warp + 1) * per, len);
#pragma unroll 8
    for (int j = warp * per; j < hi; ++j) {
      const uint64_t x = tile[j];
      below += x < mine;
      same += static_cast<uint32_t>(x >> 32) == mine_row;
    }
    __syncthreads();
  }
  partial[warp][0][lane] = below;
  partial[warp][1][lane] = same;
  __syncthreads();
  if (warp == 0 && i < B) {
    int rank = 0, len = 0;
    for (int w = 0; w < kRankWarps; ++w) {
      rank += partial[w][0][lane];
      len += partial[w][1][lane];
    }
    order[rank] = i;
    srow[rank] = valid[i] ? static_cast<int>(key[i]) : -1;
    slen[rank] = len;
  }
}

// exp(-dt/scale), with a non-finite gap decaying to 0 and a negative one
// clamped to 0, as `intensity.decay`.
__device__ __forceinline__ float decay(float dt, float scale) {
  const float d = dt < 0.0f ? 0.0f : dt;  // NaN stays NaN
  return isfinite(d) ? expf(__fdiv_rn(-d, scale)) : 0.0f;
}

// The maximum over the warp, in every lane.
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

struct FoldParams {
  const float* taus;
  float* last_t;
  float* v_f;
  float* agg;
  float* v_full;
  float* last_t_full;
  const float* q;
  const float* t;
  const float* p;
  const uint8_t* z;
  const int* order;
  const int* srow;
  const int* slen;
  int B, T;
  float h;
};

struct Member {
  float t, q, p;
  bool z;
};

// f(member, present) for the segment's members at sorted positions s ..
// s + n - 1, this lane's being m = lane, lane + 32, ..., in that order.
// Every lane calls f at each step of 32 members (`present` is false past
// the segment's end), so f may use warp-wide operations; a lane reads its
// next kPerLane members at once, so that a hot key's warp waits on a few
// rounds of loads rather than on two a member.
template <class F>
__device__ __forceinline__ void each_member(const FoldParams& P, int s,
                                            int n, int lane, F f) {
  for (int c0 = 0; c0 < n; c0 += 32 * kPerLane) {
    int idx[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int m = c0 + 32 * k + lane;
      idx[k] = m < n ? __ldg(P.order + s + m) : -1;
    }
    Member mb[kPerLane] = {};
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (idx[k] >= 0)
        mb[k] = Member{__ldg(P.t + idx[k]), __ldg(P.q + idx[k]),
                       __ldg(P.p + idx[k]), __ldg(P.z + idx[k]) != 0};
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (c0 + 32 * k < n) f(mb[k], idx[k] >= 0);
  }
}

__global__ void __launch_bounds__(kFoldThreads)
    segment_fold_kernel(const FoldParams P) {
  // Each thread's column sums: column c of thread x at acc[c * kStride + x]
  // (the stride keeps a column's 32 lanes, and a lane's columns, on
  // distinct banks).
  extern __shared__ float acc[];
  // A warp's persisted members waiting for a lane: t, q, p.
  __shared__ float zbuf[kFoldThreads / 32][3][64];
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * (kFoldThreads / 32) + threadIdx.x / 32;
  if (s >= P.B) return;  // a whole warp leaves together
  // Leave unless s is a segment's head: a valid lane whose row differs
  // from the previous position's.
  const int row = __ldg(P.srow + s);
  if (row < 0 || (s > 0 && __ldg(P.srow + s - 1) == row)) return;
  const int n = __ldg(P.slen + s);  // the segment: positions s .. s + n - 1
  const int T = P.T, C = 3 * T + 2;  // columns: the aggregates, v_f, v_full
  const int64_t r = row;
  float* row_agg = P.agg + r * 3 * T;
  const float lt = P.last_t[r], ltf = P.last_t_full[r];
  const float vf = P.v_f[r], vfull = P.v_full[r];
  const float old = lane < 3 * T ? row_agg[lane] : 0.0f;

  // Latest times: of every member (control column) and of the persisted.
  float tf = -INFINITY, tz = -INFINITY;
  each_member(P, s, n, lane, [&](const Member& m, bool present) {
    if (!present) return;
    tf = fmaxf(tf, m.t);
    if (m.z) tz = fmaxf(tz, m.t);
  });
  const float tf_star = warp_max(tf), t_star = warp_max(tz);

  // Each lane's sums, in order: the control column over its members l, l +
  // 32, ...; v_f and the aggregates (in `acc`) over the persisted members
  // k = l, l + 32, ... counted in member order, which wait in `zbuf` until
  // 32 of them can be taken at once (a persisted member is a tenth of a
  // block's lanes: taken where they lie, most steps of a hot key's warp
  // would run the T decays for a few lanes).
  float* mine = acc + threadIdx.x;
  for (int c = 0; c < 3 * T; ++c) mine[c * kStride] = 0.0f;
  float(*zb)[64] = zbuf[threadIdx.x / 32];
  float s_full = 0.0f, s_v = 0.0f;
  int pending = 0;
  auto take = [&](int count) {  // lanes below count take a waiting member
    if (lane >= count) return;
    const float t = zb[0][lane], q = zb[1][lane];
    const float inv_p = __frcp_rn(zb[2][lane]), q2 = __fmul_rn(q, q);
    const float dt = __fsub_rn(t_star, t);
    s_v = __fadd_rn(s_v, __fmul_rn(inv_p, decay(dt, P.h)));
    for (int j = 0; j < T; ++j) {
      const float wgt = __fmul_rn(inv_p, decay(dt, __ldg(P.taus + j)));
      float* a = mine + 3 * j * kStride;
      a[0] = __fadd_rn(a[0], wgt);
      a[kStride] = __fadd_rn(a[kStride], __fmul_rn(wgt, q));
      a[2 * kStride] = __fadd_rn(a[2 * kStride], __fmul_rn(wgt, q2));
    }
  };
  each_member(P, s, n, lane, [&](const Member& m, bool present) {
    if (present)
      s_full = __fadd_rn(s_full, decay(__fsub_rn(tf_star, m.t), P.h));
    const bool wait = present && m.z;
    const unsigned zs = __ballot_sync(kFull, wait);
    if (wait) {
      const int at = pending + __popc(zs & ((1u << lane) - 1u));
      zb[0][at] = m.t;
      zb[1][at] = m.q;
      zb[2][at] = m.p;
    }
    pending += __popc(zs);
    __syncwarp();
    if (pending < 32) return;
    take(32);
    __syncwarp();
    if (lane < pending - 32)
      for (int f = 0; f < 3; ++f) zb[f][lane] = zb[f][lane + 32];
    pending -= 32;
    __syncwarp();
  });
  take(pending);
  mine[(C - 2) * kStride] = s_v;
  mine[(C - 1) * kStride] = s_full;
  __syncwarp();

  // Column c's sum over the lanes in lane order, and the row's update.
  const int lanes = min(n, 32);
  const bool wrote = t_star != -INFINITY;  // a persisted member
  for (int c = lane; c < C; c += 32) {
    const float* col = acc + c * kStride + (threadIdx.x - lane);
    float sum = 0.0f;
    for (int l = 0; l < lanes; ++l) sum = __fadd_rn(sum, col[l]);
    if (c == C - 1) {
      P.v_full[r] = __fadd_rn(
          sum, __fmul_rn(decay(__fsub_rn(tf_star, ltf), P.h), vfull));
      P.last_t_full[r] = tf_star;
    } else if (wrote && c == C - 2) {
      P.v_f[r] = __fadd_rn(sum,
                           __fmul_rn(decay(__fsub_rn(t_star, lt), P.h), vf));
      P.last_t[r] = t_star;
    } else if (wrote) {
      const float a = c == lane ? old : row_agg[c];
      row_agg[c] = __fadd_rn(
          sum, __fmul_rn(a, decay(__fsub_rn(t_star, lt),
                                  __ldg(P.taus + c / 3))));
    }
  }
}

}  // namespace

// Plain C entry point for ctypes: both launches on `stream`. `order`,
// `srow` and `slen` are scratch of B ints each. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int segment_fold_launch(
    const float* taus, float* last_t, float* v_f, float* agg, float* v_full,
    float* last_t_full, const int64_t* key, const float* q, const float* t,
    const uint8_t* valid, const uint8_t* z, const float* p, int* order,
    int* srow, int* slen, int B, int T, float h, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segment_rank_kernel<<<(B + 31) / 32, kRankWarps * 32, 0, s>>>(
      key, valid, B, order, srow, slen);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  FoldParams P = {};
  P.taus = taus;
  P.last_t = last_t;
  P.v_f = v_f;
  P.agg = agg;
  P.v_full = v_full;
  P.last_t_full = last_t_full;
  P.q = q;
  P.t = t;
  P.p = p;
  P.z = z;
  P.order = order;
  P.srow = srow;
  P.slen = slen;
  P.B = B;
  P.T = T;
  P.h = h;
  const int warps = kFoldThreads / 32;
  const size_t smem = sizeof(float) * kStride * (3 * static_cast<size_t>(T)
                                                 + 2);
  if (smem > 48 * 1024)  // the attribute is the current device's
    cudaFuncSetAttribute(segment_fold_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  segment_fold_kernel<<<(B + warps - 1) / warps, kFoldThreads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Parallel-in-time HMM filter (K3) and smoother (K4) passes, in three
// recursion-dot precisions (K5), and the pairwise-joint reduction
// (joint_acc) for NVIDIA Hopper (sm_90a), with a plain C interface loaded
// through ctypes by poor_man_gplvm_tpu_torch/ops/parallel_scan.py.
//
// Replaces the Pallas TPU kernels
//   K3  poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_pfilter_kernel
//       (wrapper _pfilter_pass; finals-only and emit)
//   K4  poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_psmooth_kernel
//       (wrapper _psmooth_pass; finals-only, full, marginal, and marginal
//       with the pairwise-joint epilogue)
//   K5  poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_split_bf16 /
//       _scan_dot, the recursion dot inside K3/K4 ("highest", "bf16x3",
//       "bf16"; scan_common.cuh::window_matvec_p)
//
// The sequence of T steps is cut into C chunks of tc = ceil(T / C) rows;
// chunk c owns global rows [c*tc, (c+1)*tc) clipped to T and runs the
// sequential recursion from its boundary carry ins[c].  The fixed-point
// loop (ops/parallel_scan.py::smooth_parallel) solves the boundary carries by
// fixed-point iteration over finals-only passes, then runs one emitting
// pass.  On the TPU the C chunks were the rows of one (C, L) @ (L, L)
// matrix product per step; here each chunk is ONE THREAD BLOCK running the
// K1/K2 step of scan_kernels.cu (thread j owns latent column j, its carry
// in registers, the shared vector of the matvec in shared memory), so the
// C <= 128 chunks run on up to 128 of the H100's 132 SMs at once and
// nothing carries between blocks.
//
// Layout: no chunk-major copy and no 128-lane padding.  The weights w and
// the posteriors are read and written in global time order (T, [ND,] L):
// chunk c's rows are contiguous.  Boundary carries are (C, ND, L).
//
// What bounds it on this card: each block is a dependent chain of tc steps
// of one or two (1, L) @ (L, L) matvecs per channel plus block-wide sums,
// i.e. latency, as for K1/K2, now on C SMs at once.
//   * Both passes read only each column's window of nonzero rows, W of L,
//     from a band made once per solve (ops/band.py::transition_band) and
//     kept in shared memory when it fits: K3 its push half (L = 500,
//     W = 21: 42 KB), K4 both halves (pfilter_kernel's and psmooth_kernel's
//     notes).  In BF16X3/BF16 the resident copy is the bf16 hi/lo split,
//     the same bytes as the f32 band.  A dense channel is the band W = L:
//     resident at L = 100, streamed from the 50 MB L2 each step at L = 500.
//   * With the band resident a step's FMAs are few (W per thread); what is
//     left is the step's fixed cost: two block barriers, the block sums in
//     warp order, the divisions (PERF.md times both passes with the band
//     cut to one row).
//   * A constant (jump) channel takes the sum(v) * row shortcut of K1/K2,
//     in f32 in every precision (the TPU kernels never split it either).
//
// Validity rules (those of the TPU kernels): in K3 row t of a chunk is a
// step when t < T; in K4 when t < T - 1.  Row T - 1 passes the smoother
// carry through (smooth_parallel makes that carry post_{T-1}), and rows at or
// past T do not exist here, so they are neither run nor stored.
//
// K4 computes prior_{t+1} = push(post_t) itself, per step, from the stored
// filter posterior of row t with K3's exact arithmetic in every precision
// (the TPU kernel did it as a block prologue), so at convergence its priors
// equal K3's bit for bit.
//
// K4's marginal modes store the latent marginal lat[t, j] = sum_d smooth and
// the dynamics marginal dyn[t, d] = sum_j smooth (a block reduction) instead
// of the (T, ND, L) smoothed posterior.  The TPU kernel's marginal+acc mode
// folds sum_t post[t, d]^T r[t, e] into a 4 MB on-chip accumulator (L=500),
// which no SM's shared memory holds: here K4 writes r to a (T, ND, L)
// scratch and joint_acc reduces it (below).
//
// Numerics of K3/K4: f32 with FMA, no tensor cores, in HIGHEST (the JAX package's
// default scan precision); normalisers clamped at 1e-38; r = 0 where the
// prior is 0 or subnormal (kPriorFloor), so latent bins masked to zero weight
// stay exact zeros.  K3
// divides through an f64 reciprocal, K4 in f32: the same bits
// (scan_common.cuh::div_by_rcp).

#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace pmg;

enum SmoothMode { kFinals = 0, kFull = 1, kMarginal = 2, kMarginalAcc = 3 };

struct PassArgs {
  const float* x;       // K3: w (T, L); K4: post (T, ND, L)
  const float* tlat;    // (ND, L, L): the constant channels' first rows
  const float* tlatT;   // (ND, L, L) transposed per channel (K4 only)
  const float* tdyn;    // (ND, ND)
  const float* ins;     // (C, ND, L) boundary carries in
  float* finals;        // (C, ND, L) carries after each chunk's last row
  float* out;           // K3 EMIT: post; K4 full: smooth (T, ND, L);
                        // K4 marginal: lat (T, L)
  float* out2;          // K3 EMIT: norm (T,); K4 full, marginal+acc: r
                        // (T, ND, L)
  float* out3;          // K4 marginal: dyn (T, ND)
  // the band of the non-constant channels, (2, n_mat, W, L): the push
  // windows (of tlat) then the pull windows (of tlatT); band[k, j] is
  // row win0[j] + k of column j.  bf16 split in BF16X3/BF16.  K3 reads
  // the push half only, which leads each tensor.
  const float* band;
  const bf16* band_hi;
  const bf16* band_lo;
  const int* win0;      // (2, n_mat, L) first row of each column's window
  int T, L, tc, mask;
  int W, n_mat;         // window height (L for a dense channel), count
};

// vector operands per (ND, L) slot: the value, plus its bf16 residual
__host__ __device__ constexpr int vec_slots(int prec) {
  return prec == kHighest ? 1 : 2;
}

// copy one matrix operand (the push half of the band for K3, both halves
// for K4) into shared memory at `smem` when the pass keeps it resident (n
// elements, 4 bytes each in every precision: f32, or the bf16 hi and lo
// halves)
template <int PREC, bool RES>
__device__ MatOperand stage(const float* f, const bf16* hi, const bf16* lo,
                            size_t n, void* smem) {
  if (!RES) return {f, hi, lo};
  if (PREC == kHighest) {
    float* s = static_cast<float*>(smem);
    for (size_t k = threadIdx.x; k < n; k += blockDim.x) s[k] = f[k];
    return {s, nullptr, nullptr};
  }
  bf16* sh = static_cast<bf16*>(smem);
  bf16* sl = sh + n;
  for (size_t k = threadIdx.x; k < n; k += blockDim.x) {
    sh[k] = hi[k];
    if (PREC == kBf16x3) sl[k] = lo[k];
  }
  return {nullptr, sh, sl};
}

// K3 EMIT: store row t of post (thread j its column) and norm[t]
template <int ND>
__device__ __forceinline__ void store_row(const PassArgs& a, size_t t,
                                          const float (&carry)[ND],
                                          float den) {
  const int j = threadIdx.x;
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (j < a.L) a.out[(t * ND + d) * a.L + j] = carry[d];
  if (j == 0) a.out2[t] = den;
}

// K3: filter pass.  Per step, forward over the chunk's rows t < T:
//   q_d = sum_p Tdyn[p,d] carry_p; prior_d = q_d @ Tlat[d];
//   carry = prior * w_t, normalised.
// EMIT stores post (T, ND, L) and norm[t] = max(s_t, 1e-38), the
// normaliser the step divided by.
//
// Design for the H100 (PERF.md §5-6).  The dense pass streamed each
// non-constant channel's whole (L, L) matrix from L2 every step at L = 500
// (1 MB, ~96 % exact zeros for the RBF movement channel), and that load
// stream bounded the step.  Here the push of each such channel reads its
// band: W rows per column (21 at lengthscale 1), the push half of the band
// K4 reads, resident in shared memory whenever W * L * 4 bytes fit beside
// the vectors (W up to ~100 at L = 500), else streamed from L2 with 16
// loads in flight.  The sum runs over the window ascending with fmaf, the
// dense loop's order, and fmaf(x, +0, a) = a, so the bits are the dense
// pass's: K4's recomputed priors and the sequential K1 stay equal to it.
// The weight row w[t+1, j], which does not depend on the recursion, is
// loaded a step ahead into a register, so no global-memory latency sits on
// the chain.  A store placed just before a block barrier holds the barrier
// up, so EMIT stores row t after the next step's barrier (a), ahead of the
// window dot (row t is still in the carry registers then), as K4 does.
// The division by the normaliser is one f64 reciprocal shared by the
// channels and an f64 product each, which gives the f32 quotient's bits
// (scan_common.cuh::div_by_rcp) without the f32 division's slow path.
// What is left is the chain's fixed cost: two block barriers per step ((a)
// q complete, (b) the normaliser's partials), the block sums in warp order
// and the reciprocal.  Pushing the unnormalised carry would save barrier
// (b) but round differently; it is not done here.
template <int ND, bool RESIDENT, bool EMIT, int PREC>
__global__ void __launch_bounds__(kMaxThreads) pfilter_kernel(PassArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NV = vec_slots(PREC);
  float* qx = smem;                 // (ND, L) dynamics-mixed carry
  float* ql = smem + ND * a.L;      // (ND, L) its bf16 residual (BF16X3)
  __shared__ float red_q[32][ND];
  __shared__ float red_u[32];

  const int L = a.L, W = a.W, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int n = max(0, min(a.tc, a.T - t0));

  const MatOperand band = stage<PREC, RESIDENT>(
      a.band, a.band_hi, a.band_lo, a.n_mat * WL, smem + NV * ND * L);

  float tdyn[ND][ND], carry[ND], row0[ND];
  size_t off_f[ND];  // each channel's push band
  int i0_f[ND];      // first row of column j's window
  int slot = 0;
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = a.tdyn[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.ins[((size_t)c * ND + d) * L + j] : 0.f;
    row0[d] = live ? a.tlat[d * LL + j] : 0.f;
    off_f[d] = 0;
    i0_f[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off_f[d] = slot * WL;
      if (live) i0_f[d] = a.win0[slot * L + j];
      ++slot;
    }
  }
  // the weight of the next row, a step ahead
  float w_next = (live && n > 0) ? a.x[(size_t)t0 * L + j] : 0.f;
  float den_prev = 1.f;  // EMIT: the normaliser of the row not yet stored
  __syncthreads();  // resident band complete

  for (int tau = 0; tau < n; ++tau) {
    const size_t t = (size_t)t0 + tau;
    const float wt = w_next;
    if (live && tau + 1 < n) w_next = a.x[(t + 1) * L + j];
    // dynamics mix of the own column: q_d = sum_p Tdyn[p,d] * carry_p
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float v = tdyn[0][d] * carry[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) v = fmaf(tdyn[p][d], carry[p], v);
      if (live) store_operand<PREC>(qx + d * L, ql + d * L, j, v);
      if ((a.mask >> d) & 1) {
        const float s = warp_sum(v);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
    __syncthreads();  // (a) q and its partial sums complete

    // EMIT: row t-1 (still in carry) goes out here, where the window dot
    // that follows hides the stores
    if (EMIT && tau > 0) store_row<ND>(a, t - 1, carry, den_prev);

    float pr[ND], usum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((a.mask >> d) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][d];
        pr[d] = s * row0[d];
      } else {
        pr[d] = live ? window_matvec_p<PREC, matvec_unroll(RESIDENT)>(
                           qx + d * L, ql + d * L, band, off_f[d], i0_f[d], W,
                           L, j)
                     : 0.f;
      }
      usum = fmaf(pr[d], wt, usum);
    }
    usum = warp_sum(usum);
    if (lane == 0) red_u[warp] = usum;
    __syncthreads();  // (b) normaliser partials complete; q reads done

    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_u[k];
    const float den = fmaxf(s, 1e-38f);
#pragma unroll
    for (int d = 0; d < ND; ++d) carry[d] = pr[d] * wt;
    if (den < kRcpDivisorMax) {  // the same for the whole block
      const double rden = rcp_f64(den);
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = div_by_rcp(carry[d], rden);
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = carry[d] / den;
    }
    den_prev = den;
  }
  if (EMIT && n > 0) store_row<ND>(a, (size_t)t0 + n - 1, carry, den_prev);
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) a.finals[((size_t)c * ND + d) * L + j] = carry[d];
}

// K4 marginal modes, in two halves around a block barrier: the latent
// marginal lat[t, j] = sum_d carry[d] (thread j) and the warp partials of
// the dynamics marginal; then, after the barrier, dyn[t, d] = sum_j
// carry[d] (threads d < ND sum the warps, in warp order).
template <int ND>
__device__ __forceinline__ void marginal_partials(const PassArgs& a,
                                                  const float (&carry)[ND],
                                                  size_t t,
                                                  float (*red_m)[ND]) {
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  float lat = carry[0];
#pragma unroll
  for (int d = 1; d < ND; ++d) lat += carry[d];
  if (j < a.L) a.out[t * a.L + j] = lat;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float s = warp_sum(carry[d]);
    if (lane == 0) red_m[warp][d] = s;
  }
}

template <int ND>
__device__ __forceinline__ void marginal_finish(const PassArgs& a, size_t t,
                                                float (*red_m)[ND]) {
  const int j = threadIdx.x, nwarp = blockDim.x >> 5;
  if (j < ND) {
    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_m[k][j];
    a.out3[t * ND + j] = s;
  }
}

// K4: smoother pass.  Per step, backward over the chunk's rows t < T-1:
//   prior = push(post_t); r = carry / prior (0 where prior == 0);
//   pull_e = Tlat[e] @ r_e; out_d = sum_e Tdyn[d,e] pull_e;
//   carry = post_t * out, normalised.
// MODE full stores smooth and r (T, ND, L); marginal stores lat (T, L) and
// dyn (T, ND); marginal+acc also stores r.  On row T-1 smooth = carry, r = 0.
//
// Design for the H100 (PERF.md §5-6).  The movement channel of every
// configuration the repo runs is an RBF of integer positions, exactly 0 in
// f32 from |i - j| >= 11 at lengthscale 1: the dense pass fetched ~96 %
// zeros from L2 each step at L = 500.  Here each non-constant channel's
// push (tlat) and pull (tlatT) is a band of W rows per column, made once
// per solve by the wrapper (ops/band.py::transition_band), and
// both bands sit in shared memory (L = 500, W = 21: 42 KB each) or, when
// they do not fit, are read from L2 (W / L of the dense loads).  Each
// column's sum runs over its window in ascending row order, K3's order, so
// the recomputed prior keeps K3's bits (window_matvec_p; the window's extra
// entries are exact zeros).  A dense channel is the band W = L, win0 = 0:
// the same code and arithmetic.
//
// Two block barriers per step instead of three or four: the normaliser of
// step t is summed after the next step's first barrier (its partials stay
// in red_s until then), and with it the stores of row t and the dynamics
// marginal's partials, whose sums wait for the second barrier.  The filter
// posterior of the next row, which does not depend on the recursion, is
// loaded a step ahead into registers (each thread reads only its own
// column, so no shared ring is needed).  Thread j keeps column j: the
// warp-order block sums of a constant channel stay K3's.
template <int ND, bool RESIDENT, int MODE, int PREC>
__global__ void __launch_bounds__(kMaxThreads) psmooth_kernel(PassArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NV = vec_slots(PREC);
  constexpr bool MARG = MODE == kMarginal || MODE == kMarginalAcc;
  constexpr bool STORE_R = MODE == kFull || MODE == kMarginalAcc;
  float* qx = smem;                    // (ND, L) dynamics mix of post_t
  float* ql = smem + ND * a.L;         //   and its bf16 residual
  float* rx = smem + NV * ND * a.L;    // (ND, L) ratios r
  float* rl = rx + ND * a.L;           //   and their bf16 residual
  __shared__ float red_q[32][ND];
  __shared__ float red_r[32][ND];
  __shared__ float red_s[32];
  __shared__ float red_m[32][ND];

  const int L = a.L, W = a.W, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int t_end = min(t0 + a.tc, a.T);
  // rows [t0, t0 + n) are steps; row T-1, if this chunk holds it, is not
  const int n = max(0, min(t_end, a.T - 1) - t0);

  const MatOperand band = stage<PREC, RESIDENT>(
      a.band, a.band_hi, a.band_lo, 2 * a.n_mat * WL,
      smem + 2 * NV * ND * L);

  float tdyn[ND][ND], carry[ND], row0[ND], row0T[ND];
  size_t off_f[ND], off_b[ND];  // each channel's push and pull band
  int i0_f[ND], i0_b[ND];       // first row of column j's windows
  int slot = 0;
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = a.tdyn[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.ins[((size_t)c * ND + d) * L + j] : 0.f;
    row0[d] = live ? a.tlat[d * LL + j] : 0.f;
    row0T[d] = live ? a.tlatT[d * LL + j] : 0.f;
    off_f[d] = off_b[d] = 0;
    i0_f[d] = i0_b[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off_f[d] = slot * WL;
      off_b[d] = (a.n_mat + slot) * WL;
      if (live) {
        i0_f[d] = a.win0[slot * L + j];
        i0_b[d] = a.win0[(a.n_mat + slot) * L + j];
      }
      ++slot;
    }
  }
  bool dyn_pending = false;  // a row's dyn partials wait in red_m
  size_t dyn_row = 0;
  if (MODE != kFinals && t0 <= a.T - 1 && a.T - 1 < t_end) {
    const size_t last = (size_t)(a.T - 1);
    const size_t base = last * ND * L;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (live && MODE == kFull) a.out[base + d * L + j] = carry[d];
      if (live && STORE_R) a.out2[base + d * L + j] = 0.f;
    }
    if (MARG) {
      marginal_partials<ND>(a, carry, last, red_m);
      dyn_pending = true;
      dyn_row = last;
    }
  }
  // the filter posterior of the next row, a step ahead
  float f_next[ND];
#pragma unroll
  for (int p = 0; p < ND; ++p)
    f_next[p] = (live && n > 0)
                    ? a.x[((size_t)(t0 + n - 1) * ND + p) * L + j] : 0.f;
  __syncthreads();  // resident band complete; row T-1's dyn partials
  if (MARG && dyn_pending) marginal_finish<ND>(a, dyn_row, red_m);
  dyn_pending = false;

  float v[ND];  // the unnormalised smoothed posterior of the last step
#pragma unroll
  for (int d = 0; d < ND; ++d) v[d] = 0.f;
  for (int tau = n - 1; tau >= 0; --tau) {
    const size_t t = (size_t)t0 + tau;
    const size_t base = t * ND * L;
    const bool pending = tau < n - 1;  // step t+1 awaits its normaliser
    // (1) filter posterior of row t and its dynamics mix for the push
    float f[ND];
#pragma unroll
    for (int p = 0; p < ND; ++p) {
      f[p] = f_next[p];
      if (live && tau > 0) f_next[p] = a.x[base - ND * L + p * L + j];
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float q = tdyn[0][d] * f[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) q = fmaf(tdyn[p][d], f[p], q);
      if (live) store_operand<PREC>(qx + d * L, ql + d * L, j, q);
      if ((a.mask >> d) & 1) {
        const float s = warp_sum(q);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
    __syncthreads();  // (a) q complete; step t+1's normaliser partials

    // (1') step t+1: normalise, store its row, its dyn partials
    if (pending) {
      float s = 0.f;
      for (int k = 0; k < nwarp; ++k) s += red_s[k];
      const float den = fmaxf(s, 1e-38f);
      const size_t nb = base + ND * L;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        carry[d] = v[d] / den;
        if (MODE == kFull && live) a.out[nb + d * L + j] = carry[d];
      }
      if (MARG) {
        marginal_partials<ND>(a, carry, t + 1, red_m);
        dyn_pending = true;
        dyn_row = t + 1;
      }
    }

    // (2) prior_{t+1} of the own column, and the ratio r
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      float pr;
      if ((a.mask >> e) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][e];
        pr = s * row0[e];
      } else {
        pr = live ? window_matvec_p<PREC, matvec_unroll(RESIDENT)>(
                        qx + e * L, ql + e * L, band, off_f[e], i0_f[e], W, L,
                        j)
                  : 0.f;
      }
      const float r = pr >= kPriorFloor ? carry[e] / pr : 0.f;
      if (live) {
        store_operand<PREC>(rx + e * L, rl + e * L, j, r);
        if (STORE_R) a.out2[base + e * L + j] = r;
      }
      if ((a.mask >> e) & 1) {
        const float s = warp_sum(r);
        if (lane == 0) red_r[warp][e] = s;
      }
    }
    __syncthreads();  // (b) r complete; q reads done; dyn partials

    if (MARG && dyn_pending) marginal_finish<ND>(a, dyn_row, red_m);
    dyn_pending = false;

    // (3) pull, dynamics mix, unnormalised smoothed posterior
    float pull[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if ((a.mask >> e) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_r[k][e];
        pull[e] = s * row0T[e];
      } else {
        pull[e] = live ? window_matvec_p<PREC, matvec_unroll(RESIDENT)>(
                             rx + e * L, rl + e * L, band, off_b[e], i0_b[e],
                             W, L, j)
                       : 0.f;
      }
    }
    float vsum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float o = tdyn[d][0] * pull[0];
#pragma unroll
      for (int e = 1; e < ND; ++e) o = fmaf(tdyn[d][e], pull[e], o);
      v[d] = f[d] * o;
      vsum += v[d];
    }
    vsum = warp_sum(vsum);
    if (lane == 0) red_s[warp] = vsum;
    // no barrier: the next step reads red_s after its barrier (a), and the
    // shared q and r it writes were last read before (b)
  }
  if (n > 0) {  // the chunk's first row: normalise, store
    __syncthreads();  // its normaliser partials
    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_s[k];
    const float den = fmaxf(s, 1e-38f);
    const size_t base = (size_t)t0 * ND * L;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      carry[d] = v[d] / den;
      if (MODE == kFull && live) a.out[base + d * L + j] = carry[d];
    }
    if (MARG) {
      marginal_partials<ND>(a, carry, t0, red_m);
      __syncthreads();  // its dyn partials
      marginal_finish<ND>(a, t0, red_m);
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) a.finals[((size_t)c * ND + d) * L + j] = carry[d];
}

// ---------------------------------------------------------------------------
// joint_acc: acc[d, e, i, j] = sum_t post[t, d, i] * r[t, e, j]
//
// The TPU kernel's marginal+acc epilogue (_psmooth_kernel, the block
// epilogue folding post^T @ r into an on-chip accumulator).  With M = ND*L
// it is the product A^T B of two (T, M) matrices, K = T, owed at f32
// accuracy (the JAX kernel runs it at Precision.HIGHEST).
//
// On the tensor cores in 3xTF32: each operand a = hi + lo with hi =
// tf32(a), lo = tf32(a - hi), and a.b ~ hi.hi + hi.lo + lo.hi (the lo.lo
// term is 2^-22 of the product), each product an f32-accumulated
// mma.sync.m16n8k8 TF32 product.  Three TF32 products of 2 T M^2 operations
// at the card's 495 TFLOP/s: 1.2 ms at T = 1e5, M = 1000, against 6 ms for
// one f32 product without tensor cores (67 TFLOP/s), and 0.24 ms for
// reading A and B once, so it is bound by operations.
//
// Why mma.sync and not wgmma: TF32 wgmma takes only K-major operands, and
// here both are M-contiguous (T, M) rows; mma.sync loads its fragments from
// registers filled from any shared-memory layout.  A later kernel can
// transpose tiles into wgmma's layout.
//
// Each block owns one 128 x 128 output tile over one slice of t (split-K:
// S slices, as many as fill one wave of the card; at M = 200 there are 4
// tiles and 33 slices).  Per stage it loads 32 time rows of the A and
// B column tiles with cp.async (16-byte copies when M % 4 == 0),
// double-buffered, zero-filled past the slice and past M.  Rows are padded
// by 8 floats: the fragment reads (k = lane % 4, m = lane / 4) then fall
// on 32 banks.  Each warp splits the raw values of its fragments in
// registers (hi = tf32(a) rounded as cvt.rna.tf32.f32 does, lo = tf32(a -
// hi)) and issues the
// three products per k-step.  That beat splitting each tile once in shared
// memory, hi in place and lo beside it, on the H100: the split tile
// doubles the bytes of every fragment read and adds a pass over the tile,
// while the conversions repeated per warp take ALU slots the mma.sync loop
// leaves free.  What bounds it then is mma.sync's TF32 rate, below
// wgmma's (PERF.md times the one-product control beside it).  Sums run in
// two levels: each 32-row stage in a fresh mma
// accumulator (the tensor cores' f32 adds truncate, and a bias over 96
// accumulations per 256 rows reached 3e-6 of an entry), then the stage
// sums in f32 with rounding to nearest over the slice.  Each slice's
// partial goes to an (S, M, M) buffer; a second kernel adds the S
// partials in slice order into the (ND, ND, L, L) result.  No atomics:
// runs repeat bit for bit.  PASSES = 1 (hi.hi only, one TF32 product)
// exists for the tests' control and is not reachable from the public
// wrapper.
// ---------------------------------------------------------------------------

constexpr int kAccBK = 32;    // time rows per shared-memory stage
constexpr int kAccPad = 8;    // floats of padding per shared row

// tf32(x): the rounding of cvt.rna.tf32.f32 (to nearest, ties away from
// zero, onto the top 10 mantissa bits) in two integer operations; for
// finite x the bits are cvt's (post and r are finite).  On the H100 the
// cvt form made joint_acc slower, with bit-equal output.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo) TF32 pair, hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// copy `BYTES` (16 or 4) to shared memory, zero-filled past `src_bytes`
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the block's copies of one stage of one operand: rows [t, t + kAccBK) of
// columns [col0, col0 + TILE) of X (T, M) into xs (kAccBK, TILE + pad).
// Chunk k of the stage is 4 columns of one row; each thread takes every
// NTH-th chunk.
template <int TILE, int NTH, bool VEC>
__device__ __forceinline__ void load_stage(const float* X, float* xs, int t,
                                           int tb, int col0, int M) {
  constexpr int S = TILE + kAccPad;
  for (int k = threadIdx.x; k < kAccBK * TILE / 4; k += NTH) {
    const int row = k / (TILE / 4), col = (k % (TILE / 4)) * 4;
    const int tt = t + row, gc = col0 + col;
    float* dst = xs + row * S + col;
    const float* src = X + (size_t)tt * M + gc;
    if (VEC) {
      const bool ok = tt < tb && gc < M;
      cp_async<16>(dst, ok ? src : X, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = tt < tb && gc + u < M;
        cp_async<4>(dst + u, ok ? src + u : X, ok ? 4 : 0);
      }
    }
  }
}

// the block tile: WM x WN warps, each MT x NT_ mma tiles of 16 x 8, so
// 128 x 128 in 8 warps of 64 x 32 (on the H100 at T = 1e5 this beat 16
// warps of 32 x 32 and, at M = 200, 64 x 64 tiles of 4 warps)
constexpr int kAccWM = 2, kAccWN = 4, kAccMT = 4, kAccNT = 4;
constexpr int kAccTile = kAccWM * kAccMT * 16;
static_assert(kAccTile == kAccWN * kAccNT * 8, "square block tile");
constexpr int kAccThreads = kAccWM * kAccWN * 32;

template <int PASSES, bool VEC>
__global__ void __launch_bounds__(kAccThreads)
    joint_acc_partial_kernel(const float* __restrict__ A,
                             const float* __restrict__ B, float* partial,
                             int T, int M, int rows_per_slice) {
  constexpr int WN = kAccWN, MT = kAccMT, NT_ = kAccNT;
  constexpr int TILE = kAccTile, NTH = kAccThreads;
  constexpr int S = TILE + kAccPad;
  constexpr int STAGE = kAccBK * S;  // floats of one operand stage
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                  // [2][kAccBK][S]
  float* bs = smem + 2 * STAGE;      // [2][kAccBK][S]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int p0 = blockIdx.y * TILE, q0 = blockIdx.x * TILE;
  const int ta = blockIdx.z * rows_per_slice;
  const int tb = min(T, ta + rows_per_slice);
  const int stages = tb > ta ? (tb - ta + kAccBK - 1) / kAccBK : 0;

  float acc[MT][NT_][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT_; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[m][n][u] = 0.f;

  if (stages > 0) {
    load_stage<TILE, NTH, VEC>(A, as, ta, tb, p0, M);
    load_stage<TILE, NTH, VEC>(B, bs, ta, tb, q0, M);
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    const float* ah = as + (st & 1) * STAGE;
    const float* bh = bs + (st & 1) * STAGE;
    cp_async_wait_all();  // this thread's copies of stage st landed
    __syncthreads();      // all of stage st; every warp done with st - 1
    if (st + 1 < stages) {
      const int t = ta + (st + 1) * kAccBK;
      load_stage<TILE, NTH, VEC>(A, as + ((st + 1) & 1) * STAGE, t, tb, p0,
                                 M);
      load_stage<TILE, NTH, VEC>(B, bs + ((st + 1) & 1) * STAGE, t, tb, q0,
                                 M);
      cp_async_commit();
    }
    float part[MT][NT_][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT_; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[m][n][u] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kAccBK; k0 += 8) {
      const float* a0 = ah + (k0 + tig) * S + wm * MT * 16 + g;
      const float* b0 = bh + (k0 + tig) * S + wn * NT_ * 8 + g;
      uint32_t ahi[MT][4], alo[MT][4], bhi[NT_][2], blo[NT_][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // element i: row g (+8 for odd i), column tig (+4 for i >= 2)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(a0[(i >> 1) * 4 * S + m * 16 + (i & 1) * 8], ahi[m][i],
                     alo[m][i]);
      }
#pragma unroll
      for (int n = 0; n < NT_; ++n) {
        // element i: row (k) tig (+4 for i = 1), column g
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split_tf32(b0[i * 4 * S + n * 8], bhi[n][i], blo[n][i]);
      }
      // small terms first; each product over all tiles before the next,
      // so that neighbouring mma.sync write different accumulators
      if (PASSES == 3) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT_; ++n) mma_tf32(part[m][n], alo[m], bhi[n]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT_; ++n) mma_tf32(part[m][n], ahi[m], blo[n]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT_; ++n) mma_tf32(part[m][n], ahi[m], bhi[n]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT_; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[m][n][u] += part[m][n][u];
  }
  // accumulator element u of tile (m, n): row g (+8 for u >= 2), column
  // 2 * tig (+1 for odd u)
  float* out = partial + (size_t)blockIdx.z * M * M;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT_; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = p0 + wm * MT * 16 + m * 16 + g + (u >= 2 ? 8 : 0);
        const int q = q0 + wn * NT_ * 8 + n * 8 + 2 * tig + (u & 1);
        if (p < M && q < M) out[(size_t)p * M + q] = acc[m][n][u];
      }
}

// acc[d, e, i, j] = sum over slices, in slice order, of partial[s, d*L+i,
// e*L+j]
__global__ void joint_acc_reduce_kernel(const float* __restrict__ partial,
                                        float* acc, int S, int ND, int L) {
  const int M = ND * L;
  const size_t total = (size_t)M * M;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int jj = (int)(o % L);
    const int ii = (int)((o / L) % L);
    const int e = (int)((o / ((size_t)L * L)) % ND);
    const int d = (int)(o / ((size_t)L * L * ND));
    const size_t src = (size_t)(d * L + ii) * M + e * L + jj;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += partial[(size_t)s * total + src];
    acc[o] = sum;
  }
}

// shared memory of a pass: its vector operands, plus its matrices when
// they are kept resident (4 bytes an element in every precision: f32, or
// the bf16 hi and lo halves).  K3 keeps the push half of the (2, n_mat, W,
// L) band, K4 both halves.
size_t vec_bytes(int vecs, int prec, int n_dyn, int L) {
  return (size_t)vecs * vec_slots(prec) * n_dyn * L * sizeof(float);
}

constexpr int kFilterVecs = 1, kSmoothVecs = 2;
constexpr int kFilterHalves = 1, kSmoothHalves = 2;

size_t band_bytes(int halves, int n_mat, int W, int L) {
  return (size_t)halves * n_mat * W * (size_t)L * sizeof(float);
}

bool band_resident(int vecs, int halves, int prec, int n_dyn, int n_mat,
                   int W, int L) {
  return vec_bytes(vecs, prec, n_dyn, L) + band_bytes(halves, n_mat, W, L) <=
         kResidentCap;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const PassArgs& a, int C, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<C, block_threads(a.L), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int ND, bool RES, int MODE, int PREC>
struct FilterRun {
  static cudaError_t go(const PassArgs& a, int C, cudaStream_t s) {
    return launch(pfilter_kernel<ND, RES, MODE != 0, PREC>, a, C,
                  vec_bytes(kFilterVecs, PREC, ND, a.L) +
                      (RES ? band_bytes(kFilterHalves, a.n_mat, a.W, a.L) : 0),
                  s);
  }
};

template <int ND, bool RES, int MODE, int PREC>
struct SmoothRun {
  static cudaError_t go(const PassArgs& a, int C, cudaStream_t s) {
    return launch(psmooth_kernel<ND, RES, MODE, PREC>, a, C,
                  vec_bytes(kSmoothVecs, PREC, ND, a.L) +
                      (RES ? band_bytes(kSmoothHalves, a.n_mat, a.W, a.L) : 0),
                  s);
  }
};

// pick the instantiation: precision, then ND x resident x mode
template <template <int, bool, int, int> class Run, int ND, bool RES,
          int MODE>
cudaError_t by_prec(int prec, const PassArgs& a, int C, cudaStream_t s) {
  switch (prec) {
    case kHighest: return Run<ND, RES, MODE, kHighest>::go(a, C, s);
    case kBf16x3: return Run<ND, RES, MODE, kBf16x3>::go(a, C, s);
    case kBf16: return Run<ND, RES, MODE, kBf16>::go(a, C, s);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, bool, int, int> class Run, int ND, bool RES>
cudaError_t by_mode(int mode, int n_modes, int prec, const PassArgs& a,
                    int C, cudaStream_t s) {
  if (mode < 0 || mode >= n_modes) return cudaErrorInvalidValue;
  switch (mode) {
    case 0: return by_prec<Run, ND, RES, 0>(prec, a, C, s);
    case 1: return by_prec<Run, ND, RES, 1>(prec, a, C, s);
    case 2: return by_prec<Run, ND, RES, 2>(prec, a, C, s);
    default: return by_prec<Run, ND, RES, 3>(prec, a, C, s);
  }
}

template <template <int, bool, int, int> class Run>
cudaError_t dispatch(const PassArgs& a, int C, int n_dyn, bool res, int mode,
                     int n_modes, int prec, cudaStream_t s) {
  if (n_dyn == 1) {
    return res ? by_mode<Run, 1, true>(mode, n_modes, prec, a, C, s)
               : by_mode<Run, 1, false>(mode, n_modes, prec, a, C, s);
  }
  return res ? by_mode<Run, 2, true>(mode, n_modes, prec, a, C, s)
             : by_mode<Run, 2, false>(mode, n_modes, prec, a, C, s);
}

// every row in exactly one chunk; chunk offsets c * tc fit an int
bool bad_chunks(int T, int C, int tc) {
  const long long rows = (long long)C * tc;
  return T < 1 || C < 1 || tc < 1 || rows < T || rows > 0x7fffffffLL;
}

bool bad_prec(int prec, const void* hi, const void* lo) {
  if (prec == kHighest) return false;
  if (prec != kBf16x3 && prec != kBf16) return true;
  return hi == nullptr || (prec == kBf16x3 && lo == nullptr);
}

int count_matrices(int n_dyn, int mask) {
  int n = 0;
  for (int d = 0; d < n_dyn; ++d) n += !((mask >> d) & 1);
  return n;
}

template <int PASSES, bool VEC>
cudaError_t acc_partial(const float* A, const float* B, float* partial,
                        int T, int M, int S, int rows, cudaStream_t s) {
  const size_t smem = (size_t)4 * kAccBK * (kAccTile + kAccPad) * sizeof(float);
  auto kernel = joint_acc_partial_kernel<PASSES, VEC>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kAccTile - 1) / kAccTile;
  kernel<<<dim3(tiles, tiles, S), kAccThreads, smem, s>>>(
      A, B, partial, T, M, rows);
  return cudaGetLastError();
}

// a pass's band arguments are usable: n_mat channels of W rows
bool bad_band(int prec, int n_mat, int W, int L, const void* band,
              const void* hi, const void* lo, const void* win0) {
  if (prec != kHighest && prec != kBf16x3 && prec != kBf16) return true;
  if (n_mat == 0) return false;
  return W < 1 || W > L || win0 == nullptr ||
         (prec == kHighest ? band == nullptr : bad_prec(prec, hi, lo));
}

// the band's arguments into a PassArgs
void set_band(PassArgs& a, const void* band, const void* hi, const void* lo,
              const void* win0, int n_mat, int W) {
  a.band = static_cast<const float*>(band);
  a.band_hi = static_cast<const bf16*>(hi);
  a.band_lo = static_cast<const bf16*>(lo);
  a.win0 = static_cast<const int*>(win0);
  a.W = n_mat > 0 ? W : 0;
  a.n_mat = n_mat;
}

}  // namespace

extern "C" {

// 1 when a pass keeps its band in shared memory: kind 0 the filter pass K3
// (the push half of the (2, n_mat, W, L) band), kind 1 the smoother pass
// K4 (both halves).
int pmg_pscan_resident(int kind, int n_dyn, int n_mat, int L, int W,
                       int prec) {
  return kind == 0 ? band_resident(kFilterVecs, kFilterHalves, prec, n_dyn,
                                   n_mat, W, L)
                   : band_resident(kSmoothVecs, kSmoothHalves, prec, n_dyn,
                                   n_mat, W, L);
}

// K3.  Returns a cudaError_t (0 on success); the launch is asynchronous.
// post and norm are written only when emit != 0 (they may be null then).
// tlat is read for the constant channels' first rows; the other channels'
// push goes through the push half of `band` (2, n_mat, W, L) with window
// rows `win0` (2, n_mat, L), n_mat the channels not flagged constant in
// uniform_mask; band_hi/band_lo (its bf16 split) are read when prec != 0.
int pmg_pfilter_pass(const void* w, const void* tlat, const void* band,
                     const void* band_hi, const void* band_lo,
                     const void* win0, const void* tdyn, const void* ins,
                     void* finals, void* post, void* norm, int T, int C,
                     int tc, int n_dyn, int L, int W, int uniform_mask,
                     int emit, int prec, void* stream) {
  const int n_mat = count_matrices(n_dyn, uniform_mask);
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc) ||
      bad_band(prec, n_mat, W, L, band, band_hi, band_lo, win0))
    return (int)cudaErrorInvalidValue;
  PassArgs a{};
  a.x = static_cast<const float*>(w);
  a.tlat = static_cast<const float*>(tlat);
  set_band(a, band, band_hi, band_lo, win0, n_mat, W);
  a.tdyn = static_cast<const float*>(tdyn);
  a.ins = static_cast<const float*>(ins);
  a.finals = static_cast<float*>(finals);
  a.out = static_cast<float*>(post);
  a.out2 = static_cast<float*>(norm);
  a.T = T;
  a.L = L;
  a.tc = tc;
  a.mask = uniform_mask;
  return (int)dispatch<FilterRun>(
      a, C, n_dyn,
      band_resident(kFilterVecs, kFilterHalves, prec, n_dyn, n_mat, a.W, L),
      emit != 0, 2, prec, static_cast<cudaStream_t>(stream));
}

// K4.  mode 0 finals only; 1 full (out = smooth, out2 = r); 2 marginal
// (out = lat (T, L), out3 = dyn (T, ND)); 3 marginal + r (out2 = r, the
// scratch joint_acc reduces).  Outputs a mode does not write may be null.
// tlat/tlatT are read for the constant channels' first rows; the other
// channels' push and pull go through `band` (2, n_mat, W, L) with window
// rows `win0` (2, n_mat, L), n_mat the channels not flagged constant in
// uniform_mask; band_hi/band_lo (its bf16 split) are read when prec != 0.
int pmg_psmooth_pass(const void* post, const void* tlat, const void* tlatT,
                     const void* band, const void* band_hi,
                     const void* band_lo, const void* win0, const void* tdyn,
                     const void* ins, void* finals, void* out, void* out2,
                     void* out3, int T, int C, int tc, int n_dyn, int L,
                     int W, int uniform_mask, int mode, int prec,
                     void* stream) {
  const int n_mat = count_matrices(n_dyn, uniform_mask);
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc) ||
      bad_band(prec, n_mat, W, L, band, band_hi, band_lo, win0))
    return (int)cudaErrorInvalidValue;
  PassArgs a{};
  a.x = static_cast<const float*>(post);
  a.tlat = static_cast<const float*>(tlat);
  a.tlatT = static_cast<const float*>(tlatT);
  set_band(a, band, band_hi, band_lo, win0, n_mat, W);
  a.tdyn = static_cast<const float*>(tdyn);
  a.ins = static_cast<const float*>(ins);
  a.finals = static_cast<float*>(finals);
  a.out = static_cast<float*>(out);
  a.out2 = static_cast<float*>(out2);
  a.out3 = static_cast<float*>(out3);
  a.T = T;
  a.L = L;
  a.tc = tc;
  a.mask = uniform_mask;
  return (int)dispatch<SmoothRun>(
      a, C, n_dyn,
      band_resident(kSmoothVecs, kSmoothHalves, prec, n_dyn, n_mat, a.W, L),
      mode, 4, prec, static_cast<cudaStream_t>(stream));
}

// joint_acc over post, r (T, ND, L): S slices of `rows_per_slice` rows of
// 128 x 128 output tiles into `partial` (S, ND*L, ND*L), then their sum
// into acc (ND, ND, L, L).  passes 3: 3xTF32; 1: the one-pass control
// (hi.hi only).
int pmg_joint_acc(const void* post, const void* r, void* partial, void* acc,
                  int T, int n_dyn, int L, int S, int rows_per_slice,
                  int passes, void* stream) {
  if (bad_shape(n_dyn, L) || T < 1 || S < 1 || rows_per_slice < 1 ||
      (long long)S * rows_per_slice < T || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const int M = n_dyn * L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(post);
  const float* B = static_cast<const float*>(r);
  float* part = static_cast<float*>(partial);
  // 16-byte copies when every row of the tiles starts 16-byte aligned
  const bool vec = M % 4 == 0;
  cudaError_t err =
      passes == 3
          ? (vec ? acc_partial<3, true>(A, B, part, T, M, S, rows_per_slice, s)
                 : acc_partial<3, false>(A, B, part, T, M, S, rows_per_slice,
                                         s))
          : (vec ? acc_partial<1, true>(A, B, part, T, M, S, rows_per_slice, s)
                 : acc_partial<1, false>(A, B, part, T, M, S, rows_per_slice,
                                         s));
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * M;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  joint_acc_reduce_kernel<<<blocks, 256, 0, s>>>(part,
                                                 static_cast<float*>(acc), S,
                                                 n_dyn, L);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Validity rules (those of the TPU kernels, with their runtime bound
// n_valid): in K3 row t of a chunk is a step when t < n_valid (0 <= n_valid
// <= T); in K4 when t < n_valid - 1 (0 <= n_valid <= T + 1).  The rows of a
// chunk that are not steps pass the carry through: K3 stores the carry and
// norm 1, K4 the carry and r = 0, so no row is left unwritten.  The
// single-sequence driver passes n_valid = T, which makes row T - 1 K4's one
// pass-through row (smooth_parallel makes that carry post_{T-1}); a time
// shard of a mesh (parallel/spmd.py) passes its own bounds, up to T + 1 in
// K4, where every row recurses and the last reads the carry of the next
// shard.  Rows at or past T do not exist here, so they are neither run nor
// stored.
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

#include "hopper_common.cuh"
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
  int nv;               // the validity bound n_valid (see the header)
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

// K3: filter pass.  Per step, forward over the chunk's rows t < n_valid:
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
  const int rows = max(0, min(a.tc, a.T - t0));  // the chunk's rows
  const int n = max(0, min(rows, a.nv - t0));    // its steps

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
  // the rows past n_valid pass the carry through, with norm 1
  if (EMIT)
    for (int tau = n; tau < rows; ++tau)
      store_row<ND>(a, (size_t)t0 + tau, carry, 1.f);
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

// K4: smoother pass.  Per step, backward over the chunk's rows
// t < n_valid - 1:
//   prior = push(post_t); r = carry / prior (0 where prior == 0);
//   pull_e = Tlat[e] @ r_e; out_d = sum_e Tdyn[d,e] pull_e;
//   carry = post_t * out, normalised.
// MODE full stores smooth and r (T, ND, L); marginal stores lat (T, L) and
// dyn (T, ND); marginal+acc also stores r.  On the rows that are not steps
// (row T-1 alone at n_valid = T) smooth = carry, r = 0.
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
  // rows [t0, t0 + n) are steps; rows [t0 + n, t_end) pass the carry
  // through (row T-1 alone at n_valid = T, none at T + 1)
  const int n = max(0, min(t_end, a.nv - 1) - t0);

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
  const int pass0 = t0 + n;  // the first row that passes the carry through
  if (MODE != kFinals && pass0 < t_end) {
    for (int t = pass0; t < t_end; ++t) {
      const size_t base = (size_t)t * ND * L;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        if (live && MODE == kFull) a.out[base + d * L + j] = carry[d];
        if (live && STORE_R) a.out2[base + d * L + j] = 0.f;
      }
      // every such row holds the same carry: one block reduction serves
      // them all (its lat row stored here, its dyn rows after the barrier)
      if (MARG) marginal_partials<ND>(a, carry, t, red_m);
    }
    if (MARG) {
      dyn_pending = true;
      dyn_row = pass0;
    }
  }
  // the filter posterior of the next row, a step ahead
  float f_next[ND];
#pragma unroll
  for (int p = 0; p < ND; ++p)
    f_next[p] = (live && n > 0)
                    ? a.x[((size_t)(t0 + n - 1) * ND + p) * L + j] : 0.f;
  __syncthreads();  // resident band complete; the pass rows' dyn partials
  if (MARG && dyn_pending)
    for (int t = (int)dyn_row; t < t_end; ++t)
      marginal_finish<ND>(a, t, red_m);
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
// term is 2^-22 of the product), each product an f32-accumulated TF32
// wgmma.  Three TF32 products of 2 T M^2 operations at the card's 495
// TFLOP/s: 1.2 ms at T = 1e5, M = 1000, against 6 ms for one f32 product
// without tensor cores (67 TFLOP/s), and 0.24 ms for reading A and B once,
// so it is bound by operations.
//
// The design for Hopper (the warp-level mma kernel it replaced ran at a
// third of the bound: that TF32 rate is below wgmma's).  TF32 wgmma reads B
// only K-major from shared memory, and here both operands are M-contiguous
// (T, M) rows, so B is transposed once per stage.  Each block owns one
// 128 x 128 output tile over one slice of time (split-K: S slices, as many
// as fill one wave of the card; at M = 200 there are 4 tiles and 33
// slices), and holds three warpgroups:
//   * a producer warpgroup fills a ring of kAccStages stages, each 32 time
//     rows of the A and B column tiles as they lie in device memory: TMA
//     boxes where M % 4 == 0 and the bases are 16-byte aligned, else 4-byte
//     cp.asyncs (AccLoad); a stage's mbarrier counts its bytes (or the
//     cp.asyncs' arrivals); a stage is refilled once both consumer
//     warpgroups have read their A fragments from it;
//   * two consumer warpgroups own 64 rows each of the tile.  Together they
//     transpose and split each stage's B tile once into K-major hi and lo
//     TF32 tiles in the 128-byte-swizzled layout wgmma reads (128 rows of
//     32 k: one swizzle row each; double-buffered, so the next stage's
//     tile is made while the tensor cores form this one's products); each
//     reads its A rows' fragments from the stage into registers and splits
//     them there (each staged value is split once, by the one thread that
//     owns it), and issues wgmma.m64n128k8 TF32 with A from registers, B
//     from shared memory.  setmaxnreg gives the producer's registers to
//     them.
// Past T and past M the values are masked to exact zeros where they are
// read (the stages hold stale data there).
//
// Order (no atomics: runs repeat bit for bit).  Each 32-row stage goes
// into a fresh tensor-core accumulator (per 8-row step lo.hi, hi.lo, then
// hi.hi; the tensor cores' f32 adds truncate, and a bias over 96
// accumulations per 256 rows reached 3e-6 of an entry without it), which
// is then added to the tile's running f32 sum, rounded to nearest, stage
// after stage over the slice.  Each slice's partial goes to an (S, M, M)
// buffer; a second kernel adds the S partials in slice order into the
// (ND, ND, L, L) result.  PASSES = 1 (hi.hi only, one TF32 product) exists
// for the tests' control and is not reachable from the public wrapper.
// ---------------------------------------------------------------------------

// The two ways the ring is filled (the same values; the consumers read
// through raw_off):
//   kLoadTma: TMA boxes of 32 columns x 32 rows, four per operand and
//     stage, 128-byte swizzle (M % 4 == 0, 16-byte aligned bases);
//   kLoadCp: 4-byte cp.asyncs into rows padded to 136 floats (any M, any
//     alignment).
// On the H100 at T = 1e5, L = 500 (scripts/scan_push_probe.py) the TMA
// boxes took 2.16 ms, one bulk copy per row 3.66 and cp.async 4.00.
enum AccLoad { kLoadTma = 0, kLoadCp = 2 };

constexpr int kAccBK = 32;      // time rows per stage: one swizzle row of K
constexpr int kAccTile = 128;   // the output tile, kAccTile x kAccTile
constexpr int kAccRow = kAccTile + 8;  // floats of a padded staged row
constexpr int kAccStages = 4;
constexpr int kAccConsumers = 256;     // two warpgroups
constexpr int kAccThreads = kAccConsumers + 128;  // + a producer warpgroup
// one operand's stage: the padded rows, rounded up to 1024 bytes (the
// swizzled boxes take 16 KB of it)
constexpr uint32_t kAccRawBytes = (kAccBK * kAccRow * 4 + 1023) / 1024 * 1024;
constexpr uint32_t kAccBTile = kAccTile * kAccBK * 4;     // B hi (or lo)
// the K-major B tiles (two buffers of hi and lo), the ring, its barriers,
// and room to align to 1024
constexpr size_t kAccSmem =
    4 * kAccBTile + kAccStages * 2 * kAccRawBytes + 16 * kAccStages + 1024;

// byte offset of element (time row k, column m) in an operand's stage
template <int LOAD>
__device__ __forceinline__ uint32_t raw_off(int k, int m) {
  if (LOAD == kLoadTma) return (m >> 5) * 4096 + sw128_off4(k, m);
  return (k * kAccRow + m) * 4;
}

// tf32(x): the rounding of cvt.rna.tf32.f32 (to nearest, ties away from
// zero, onto the top 10 mantissa bits) in two integer operations; for
// finite x the bits are cvt's (post and r are finite).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo) TF32 pair, hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d (64 x 128, f32) = (scale_d ? d : 0) + a (64 x 8 TF32, registers) @ b
// (128 x 8 TF32, K-major in shared memory); a: (row g, k t), (row g + 8,
// k t), (row g, k t + 4), (row g + 8, k t + 4) of the warp's 16 rows
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <int PASSES, int LOAD>
__global__ void __launch_bounds__(kAccThreads, 1)
    joint_acc_partial_kernel(const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_b,
                             const float* __restrict__ A,
                             const float* __restrict__ B, float* partial,
                             int T, int M, int rows_per_slice) {
  constexpr int S = kAccStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const tiles = smem_raw + (base - raw0);  // B hi/lo [2 buffers]
  uint8_t* const ring = tiles + 4 * kAccBTile;       // [S][A, B]
  const uint32_t ring_u = base + 4 * kAccBTile;
  const uint32_t bars = ring_u + S * 2 * kAccRawBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.y * kAccTile, q0 = blockIdx.x * kAccTile;
  const int ta = blockIdx.z * rows_per_slice;
  const int tb = min(T, ta + rows_per_slice);
  const int nst = tb > ta ? (tb - ta + kAccBK - 1) / kAccBK : 0;
  // the tile's columns that lie in the matrix, of A (rows of the output)
  // and of B (its columns)
  const int ma = min(kAccTile, M - p0), nb = min(kAccTile, M - q0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), LOAD == kLoadCp ? 128 : 1);
      mbar_init(empty(s), 2);  // one release per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kAccConsumers) {
    // ---- the producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int p = threadIdx.x - kAccConsumers;
    if (LOAD == kLoadTma && p >= 32) return;  // one thread issues the boxes
    for (int st = 0; st < nst; ++st) {
      const int s = st % S;
      if (st >= S) mbar_wait(empty(s), (st / S - 1) & 1);
      const int t0 = ta + st * kAccBK, rows = min(kAccBK, tb - t0);
      const uint32_t sa = ring_u + s * 2 * kAccRawBytes, sb = sa + kAccRawBytes;
      if (LOAD == kLoadTma) {
        if (lane == 0) {
          // zeros past M and past T, counted as loaded
          mbar_expect_tx(full(s), 2 * 4 * 4096);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tma_load(sa + 4096 * j, &tm_a, full(s), p0 + 32 * j, t0, 0);
            tma_load(sb + 4096 * j, &tm_b, full(s), q0 + 32 * j, t0, 0);
          }
        }
      } else {
        for (int e = p; e < rows * kAccTile; e += 128) {
          const int r = e / kAccTile, c = e % kAccTile;
          const size_t g = (size_t)(t0 + r) * M;
          if (c < ma) cp_async4(sa + raw_off<LOAD>(r, c), A + g + p0 + c, 4);
          if (c < nb) cp_async4(sb + raw_off<LOAD>(r, c), B + g + q0 + c, 4);
        }
        cp_async_arrive(full(s));
      }
    }
    if (LOAD == kLoadCp) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the consumers: warpgroup wg owns rows wg * 64 .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int ct = threadIdx.x;  // 0 .. 255
  const int wg = warp >> 2, g8 = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g8;  // and r0 + 8
  auto rows_of = [&](int st) { return min(kAccBK, tb - (ta + st * kAccBK)); };

  // stage st's B tile (k, n) -> K-major hi (and lo) TF32 tiles of buffer
  // `buf`: thread ct takes column n = ct % 128 and the 4-row chunks kc =
  // ct / 128 + 2 i, one 16-byte store each (a warp's reads and stores fall
  // on 32 banks)
  auto convert = [&](int st, int buf) {
    const uint8_t* rb = ring + (st % S) * 2 * kAccRawBytes + kAccRawBytes;
    const int rows = rows_of(st), n = ct & (kAccTile - 1);
    const uint32_t hi_t = base + buf * 2 * kAccBTile, lo_t = hi_t + kAccBTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = (ct >> 7) + 2 * i;
      uint32_t h[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * kc + u;
        const float x =
            (n < nb && k < rows)
                ? *reinterpret_cast<const float*>(rb + raw_off<LOAD>(k, n))
                : 0.f;
        split_tf32(x, h[u], l[u]);
      }
      const uint32_t off = sw128_off4(n, 4 * kc);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       hi_t + off),
                   "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                   : "memory");
      if (PASSES == 3)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         lo_t + off),
                     "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                     : "memory");
    }
    fence_proxy_async();  // the tiles are read by wgmma
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (nst > 0) {
    mbar_wait(full(0), 0);
    convert(0, 0);
  }
  named_sync(1, kAccConsumers);
  for (int st = 0; st < nst; ++st) {
    const int s = st % S, buf = st & 1, rows = rows_of(st);
    // this warp's A fragments of the stage's four 8-row steps, split
    const uint8_t* ra = ring + s * 2 * kAccRawBytes;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = r0 + (i & 1) * 8, k = ks * 8 + t4 + (i >> 1) * 4;
        const float x =
            (m < ma && k < rows)
                ? *reinterpret_cast<const float*>(ra + raw_off<LOAD>(k, m))
                : 0.f;
        split_tf32(x, ahi[ks][i], alo[ks][i]);
      }
    // the stage is read (its B converted before the last consumer
    // barrier): the warpgroup releases it
    named_sync(2 + wg, 128);
    if ((warp & 3) == 0 && lane == 0) mbar_arrive(empty(s));
    const uint32_t hi_t = base + buf * 2 * kAccBTile, lo_t = hi_t + kAccBTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dh = sw128_desc(hi_t + 32 * ks);
      if (PASSES == 3) {
        wgmma_tf32(part, alo[ks], dh, ks);
        wgmma_tf32(part, ahi[ks], sw128_desc(lo_t + 32 * ks), 1);
        wgmma_tf32(part, ahi[ks], dh, 1);
      } else {
        wgmma_tf32(part, ahi[ks], dh, ks);
      }
    }
    wgmma_commit();
    // the next stage's B tile, made while the tensor cores work
    if (st + 1 < nst) {
      mbar_wait(full((st + 1) % S), ((st + 1) / S) & 1);
      convert(st + 1, buf ^ 1);
    }
    wgmma_wait0();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    // the next tile complete; no warpgroup still reads this one
    named_sync(1, kAccConsumers);
  }
  // accumulator 4j + u: row r0 (+8 for u >= 2), column 8j + 2 t4 (+1 for
  // odd u)
  float* out = partial + (size_t)blockIdx.z * M * M;
  const bool pair = M % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + r0 + half * 8;
    if (p >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int q = q0 + jj * 8 + 2 * t4;
      float* o = out + (size_t)p * M + q;
      const float v0 = acc[4 * jj + 2 * half], v1 = acc[4 * jj + 2 * half + 1];
      if (pair && q + 1 < M) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (q < M) o[0] = v0;
        if (q + 1 < M) o[1] = v1;
      }
    }
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

// every row in exactly one chunk; chunk offsets c * tc fit an int; the
// validity bound in [0, T + extra] (extra 0 for K3, 1 for K4)
bool bad_chunks(int T, int C, int tc, int n_valid, int extra) {
  const long long rows = (long long)C * tc;
  return T < 1 || C < 1 || tc < 1 || rows < T || rows > 0x7fffffffLL ||
         n_valid < 0 || (long long)n_valid > (long long)T + extra;
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

template <int PASSES, int LOAD>
cudaError_t acc_partial(const CUtensorMap& ta, const CUtensorMap& tb,
                        const float* A, const float* B, float* partial,
                        int T, int M, int S, int rows, cudaStream_t s) {
  auto kernel = joint_acc_partial_kernel<PASSES, LOAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAccSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kAccTile - 1) / kAccTile;
  kernel<<<dim3(tiles, tiles, S), kAccThreads, kAccSmem, s>>>(
      ta, tb, A, B, partial, T, M, rows);
  return cudaGetLastError();
}

template <int PASSES>
cudaError_t acc_partial_by(int load, const CUtensorMap& ta,
                           const CUtensorMap& tb, const float* A,
                           const float* B, float* partial, int T, int M,
                           int S, int rows, cudaStream_t s) {
  if (load == kLoadTma)
    return acc_partial<PASSES, kLoadTma>(ta, tb, A, B, partial, T, M, S,
                                         rows, s);
  return acc_partial<PASSES, kLoadCp>(ta, tb, A, B, partial, T, M, S, rows,
                                      s);
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
// Rows t < n_valid (0 <= n_valid <= T) are steps, the others pass the
// carry through (n_valid = T: every row a step).
// tlat is read for the constant channels' first rows; the other channels'
// push goes through the push half of `band` (2, n_mat, W, L) with window
// rows `win0` (2, n_mat, L), n_mat the channels not flagged constant in
// uniform_mask; band_hi/band_lo (its bf16 split) are read when prec != 0.
int pmg_pfilter_pass(const void* w, const void* tlat, const void* band,
                     const void* band_hi, const void* band_lo,
                     const void* win0, const void* tdyn, const void* ins,
                     void* finals, void* post, void* norm, int T, int C,
                     int tc, int n_valid, int n_dyn, int L, int W,
                     int uniform_mask, int emit, int prec, void* stream) {
  const int n_mat = count_matrices(n_dyn, uniform_mask);
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc, n_valid, 0) ||
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
  a.nv = n_valid;
  a.mask = uniform_mask;
  return (int)dispatch<FilterRun>(
      a, C, n_dyn,
      band_resident(kFilterVecs, kFilterHalves, prec, n_dyn, n_mat, a.W, L),
      emit != 0, 2, prec, static_cast<cudaStream_t>(stream));
}

// K4.  mode 0 finals only; 1 full (out = smooth, out2 = r); 2 marginal
// (out = lat (T, L), out3 = dyn (T, ND)); 3 marginal + r (out2 = r, the
// scratch joint_acc reduces).  Outputs a mode does not write may be null.
// Rows t < n_valid - 1 (0 <= n_valid <= T + 1) are steps, the others pass
// the carry through (n_valid = T: row T - 1 alone).
// tlat/tlatT are read for the constant channels' first rows; the other
// channels' push and pull go through `band` (2, n_mat, W, L) with window
// rows `win0` (2, n_mat, L), n_mat the channels not flagged constant in
// uniform_mask; band_hi/band_lo (its bf16 split) are read when prec != 0.
int pmg_psmooth_pass(const void* post, const void* tlat, const void* tlatT,
                     const void* band, const void* band_hi,
                     const void* band_lo, const void* win0, const void* tdyn,
                     const void* ins, void* finals, void* out, void* out2,
                     void* out3, int T, int C, int tc, int n_valid,
                     int n_dyn, int L, int W, int uniform_mask, int mode,
                     int prec, void* stream) {
  const int n_mat = count_matrices(n_dyn, uniform_mask);
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc, n_valid, 1) ||
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
  a.nv = n_valid;
  a.mask = uniform_mask;
  return (int)dispatch<SmoothRun>(
      a, C, n_dyn,
      band_resident(kSmoothVecs, kSmoothHalves, prec, n_dyn, n_mat, a.W, L),
      mode, 4, prec, static_cast<cudaStream_t>(stream));
}

// joint_acc over post, r (T, ND, L): S slices of `rows_per_slice` rows of
// 128 x 128 output tiles into `partial` (S, ND*L, ND*L), then their sum
// into acc (ND, ND, L, L).  passes 3: 3xTF32; 1: the one-pass control
// (hi.hi only).  Both on wgmma TF32.  The ring is filled by TMA where
// M % 4 == 0 and both bases are 16-byte aligned, else by cp.async
// (AccLoad; the same bits either way).
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
  // TMA where every row starts 16-byte aligned
  const bool aligned = M % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int load = aligned ? kLoadTma : kLoadCp;
  CUtensorMap maps[2] = {};
  if (load == kLoadTma &&
      (!encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M, T, 1,
               4LL * M, 4LL * M * T, 32, kAccBK) ||
       !encode(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, B, M, T, 1,
               4LL * M, 4LL * M * T, 32, kAccBK)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      passes == 3 ? acc_partial_by<3>(load, maps[0], maps[1], A, B, part, T,
                                      M, S, rows_per_slice, s)
                  : acc_partial_by<1>(load, maps[0], maps[1], A, B, part, T,
                                      M, S, rows_per_slice, s);
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

// Sequential HMM filter (K1) and smoother (K2) scans for NVIDIA Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// poor_man_gplvm_tpu_torch/ops/scan_kernels.py.
//
// Replaces the Pallas TPU kernels
//   K1  poor_man_gplvm_tpu/ops/pallas/scan_kernels.py::_filter_kernel
//       (wrapper filter_chunk_pallas)
//   K2  poor_man_gplvm_tpu/ops/pallas/scan_kernels.py::_smoother_kernel
//       (wrapper smoother_chunk_pallas)
// and computes what they compute, not how they are blocked.  The TPU runs
// its grid in order and carries the scan state in VMEM from one grid step
// to the next; blocks of a CUDA grid run in no order, so here ONE thread
// block loops over all T steps inside the kernel and nothing carries
// between blocks.  There is no 128-lane or block_t padding: the loop runs
// to exactly T and threads j >= L are masked.
//
// Layout: one thread block per sequence (blockIdx.x = sequence index; a
// single sequence is a batch of one), thread j owns latent column j
// (blockDim = L rounded up to 32, at most 1024).  A block runs exactly its
// own length, lengths[e] <= Tmax, and writes nothing past it.  A launch
// holds G transition configurations (G = 1 without a configuration index):
// a stack of G transition stacks, tdyns and bands, all of one L, n_dyn,
// constant-channel mask and band width W (a narrower band is padded with
// exact zeros).  Block e runs under configuration cfg[e] (0 when cfg is
// null): it moves its tlat, band, win0 and tdyn pointers to that
// configuration once, before the loop, and keeps its own copy of the band
// in shared memory.  Thread j's carry (n_dyn
// values) lives in its registers, since step t+1 needs only column j of
// step t's posterior.  The vector that every thread reads in the matvec
// (the dynamics-mixed carry q in K1, the ratio r in K2) goes to shared
// memory.  Each step has two barriers:
//   (a) after q (or r) and the warp partials of the constant-channel sums
//       are written, so that the matvec sees the whole vector;
//   (b) after the warp partials of the normaliser are written.
// Barrier (b) of step t also orders step t's matvec reads of q before step
// t+1's writes of q, so one buffer suffices: no thread can overwrite the
// shared vector (or a partials array) while another still reads step t's.
//
// What bounds it on this card: a scan is one dependent chain of T steps,
// each a (1,L)@(L,L) matvec per dynamics channel plus a block-wide sum, so
// one sequence is latency-bound on 1 of the H100's 132 SMs; a batch of
// short sequences (decode_latent_epochs) fills the card with one block
// each.
//   * Both kernels read only each column's window of nonzero rows, W of L,
//     from a band made once per decode (ops/band.py::transition_band): K1
//     the push half, K2 the pull half, kept in shared memory when it fits
//     (the kernels' notes).  A dense channel is the band W = L.
//   * The constant (jump) channel has every entry equal, so its matvec is
//     sum(q) * row: no matrix traffic at all (detected on the host exactly
//     as _detect_uniform_rows does; identical but non-constant rows take
//     the general matvec).
// Long sequences fill the card through the parallel-in-time kernels K3/K4
// (parallel_scan.cu), which run this step on one block per chunk.
//
// Numerics: f32 with FMA; the normaliser is clamped at 1e-38 as in the TPU
// kernels; r = 0 where the prior is 0 or subnormal (never 0/0, never inf:
// scan_common.cuh::kPriorFloor), so latent bins masked to zero weight give
// exact zeros, not NaNs.  K1 writes each step's normaliser s_t
// itself (Mosaic could not store a dynamic 1-D slice, so JAX recomputed it
// outside the kernel); the caller forms log(s_t) + scale * m_t.  Both
// kernels divide through an f64 reciprocal, which gives the f32 quotient's
// bits (scan_common.cuh::div_by_rcp).

#include "scan_common.cuh"

namespace {

using namespace pmg;

// One launch of K1 or K2 over a batch of E sequences.  Every sequence has
// Tmax rows of storage and runs lengths[e] of them (Tmax when lengths is
// null).  `x`/`x2` are the per-row inputs (K1: w; K2: filt and prior) with
// their own strides between sequences, in elements, so that K2 can read the
// filter's outputs in place (filt = post[:, :-1], prior = prior[:, 1:]);
// the outputs are contiguous.
struct SeqArgs {
  const float* x;      // K1: w (E, Tmax, L); K2: filt (E, Tmax, ND, L)
  const float* x2;     // K2: prior (E, Tmax, ND, L), +1-shifted
  const float* tlat;   // (ND, L, L), K2: transposed per channel; read for
                       // the constant channels' first rows
  const float* band;   // (n_mat, W, L): K1 the push windows, K2 the pull
                       // windows of the n_mat non-constant channels;
                       // band[m][k][j] = row win0[m][j] + k of column j
  const int* win0;     // (n_mat, L)
  const float* tdyn;   // (ND, ND)
  const float* init;   // (E, ND, L)
  const int* lengths;  // (E,) or null
  float* out;          // K1: post (null: norm only); K2: smooth
                       // (E, Tmax, ND, L)
  float* out2;         // K1: prior (null with post); K2: r (E, Tmax, ND, L)
  float* norm;         // K1: (E, Tmax) sum of the unnormalised u_t
  long long x_stride, x2_stride;
  int Tmax, L, W, n_mat, mask;
};

// The configuration index of a launch, a kernel argument of its own so that
// the launches without one take SeqArgs alone, as before it existed.
struct CfgArgs {
  const int* cfg;  // (E,) each sequence's configuration
  // elements between two configurations of tlat, band, win0 and tdyn
  long long tlat, band, win, tdyn;
};

__device__ __forceinline__ int seq_length(const SeqArgs& a, int e) {
  return a.lengths ? min(max(a.lengths[e], 0), a.Tmax) : a.Tmax;
}

// the transition of sequence e's configuration (CFG: a launch with a
// configuration index; without one every block reads the launch's own)
struct SeqTransition {
  const float* tlat;
  const float* band;
  const int* win0;
  const float* tdyn;
};

template <bool CFG>
__device__ __forceinline__ SeqTransition seq_transition(const SeqArgs& a,
                                                        const CfgArgs& c,
                                                        int e) {
  if (!CFG) return {a.tlat, a.band, a.win0, a.tdyn};
  const long long g = c.cfg[e];
  return {a.tlat + g * c.tlat, a.band + g * c.band, a.win0 + g * c.win,
          a.tdyn + g * c.tdyn};
}

// K1: causal filter over pre-computed weights w = exp(scale*(ll - rowmax)).
// Per sequence: w (T, L); tlat[d][i][j] = p(j | i, dyn=d); tdyn[p][d] =
// p(d | p); init (ND, L).  Out: post and prior (T, ND, L), norm (T,) = sum
// of the unnormalised u_t.
//
// Design for the H100 (PERF.md §5-6), K2's and K3's.  The dense kernel
// streamed each non-constant channel's whole 1 MB matrix from L2 into its
// SM every step at L = 500 (22 us a step), ~96 % of it exact zeros for the
// RBF movement channel.  Here the push reads the channel's band: W rows per
// column (21 at lengthscale 1), resident in shared memory whenever W * L *
// 4 bytes fit beside q (42 KB at L = 500), else streamed from L2 with 16
// loads in flight.  The sum runs over the window ascending with fmaf, the
// dense loop's order, and fmaf(x, +0, a) = a, so the bits are the dense
// kernel's; a dense channel is the band W = L, win0 = 0: the same code.
// The weight row w[t+1], which does not depend on the recursion, is loaded
// into a register while step t computes.  A store placed just before a
// block barrier holds the barrier up, so post[t], prior[t] and norm[t]
// (still in registers) go out right after the next step's barrier (a),
// ahead of the window dot, and the last row after the loop.  The division
// by the normaliser is one f64 reciprocal shared by the channels and an
// f64 product each, which has the f32 quotient's bits
// (scan_common.cuh::div_by_rcp): this step is K3's, bit for bit.
// STORE = false is the norm-only filter: the same steps with the post and
// prior row stores left out, for a caller that reads only the normalisers
// (the masked log-marginals of model selection); they keep their bits.
// CFG: each block under its own configuration (seq_transition).  The
// launch without either is `filter_kernel`, the same code as before they
// existed; the others are `filter_cfg_kernel`, whose launch bound of one
// block per SM lets ptxas use 64 registers (one kernel holding all of them
// got 32 registers with spills from ptxas, and 15 % more time at L = 500
// on the H100, also without a configuration index).
template <int ND, bool RESIDENT, bool STORE, bool CFG>
__device__ __forceinline__ void filter_body(const SeqArgs& a,
                                            const CfgArgs& c) {
  extern __shared__ float smem[];
  float* q = smem;                  // (ND, L) dynamics-mixed carry
  float* band_s = smem + ND * a.L;  // (n_mat, W, L) when RESIDENT
  __shared__ float red_q[32][ND];
  __shared__ float red_u[32];

  const int L = a.L, W = a.W, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const int e = blockIdx.x;
  const int T = seq_length(a, e);
  if (T <= 0) return;  // the whole block
  const float* __restrict__ w = a.x + (size_t)e * a.x_stride;
  const size_t row = (size_t)ND * L;
  float* __restrict__ post = STORE ? a.out + (size_t)e * a.Tmax * row
                                   : nullptr;
  float* __restrict__ prior_out = STORE ? a.out2 + (size_t)e * a.Tmax * row
                                        : nullptr;
  float* __restrict__ norm = a.norm + (size_t)e * a.Tmax;
  const SeqTransition tr = seq_transition<CFG>(a, c, e);

  if (RESIDENT) {
    for (size_t k = j; k < a.n_mat * WL; k += blockDim.x) band_s[k] = tr.band[k];
  }
  const float* band = RESIDENT ? band_s : tr.band;

  float tdyn[ND][ND], carry[ND], row0[ND], pr[ND];
  size_t off_f[ND];  // each channel's push band
  int i0_f[ND];      // first row of column j's window
  int slot = 0;
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = tr.tdyn[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.init[(size_t)e * row + d * L + j] : 0.f;
    row0[d] = live ? tr.tlat[d * LL + j] : 0.f;
    pr[d] = 0.f;
    off_f[d] = 0;
    i0_f[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off_f[d] = slot * WL;
      if (live) i0_f[d] = tr.win0[slot * L + j];
      ++slot;
    }
  }
  // the weight of the next row, a step ahead
  float w_next = live ? w[j] : 0.f;
  float s_prev = 0.f;  // the normaliser of the row not yet stored
  __syncthreads();     // resident band complete

  for (int t = 0; t < T; ++t) {
    const float wt = w_next;
    if (live && t + 1 < T) w_next = w[(size_t)(t + 1) * L + j];
    // dynamics mix of the own column: q_d = sum_p Tdyn[p,d] * carry_p
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float v = tdyn[0][d] * carry[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) v = fmaf(tdyn[p][d], carry[p], v);
      if (live) q[d * L + j] = v;
      if ((a.mask >> d) & 1) {
        const float s = warp_sum(v);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
    __syncthreads();  // (a) q and its partial sums complete

    // row t-1 (post in carry, prior in pr) goes out here, where the window
    // dot that follows hides the stores
    if (t > 0) {
      const size_t base = (size_t)(t - 1) * row;
      if (STORE && live) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          post[base + d * L + j] = carry[d];
          prior_out[base + d * L + j] = pr[d];
        }
      }
      if (j == 0) norm[t - 1] = s_prev;
    }

    float usum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((a.mask >> d) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][d];
        pr[d] = s * row0[d];
      } else {
        pr[d] = live ? window_matvec<matvec_unroll(RESIDENT)>(
                           q + d * L, band + off_f[d], i0_f[d], W, L, j)
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
    s_prev = s;
  }
  const size_t base = (size_t)(T - 1) * row;  // the last row
  if (STORE && live) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      post[base + d * L + j] = carry[d];
      prior_out[base + d * L + j] = pr[d];
    }
  }
  if (j == 0) norm[T - 1] = s_prev;
}

template <int ND, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads) filter_kernel(SeqArgs a) {
  filter_body<ND, RESIDENT, true, false>(a, CfgArgs{});
}

template <int ND, bool RESIDENT, bool STORE, bool CFG>
__global__ void __launch_bounds__(kMaxThreads, 1)
    filter_cfg_kernel(SeqArgs a, CfgArgs c) {
  filter_body<ND, RESIDENT, STORE, CFG>(a, c);
}

// K2: backward smoother over filter posteriors and +1-shifted priors.
// Per sequence: filt, prior (T, ND, L); tlat (ND, L, L) = Tlat transposed
// per channel, tlatT[e][i][j] = Tlat[e][j][i] (read for the constant
// channels' first rows); band (n_mat, W, L) the pull windows of the n_mat
// non-constant channels, band[m][k][j] = row win0[m][j] + k of column j of
// that channel's tlatT, win0 (n_mat, L); tdyn (ND, ND); init (ND, L) =
// smoothed posterior of the step after the last row.  Out: smooth and r
// (T, ND, L).
//
// Design for the H100 (PERF.md §5-6).  The dense kernel streamed each
// non-constant channel's whole 1 MB matrix from L2 into its one SM every
// step at L = 500 (23 us a step), ~96 % of it exact zeros for the RBF
// movement channel.  Here the pull reads the channel's band: W rows per
// column (21 at lengthscale 1), resident in shared memory whenever W * L *
// 4 bytes fit beside r (42 KB at L = 500), else streamed from L2 with 16
// loads in flight.  The sum runs over the window ascending with fmaf, the
// dense loop's order, and fmaf(x, +0, a) = a, so the bits are the dense
// kernel's; a dense channel is the band W = L, win0 = 0: the same code.
// The rows filt[t-1] and prior[t-1], which do not depend on the recursion,
// are loaded into registers while step t computes, and the ratio carry /
// prior at the head of a step is the carry times the prior's f64
// reciprocal, which has the f32 quotient's bits (scan_common.cuh::
// div_by_rcp): it waits on no memory, and the reciprocal neither waits for
// the carry nor takes the f32 division's slow path on the tails; the
// normaliser's division is one reciprocal shared by the channels.  A store
// placed just before a block barrier holds the barrier up (0.9 us a step
// on the H100 with the r store before (a) and the smooth store before the
// next step's (a)), so the r of step t and the smoothed row of step t+1
// are stored right after barrier (a), ahead of the window dot.  What is
// left is the chain's fixed cost: two block barriers per step, the block
// sums in warp order and the normaliser's reciprocal.  With a configuration
// index it is `smoother_cfg_kernel` (as for K1).
template <int ND, bool RESIDENT, bool CFG>
__device__ __forceinline__ void smoother_body(const SeqArgs& a,
                                              const CfgArgs& c) {
  extern __shared__ float smem[];
  float* r_s = smem;                // (ND, L) ratios
  float* band_s = smem + ND * a.L;  // (n_mat, W, L) when RESIDENT
  __shared__ float red_r[32][ND];
  __shared__ float red_s[32];

  const int L = a.L, W = a.W, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const int b = blockIdx.x;
  const int T = seq_length(a, b);
  if (T <= 0) return;  // the whole block
  const size_t row = (size_t)ND * L;
  const float* __restrict__ filt = a.x + (size_t)b * a.x_stride;
  const float* __restrict__ prior = a.x2 + (size_t)b * a.x2_stride;
  float* __restrict__ smooth = a.out + (size_t)b * a.Tmax * row;
  float* __restrict__ rout = a.out2 + (size_t)b * a.Tmax * row;
  const SeqTransition tr = seq_transition<CFG>(a, c, b);

  if (RESIDENT) {
    for (size_t k = j; k < a.n_mat * WL; k += blockDim.x) band_s[k] = tr.band[k];
  }
  const float* band = RESIDENT ? band_s : tr.band;

  float tdyn[ND][ND], carry[ND], row0[ND];
  size_t off_b[ND];  // each channel's pull band
  int i0_b[ND];      // first row of column j's window
  int slot = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < ND; ++e) tdyn[d][e] = tr.tdyn[d * ND + e];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.init[(size_t)b * row + d * L + j] : 0.f;
    row0[d] = live ? tr.tlat[d * LL + j] : 0.f;
    off_b[d] = 0;
    i0_b[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off_b[d] = slot * WL;
      if (live) i0_b[d] = tr.win0[slot * L + j];
      ++slot;
    }
  }
  // the filter posterior and the prior of the next row, a step ahead
  float f_next[ND], p_next[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    const size_t at = ((size_t)(T - 1) * ND + e) * L + j;
    f_next[e] = live ? filt[at] : 0.f;
    p_next[e] = live ? prior[at] : 0.f;
  }
  __syncthreads();  // resident band complete

  for (int t = T - 1; t >= 0; --t) {
    const size_t base = (size_t)t * row;
    float f[ND], r[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      f[e] = f_next[e];
      const float pn = p_next[e];
      if (live && t > 0) {
        f_next[e] = filt[base - row + e * L + j];
        p_next[e] = prior[base - row + e * L + j];
      }
      // carry / pn: the reciprocal does not wait for the carry
      r[e] = pn >= kPriorFloor ? (pn < kRcpDivisorMax
                             ? div_by_rcp(carry[e], rcp_f64(pn))
                             : carry[e] / pn)
                      : 0.f;
      if (live) r_s[e * L + j] = r[e];
      if ((a.mask >> e) & 1) {
        const float s = warp_sum(r[e]);
        if (lane == 0) red_r[warp][e] = s;
      }
    }
    __syncthreads();  // (a)

    // this step's r and the smoothed row of step t+1 (still in carry) go
    // out here, where the window dot that follows hides them
    if (live) {
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        rout[base + e * L + j] = r[e];
        if (t < T - 1) smooth[base + (ND + e) * L + j] = carry[e];
      }
    }

    // pull_e = Tlat[e] @ r_e; out_d = sum_e Tdyn[d,e] * pull_e
    float pull[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if ((a.mask >> e) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_r[k][e];
        pull[e] = s * row0[e];
      } else {
        pull[e] = live ? window_matvec<matvec_unroll(RESIDENT)>(
                             r_s + e * L, band + off_b[e], i0_b[e], W, L, j)
                       : 0.f;
      }
    }
    float v[ND], vsum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float out = tdyn[d][0] * pull[0];
#pragma unroll
      for (int e = 1; e < ND; ++e) out = fmaf(tdyn[d][e], pull[e], out);
      v[d] = f[d] * out;
      vsum += v[d];
    }
    vsum = warp_sum(vsum);
    if (lane == 0) red_s[warp] = vsum;
    __syncthreads();  // (b)

    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_s[k];
    const float den = fmaxf(s, 1e-38f);
    if (den < kRcpDivisorMax) {  // the same for the whole block
      const double rden = rcp_f64(den);
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = div_by_rcp(v[d], rden);
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = v[d] / den;
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) smooth[d * L + j] = carry[d];  // row 0
}

template <int ND, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads) smoother_kernel(SeqArgs a) {
  smoother_body<ND, RESIDENT, false>(a, CfgArgs{});
}

template <int ND, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    smoother_cfg_kernel(SeqArgs a, CfgArgs c) {
  smoother_body<ND, RESIDENT, true>(a, c);
}

// K2 with the prior recomputed (the smoother of the 'filter' and
// 'filter_bf16' memory modes, ops/hmm.py::_smooth_chunked_filterstore):
// the backward smoother over stored filter posteriors alone, each +1-shifted
// prior formed in the kernel as K1 formed it, prior_{t+1} = push(filt_t).
// As K4 recomputes K3's prior (parallel_scan.cu::psmooth_kernel), the push
// runs K1's operations in K1's order (the dynamics mix of the own column,
// the warp-order row sum of a constant channel, the window sum over the
// push band ascending with fmaf), so on f32 filter posteriors it gives
// K1's prior bits and the smoothed rows and r are K2's on the stored
// priors, bit for bit.  The push's window sum runs in the pull's loop, as
// a second chain (the dense loop's order in each).  FT = bf16 reads the 'filter_bf16' store and forms
// the push and the smoother step from its f32 values.
//
// Layout as K2 (one block, thread j owns column j; E = 1).  The push of
// row t-1, which does not depend on the recursion, runs beside step t's
// pull: its dynamics-mixed vector q goes to shared memory before barrier
// (a) with r, and both window sums run between (a) and (b), so a step
// keeps K2's two barriers.  Shared memory holds r, q and both halves of
// the band (84 KB at L = 500, W = 21) when they fit.
struct PushArgs {
  const void* filt;     // (T, ND, L) float or bf16
  const float* tlat;    // (ND, L, L): row 0 of the constant channels' push
  const float* tlatT;   // (ND, L, L) transposed: row 0 of their pull
  const float* band;    // (2, n_mat, W, L): the push half, then the pull
  const int* win0;      // (2, n_mat, L)
  const float* tdyn;    // (ND, ND)
  const float* init;    // (ND, L) smoothed posterior after the last row
  float* smooth;        // (T, ND, L)
  float* rout;          // (T, ND, L)
  int T, L, W, n_mat, mask;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <int ND, bool RESIDENT, typename FT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    smoother_push_kernel(PushArgs a) {
  extern __shared__ float smem[];
  float* r_s = smem;                    // (ND, L) ratios
  float* q_s = smem + ND * a.L;         // (ND, L) dynamics-mixed filt row
  float* band_s = smem + 2 * ND * a.L;  // (2, n_mat, W, L) when RESIDENT
  __shared__ float red_r[32][ND];
  __shared__ float red_q[32][ND];
  __shared__ float red_s[32];

  const int L = a.L, W = a.W, T = a.T, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const size_t row = (size_t)ND * L, half = (size_t)a.n_mat * WL;
  const FT* __restrict__ filt = static_cast<const FT*>(a.filt);

  if (RESIDENT) {
    for (size_t k = j; k < 2 * half; k += blockDim.x) band_s[k] = a.band[k];
  }
  const float* band = RESIDENT ? band_s : a.band;

  float tdyn[ND][ND], carry[ND], row0_f[ND], row0_b[ND];
  size_t off[ND];  // each channel's window in a half of the band
  int i0_f[ND], i0_b[ND];
  int slot = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < ND; ++e) tdyn[d][e] = a.tdyn[d * ND + e];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.init[d * L + j] : 0.f;
    row0_f[d] = live ? a.tlat[d * LL + j] : 0.f;
    row0_b[d] = live ? a.tlatT[d * LL + j] : 0.f;
    off[d] = 0;
    i0_f[d] = i0_b[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off[d] = slot * WL;
      if (live) {
        i0_f[d] = a.win0[slot * L + j];
        i0_b[d] = a.win0[(a.n_mat + slot) * L + j];
      }
      ++slot;
    }
  }

  // q_d = sum_p Tdyn[p,d] * f_p of the own column (K1's mix), to shared
  // memory with the warp partials of the constant channels
  auto mix = [&](const float (&f)[ND]) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float v = tdyn[0][d] * f[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) v = fmaf(tdyn[p][d], f[p], v);
      if (live) q_s[d * L + j] = v;
      if ((a.mask >> d) & 1) {
        const float s = warp_sum(v);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
  };
  // the prior of column j from q in shared memory (K1's push)
  auto push = [&](float (&pr)[ND]) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((a.mask >> d) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][d];
        pr[d] = s * row0_f[d];
      } else {
        pr[d] = live ? window_matvec<matvec_unroll(RESIDENT)>(
                           q_s + d * L, band + off[d], i0_f[d], W, L, j)
                     : 0.f;
      }
    }
  };
  // the pull of r (K2's) and, in the same loops, the push of q: two
  // independent chains, each summed in its own order, so each has the bits
  // it has alone while their loads overlap
  auto pull_push = [&](float (&pull)[ND], float (&pr)[ND]) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((a.mask >> d) & 1) {
        float s = 0.f, u = 0.f;
        for (int k = 0; k < nwarp; ++k) {
          s += red_r[k][d];
          u += red_q[k][d];
        }
        pull[d] = s * row0_b[d];
        pr[d] = u * row0_f[d];
      } else {
        float x = 0.f, y = 0.f;
        if (live) {
          const float* __restrict__ rv = r_s + d * L + i0_b[d];
          const float* __restrict__ qv = q_s + d * L + i0_f[d];
          const float* __restrict__ mb = band + half + off[d];
          const float* __restrict__ mf = band + off[d];
          constexpr int kUnroll = matvec_unroll(RESIDENT);
#pragma unroll (kUnroll)
          for (int k = 0; k < W; ++k) {
            x = fmaf(rv[k], mb[(size_t)k * L + j], x);
            y = fmaf(qv[k], mf[(size_t)k * L + j], y);
          }
        }
        pull[d] = x;
        pr[d] = y;
      }
    }
  };

  // the filter rows t and t-1 (mixed for the push this step), and row t-2
  // as stored, loaded a whole step before its mix and converted only then
  float f[ND], f_next[ND], pn[ND];
  FT f_ld[ND] = {};
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    f[e] = live ? to_f32(filt[(size_t)(T - 1) * row + e * L + j]) : 0.f;
    f_next[e] = (live && T > 1)
                    ? to_f32(filt[(size_t)(T - 2) * row + e * L + j])
                    : 0.f;
  }
  __syncthreads();  // resident band complete
  mix(f);
  __syncthreads();
  push(pn);         // the prior of the last row
  __syncthreads();  // q reads done before the first step writes q

  for (int t = T - 1; t >= 0; --t) {
    const size_t base = (size_t)t * row;
    float r[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if (live && t > 1) f_ld[e] = filt[(size_t)(t - 2) * row + e * L + j];
      const float p = pn[e];
      r[e] = p >= kPriorFloor ? (p < kRcpDivisorMax
                                     ? div_by_rcp(carry[e], rcp_f64(p))
                                     : carry[e] / p)
                              : 0.f;
      if (live) r_s[e * L + j] = r[e];
      if ((a.mask >> e) & 1) {
        const float s = warp_sum(r[e]);
        if (lane == 0) red_r[warp][e] = s;
      }
    }
    if (t > 0) mix(f_next);  // the push of row t-1 rides this step
    __syncthreads();  // (a)

    if (live) {
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        a.rout[base + e * L + j] = r[e];
        if (t < T - 1) a.smooth[base + (ND + e) * L + j] = carry[e];
      }
    }

    // (at t = 0 the push reads the previous step's q, unused)
    float pull[ND], pn_next[ND];
    pull_push(pull, pn_next);
    float v[ND], vsum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float out = tdyn[d][0] * pull[0];
#pragma unroll
      for (int e = 1; e < ND; ++e) out = fmaf(tdyn[d][e], pull[e], out);
      v[d] = f[d] * out;
      vsum += v[d];
    }
    vsum = warp_sum(vsum);
    if (lane == 0) red_s[warp] = vsum;
    __syncthreads();  // (b)

    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_s[k];
    const float den = fmaxf(s, 1e-38f);
    if (den < kRcpDivisorMax) {  // the same for the whole block
      const double rden = rcp_f64(den);
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = div_by_rcp(v[d], rden);
    } else {
#pragma unroll
      for (int d = 0; d < ND; ++d) carry[d] = v[d] / den;
    }
    if (t > 0) {
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        pn[e] = pn_next[e];
        f[e] = f_next[e];
        f_next[e] = to_f32(f_ld[e]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) a.smooth[d * L + j] = carry[d];  // row 0
}

// shared memory of either kernel: the (ND, L) vector, plus its half of the
// band when that is kept resident
size_t vec_bytes(int n_dyn, int L) {
  return (size_t)n_dyn * L * sizeof(float);
}

size_t band_bytes(int n_mat, int W, int L) {
  return (size_t)n_mat * W * (size_t)L * sizeof(float);
}

bool band_resident(int n_dyn, int n_mat, int W, int L) {
  return vec_bytes(n_dyn, L) + band_bytes(n_mat, W, L) <= kResidentCap;
}

// launch `kernel` over E blocks with its arguments, SeqArgs first (and a
// CfgArgs where the kernel takes one)
template <typename Kernel, typename... More>
cudaError_t run(Kernel kernel, const SeqArgs& a, int E, int n_dyn,
                bool resident, cudaStream_t stream, const More&... more) {
  const size_t smem =
      vec_bytes(n_dyn, a.L) + (resident ? band_bytes(a.n_mat, a.W, a.L) : 0);
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<E, block_threads(a.L), smem, stream>>>(a, more...);
  return cudaGetLastError();
}

// one K1 launch: the kernel compiled as before the configuration index and
// the norm-only mode existed when neither is asked for, else the one with
// them
template <int ND, bool STORE, bool CFG>
cudaError_t launch_filter(const SeqArgs& a, const CfgArgs& c, int E,
                          bool res, cudaStream_t s) {
  if constexpr (STORE && !CFG) {
    return res ? run(filter_kernel<ND, true>, a, E, ND, true, s)
               : run(filter_kernel<ND, false>, a, E, ND, false, s);
  } else {
    return res ? run(filter_cfg_kernel<ND, true, STORE, CFG>, a, E, ND, true,
                     s, c)
               : run(filter_cfg_kernel<ND, false, STORE, CFG>, a, E, ND,
                     false, s, c);
  }
}

// check the shapes, count the non-constant channels and fill what both
// kernels share; false on a shape the kernels do not take
bool prepare(SeqArgs& a, int E, int Tmax, int n_dyn, int L, int W, int mask,
             const void* band, const void* win0) {
  if (bad_shape(n_dyn, L) || E < 1 || Tmax < 1) return false;
  int n_mat = 0;
  for (int d = 0; d < n_dyn; ++d) n_mat += !((mask >> d) & 1);
  if (n_mat == 0) W = 0;
  if (n_mat > 0 && (W < 1 || W > L || band == nullptr || win0 == nullptr))
    return false;
  a.band = static_cast<const float*>(band);
  a.win0 = static_cast<const int*>(win0);
  a.Tmax = Tmax;
  a.L = L;
  a.W = W;
  a.n_mat = n_mat;
  a.mask = mask;
  return true;
}

}  // namespace

extern "C" {

// 1 when K1 or K2 keeps its (n_mat, W, L) half of the band in shared
// memory beside the (n_dyn, L) vector.
int pmg_scan_band_resident(int n_dyn, int n_mat, int L, int W) {
  return band_resident(n_dyn, n_mat, W, L);
}

// K1 over E sequences, one thread block each.  w (E, Tmax, L) with
// w_stride elements between sequences; tlat is read for the constant
// channels' first rows; the other channels' push goes through `band`
// (n_mat, W, L), the push half of the transition band, with window rows
// `win0` (n_mat, L); n_mat counts the channels not flagged constant in
// uniform_mask; lengths (E,) int32 on the device, or null for Tmax each.
// cfg (E,) int32 on the device gives each sequence its configuration of G:
// tlat, band, win0 and tdyn then hold G of each, cfg_tlat, cfg_band,
// cfg_win and cfg_tdyn elements apart (null cfg: configuration 0 for all).
// Null post and prior: the norm-only filter, which writes only norm.
// Returns a cudaError_t (0 on success); the launch is asynchronous.
int pmg_filter_scan(const void* w, const void* tlat, const void* band,
                    const void* win0, const void* tdyn, const void* init,
                    const void* lengths, const void* cfg, void* post,
                    void* prior, void* norm, long long w_stride,
                    long long cfg_tlat, long long cfg_band, long long cfg_win,
                    long long cfg_tdyn, int E, int Tmax, int n_dyn, int L,
                    int W, int uniform_mask, void* stream) {
  SeqArgs a{};
  if (!prepare(a, E, Tmax, n_dyn, L, W, uniform_mask, band, win0) ||
      (post == nullptr) != (prior == nullptr))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(w);
  a.tlat = static_cast<const float*>(tlat);
  a.tdyn = static_cast<const float*>(tdyn);
  a.init = static_cast<const float*>(init);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(post);
  a.out2 = static_cast<float*>(prior);
  a.norm = static_cast<float*>(norm);
  a.x_stride = w_stride;
  const CfgArgs c{static_cast<const int*>(cfg), cfg_tlat, cfg_band, cfg_win,
                  cfg_tdyn};
  auto s = static_cast<cudaStream_t>(stream);
  const bool res = band_resident(n_dyn, a.n_mat, a.W, L);
  const bool store = post != nullptr, ix = cfg != nullptr;
  cudaError_t err;
  if (n_dyn == 1) {
    err = store ? (ix ? launch_filter<1, true, true>(a, c, E, res, s)
                      : launch_filter<1, true, false>(a, c, E, res, s))
                : (ix ? launch_filter<1, false, true>(a, c, E, res, s)
                      : launch_filter<1, false, false>(a, c, E, res, s));
  } else {
    err = store ? (ix ? launch_filter<2, true, true>(a, c, E, res, s)
                      : launch_filter<2, true, false>(a, c, E, res, s))
                : (ix ? launch_filter<2, false, true>(a, c, E, res, s)
                      : launch_filter<2, false, false>(a, c, E, res, s));
  }
  return (int)err;
}

// K2 over E sequences, one thread block each.  filt and prior (E, Tmax,
// n_dyn, L) with their strides between sequences, in elements; tlatT is
// read for the constant channels' first rows; the other channels' pull
// goes through `band` (n_mat, W, L), the pull half of the transition band,
// with window rows `win0` (n_mat, L); lengths as for K1 (a length of 0
// leaves that sequence's outputs untouched); cfg and the configuration
// strides as for K1.
int pmg_smoother_scan(const void* filt, const void* prior, const void* tlatT,
                      const void* band, const void* win0, const void* tdyn,
                      const void* init, const void* lengths, const void* cfg,
                      void* smooth, void* rout, long long filt_stride,
                      long long prior_stride, long long cfg_tlat,
                      long long cfg_band, long long cfg_win,
                      long long cfg_tdyn, int E, int Tmax, int n_dyn, int L,
                      int W, int uniform_mask, void* stream) {
  SeqArgs a{};
  if (!prepare(a, E, Tmax, n_dyn, L, W, uniform_mask, band, win0))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(filt);
  a.x2 = static_cast<const float*>(prior);
  a.tlat = static_cast<const float*>(tlatT);
  a.tdyn = static_cast<const float*>(tdyn);
  a.init = static_cast<const float*>(init);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(smooth);
  a.out2 = static_cast<float*>(rout);
  a.x_stride = filt_stride;
  a.x2_stride = prior_stride;
  const CfgArgs c{static_cast<const int*>(cfg), cfg_tlat, cfg_band, cfg_win,
                  cfg_tdyn};
  auto s = static_cast<cudaStream_t>(stream);
  const bool res = band_resident(n_dyn, a.n_mat, a.W, L);
  cudaError_t err;
  if (n_dyn == 1) {
    err = cfg == nullptr
              ? (res ? run(smoother_kernel<1, true>, a, E, 1, true, s)
                     : run(smoother_kernel<1, false>, a, E, 1, false, s))
              : (res ? run(smoother_cfg_kernel<1, true>, a, E, 1, true, s, c)
                     : run(smoother_cfg_kernel<1, false>, a, E, 1, false, s,
                           c));
  } else {
    err = cfg == nullptr
              ? (res ? run(smoother_kernel<2, true>, a, E, 2, true, s)
                     : run(smoother_kernel<2, false>, a, E, 2, false, s))
              : (res ? run(smoother_cfg_kernel<2, true>, a, E, 2, true, s, c)
                     : run(smoother_cfg_kernel<2, false>, a, E, 2, false, s,
                           c));
  }
  return (int)err;
}

// 1 when K2 with the prior recomputed keeps both halves of the band in
// shared memory beside its two (n_dyn, L) vectors.
int pmg_smoother_push_resident(int n_dyn, int n_mat, int L, int W) {
  return 2 * (vec_bytes(n_dyn, L) + band_bytes(n_mat, W, L)) <= kResidentCap;
}

// K2 with the prior recomputed, over one sequence of T rows: filt (T,
// n_dyn, L), float32 (filt_bf16 = 0) or bfloat16 (1); tlat and tlatT are
// read for the constant channels' first rows; the other channels go through
// `band` (2, n_mat, W, L), both halves of the transition band (push, then
// pull), with window rows `win0` (2, n_mat, L).  Out: smooth and r (T,
// n_dyn, L), as pmg_smoother_scan with prior[t] = push(filt[t]).
int pmg_smoother_push_scan(const void* filt, const void* tlat,
                           const void* tlatT, const void* band,
                           const void* win0, const void* tdyn,
                           const void* init, void* smooth, void* rout, int T,
                           int n_dyn, int L, int W, int uniform_mask,
                           int filt_bf16, void* stream) {
  SeqArgs s{};
  if (!prepare(s, 1, T, n_dyn, L, W, uniform_mask, band, win0))
    return (int)cudaErrorInvalidValue;
  PushArgs a{filt, static_cast<const float*>(tlat),
             static_cast<const float*>(tlatT), s.band, s.win0,
             static_cast<const float*>(tdyn), static_cast<const float*>(init),
             static_cast<float*>(smooth), static_cast<float*>(rout), T, L,
             s.W, s.n_mat, uniform_mask};
  const bool res = pmg_smoother_push_resident(n_dyn, s.n_mat, L, s.W);
  const size_t smem = 2 * vec_bytes(n_dyn, L) +
                      (res ? 2 * band_bytes(s.n_mat, s.W, L) : 0);
  auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    cudaError_t err = launch_prep(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, block_threads(L), smem, st>>>(a);
    return cudaGetLastError();
  };
  cudaError_t err;
  if (n_dyn == 1) {
    err = filt_bf16 ? (res ? go(smoother_push_kernel<1, true, bf16>)
                           : go(smoother_push_kernel<1, false, bf16>))
                    : (res ? go(smoother_push_kernel<1, true, float>)
                           : go(smoother_push_kernel<1, false, float>));
  } else {
    err = filt_bf16 ? (res ? go(smoother_push_kernel<2, true, bf16>)
                           : go(smoother_push_kernel<2, false, bf16>))
                    : (res ? go(smoother_push_kernel<2, true, float>)
                           : go(smoother_push_kernel<2, false, float>));
  }
  return (int)err;
}

}  // extern "C"

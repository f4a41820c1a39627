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

#include "hopper_common.cuh"
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
// priors, bit for bit.  FT = bf16 reads the 'filter_bf16' store and forms
// the push and the smoother step from its f32 values.
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

// The specialised design of K2 with the prior recomputed: the push taken
// off the chain and off the chain's SM.  prior_{t+1} = push(filt_t) does
// not depend on the recursion, so a cluster of two thread blocks, on two
// SMs, runs one sequence:
//   * block 0, the consumer: thread j owns latent column j (one thread per
//     column at every L up to 1,024) and runs K2's step exactly (the
//     ratio, r to shared memory, the pull's window sum, the dynamics mix,
//     the normaliser, the division through div_by_rcp), the filter row of
//     the step loaded from device memory a step ahead as K2 loads it; the
//     prior comes as its reciprocal code from a ring in its own shared
//     memory, read a step ahead too (while the other warps reach barrier
//     (b)), so the ring is off the chain;
//   * block 1, the producer: S rows ahead of the consumer, it brings the
//     stored filter rows t = T-1, T-2, ... into its shared memory by bulk
//     copies (cp.async.bulk, one 16-byte-aligned span a row, S rows in
//     flight, each completing on its stage's mbarrier), and thread j forms
//     column j's prior with K1's operations in K1's order and K1's layout
//     (the dynamics mix of its column, warp_sum's tree and the warps in
//     ascending order for a constant channel, the window sum over the push
//     band ascending with fmaf), so the prior's bits are K1's; it stores
//     the prior's reciprocal code into the consumer's ring by asynchronous
//     stores to the cluster's distributed shared memory (st.async), whose
//     bytes complete on the consumer's barrier: rcp_f64(p) for FLT_MIN <=
//     p < 2, -p for p >= 2 (the consumer then divides in f32, as K2 does),
//     0 below FLT_MIN or NaN (r = 0).
// What the H100 taught (scripts/scan_push_probe.py, PERF.md): a producer
// warpgroup inside the consumer's block (warp specialisation in one block)
// made a step slower, 2.61 us against 2.18 for the push on the consumer
// threads: its instructions take the issue slots of the chain it was meant
// to spare.  On its own SM the producer costs the chain nothing.  The
// consumer's side of the ring stays at block scope: a cluster-scope
// release and acquire there compiled to a GPU-wide memory barrier and an
// L1 invalidation each step (2.09-2.15 us a step; 1.84 with st.async and
// block-scope waits).
//
// Synchronisation, per ring stage (ring[s][j][d]: a column's codes
// together): `full` in the consumer (its thread 0 arms it with the row's
// bytes, the producer's stores complete them), `empty` in the producer
// (the consumer's thread 0 arrives after its barrier (a), by which every
// consumer thread has read the stage's codes), `loaded` in the producer
// (the bulk copy's bytes).  Row i (i = T-1-t) uses stage i % S; waits on
// stage s for the phase (i / S) & 1, the producer's wait for `empty` the
// phase of the row S before.  A cluster barrier after the barriers'
// initialisation and another before either block leaves (the consumer's
// last release reaches the producer's shared memory).
//
// Shared memory (push_layout, the same for both blocks): the barriers, the
// ring (S x ND x L f64), then the role's part: the producer's S filter
// stages, two mixed rows and the push half of the band; the consumer's r
// and the pull half (each thread keeps its window rows and the constant
// channels' first rows in registers).  A half of the band is kept resident
// when both roles' layouts fit kResidentCap at 2 stages, else read from L2
// with 16 loads in flight (a dense channel); the host code takes S, the
// most stages, up to 4, that fit (push_plan_of).
// ops/scan_kernels.py::push_plan mirrors that choice for the tests.
constexpr int kPushMaxStages = 4;
constexpr int kPushMinStages = 2;

struct PushLayout {
  size_t bars, ring, filt, fstage, q, pband, r, cband, total;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

__host__ __device__ inline PushLayout push_layout(int nd, int n_mat, int L,
                                                  int W, int fbytes, int S,
                                                  bool resident) {
  PushLayout p{};
  const size_t vec = (size_t)nd * L * 4;
  const size_t half = resident ? (size_t)n_mat * W * L * 4 : 0;
  size_t o = 0;
  p.bars = o;  // full[S], empty[S], loaded[S]
  o = align16(o + (size_t)3 * S * 8);
  p.ring = o;
  o = align16(o + (size_t)S * nd * L * 8);
  const size_t role = o;
  // the producer's part: a row's bytes rounded up, and 16 more for the
  // span's offset, per filter stage
  p.fstage = align16((size_t)nd * L * fbytes) + 16;
  p.filt = role;
  p.q = p.filt + S * p.fstage;  // two mixed rows
  p.pband = align16(p.q + 2 * vec);
  const size_t prod = align16(p.pband + half);
  // the consumer's part
  p.r = role;
  p.cband = align16(p.r + vec);
  const size_t cons = align16(p.cband + half);
  p.total = prod > cons ? prod : cons;
  return p;
}

// the ring depth (0 where 2 stages do not fit) of one residency
inline int push_stages(int n_dyn, int n_mat, int L, int W, int fbytes,
                       bool resident) {
  for (int S = kPushMaxStages; S >= kPushMinStages; --S)
    if (push_layout(n_dyn, n_mat, L, W, fbytes, S, resident).total <=
        kResidentCap)
      return S;
  return 0;
}

// the launch's plan: the band's residency, the ring depth and the bytes
struct PushPlan {
  bool resident;
  int stages;
  size_t smem;
};

inline PushPlan push_plan_of(int n_dyn, int n_mat, int L, int W,
                             int filt_bf16) {
  if (n_mat == 0) W = 0;
  const int fbytes = filt_bf16 ? 2 : 4;
  PushPlan p{};
  p.resident = push_stages(n_dyn, n_mat, L, W, fbytes, true) > 0;
  p.stages = push_stages(n_dyn, n_mat, L, W, fbytes, p.resident);
  p.smem =
      push_layout(n_dyn, n_mat, L, W, fbytes, p.stages, p.resident).total;
  return p;
}

// the reciprocal code of a prior p (see above)
__device__ __forceinline__ double prior_code(float p) {
  return p >= kPriorFloor ? (p < kRcpDivisorMax ? rcp_f64(p) : -(double)p)
                          : 0.0;
}

template <int ND, typename FT, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    smoother_push_cluster_kernel(PushArgs a, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][32][ND];  // warp partials: the producer's q
                                    // sums (two rows), the consumer's r
  __shared__ float red_s[32];

  const int L = a.L, W = a.W, T = a.T, n_mat = a.n_mat;
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const PushLayout lay =
      push_layout(ND, n_mat, L, W, sizeof(FT), S, RESIDENT);
  const uint32_t bars = smem_u32(smem_raw + lay.bars);
  const uint32_t ring = smem_u32(smem_raw + lay.ring);
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;
  const size_t row = (size_t)ND * L, half = (size_t)n_mat * WL;
  const bool producer = cluster_rank() == 1;
  const uint32_t full = bars, empty = bars + 8 * S, loaded = bars + 16 * S;

  // each block's half of the band
  float* __restrict__ band_s = reinterpret_cast<float*>(
      smem_raw + (producer ? lay.pband : lay.cband));
  if (RESIDENT) {
    const float* src = a.band + (producer ? 0 : half);
    for (size_t k = j; k < half; k += blockDim.x) band_s[k] = src[k];
  }
  const float* __restrict__ band =
      RESIDENT ? band_s : a.band + (producer ? 0 : half);
  constexpr int kUnroll = matvec_unroll(RESIDENT);
  if (j == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
      mbar_init(loaded + 8 * s, 1);
    }
    mbar_init_fence();
  }
  float tdyn[ND][ND], row0[ND];
  size_t off[ND];  // each channel's window in the block's half of the band
  int i0[ND];
  int slot = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < ND; ++e) tdyn[d][e] = a.tdyn[d * ND + e];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    // the first row of a constant channel: the push's (tlat) or the
    // pull's (tlatT)
    row0[d] = live ? (producer ? a.tlat : a.tlatT)[d * LL + j] : 0.f;
    off[d] = 0;
    i0[d] = 0;
    if (!((a.mask >> d) & 1)) {
      off[d] = slot * WL;
      if (live) i0[d] = a.win0[((producer ? 0 : n_mat) + slot) * L + j];
      ++slot;
    }
  }
  cluster_sync();  // both blocks' barriers and bands ready
  const FT* __restrict__ filt = static_cast<const FT*>(a.filt);

  if (producer) {
    // ---- block 1: the priors of rows T-1, T-2, ..., K1's push ----
    const size_t rbytes = row * sizeof(FT);
    if (j == 0) {
      // the 16-byte-aligned span of row T-1-i into filter stage i % S
      for (int i = 0; i < S && i < T; ++i) {
        const uintptr_t src =
            reinterpret_cast<uintptr_t>(filt) + (size_t)(T - 1 - i) * rbytes;
        const uintptr_t a0 = src & ~(uintptr_t)15;
        const uint32_t bytes =
            (uint32_t)(((src + rbytes + 15) & ~(uintptr_t)15) - a0);
        mbar_expect_tx(loaded + 8 * i, bytes);
        bulk_load(smem_u32(smem_raw + lay.filt + i * lay.fstage),
                  reinterpret_cast<const void*>(a0), bytes, loaded + 8 * i);
      }
    }
    for (int i = 0; i < T; ++i) {
      const int s = i % S, k = i / S, qb = i & 1;
      const uintptr_t src =
          reinterpret_cast<uintptr_t>(filt) + (size_t)(T - 1 - i) * rbytes;
      const FT* __restrict__ fr = reinterpret_cast<const FT*>(
          smem_raw + lay.filt + s * lay.fstage + (src & 15));
      // two mixed rows and partials, so one barrier a row orders them
      float* __restrict__ q =
          reinterpret_cast<float*>(smem_raw + lay.q) + qb * row;
      mbar_wait(loaded + 8 * s, k & 1);
      // q_d = sum_p Tdyn[p,d] * f_p of the own column (K1's mix)
      float f[ND];
#pragma unroll
      for (int e = 0; e < ND; ++e) f[e] = live ? to_f32(fr[e * L + j]) : 0.f;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float v = tdyn[0][d] * f[0];
#pragma unroll
        for (int p = 1; p < ND; ++p) v = fmaf(tdyn[p][d], f[p], v);
        if (live) q[d * L + j] = v;
        if ((a.mask >> d) & 1) {
          const float sum = warp_sum(v);
          if (lane == 0) red[qb][warp][d] = sum;
        }
      }
      __syncthreads();  // q complete; filter stage s read
      if (j == 0 && i + S < T) {
        const uintptr_t nsrc = reinterpret_cast<uintptr_t>(filt) +
                               (size_t)(T - 1 - i - S) * rbytes;
        const uintptr_t a0 = nsrc & ~(uintptr_t)15;
        const uint32_t bytes =
            (uint32_t)(((nsrc + rbytes + 15) & ~(uintptr_t)15) - a0);
        mbar_expect_tx(loaded + 8 * s, bytes);
        bulk_load(smem_u32(smem_raw + lay.filt + s * lay.fstage),
                  reinterpret_cast<const void*>(a0), bytes, loaded + 8 * s);
      }
      double code[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float pr;
        if ((a.mask >> d) & 1) {
          float sum = 0.f;
          for (int w = 0; w < nwarp; ++w) sum += red[qb][w][d];
          pr = sum * row0[d];
        } else {
          pr = live ? window_matvec<kUnroll>(q + d * L, band + off[d], i0[d],
                                             W, L, j)
                    : 0.f;
        }
        code[d] = prior_code(pr);
      }
      if (k > 0) mbar_wait(empty + 8 * s, (k - 1) & 1);
      // column j's codes into the consumer's ring, counted on its `full`
      if (live)
        st_async<ND>(map_shared(ring + 8 * (s * row + j * ND), 0), code,
                     map_shared(full + 8 * s, 0));
    }
    cluster_sync();  // the consumer's last release has arrived
    return;
  }

  // ---- block 0: K2's step, thread j owns column j ----
  float* __restrict__ r_s = reinterpret_cast<float*>(smem_raw + lay.r);
  const double* __restrict__ codes =
      reinterpret_cast<const double*>(smem_raw + lay.ring);
  const uint32_t row_bytes = (uint32_t)(row * 8);
  if (j == 0)  // each stage expects its row's codes
    for (int s = 0; s < S && s < T; ++s)
      mbar_expect_tx(full + 8 * s, row_bytes);
  float carry[ND];
  FT f_next[ND] = {};
  double c_next[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    carry[e] = live ? a.init[e * L + j] : 0.f;
    if (live) f_next[e] = filt[(size_t)(T - 1) * row + e * L + j];
  }
  mbar_wait(full, 0);
#pragma unroll
  for (int e = 0; e < ND; ++e) c_next[e] = live ? codes[j * ND + e] : 0.0;

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i, s = i % S;
    const size_t base = (size_t)t * row;
    float f[ND], r[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      f[e] = to_f32(f_next[e]);
      // K2's carry / prior: through the reciprocal for FLT_MIN <= p < 2
      const double rc = c_next[e];
      r[e] = rc > 0.0 ? div_by_rcp(carry[e], rc)
                      : (rc < 0.0 ? carry[e] / (float)(-rc) : 0.f);
      if (live) r_s[e * L + j] = r[e];
      if ((a.mask >> e) & 1) {
        const float sum = warp_sum(r[e]);
        if (lane == 0) red[0][warp][e] = sum;
      }
    }
    __syncthreads();  // (a)
#pragma unroll
    for (int e = 0; e < ND; ++e)
      if (live && t > 0) f_next[e] = filt[base - row + e * L + j];
    // this step's r and the smoothed row of step t+1 (still in carry) go
    // out here, where the window dot that follows hides them
    if (live) {
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        a.rout[base + e * L + j] = r[e];
        if (t < T - 1) a.smooth[base + (ND + e) * L + j] = carry[e];
      }
    }

    // pull_e = Tlat[e] @ r_e; out_d = sum_e Tdyn[d,e] * pull_e
    float pull[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if ((a.mask >> e) & 1) {
        float sum = 0.f;
        for (int k = 0; k < nwarp; ++k) sum += red[0][k][e];
        pull[e] = sum * row0[e];
      } else {
        pull[e] = live ? window_matvec<kUnroll>(r_s + e * L, band + off[e],
                                                i0[e], W, L, j)
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
    // Every code of row i was read before (b) of the step before: thread 0
    // arms the stage for row i + S and releases it to the producer.  Then
    // the next row's codes, a step ahead, while the other warps reach (b).
    if (j == 0) {
      if (i + S < T) mbar_expect_tx(full + 8 * s, row_bytes);
      mbar_arrive_cluster(empty + 8 * s, 1);
    }
    if (i + 1 < T) {
      const int s1 = (i + 1) % S;
      mbar_wait(full + 8 * s1, ((i + 1) / S) & 1);
#pragma unroll
      for (int e = 0; e < ND; ++e)
        c_next[e] = live ? codes[s1 * row + j * ND + e] : 0.0;
    }
    __syncthreads();  // (b)

    float sum = 0.f;
    for (int k = 0; k < nwarp; ++k) sum += red_s[k];
    const float den = fmaxf(sum, 1e-38f);
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
    if (live) a.smooth[d * L + j] = carry[d];  // row 0
  cluster_sync();
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

// The dynamic shared memory of each block of K2 with the prior recomputed,
// or -1 where `stages` is not the ring depth the launch takes
// (push_plan_of; ops/scan_kernels.py::push_plan is the tests' mirror).
int pmg_smoother_push_smem(int n_dyn, int n_mat, int L, int W,
                           int filt_bf16, int stages) {
  if (bad_shape(n_dyn, L) || n_mat < 0 || n_mat > n_dyn) return -1;
  const PushPlan p = push_plan_of(n_dyn, n_mat, L, W, filt_bf16);
  return stages == p.stages ? (int)p.smem : -1;
}

// K2 with the prior recomputed, over one sequence of T rows: filt (T,
// n_dyn, L), float32 (filt_bf16 = 0) or bfloat16 (1); tlat and tlatT are
// read for the constant channels' first rows; the other channels go through
// `band` (2, n_mat, W, L), both halves of the transition band (push, then
// pull), with window rows `win0` (2, n_mat, L).  Out: smooth and r (T,
// n_dyn, L), as pmg_smoother_scan with prior[t] = push(filt[t]).  A
// cluster of two blocks, with the ring depth and residency of
// push_plan_of.
int pmg_smoother_push_scan(const void* filt, const void* tlat,
                           const void* tlatT, const void* band,
                           const void* win0, const void* tdyn,
                           const void* init, void* smooth, void* rout, int T,
                           int n_dyn, int L, int W, int uniform_mask,
                           int filt_bf16, void* stream) {
  SeqArgs s{};
  if (!prepare(s, 1, T, n_dyn, L, W, uniform_mask, band, win0))
    return (int)cudaErrorInvalidValue;
  const PushPlan plan = push_plan_of(n_dyn, s.n_mat, L, s.W, filt_bf16);
  const size_t smem = plan.smem;
  PushArgs a{filt, static_cast<const float*>(tlat),
             static_cast<const float*>(tlatT), s.band, s.win0,
             static_cast<const float*>(tdyn), static_cast<const float*>(init),
             static_cast<float*>(smooth), static_cast<float*>(rout), T, L,
             s.W, s.n_mat, uniform_mask};
  auto st = static_cast<cudaStream_t>(stream);
  // a cluster of two blocks: the consumer (rank 0) and the producer
  auto go = [&](auto kernel) {
    cudaError_t err = launch_prep(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(block_threads(L));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a, plan.stages);
    return err != cudaSuccess ? err : cudaGetLastError();
  };
  const bool res = plan.resident;
  cudaError_t err;
  if (n_dyn == 1)
    err = filt_bf16 ? (res ? go(smoother_push_cluster_kernel<1, bf16, true>)
                           : go(smoother_push_cluster_kernel<1, bf16, false>))
                    : (res ? go(smoother_push_cluster_kernel<1, float, true>)
                           : go(smoother_push_cluster_kernel<1, float, false>));
  else
    err = filt_bf16 ? (res ? go(smoother_push_cluster_kernel<2, bf16, true>)
                           : go(smoother_push_cluster_kernel<2, bf16, false>))
                    : (res ? go(smoother_push_cluster_kernel<2, float, true>)
                           : go(smoother_push_cluster_kernel<2, float, false>));
  return (int)err;
}

}  // extern "C"

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
// Layout: thread j owns latent column j (blockDim = L rounded up to 32,
// at most 1024).  Its carry (n_dyn values) lives in its registers, since
// step t+1 needs only column j of step t's posterior.  The vector that
// every thread reads in the matvec (the dynamics-mixed carry q in K1, the
// ratio r in K2) goes to shared memory.  Each step has two barriers:
//   (a) after q (or r) and the warp partials of the constant-channel sums
//       are written, so that the matvec sees the whole vector;
//   (b) after the warp partials of the normaliser are written.
// Barrier (b) of step t also orders step t's matvec reads of q before step
// t+1's writes of q, so one buffer suffices: no thread can overwrite the
// shared vector (or a partials array) while another still reads step t's.
//
// What bounds it on this card: the scan is one dependent chain of T steps,
// each a (1,L)@(L,L) matvec per dynamics channel plus a block-wide sum, so
// it is latency-bound and uses 1 of the H100's 132 SMs.
//   * K1 (dense), L=100: both (L,L) f32 channels are 80 KB, so Tlat is
//     copied once into shared memory (dynamic shared memory, opted in above
//     48 KB) and every step reads it from there; neighbouring threads read
//     neighbouring addresses (no bank conflicts) and q[i] is a broadcast.
//   * K1 (dense), L=500: one channel is 1 MB and does not fit in 227 KB of
//     shared memory.  Tlat is then read from global memory with coalesced
//     loads; it stays resident in the 50 MB L2, and each step streams the
//     full matrix from L2 into the one SM, which bounds the step time.
//   * K2 (banded): reads only each column's window of nonzero rows, W of
//     L, from the pull half of a band made once per decode
//     (ops/band.py::transition_band) and kept in shared memory when it
//     fits (smoother_kernel's note).
//   * The constant (jump) channel has every entry equal, so its matvec is
//     sum(q) * row: no matrix traffic at all (detected on the host exactly
//     as _detect_uniform_rows does; identical but non-constant rows take
//     the general matvec).
// Long sequences fill the card through the parallel-in-time kernels K3/K4
// (parallel_scan.cu), which run this step on one block per chunk.
//
// Numerics: f32 with FMA; the normaliser is clamped at 1e-38 as in K1/K2;
// r = 0 where the prior is 0 (never 0/0), so latent bins masked to zero
// weight give exact zeros, not NaNs.  K1 writes each step's normaliser s_t
// itself (Mosaic could not store a dynamic 1-D slice, so JAX recomputed it
// outside the kernel); the caller forms log(s_t) + scale * m_t.  K1 divides
// in f32, K2 through an f64 reciprocal: the same bits
// (scan_common.cuh::div_by_rcp).

#include "scan_common.cuh"

namespace {

using namespace pmg;

// K1: causal filter over pre-computed weights w = exp(scale*(ll - rowmax)).
// w (T, L); tlat (ND, L, L) with tlat[d][i][j] = p(j | i, dyn=d);
// tdyn (ND, ND) with tdyn[p][d] = p(d | p); init (ND, L).
// Out: post and prior (T, ND, L), norm (T,) = sum of unnormalised u_t.
template <int ND, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
filter_kernel(const float* __restrict__ w, const float* __restrict__ tlat_g,
              const float* __restrict__ tdyn_g,
              const float* __restrict__ init, float* __restrict__ post,
              float* __restrict__ prior_out, float* __restrict__ norm, int T,
              int L, int uniform_mask) {
  extern __shared__ float smem[];
  float* q = smem;            // (ND, L) dynamics-mixed carry
  float* tl_s = smem + ND * L;  // (ND, L, L) when RESIDENT
  __shared__ float red_q[32][ND];
  __shared__ float red_u[32];

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L;

  if (RESIDENT) {
    for (size_t k = j; k < ND * LL; k += blockDim.x) tl_s[k] = tlat_g[k];
  }
  const float* tlat = RESIDENT ? tl_s : tlat_g;

  float tdyn[ND][ND], carry[ND], row0[ND];
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = tdyn_g[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? init[d * L + j] : 0.f;
    row0[d] = live ? tlat_g[d * LL + j] : 0.f;
  }
  __syncthreads();  // resident Tlat complete

  for (int t = 0; t < T; ++t) {
    const float wt = live ? w[(size_t)t * L + j] : 0.f;
    // dynamics mix of the own column: q_d = sum_p Tdyn[p,d] * carry_p
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float a = tdyn[0][d] * carry[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) a = fmaf(tdyn[p][d], carry[p], a);
      if (live) q[d * L + j] = a;
      if ((uniform_mask >> d) & 1) {
        const float s = warp_sum(a);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
    __syncthreads();  // (a)

    float pr[ND], usum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((uniform_mask >> d) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][d];
        pr[d] = s * row0[d];
      } else {
        pr[d] = live ? col_matvec(q + d * L, tlat + d * LL, L, j) : 0.f;
      }
      usum = fmaf(pr[d], wt, usum);
    }
    usum = warp_sum(usum);
    if (lane == 0) red_u[warp] = usum;
    __syncthreads();  // (b)

    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_u[k];
    const float den = fmaxf(s, 1e-38f);
    const size_t base = (size_t)t * ND * L;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      carry[d] = (pr[d] * wt) / den;
      if (live) {
        post[base + d * L + j] = carry[d];
        prior_out[base + d * L + j] = pr[d];
      }
    }
    if (j == 0) norm[t] = s;
  }
}

// K2: backward smoother over filter posteriors and +1-shifted priors.
// filt, prior (T, ND, L); tlatT (ND, L, L) = Tlat transposed per channel,
// tlatT[e][i][j] = Tlat[e][j][i] (read for the constant channels' first
// rows); band (n_mat, W, L) the pull windows of the n_mat non-constant
// channels, band[m][k][j] = row win0[m][j] + k of column j of that
// channel's tlatT, win0 (n_mat, L); tdyn (ND, ND); init (ND, L) = smoothed
// posterior of the step after the last row.  Out: smooth and r (T, ND, L).
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
// sums in warp order and the normaliser's reciprocal.
template <int ND, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
smoother_kernel(const float* __restrict__ filt,
                const float* __restrict__ prior,
                const float* __restrict__ tlatT_g,
                const float* __restrict__ band_g,
                const int* __restrict__ win0, const float* __restrict__ tdyn_g,
                const float* __restrict__ init, float* __restrict__ smooth,
                float* __restrict__ rout, int T, int L, int W, int n_mat,
                int uniform_mask) {
  extern __shared__ float smem[];
  float* r_s = smem;             // (ND, L) ratios
  float* band_s = smem + ND * L;  // (n_mat, W, L) when RESIDENT
  __shared__ float red_r[32][ND];
  __shared__ float red_s[32];

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L, WL = (size_t)W * L;

  if (RESIDENT) {
    for (size_t k = j; k < n_mat * WL; k += blockDim.x) band_s[k] = band_g[k];
  }
  const float* band = RESIDENT ? band_s : band_g;

  float tdyn[ND][ND], carry[ND], row0[ND];
  size_t off_b[ND];  // each channel's pull band
  int i0_b[ND];      // first row of column j's window
  int slot = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < ND; ++e) tdyn[d][e] = tdyn_g[d * ND + e];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? init[d * L + j] : 0.f;
    row0[d] = live ? tlatT_g[d * LL + j] : 0.f;
    off_b[d] = 0;
    i0_b[d] = 0;
    if (!((uniform_mask >> d) & 1)) {
      off_b[d] = slot * WL;
      if (live) i0_b[d] = win0[slot * L + j];
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
    const size_t base = (size_t)t * ND * L;
    float f[ND], r[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      f[e] = f_next[e];
      const float pn = p_next[e];
      if (live && t > 0) {
        f_next[e] = filt[base - ND * L + e * L + j];
        p_next[e] = prior[base - ND * L + e * L + j];
      }
      // carry / pn: the reciprocal does not wait for the carry
      r[e] = pn > 0.f ? (pn < kRcpDivisorMax
                             ? div_by_rcp(carry[e], rcp_f64(pn))
                             : carry[e] / pn)
                      : 0.f;
      if (live) r_s[e * L + j] = r[e];
      if ((uniform_mask >> e) & 1) {
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
      if ((uniform_mask >> e) & 1) {
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

size_t resident_bytes(int n_dyn, int L) {
  return (size_t)n_dyn * L * (size_t)(L + 1) * sizeof(float);
}

bool is_resident(int n_dyn, int L) {
  return resident_bytes(n_dyn, L) <= kResidentCap;
}

template <int ND, bool RESIDENT>
cudaError_t run_filter(const float* w, const float* tlat, const float* tdyn,
                       const float* init, float* post, float* prior,
                       float* norm, int T, int L, int mask,
                       cudaStream_t stream) {
  const size_t smem =
      RESIDENT ? resident_bytes(ND, L) : (size_t)ND * L * sizeof(float);
  auto kernel = filter_kernel<ND, RESIDENT>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, block_threads(L), smem, stream>>>(w, tlat, tdyn, init, post,
                                                prior, norm, T, L, mask);
  return cudaGetLastError();
}

// K2's shared memory: r, plus the pull band when it is kept resident
size_t smoother_vec_bytes(int n_dyn, int L) {
  return (size_t)n_dyn * L * sizeof(float);
}

size_t pull_band_bytes(int n_mat, int W, int L) {
  return (size_t)n_mat * W * (size_t)L * sizeof(float);
}

bool smoother_resident(int n_dyn, int n_mat, int W, int L) {
  return smoother_vec_bytes(n_dyn, L) + pull_band_bytes(n_mat, W, L) <=
         kResidentCap;
}

template <int ND, bool RESIDENT>
cudaError_t run_smoother(const float* filt, const float* prior,
                         const float* tlatT, const float* band,
                         const int* win0, const float* tdyn,
                         const float* init, float* smooth, float* rout, int T,
                         int L, int W, int n_mat, int mask,
                         cudaStream_t stream) {
  const size_t smem = smoother_vec_bytes(ND, L) +
                      (RESIDENT ? pull_band_bytes(n_mat, W, L) : 0);
  auto kernel = smoother_kernel<ND, RESIDENT>;
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, block_threads(L), smem, stream>>>(filt, prior, tlatT, band,
                                                win0, tdyn, init, smooth,
                                                rout, T, L, W, n_mat, mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when K1 keeps the (n_dyn, L, L) transition stack in shared memory.
int pmg_scan_tlat_resident(int n_dyn, int L) { return is_resident(n_dyn, L); }

// Returns a cudaError_t (0 on success); the launch is asynchronous.
int pmg_filter_scan(const void* w, const void* tlat, const void* tdyn,
                    const void* init, void* post, void* prior, void* norm,
                    int T, int n_dyn, int L, int uniform_mask, void* stream) {
  if (bad_shape(n_dyn, L) || T < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(w);
  auto b = static_cast<const float*>(tlat);
  auto c = static_cast<const float*>(tdyn);
  auto d = static_cast<const float*>(init);
  auto o1 = static_cast<float*>(post);
  auto o2 = static_cast<float*>(prior);
  auto o3 = static_cast<float*>(norm);
  const bool res = is_resident(n_dyn, L);
  cudaError_t err;
  if (n_dyn == 1) {
    err = res ? run_filter<1, true>(a, b, c, d, o1, o2, o3, T, L, uniform_mask, s)
              : run_filter<1, false>(a, b, c, d, o1, o2, o3, T, L, uniform_mask, s);
  } else {
    err = res ? run_filter<2, true>(a, b, c, d, o1, o2, o3, T, L, uniform_mask, s)
              : run_filter<2, false>(a, b, c, d, o1, o2, o3, T, L, uniform_mask, s);
  }
  return (int)err;
}

// 1 when K2 keeps the (n_mat, W, L) pull band in shared memory.
int pmg_smoother_resident(int n_dyn, int n_mat, int L, int W) {
  return smoother_resident(n_dyn, n_mat, W, L);
}

// K2.  tlatT is read for the constant channels' first rows; the other
// channels' pull goes through `band` (n_mat, W, L), the pull half of the
// transition band, with window rows `win0` (n_mat, L); n_mat counts the
// channels not flagged constant in uniform_mask.
int pmg_smoother_scan(const void* filt, const void* prior, const void* tlatT,
                      const void* band, const void* win0, const void* tdyn,
                      const void* init, void* smooth, void* rout, int T,
                      int n_dyn, int L, int W, int uniform_mask,
                      void* stream) {
  if (bad_shape(n_dyn, L) || T < 1) return (int)cudaErrorInvalidValue;
  int n_mat = 0;
  for (int d = 0; d < n_dyn; ++d) n_mat += !((uniform_mask >> d) & 1);
  if (n_mat == 0) W = 0;
  if (n_mat > 0 && (W < 1 || W > L || band == nullptr || win0 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(filt);
  auto b = static_cast<const float*>(prior);
  auto c = static_cast<const float*>(tlatT);
  auto m = static_cast<const float*>(band);
  auto w0 = static_cast<const int*>(win0);
  auto d = static_cast<const float*>(tdyn);
  auto e = static_cast<const float*>(init);
  auto o1 = static_cast<float*>(smooth);
  auto o2 = static_cast<float*>(rout);
  const bool res = smoother_resident(n_dyn, n_mat, W, L);
  cudaError_t err;
  if (n_dyn == 1) {
    err = res ? run_smoother<1, true>(a, b, c, m, w0, d, e, o1, o2, T, L, W, n_mat, uniform_mask, s)
              : run_smoother<1, false>(a, b, c, m, w0, d, e, o1, o2, T, L, W, n_mat, uniform_mask, s);
  } else {
    err = res ? run_smoother<2, true>(a, b, c, m, w0, d, e, o1, o2, T, L, W, n_mat, uniform_mask, s)
              : run_smoother<2, false>(a, b, c, m, w0, d, e, o1, o2, T, L, W, n_mat, uniform_mask, s);
  }
  return (int)err;
}

}  // extern "C"

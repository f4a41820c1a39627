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
//       "bf16"; scan_common.cuh::col_matvec_p)
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
//   * L=100: the latent transitions fit in shared memory (K3: 80 KB for
//     two channels; K4 keeps Tlat and its transpose, 160 KB) and are copied
//     in once per block.  In BF16X3/BF16 the resident copy is the bf16
//     hi/lo split, the same bytes as the f32 matrix.
//   * L=500: one channel is 1 MB; every block streams it from the 50 MB L2
//     each step.  With C blocks doing so at once, L2 bandwidth rather than
//     one SM's load latency sets the pace (PERF.md); BF16 streams half the
//     bytes (the hi part only).
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
// Numerics: f32 with FMA, no tensor cores, in HIGHEST (the JAX package's
// default scan precision); normalisers clamped at 1e-38; r = 0 where the
// prior is 0, so latent bins masked to zero weight stay exact zeros.

#include "scan_common.cuh"

namespace {

using namespace pmg;

enum SmoothMode { kFinals = 0, kFull = 1, kMarginal = 2, kMarginalAcc = 3 };

struct PassArgs {
  const float* x;       // K3: w (T, L); K4: post (T, ND, L)
  const float* tlat;    // (ND, L, L)
  const float* tlatT;   // (ND, L, L) transposed per channel (K4 only)
  const bf16* tl_hi;    // (ND, L, L) bf16 split of tlat (BF16X3/BF16)
  const bf16* tl_lo;
  const bf16* tlT_hi;   // (ND, L, L) bf16 split of tlatT (K4, BF16X3/BF16)
  const bf16* tlT_lo;
  const float* tdyn;    // (ND, ND)
  const float* ins;     // (C, ND, L) boundary carries in
  float* finals;        // (C, ND, L) carries after each chunk's last row
  float* out;           // K3 EMIT: post; K4 full: smooth (T, ND, L);
                        // K4 marginal: lat (T, L)
  float* out2;          // K3 EMIT: norm (T,); K4 full, marginal+acc: r
                        // (T, ND, L)
  float* out3;          // K4 marginal: dyn (T, ND)
  int T, L, tc, mask;
};

// vector operands per (ND, L) slot: the value, plus its bf16 residual
__host__ __device__ constexpr int vec_slots(int prec) {
  return prec == kHighest ? 1 : 2;
}

// copy one (ND, L, L) matrix operand into shared memory at `smem` when the
// pass keeps it resident (n elements, 4 bytes each in every precision: f32,
// or the bf16 hi and lo halves)
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

// K3: filter pass.  EMIT stores post (T, ND, L) and norm[t] = max(s_t,
// 1e-38), the normaliser the step divided by.
template <int ND, bool RESIDENT, bool EMIT, int PREC>
__global__ void __launch_bounds__(kMaxThreads) pfilter_kernel(PassArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NV = vec_slots(PREC);
  float* qx = smem;                 // (ND, L) dynamics-mixed carry
  float* ql = smem + ND * a.L;      // (ND, L) its bf16 residual (BF16X3)
  __shared__ float red_q[32][ND];
  __shared__ float red_u[32];

  const int L = a.L, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int n = max(0, min(a.tc, a.T - t0));

  const MatOperand tl = stage<PREC, RESIDENT>(
      a.tlat, a.tl_hi, a.tl_lo, ND * LL, smem + NV * ND * L);

  float tdyn[ND][ND], carry[ND], row0[ND];
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = a.tdyn[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.ins[((size_t)c * ND + d) * L + j] : 0.f;
    row0[d] = live ? a.tlat[d * LL + j] : 0.f;
  }
  __syncthreads();  // resident Tlat complete

  for (int tau = 0; tau < n; ++tau) {
    const size_t t = (size_t)t0 + tau;
    const float wt = live ? a.x[t * L + j] : 0.f;
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

    float pr[ND], usum = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if ((a.mask >> d) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][d];
        pr[d] = s * row0[d];
      } else {
        pr[d] = live ? col_matvec_p<PREC>(qx + d * L, ql + d * L, tl,
                                          d * LL, L, j)
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
    for (int d = 0; d < ND; ++d) {
      carry[d] = (pr[d] * wt) / den;
      if (EMIT && live) a.out[(t * ND + d) * L + j] = carry[d];
    }
    if (EMIT && j == 0) a.out2[t] = den;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) a.finals[((size_t)c * ND + d) * L + j] = carry[d];
}

// K4 marginal modes: lat[t, j] = sum_d carry[d] (thread j), dyn[t, d] =
// sum_j carry[d] (warp sums, one barrier, threads d < ND sum the warps).
// Every thread of the block calls it.  The next write to red_m comes after
// the next step's three barriers, so the reads here cannot race it.
template <int ND>
__device__ __forceinline__ void store_marginals(const PassArgs& a,
                                                const float (&carry)[ND],
                                                size_t t, float (*red_m)[ND]) {
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int nwarp = blockDim.x >> 5;
  float lat = carry[0];
#pragma unroll
  for (int d = 1; d < ND; ++d) lat += carry[d];
  if (j < a.L) a.out[t * a.L + j] = lat;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float s = warp_sum(carry[d]);
    if (lane == 0) red_m[warp][d] = s;
  }
  __syncthreads();  // (m) marginal partials complete
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

  const int L = a.L, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int t_end = min(t0 + a.tc, a.T);
  // rows [t0, t0 + n) are steps; row T-1, if this chunk holds it, is not
  const int n = max(0, min(t_end, a.T - 1) - t0);

  float* mats = smem + 2 * NV * ND * L;
  const MatOperand tl = stage<PREC, RESIDENT>(a.tlat, a.tl_hi, a.tl_lo,
                                              ND * LL, mats);
  const MatOperand tlT = stage<PREC, RESIDENT>(a.tlatT, a.tlT_hi, a.tlT_lo,
                                               ND * LL, mats + ND * LL);

  float tdyn[ND][ND], carry[ND], row0[ND], row0T[ND];
#pragma unroll
  for (int p = 0; p < ND; ++p)
#pragma unroll
    for (int d = 0; d < ND; ++d) tdyn[p][d] = a.tdyn[p * ND + d];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    carry[d] = live ? a.ins[((size_t)c * ND + d) * L + j] : 0.f;
    row0[d] = live ? a.tlat[d * LL + j] : 0.f;
    row0T[d] = live ? a.tlatT[d * LL + j] : 0.f;
  }
  if (MODE != kFinals && t0 <= a.T - 1 && a.T - 1 < t_end) {
    const size_t last = (size_t)(a.T - 1);
    const size_t base = last * ND * L;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (live && MODE == kFull) a.out[base + d * L + j] = carry[d];
      if (live && STORE_R) a.out2[base + d * L + j] = 0.f;
    }
    if (MARG) store_marginals<ND>(a, carry, last, red_m);
  }
  __syncthreads();  // resident matrices complete

  for (int tau = n - 1; tau >= 0; --tau) {
    const size_t t = (size_t)t0 + tau;
    const size_t base = t * ND * L;
    // (1) filter posterior of row t and its dynamics mix for the push
    float f[ND];
#pragma unroll
    for (int p = 0; p < ND; ++p) f[p] = live ? a.x[base + p * L + j] : 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float v = tdyn[0][d] * f[0];
#pragma unroll
      for (int p = 1; p < ND; ++p) v = fmaf(tdyn[p][d], f[p], v);
      if (live) store_operand<PREC>(qx + d * L, ql + d * L, j, v);
      if ((a.mask >> d) & 1) {
        const float s = warp_sum(v);
        if (lane == 0) red_q[warp][d] = s;
      }
    }
    __syncthreads();  // (a) q complete

    // (2) prior_{t+1} of the own column, and the ratio r
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      float pr;
      if ((a.mask >> e) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_q[k][e];
        pr = s * row0[e];
      } else {
        pr = live ? col_matvec_p<PREC>(qx + e * L, ql + e * L, tl, e * LL,
                                       L, j)
                  : 0.f;
      }
      const float r = pr > 0.f ? carry[e] / pr : 0.f;
      if (live) {
        store_operand<PREC>(rx + e * L, rl + e * L, j, r);
        if (STORE_R) a.out2[base + e * L + j] = r;
      }
      if ((a.mask >> e) & 1) {
        const float s = warp_sum(r);
        if (lane == 0) red_r[warp][e] = s;
      }
    }
    __syncthreads();  // (b) r complete; q reads done

    // (3) pull, dynamics mix, unnormalised smoothed posterior
    float pull[ND];
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      if ((a.mask >> e) & 1) {
        float s = 0.f;
        for (int k = 0; k < nwarp; ++k) s += red_r[k][e];
        pull[e] = s * row0T[e];
      } else {
        pull[e] = live ? col_matvec_p<PREC>(rx + e * L, rl + e * L, tlT,
                                            e * LL, L, j)
                       : 0.f;
      }
    }
    float v[ND], vsum = 0.f;
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
    __syncthreads();  // (c) normaliser partials complete; r reads done

    float s = 0.f;
    for (int k = 0; k < nwarp; ++k) s += red_s[k];
    const float den = fmaxf(s, 1e-38f);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      carry[d] = v[d] / den;
      if (MODE == kFull && live) a.out[base + d * L + j] = carry[d];
    }
    if (MARG) store_marginals<ND>(a, carry, t, red_m);
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
// it is the product A^T B of two (T, M) matrices, K = T: 2 T M^2 f32
// operations (2e12 at T = 1e6, M = 1000: about 30 ms at the card's 67
// TFLOP/s without tensor cores, against 2.4 ms for reading A and B once),
// so it is bound by operations.  Each block owns one 64 x 64 output tile
// over one slice of t (split-K: S slices, so that the few tiles of a small
// M still fill the SMs) and walks it in 16-row steps through shared memory,
// 256 threads each holding a 4 x 4 tile of sums.  Sums run in two levels
// (256 rows, then the slice) to keep f32 rounding down over long slices.
// Each slice's partial goes to an (S, M, M) buffer; a second kernel adds the
// S partials in slice order into the (ND, ND, L, L) result.  No atomics:
// runs repeat bit for bit.
// ---------------------------------------------------------------------------

constexpr int kTile = 64, kStepT = 16, kInnerSteps = 16;

__global__ void __launch_bounds__(256)
    joint_acc_partial_kernel(const float* __restrict__ A,
                             const float* __restrict__ B, float* partial,
                             int T, int M, int rows_per_slice) {
  __shared__ float As[kStepT][kTile];
  __shared__ float Bs[kStepT][kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.y * kTile, q0 = blockIdx.x * kTile;
  const int s = blockIdx.z;
  const int ta = s * rows_per_slice;
  const int tb = min(T, ta + rows_per_slice);

  float acc[4][4], part[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = part[u][v] = 0.f;

  int steps = 0;
  for (int t = ta; t < tb; t += kStepT) {
    // load 16 rows of the A and B column tiles (neighbouring threads on
    // neighbouring columns), zero past T and past M
    for (int k = threadIdx.x; k < kStepT * kTile; k += 256) {
      const int row = k / kTile, col = k % kTile;
      const int tt = t + row;
      const bool in_t = tt < tb;
      As[row][col] = (in_t && p0 + col < M) ? A[(size_t)tt * M + p0 + col]
                                            : 0.f;
      Bs[row][col] = (in_t && q0 + col < M) ? B[(size_t)tt * M + q0 + col]
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStepT; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = As[kk][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[u][v] = fmaf(av[u], bv[v], part[u][v]);
    }
    __syncthreads();
    if (++steps == kInnerSteps) {
      steps = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] += part[u][v];
          part[u][v] = 0.f;
        }
    }
  }
  float* out = partial + (size_t)s * M * M;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int p = p0 + ty + 16 * u;
    if (p >= M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int q = q0 + tx + 16 * v;
      if (q < M) out[(size_t)p * M + q] = acc[u][v] + part[u][v];
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

// shared memory of a pass: its vector operands, plus `mats` (ND, L, L)
// matrices when they are kept resident (4 bytes an element in every
// precision)
size_t vec_bytes(int vecs, int prec, int n_dyn, int L) {
  return (size_t)vecs * vec_slots(prec) * n_dyn * L * sizeof(float);
}

size_t mat_bytes(int mats, int n_dyn, int L) {
  return (size_t)mats * n_dyn * L * (size_t)L * sizeof(float);
}

bool resident(int vecs, int mats, int prec, int n_dyn, int L) {
  return vec_bytes(vecs, prec, n_dyn, L) + mat_bytes(mats, n_dyn, L) <=
         kResidentCap;
}

constexpr int kFilterVecs = 1, kFilterMats = 1;
constexpr int kSmoothVecs = 2, kSmoothMats = 2;

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
                      (RES ? mat_bytes(kFilterMats, ND, a.L) : 0),
                  s);
  }
};

template <int ND, bool RES, int MODE, int PREC>
struct SmoothRun {
  static cudaError_t go(const PassArgs& a, int C, cudaStream_t s) {
    return launch(psmooth_kernel<ND, RES, MODE, PREC>, a, C,
                  vec_bytes(kSmoothVecs, PREC, ND, a.L) +
                      (RES ? mat_bytes(kSmoothMats, ND, a.L) : 0),
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

}  // namespace

extern "C" {

// 1 when the pass keeps its (ND, L, L) transition matrices in shared memory
// (kind 0: the filter pass K3, kind 1: the smoother pass K4).
int pmg_pscan_tlat_resident(int kind, int n_dyn, int L, int prec) {
  return kind == 0 ? resident(kFilterVecs, kFilterMats, prec, n_dyn, L)
                   : resident(kSmoothVecs, kSmoothMats, prec, n_dyn, L);
}

// K3.  Returns a cudaError_t (0 on success); the launch is asynchronous.
// post and norm are written only when emit != 0 (they may be null then);
// tl_hi/tl_lo (the bf16 split of tlat) are read only when prec != 0.
int pmg_pfilter_pass(const void* w, const void* tlat, const void* tl_hi,
                     const void* tl_lo, const void* tdyn, const void* ins,
                     void* finals, void* post, void* norm, int T, int C,
                     int tc, int n_dyn, int L, int uniform_mask, int emit,
                     int prec, void* stream) {
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc) ||
      bad_prec(prec, tl_hi, tl_lo))
    return (int)cudaErrorInvalidValue;
  PassArgs a{};
  a.x = static_cast<const float*>(w);
  a.tlat = static_cast<const float*>(tlat);
  a.tl_hi = static_cast<const bf16*>(tl_hi);
  a.tl_lo = static_cast<const bf16*>(tl_lo);
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
      a, C, n_dyn, resident(kFilterVecs, kFilterMats, prec, n_dyn, L),
      emit != 0, 2, prec, static_cast<cudaStream_t>(stream));
}

// K4.  mode 0 finals only; 1 full (out = smooth, out2 = r); 2 marginal
// (out = lat (T, L), out3 = dyn (T, ND)); 3 marginal + r (out2 = r, the
// scratch joint_acc reduces).  Outputs a mode does not write may be null.
int pmg_psmooth_pass(const void* post, const void* tlat, const void* tlatT,
                     const void* tl_hi, const void* tl_lo,
                     const void* tlT_hi, const void* tlT_lo,
                     const void* tdyn, const void* ins, void* finals,
                     void* out, void* out2, void* out3, int T, int C, int tc,
                     int n_dyn, int L, int uniform_mask, int mode, int prec,
                     void* stream) {
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc) ||
      bad_prec(prec, tl_hi, tl_lo) || bad_prec(prec, tlT_hi, tlT_lo))
    return (int)cudaErrorInvalidValue;
  PassArgs a{};
  a.x = static_cast<const float*>(post);
  a.tlat = static_cast<const float*>(tlat);
  a.tlatT = static_cast<const float*>(tlatT);
  a.tl_hi = static_cast<const bf16*>(tl_hi);
  a.tl_lo = static_cast<const bf16*>(tl_lo);
  a.tlT_hi = static_cast<const bf16*>(tlT_hi);
  a.tlT_lo = static_cast<const bf16*>(tlT_lo);
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
      a, C, n_dyn, resident(kSmoothVecs, kSmoothMats, prec, n_dyn, L), mode,
      4, prec, static_cast<cudaStream_t>(stream));
}

// joint_acc over post, r (T, ND, L): S slices of `rows_per_slice` rows into
// `partial` (S, ND*L, ND*L), then their sum into acc (ND, ND, L, L).
int pmg_joint_acc(const void* post, const void* r, void* partial, void* acc,
                  int T, int n_dyn, int L, int S, int rows_per_slice,
                  void* stream) {
  if (bad_shape(n_dyn, L) || T < 1 || S < 1 || rows_per_slice < 1 ||
      (long long)S * rows_per_slice < T)
    return (int)cudaErrorInvalidValue;
  const int M = n_dyn * L;
  const int tiles = (M + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  joint_acc_partial_kernel<<<dim3(tiles, tiles, S), 256, 0, s>>>(
      static_cast<const float*>(post), static_cast<const float*>(r),
      static_cast<float*>(partial), T, M, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * M;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  joint_acc_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(acc), S,
      n_dyn, L);
  return (int)cudaGetLastError();
}

}  // extern "C"

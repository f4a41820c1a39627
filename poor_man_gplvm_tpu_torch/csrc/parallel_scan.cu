// Parallel-in-time HMM filter (K3) and smoother (K4) passes for NVIDIA
// Hopper (sm_90a), with a plain C interface loaded through ctypes by
// poor_man_gplvm_tpu_torch/ops/parallel_scan.py.
//
// Replaces the Pallas TPU kernels
//   K3  poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_pfilter_kernel
//       (wrapper _pfilter_pass)
//   K4  poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_psmooth_kernel
//       (wrapper _psmooth_pass; the finals-only and full modes)
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
//     in once per block.
//   * L=500: one channel is 1 MB; every block streams it from the 50 MB L2
//     each step.  With C blocks doing so at once, L2 bandwidth rather than
//     one SM's load latency may set the pace (measured in PERF.md).
//   * A constant (jump) channel takes the sum(v) * row shortcut of K1/K2.
//
// Validity rules (those of the TPU kernels): in K3 row t of a chunk is a
// step when t < T; in K4 when t < T - 1.  Row T - 1 passes the smoother
// carry through (smooth_parallel makes that carry post_{T-1}), and rows at or
// past T do not exist here, so they are neither run nor stored.
//
// K4 computes prior_{t+1} = push(post_t) itself, per step, from the stored
// filter posterior of row t (the TPU kernel did it as a block prologue).
//
// Numerics: f32 with FMA, no tensor cores (the JAX package's "highest"
// scan precision); normalisers clamped at 1e-38; r = 0 where the prior is
// 0, so latent bins masked to zero weight stay exact zeros.

#include "scan_common.cuh"

namespace {

using namespace pmg;

struct PassArgs {
  const float* x;       // K3: w (T, L); K4: post (T, ND, L)
  const float* tlat;    // (ND, L, L)
  const float* tlatT;   // (ND, L, L) transposed per channel (K4 only)
  const float* tdyn;    // (ND, ND)
  const float* ins;     // (C, ND, L) boundary carries in
  float* finals;        // (C, ND, L) carries after each chunk's last row
  float* out;           // EMIT: K3 post / K4 smooth (T, ND, L)
  float* out2;          // EMIT: K3 norm (T,) / K4 r (T, ND, L)
  int T, L, tc, mask;
};

// K3: filter pass.  EMIT stores post (T, ND, L) and norm[t] = max(s_t,
// 1e-38), the normaliser the step divided by.
template <int ND, bool RESIDENT, bool EMIT>
__global__ void __launch_bounds__(kMaxThreads) pfilter_kernel(PassArgs a) {
  extern __shared__ float smem[];
  float* q = smem;              // (ND, L) dynamics-mixed carry
  float* tl_s = smem + ND * a.L;  // (ND, L, L) when RESIDENT
  __shared__ float red_q[32][ND];
  __shared__ float red_u[32];

  const int L = a.L, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int n = max(0, min(a.tc, a.T - t0));

  if (RESIDENT) {
    for (size_t k = j; k < ND * LL; k += blockDim.x) tl_s[k] = a.tlat[k];
  }
  const float* tlat = RESIDENT ? tl_s : a.tlat;

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
      if (live) q[d * L + j] = v;
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
        pr[d] = live ? col_matvec(q + d * L, tlat + d * LL, L, j) : 0.f;
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

// K4: smoother pass.  Per step, backward over the chunk's rows t < T-1:
//   prior = push(post_t); r = carry / prior (0 where prior == 0);
//   pull_e = Tlat[e] @ r_e; out_d = sum_e Tdyn[d,e] pull_e;
//   carry = post_t * out, normalised.
// EMIT stores smooth and r (T, ND, L); on row T-1 smooth = carry, r = 0.
template <int ND, bool RESIDENT, bool EMIT>
__global__ void __launch_bounds__(kMaxThreads) psmooth_kernel(PassArgs a) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // (ND, L) dynamics mix of post_t
  float* r_s = smem + ND * a.L;       // (ND, L) ratios r
  float* tl_s = smem + 2 * ND * a.L;  // Tlat then Tlat^T, when RESIDENT
  __shared__ float red_q[32][ND];
  __shared__ float red_r[32][ND];
  __shared__ float red_s[32];

  const int L = a.L, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, nwarp = blockDim.x >> 5;
  const bool live = j < L;
  const size_t LL = (size_t)L * L;
  const int c = blockIdx.x;
  const int t0 = c * a.tc;
  const int t_end = min(t0 + a.tc, a.T);
  // rows [t0, t0 + n) are steps; row T-1, if this chunk holds it, is not
  const int n = max(0, min(t_end, a.T - 1) - t0);

  if (RESIDENT) {
    for (size_t k = j; k < ND * LL; k += blockDim.x) {
      tl_s[k] = a.tlat[k];
      tl_s[ND * LL + k] = a.tlatT[k];
    }
  }
  const float* tlat = RESIDENT ? tl_s : a.tlat;
  const float* tlT = RESIDENT ? tl_s + ND * LL : a.tlatT;

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
  if (EMIT && live && t0 <= a.T - 1 && a.T - 1 < t_end) {
    const size_t base = (size_t)(a.T - 1) * ND * L;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      a.out[base + d * L + j] = carry[d];
      a.out2[base + d * L + j] = 0.f;
    }
  }
  __syncthreads();  // resident matrices complete

  for (int tau = n - 1; tau >= 0; --tau) {
    const size_t base = ((size_t)t0 + tau) * ND * L;
    // (1) filter posterior of row t and its dynamics mix for the push
    float f[ND];
#pragma unroll
    for (int p = 0; p < ND; ++p) f[p] = live ? a.x[base + p * L + j] : 0.f;
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
        pr = live ? col_matvec(q_s + e * L, tlat + e * LL, L, j) : 0.f;
      }
      const float r = pr > 0.f ? carry[e] / pr : 0.f;
      if (live) {
        r_s[e * L + j] = r;
        if (EMIT) a.out2[base + e * L + j] = r;
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
        pull[e] = live ? col_matvec(r_s + e * L, tlT + e * LL, L, j) : 0.f;
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
      if (EMIT && live) a.out[base + d * L + j] = carry[d];
    }
  }
#pragma unroll
  for (int d = 0; d < ND; ++d)
    if (live) a.finals[((size_t)c * ND + d) * L + j] = carry[d];
}

// shared memory of a pass: its vectors, plus `mats` (ND, L, L) matrices
// when they are kept resident
size_t vec_bytes(int vecs, int n_dyn, int L) {
  return (size_t)vecs * n_dyn * L * sizeof(float);
}

size_t mat_bytes(int mats, int n_dyn, int L) {
  return (size_t)mats * n_dyn * L * (size_t)L * sizeof(float);
}

bool resident(int vecs, int mats, int n_dyn, int L) {
  return vec_bytes(vecs, n_dyn, L) + mat_bytes(mats, n_dyn, L) <= kResidentCap;
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

template <int ND, bool RES, bool EMIT>
struct FilterRun {
  static cudaError_t go(const PassArgs& a, int C, cudaStream_t s) {
    return launch(pfilter_kernel<ND, RES, EMIT>, a, C,
                  vec_bytes(kFilterVecs, ND, a.L) +
                      (RES ? mat_bytes(kFilterMats, ND, a.L) : 0),
                  s);
  }
};

template <int ND, bool RES, bool EMIT>
struct SmoothRun {
  static cudaError_t go(const PassArgs& a, int C, cudaStream_t s) {
    return launch(psmooth_kernel<ND, RES, EMIT>, a, C,
                  vec_bytes(kSmoothVecs, ND, a.L) +
                      (RES ? mat_bytes(kSmoothMats, ND, a.L) : 0),
                  s);
  }
};

// pick the instantiation: ND x resident x emit
template <template <int, bool, bool> class Run>
cudaError_t dispatch(const PassArgs& a, int C, int n_dyn, bool res, bool emit,
                     cudaStream_t s) {
  if (n_dyn == 1) {
    if (res) return emit ? Run<1, true, true>::go(a, C, s) : Run<1, true, false>::go(a, C, s);
    return emit ? Run<1, false, true>::go(a, C, s) : Run<1, false, false>::go(a, C, s);
  }
  if (res) return emit ? Run<2, true, true>::go(a, C, s) : Run<2, true, false>::go(a, C, s);
  return emit ? Run<2, false, true>::go(a, C, s) : Run<2, false, false>::go(a, C, s);
}

// every row in exactly one chunk; chunk offsets c * tc fit an int
bool bad_chunks(int T, int C, int tc) {
  const long long rows = (long long)C * tc;
  return T < 1 || C < 1 || tc < 1 || rows < T || rows > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// 1 when the pass keeps its (ND, L, L) transition matrices in shared memory
// (kind 0: the filter pass K3, kind 1: the smoother pass K4).
int pmg_pscan_tlat_resident(int kind, int n_dyn, int L) {
  return kind == 0 ? resident(kFilterVecs, kFilterMats, n_dyn, L)
                   : resident(kSmoothVecs, kSmoothMats, n_dyn, L);
}

// K3.  Returns a cudaError_t (0 on success); the launch is asynchronous.
// post and norm are written only when emit != 0 (they may be null then).
int pmg_pfilter_pass(const void* w, const void* tlat, const void* tdyn,
                     const void* ins, void* finals, void* post, void* norm,
                     int T, int C, int tc, int n_dyn, int L, int uniform_mask,
                     int emit, void* stream) {
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc))
    return (int)cudaErrorInvalidValue;
  PassArgs a{static_cast<const float*>(w), static_cast<const float*>(tlat),
             nullptr, static_cast<const float*>(tdyn),
             static_cast<const float*>(ins), static_cast<float*>(finals),
             static_cast<float*>(post), static_cast<float*>(norm),
             T, L, tc, uniform_mask};
  return (int)dispatch<FilterRun>(
      a, C, n_dyn, resident(kFilterVecs, kFilterMats, n_dyn, L), emit != 0,
      static_cast<cudaStream_t>(stream));
}

// K4.  smooth and r are written only when emit != 0 (they may be null then).
int pmg_psmooth_pass(const void* post, const void* tlat, const void* tlatT,
                     const void* tdyn, const void* ins, void* finals,
                     void* smooth, void* r, int T, int C, int tc, int n_dyn,
                     int L, int uniform_mask, int emit, void* stream) {
  if (bad_shape(n_dyn, L) || bad_chunks(T, C, tc))
    return (int)cudaErrorInvalidValue;
  PassArgs a{static_cast<const float*>(post), static_cast<const float*>(tlat),
             static_cast<const float*>(tlatT), static_cast<const float*>(tdyn),
             static_cast<const float*>(ins), static_cast<float*>(finals),
             static_cast<float*>(smooth), static_cast<float*>(r),
             T, L, tc, uniform_mask};
  return (int)dispatch<SmoothRun>(
      a, C, n_dyn, resident(kSmoothVecs, kSmoothMats, n_dyn, L), emit != 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"

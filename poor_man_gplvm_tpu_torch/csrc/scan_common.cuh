// Device and launch helpers shared by the scan kernels (scan_kernels.cu,
// parallel_scan.cu).  Each .cu file is its own translation unit and its own
// shared library; this header holds what both need.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace pmg {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDyn = 2;
// keep transition matrices resident in shared memory up to this many bytes
// of dynamic shared memory (the card allows 227 KB per block)
constexpr size_t kResidentCap = 200 * 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one column of a row-vector @ matrix product over a window of W rows:
// sum_{k < W} vec[i0 + k] * mat[k, j], mat (W, L) row-major.  With i0 = 0
// and W = L it is the dense column sum_i vec[i] * mat[i, j].  The sum runs
// over k ascending with fmaf, so a window that covers every nonzero of the
// column gives the dense sum's bits when vec >= 0 is finite: fmaf(x, +0, a)
// returns a unchanged.  UNROLL sets how many of the matrix loads are in
// flight at once: 4 where the matrix sits in shared memory; a matrix
// streamed from L2 takes 16, which is what hides L2's latency (K3 at
// L = 500 on the H100: 33 ms per pass at 4, 19 at 16; PERF.md).
template <int UNROLL = 4>
__device__ __forceinline__ float window_matvec(const float* __restrict__ vec,
                                               const float* __restrict__ mat,
                                               int i0, int W, int L, int j) {
  const float* __restrict__ v = vec + i0;
  float a = 0.f;
#pragma unroll (UNROLL)
  for (int k = 0; k < W; ++k) a = fmaf(v[k], mat[(size_t)k * L + j], a);
  return a;
}

// ---------------------------------------------------------------------------
// K5: the recursion dot in reduced precision
// (poor_man_gplvm_tpu/ops/pallas/parallel_scan.py::_split_bf16 / _scan_dot)
//
//   HIGHEST  f32 FMAs (the dot above)
//   BF16X3   a_hi.b_hi + a_lo.b_hi + a_hi.b_lo, each an f32-accumulated dot
//            of bf16 operands (x = hi + lo, hi = bf16(x), lo = bf16(x - hi))
//   BF16     bf16(a).b_hi
//
// A product of two bf16 values is exact in f32, so each partial dot rounds
// only in its f32 sum, as the TPU's f32-accumulated bf16 dots do.  The
// matrix operand's split is loop-invariant and made once per solve (the
// wrapper's setup); the vector operand is split per step by the thread
// that owns its column, and stored as the float values of its bf16 parts.
// ---------------------------------------------------------------------------

enum Prec { kHighest = 0, kBf16x3 = 1, kBf16 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the matrix operand of a recursion dot: f32 (HIGHEST) or its bf16 split
struct MatOperand {
  const float* f;
  const bf16* hi;
  const bf16* lo;
};

// store element j of a vector operand: x[j] = the value (HIGHEST) or its
// bf16 rounding, lo[j] = the bf16 rounding of the residual (BF16X3)
template <int PREC>
__device__ __forceinline__ void store_operand(float* x, float* lo, int j,
                                              float v) {
  if (PREC == kHighest) {
    x[j] = v;
  } else {
    const float h = bf16_round(v);
    x[j] = h;
    if (PREC == kBf16x3) lo[j] = bf16_round(v - h);
  }
}

// one column of the row-vector @ matrix product of the (W, L) window at
// offset `off` of the matrix operand, rows i0 .. i0 + W - 1 of the vector
// (window_matvec's order in every precision; bf16 hi and lo of 0 are 0)
template <int PREC, int UNROLL>
__device__ __forceinline__ float window_matvec_p(const float* __restrict__ x,
                                                 const float* __restrict__ lo,
                                                 const MatOperand& m,
                                                 size_t off, int i0, int W,
                                                 int L, int j) {
  if (PREC == kHighest)
    return window_matvec<UNROLL>(x, m.f + off, i0, W, L, j);
  const float* __restrict__ xv = x + i0;
  const bf16* __restrict__ mh = m.hi + off;
  if (PREC == kBf16) {
    float a = 0.f;
#pragma unroll (UNROLL)
    for (int k = 0; k < W; ++k)
      a = fmaf(xv[k], __bfloat162float(mh[(size_t)k * L + j]), a);
    return a;
  }
  const float* __restrict__ lv = lo + i0;
  const bf16* __restrict__ ml = m.lo + off;
  float hh = 0.f, lh = 0.f, hl = 0.f;
#pragma unroll (UNROLL)
  for (int k = 0; k < W; ++k) {
    const float bh = __bfloat162float(mh[(size_t)k * L + j]);
    const float bl = __bfloat162float(ml[(size_t)k * L + j]);
    hh = fmaf(xv[k], bh, hh);
    lh = fmaf(lv[k], bh, lh);
    hl = fmaf(xv[k], bl, hl);
  }
  return (hh + lh) + hl;
}

// ---------------------------------------------------------------------------
// x / y through a reciprocal, with the bits of the f32 division
//
// Each scan step divides by a normaliser every thread shares, or by a prior
// that does not depend on the recursion.  The f32 division is a long
// dependent sequence with a slow path for tiny operands (posterior tails
// are full of them); on the H100 two of them were ~0.3 us of a 1.5 us
// step.  Here the divisor's reciprocal is made once in f64, rcp_f64(y) =
// (1 / y)(1 + e) with |e| <= 2^-52 (the hardware's approximation and three
// Newton steps, no branch), and each quotient is one f64 product rounded
// to f32: div_by_rcp(x, r) = RN32(RN64(x * r)), within 2^-51 of x / y.
//
// That IS the correctly rounded f32 quotient, so kernels that use it and
// kernels that divide agree bit for bit.  For f32 x >= 0 and 0 < y < 2
// (normal or subnormal): a rounding boundary of the f32 result is B = M *
// 2^c with M odd, M < 2^25.  If x / y != B, then |x / y - B| >= 2^-49 B
// (x = X 2^a, y = Y 2^b with X, Y < 2^24: the numerator X 2^a - M Y 2^(b+c)
// is a nonzero multiple of 2^min(a, b+c)), 4x the error above, so the
// product rounds as the quotient does.  And x / y = B cannot happen: in the
// normal range M Y has an odd part of 25 bits or more and x has 24; in the
// subnormal range (c = -150) x = M Y 2^(b-150) is a multiple of 2^-149 only
// if y >= 2.  Callers fall back to the plain division when y >= 2 (never,
// for normalisers and priors of probabilities).
// ---------------------------------------------------------------------------

__device__ __forceinline__ double rcp_f64(float y) {
  const double d = (double)y;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-d, r, 1.0), r);
  return r;
}

__device__ __forceinline__ float div_by_rcp(float x, double r) {
  return (float)((double)x * r);
}

constexpr float kRcpDivisorMax = 2.f;

// The smoother's ratio r = carry / prior treats a prior below the smallest
// normal float (FLT_MIN) as zero, as the JAX package does (XLA flushes
// subnormals).  A subnormal prior under a carry of normal size would give
// r = inf and a NaN row; with the floor r < 1 / FLT_MIN, and the pulled
// vector, a row-stochastic average of the r, cannot overflow.
constexpr float kPriorFloor = 1.17549435e-38f;

// loads in flight of a matrix read from shared memory or streamed from L2
__host__ __device__ constexpr int matvec_unroll(bool resident) {
  return resident ? 4 : 16;
}

// thread j owns latent column j: L rounded up to whole warps
inline int block_threads(int L) { return ((L + 31) / 32) * 32; }

inline bool bad_shape(int n_dyn, int L) {
  return n_dyn < 1 || n_dyn > kMaxDyn || L < 1 ||
         block_threads(L) > kMaxThreads;
}

// opt in to more than 48 KB of dynamic shared memory when a launch needs it
template <typename Kernel>
cudaError_t launch_prep(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

}  // namespace pmg

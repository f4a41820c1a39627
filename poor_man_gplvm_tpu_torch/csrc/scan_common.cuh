// Device and launch helpers shared by the scan kernels (scan_kernels.cu,
// parallel_scan.cu).  Each .cu file is its own translation unit and its own
// shared library; this header holds what both need.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace pmg {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDyn = 2;
// keep transition matrices resident in shared memory up to this many bytes
// of dynamic shared memory (the card allows 227 KB per block)
constexpr size_t kResidentCap = 200 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one column of a row-vector @ matrix product: sum_i vec[i] * mat[i, j]
__device__ __forceinline__ float col_matvec(const float* __restrict__ vec,
                                            const float* __restrict__ mat,
                                            int L, int j) {
  float a = 0.f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) a = fmaf(vec[i], mat[(size_t)i * L + j], a);
  return a;
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

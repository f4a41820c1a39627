// Hopper (sm_90a) building blocks shared by the kernels that feed shared
// memory asynchronously and run the tensor cores' warpgroup products:
// bf16_gemm.cu (the lower matmul precisions), parallel_scan.cu (joint_acc)
// and scan_kernels.cu (K2 with the prior recomputed).  Each .cu file is its
// own translation unit and its own shared library; this header holds
// inline device code and the host's TMA tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_runtime.h>
#include <stdint.h>

namespace pmg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier: a barrier in shared memory that counts arrivals and the bytes of
// asynchronous copies; a wait names the parity of the phase it waits for
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the asynchronous proxy
// (the copies that complete on them); then a block barrier
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// whether the barrier's phase of `parity` has completed (no wait)
__device__ __forceinline__ bool mbar_ready(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------

// `bytes` contiguous bytes (16-byte aligned at both ends, a multiple of 16)
// by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one TMA box of a 3-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 4 bytes into shared memory, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on `bar` once this thread's cp.asyncs have landed (the barrier's
// count includes this arrival)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// order this thread's shared-memory writes before later reads of the
// asynchronous proxy (a wgmma operand, a TMA store)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `n` threads (a multiple of 32) under id `id` (1-15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a K-major, 128-byte-swizzled operand tile at shared address
// `addr` (rows of 128 bytes of K, 8-row groups 1024 bytes apart, the tile
// 1024-byte aligned; a K offset within the row is added to addr): 64 bf16
// or 32 tf32 values of K a row
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of element (row, k) in such a tile of 4-byte values: the
// 16-byte chunk of a 128-byte row XOR-ed with the row's index mod 8
__device__ __forceinline__ uint32_t sw128_off4(int row, int k) {
  return row * 128 + ((((k & 31) >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// thread block clusters and their distributed shared memory
// ---------------------------------------------------------------------------

// this thread block's place in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a barrier of every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// arrive on the barrier at shared address `bar` of block `rank` of the
// cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}

// the shared address `addr` of this block, in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// an asynchronous store of `n` (1 or 2) f64 values into another block's
// shared memory (addresses from map_shared: the values at `addr`, the
// barrier at `bar`), whose bytes complete on that block's barrier
template <int N>
__device__ __forceinline__ void st_async(uint32_t addr, const double (&v)[N],
                                         uint32_t bar) {
  static_assert(N == 1 || N == 2, "one or two f64 values");
  if (N == 1)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], "
        "%1, [%2];\n" ::"r"(addr),
        "d"(v[0]), "r"(bar)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(addr),
        "d"(v[0]), "d"(v[N - 1]), "r"(bar)
        : "memory");
}

// ---------------------------------------------------------------------------
// TMA tensor maps, encoded on the host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

inline long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

// a 3-D map (d0 fastest) with the strides of d1 and d2 in bytes, boxes of
// b0 x b1 x 1, 128-byte swizzle, zeros out of bounds
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                   long long d0, long long d1, long long d2, long long s1,
                   long long s2, int b0, int b1) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pmg

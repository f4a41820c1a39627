// The emission and M-step products at the lower matmul precisions,
// C = A @ B on the tensor cores with bf16 operands, f32 sums and f32
// output, for NVIDIA Hopper (sm_90a), with a plain C interface loaded
// through ctypes by poor_man_gplvm_tpu_torch/ops/precision.py.
//
// Not the port of a Pallas kernel: on the TPU this product is XLA's
// (jnp.matmul(..., precision=PRECISION) in the JAX package's
// ops/emissions.py, ops/mstep.py, ops/fit_tuning_with_basis.py and
// experimental/gain.py), at the level config.set_matmul_precision sets.
// Its meaning is the TPU's, as the JAX package's _scan_dot
// (ops/pallas/parallel_scan.py:126-150) emulates it:
//   PASSES = 3 ('high', bf16x3): a = hi + lo with hi = bf16(a) (round to
//     nearest even) and lo = bf16(a - hi); a.b ~ hi.hi + lo.hi + hi.lo;
//   PASSES = 1 ('default', bf16): bf16(a).bf16(b).
// A product of two bf16 values is exact in f32; the sums are f32 and the
// output is f32 (a torch.matmul on bf16 tensors would round it to bf16,
// and three library products would store the hi/lo copies of both
// operands).
//
// Operands are f32 with arbitrary element strides, so a transposed
// operand (post.T, (log_lam * ma).T) is read in place; a batch index on
// gridDim.z carries its own batch strides (0 broadcasts an operand).
// Block tile 128 x 128 in 8 warps of 64 x 32 when the output holds many
// such tiles (the emissions, the sweep's batched statistics), else 64 x 64
// in 4 warps of 32 x 32 (one statistics chunk, L x N = 500 x 500: 64
// blocks); mma.sync m16n8k16, BK = 32 rows of K per stage.  The large
// tile halves what the blocks read again from L2 (each A row once per
// column tile, each B column once per row tile).  Each operand's raw f32
// tile is copied into shared memory with cp.async along its unit stride
// (K for y and (log lam).T, M or N for post.T and y in the statistics;
// 16-byte copies when the strides and the pointer allow, 4-byte ones
// otherwise), kStages stages in flight, zero-filled past M, N and K.
// Each warp splits the values of its fragments into bf16 hi/lo in
// registers as it reads them (__floats2bfloat162_rn packs a pair along
// K), so nothing bf16 is stored.  The shared rows are padded so that the
// fragment reads of a warp fall on distinct banks in both layouts.
//
// On the H100 (PERF.md) the first design, which split each element into
// bf16 as it staged it from registers into shared memory, took 18.2 ms
// for the north-star emission at 'high'; cp.async with the split in
// registers took 11.6, the large tile 10.3 (the f32 product 9.9).  What
// bounds it now is not measured; 254 registers leave one block of 8
// warps per SM.
//
// Row independence: each output element's K loop runs in one fixed order
// that depends on nothing but K and is the same in both tiles.  Per 32-wide stage of K, from k = 0:
// the stage's products (for each 16-wide half: lo.hi, hi.lo, then hi.hi)
// go into a fresh mma accumulator, which is then added to the element's
// running f32 sum (round to nearest).  The tensor cores' own f32 adds
// truncate, so the running sum over a long K (the statistics' 2e5 rows)
// stays out of them.  No split-K and no atomics; out-of-range values are
// zeros.  So a row's result is the same in every call that contains it:
// a slice of rows, another N, another batch, another tile position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32, kStages = 3;
constexpr int kSK = kBK + 8;  // floats per row of a K-fast shared tile

// a block tile: WM x WN warps, each MT x NT mma tiles of 16 x 8 (square)
template <int WM_, int WN_, int MT_, int NT_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int kThreads = WM * WN * 32;
  // shared tiles (floats): K-fast [rows][kSK], M/N-fast [kBK][rows + 4];
  // both keep 16-byte rows and conflict-free fragment reads
  static constexpr int SR = BM + 4;
  static constexpr int kTile = BM * kSK > kBK * SR ? BM * kSK : kBK * SR;
  static constexpr int kSmemBytes = kStages * 2 * kTile * 4;
  static_assert(BM == BN, "one tile shape for both operands");
};
using Small = Tile<2, 2, 2, 4>;  // 64 x 64, 4 warps
using Large = Tile<2, 4, 4, 4>;  // 128 x 128, 8 warps
// 128 x 128 tiles when there are at least this many (4 per SM of the
// H100's 132): both tiles add the same products in the same order, so
// the choice changes no bit
constexpr long long kLargeMinTiles = 4 * 132;

struct Gemm {
  const float* A;
  const float* B;
  float* C;
  long long M, N, K;
  long long sa_b, sa_m, sa_k;
  long long sb_b, sb_k, sb_n;
  long long sc_b, sc_m, sc_n;
  long long tiles_n;
  int vec_a, vec_b;  // 16-byte copies allowed
};

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of one operand X (rows r0.. of `rows`, K from k0) into xs.
// K_FAST: X's unit stride is along K, and xs is [row][kSK]; otherwise it
// is along the rows, and xs is [k][TL::SR].  `vec`: 16-byte copies of 4
// consecutive values along the unit stride (its other strides multiples
// of 4, the pointer 16-byte aligned).
template <class TL, bool K_FAST>
__device__ __forceinline__ void load_stage(const float* X, float* xs,
                                           long long r0, long long rows,
                                           long long s_r, long long k0,
                                           long long K, long long s_k,
                                           bool vec) {
  if (vec) {
    // chunks of 4 along the unit stride: BM * kBK / 4 of them
    for (int c = threadIdx.x; c < TL::BM * kBK / 4; c += TL::kThreads) {
      int row, k;
      long long left;  // values left along the unit stride
      if (K_FAST) {
        row = c / (kBK / 4);
        k = (c % (kBK / 4)) * 4;
        left = (r0 + row < rows) ? K - (k0 + k) : 0;
      } else {
        k = c / (TL::BM / 4);
        row = (c % (TL::BM / 4)) * 4;
        left = (k0 + k < K) ? rows - (r0 + row) : 0;
      }
      const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : (int)left * 4);
      float* dst = K_FAST ? xs + row * kSK + k : xs + k * TL::SR + row;
      const float* src = X + (r0 + row) * s_r + (k0 + k) * s_k;
      cp_async<16>(dst, bytes ? src : X, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < TL::BM * kBK; e += TL::kThreads) {
      int row, k;
      if (K_FAST) {
        row = e / kBK;
        k = e % kBK;
      } else {
        k = e / TL::BM;
        row = e % TL::BM;
      }
      const bool ok = r0 + row < rows && k0 + k < K;
      float* dst = K_FAST ? xs + row * kSK + k : xs + k * TL::SR + row;
      const float* src = X + (r0 + row) * s_r + (k0 + k) * s_k;
      cp_async<4>(dst, ok ? src : X, ok ? 4 : 0);
    }
  }
}

// the pair (row, k), (row, k + 1) of a staged tile
template <class TL, bool K_FAST>
__device__ __forceinline__ float2 pair(const float* xs, int row, int k) {
  if (K_FAST) return *reinterpret_cast<const float2*>(xs + row * kSK + k);
  return make_float2(xs[k * TL::SR + row], xs[(k + 1) * TL::SR + row]);
}

// a pair as packed bf16 hi (and, for PASSES = 3, lo); the lower half
// holds the lower k, as mma.sync reads it
template <int PASSES>
__device__ __forceinline__ void split(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if (PASSES == 3) {
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        v.x - __low2float(h), v.y - __high2float(h));
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <class TL, int PASSES, bool A_KF, bool B_KF>
__global__ void __launch_bounds__(TL::kThreads) bf16_gemm_kernel(Gemm g) {
  constexpr int kMT = TL::MT, kNT = TL::NT, kWN = TL::WN;
  constexpr int kTile = TL::kTile;
  extern __shared__ __align__(16) float smem[];
  const long long tile = blockIdx.x;
  const long long m0 = (tile / g.tiles_n) * TL::BM;
  const long long n0 = (tile % g.tiles_n) * TL::BN;
  const float* A = g.A + blockIdx.z * g.sa_b;
  const float* B = g.B + blockIdx.z * g.sb_b;
  float* C = g.C + blockIdx.z * g.sc_b;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[m][n][u] = 0.f;

  const long long stages = (g.K + kBK - 1) / kBK;
  auto issue = [&](long long st) {
    float* as = smem + (st % kStages) * 2 * kTile;
    load_stage<TL, A_KF>(A, as, m0, g.M, g.sa_m, st * kBK, g.K, g.sa_k,
                         g.vec_a);
    load_stage<TL, B_KF>(B, as + kTile, n0, g.N, g.sb_n, st * kBK, g.K,
                         g.sb_k, g.vec_b);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) issue(s);
    cp_async_commit();
  }
  for (long long st = 0; st < stages; ++st) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage st
    __syncthreads();  // all of stage st; every warp done with st - 1
    if (st + kStages - 1 < stages) issue(st + kStages - 1);
    cp_async_commit();
    const float* as = smem + (st % kStages) * 2 * kTile;
    const float* bs = as + kTile;
    float part[kMT][kNT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) part[m][n][u] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        // registers: (row g, k 2t..), (row g+8, k 2t..), (row g, k 2t+8..),
        // (row g+8, k 2t+8..)
        const int r = wm * kMT * 16 + m * 16 + gid, k = kk + 2 * tig;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split<PASSES>(
              pair<TL, A_KF>(as, r + (i & 1) * 8, k + (i >> 1) * 8),
              ah[m][i], al[m][i]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        // registers: (k 2t.., column g), (k 2t+8.., column g)
        const int c = wn * kNT * 8 + n * 8 + gid, k = kk + 2 * tig;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split<PASSES>(pair<TL, B_KF>(bs, c, k + i * 8), bh[n][i],
                        bl[n][i]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (PASSES == 3) {
            mma_bf16(part[m][n], al[m], bh[n]);
            mma_bf16(part[m][n], ah[m], bl[n]);
          }
          mma_bf16(part[m][n], ah[m], bh[n]);
        }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[m][n][u] += part[m][n][u];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // accumulator u: row g (+8 for u >= 2), column 2t (+1 for odd u)
        const long long row =
            m0 + wm * kMT * 16 + m * 16 + gid + (u >> 1) * 8;
        const long long col = n0 + wn * kNT * 8 + n * 8 + 2 * tig + (u & 1);
        if (row < g.M && col < g.N)
          C[row * g.sc_m + col * g.sc_n] = acc[m][n][u];
      }
}

template <class TL, int PASSES, bool A_KF, bool B_KF>
cudaError_t launch(Gemm g, long long batch, cudaStream_t s) {
  auto kernel = bf16_gemm_kernel<TL, PASSES, A_KF, B_KF>;
  static bool opted_in = false;  // the shared memory above 48 KB, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  g.tiles_n = (g.N + TL::BN - 1) / TL::BN;
  const long long tiles = ((g.M + TL::BM - 1) / TL::BM) * g.tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, (unsigned)batch);
  kernel<<<grid, TL::kThreads, TL::kSmemBytes, s>>>(g);
  return cudaGetLastError();
}

template <class TL, int PASSES>
cudaError_t launch_layout(const Gemm& g, long long batch, cudaStream_t s) {
  // each operand is staged along its unit stride
  const bool a_kf = g.sa_m != 1, b_kf = g.sb_n != 1;
  if (a_kf)
    return b_kf ? launch<TL, PASSES, true, true>(g, batch, s)
                : launch<TL, PASSES, true, false>(g, batch, s);
  return b_kf ? launch<TL, PASSES, false, true>(g, batch, s)
              : launch<TL, PASSES, false, false>(g, batch, s);
}

// the large tile where it still gives every SM several blocks
template <int PASSES>
cudaError_t launch_tile(const Gemm& g, long long batch, cudaStream_t s) {
  const long long large = ((g.M + Large::BM - 1) / Large::BM) *
                          ((g.N + Large::BN - 1) / Large::BN) * batch;
  return large >= kLargeMinTiles ? launch_layout<Large, PASSES>(g, batch, s)
                                 : launch_layout<Small, PASSES>(g, batch, s);
}

// 16-byte copies of an operand: unit stride along its fast axis, its
// other strides multiples of 4 floats and the pointer 16-byte aligned
bool vec_ok(const void* p, long long s_b, long long s_fast, long long s_other,
            long long batch) {
  return s_fast == 1 && s_other % 4 == 0 && (batch == 1 || s_b % 4 == 0) &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// C[b] (M, N) = A[b] (M, K) @ B[b] (K, N) for b < batch, every operand f32
// with the element strides given (batch strides may be 0); passes 3
// ('high', bf16x3) or 1 ('default', bf16).  Returns a cudaError_t.
int pmg_bf16_gemm(const void* A, const void* B, void* C, long long M,
                  long long N, long long K, long long batch, long long sa_b,
                  long long sa_m, long long sa_k, long long sb_b,
                  long long sb_k, long long sb_n, long long sc_b,
                  long long sc_m, long long sc_n, int passes, void* stream) {
  if (M < 0 || N < 0 || K < 0 || batch < 1 || batch > 65535 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const bool a_kf = sa_m != 1, b_kf = sb_n != 1;
  const Gemm g{static_cast<const float*>(A),
               static_cast<const float*>(B),
               static_cast<float*>(C),
               M, N, K, sa_b, sa_m, sa_k, sb_b, sb_k, sb_n, sc_b, sc_m, sc_n,
               0,
               vec_ok(A, sa_b, a_kf ? sa_k : sa_m, a_kf ? sa_m : sa_k, batch),
               vec_ok(B, sb_b, b_kf ? sb_k : sb_n, b_kf ? sb_n : sb_k, batch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(passes == 3 ? launch_tile<3>(g, batch, s)
                           : launch_tile<1>(g, batch, s));
}

}  // extern "C"

// The emission and M-step products at the lower matmul precisions,
// C = A @ B on the tensor cores with bf16 operands, f32 sums and f32
// output, for NVIDIA Hopper (sm_90a: wgmma, TMA, mbarrier), with a plain C
// interface loaded through ctypes by poor_man_gplvm_tpu_torch/ops/precision.py.
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
// output is f32.
//
// The design.  B is split once per call into bf16 hi (and lo) by
// split_b_kernel, into scratch laid out (batch, N, K) with K contiguous,
// so every stage of it is one TMA box in wgmma's K-major 128-byte-swizzled
// layout.  A stays f32 in device memory and is read in place through its
// strides: a ring of shared-memory stages (128 rows x 64 of K) is filled
// by one producer warp, by TMA (cp.async.bulk.tensor, 128-byte swizzle,
// K-fast or M-fast boxes as A's unit stride lies) where A's base and
// strides meet TMA's 16-byte rules, else by 4-byte cp.async into the same
// layout (the pipeline's N = 490 and L = 101, a view at a 4-byte offset, a
// broadcast row): the second variant stores the same values in the same
// places, so the two give the same bits.  Both raise an mbarrier per
// stage.  With TMA and at least 3 column tiles the blocks run in clusters
// of 4 along N: each loads a quarter of A's stage and multicasts it to the
// others, which share A's rows.  Two consumer warpgroups own 64 rows each
// of the 128 x 128 block tile: each reads its A rows from shared memory
// into registers, splits them into bf16 hi/lo there (each staged value is
// split once, by the one warp that owns its row) and issues
// wgmma.m64n128k16 with A from registers and B from shared memory; it
// loads and splits A's next slice while the tensor cores form the current
// one's products.  The producer warpgroup (one warp of it loads) gives its
// registers to them (setmaxnreg: 56 and 224 a thread; 40 left the
// cp.async variant's copy loop 35 % slower).  The
// output tile is staged in shared memory and stored by TMA (where its rows
// are 16-byte aligned, else by the threads), so the store overlaps the
// next item's products.  The grid is persistent (as many clusters as can
// be resident, each walking its work items), so the producer loads the
// next item's stages while the consumers finish the last.  Zero past M,
// N and K: TMA's out-of-bounds fill, or cp.async's zero fill.
//
// Order (row independence): each output element's sum depends on K
// alone.  Per 32-wide slice of K, from k = 0, the slice's products (per
// 16-wide half: lo.hi, hi.lo, then hi.hi; hi.hi alone at 'default') go
// into a fresh wgmma accumulator, which is then added to the element's
// running f32 sum (round to nearest): the tensor cores' own f32 adds
// truncate, so a long K is summed outside them.  Products with K above
// precision.SPLIT_MIN_K (16,384) are cut into segments of precision.SEG_K
// (4,096: 128 slices) at fixed boundaries, multiples of SEG_K from k = 0;
// each segment's running sum is stored as a partial, and
// sum_segments_kernel adds the partials in segment order (no atomics).
// The cut depends on K alone, never on M, N, the batch or the card, and
// it fills the card on a statistics chunk (K = 2e5: 49 segments x 16
// tiles = 784 tiles for 120 SMs, against 64 tiles walking all of K in the
// mma.sync kernel it replaced).  So a row's bits are the same in every
// call that contains it: a slice of rows, a block of columns, another
// batch, another variant, cluster or grid.  The caller passes the
// variant, the cluster and the segment length, from
// ops/precision.py::gemm_plan.
//
// On the H100 (PERF.md, scripts/bf16_gemm_probe.py) it takes 3.2 / 2.2
// ms for the north-star emission (1e6 x 500 x 500) and 1.0 / 0.6 ms for a
// statistics chunk (500 x 2e5 x 500), 'high' / 'default' (the earlier
// mma.sync kernel, which split every value in each warp that read it,
// 10.3 / 7.1 and 6.6 / 5.0).  What bounds it
// (scripts/bf16_gemm_variants.py, the emission): the shared memory a
// block is fed, 64 / 48 KB per 64 of K (the loads alone take 2.2 / 1.4 ms
// of the whole 3.1 / 2.2), and the consumers' split and f32 adds beside
// the tensor cores (the consumers and the stores alone 2.7 / 1.7): each
// part nearly fills the time and they
// overlap only in part.  On a statistics chunk also B's split (0.37 / 0.24
// ms of its 400 MB of y).  168 registers a thread at launch, 224 for the
// consumers after setmaxnreg, nothing spilled.  Tried and dropped:
// clusters of 2 x 4 (B multicast too), a stage more or fewer, and two
// accumulators of 64 columns so that one's f32 adds overlap the other's
// products (ptxas serialises the wgmmas).

#include <cuda.h>  // CUtensorMap; its encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace pmg;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile, K per stage
constexpr int kConsumerWarps = 8;              // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + a producer warpgroup
constexpr uint32_t kABytes = kBM * kBK * 4;    // f32 A per stage
constexpr uint32_t kBBytes = kBN * kBK * 2;    // bf16 hi (or lo) per stage
constexpr uint32_t kCBytes = kBM * kBN * 4;    // the output tile, staged

template <int PASSES>
struct Cfg {
  static constexpr uint32_t kStageBytes =
      kABytes + kBBytes * (PASSES == 3 ? 2 : 1);
  // as many stages as fit beside the output tile (more measured no faster)
  static constexpr int kStages = PASSES == 3 ? 2 : 3;
  // stages, the output tile, their barriers, and room to align to 1024
  static constexpr int kSmem =
      kStages * kStageBytes + kCBytes + 16 * kStages + 1024;
};

struct Gemm {
  const float* A;  // read in place by the cp.async variant
  float* C;
  float* part;     // (segs, batch, M, N) partials when segs > 1
  long long M, N, K;
  long long sa_b, sa_m, sa_k;
  long long sc_b, sc_m, sc_n;
  long long tiles_m, tiles_n, segs, seg_stages, items, batch;
  int a_bcast, b_bcast;
  int c_tma;  // the output (or the partials) stored by TMA from tm_c
};

// Byte offset of A's element (m, k) in a stage, as TMA's 128-byte swizzle
// lays its boxes: K-fast, two boxes of [128 m][32 k]; M-fast, four boxes
// of [64 k][32 m]; the 16-byte chunk of a 128-byte row is XOR-ed with the
// row's index mod 8, so a warp's fragment reads fall on distinct banks.
template <bool KFAST>
__device__ __forceinline__ uint32_t a_off(int m, int k) {
  if (KFAST)
    return ((k >> 5) << 14) + m * 128 +
           ((((k & 31) >> 2) ^ (m & 7)) << 4) + ((k & 3) << 2);
  return ((m >> 5) << 13) + k * 128 + ((((m & 31) >> 2) ^ (k & 7)) << 4) +
         ((m & 3) << 2);
}

// the pair (m, k), (m, k + 1) of A's stage, k even
template <bool KFAST>
__device__ __forceinline__ float2 a_pair(const uint8_t* sa, int m, int k) {
  if (KFAST) return *reinterpret_cast<const float2*>(sa + a_off<true>(m, k));
  return make_float2(*reinterpret_cast<const float*>(sa + a_off<false>(m, k)),
                     *reinterpret_cast<const float*>(
                         sa + a_off<false>(m, k + 1)));
}

// a pair as packed bf16 hi (and, for PASSES = 3, lo); the lower half
// holds the lower k, as wgmma reads an A fragment from registers
template <int PASSES>
__device__ __forceinline__ void split(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if (PASSES == 3) {
    const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - __low2float(h),
                                                   v.y - __high2float(h));
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// d (64 x 128, f32) = (scale_d ? d : 0) + a (64 x 16, registers) @ b
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// A's fragment of 32-wide slice `sl` of a stage, split: hi[h], lo[h] for
// its two 16-wide halves; registers: (row g, k 2t..), (row g+8, k 2t..),
// (row g, k 2t+8..), (row g+8, k 2t+8..)
template <int PASSES, bool KFAST>
__device__ __forceinline__ void a_frag(const uint8_t* pa, int r0, int t4,
                                       int sl, uint32_t (&hi)[2][4],
                                       uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split<PASSES>(a_pair<KFAST>(pa, r0 + (i & 1) * 8,
                                  sl * 32 + h * 16 + 2 * t4 + (i >> 1) * 8),
                    hi[h][i], lo[h][i]);
}

// one 32-wide slice's products into a fresh accumulator d (per 16-wide
// half lo.hi, hi.lo, hi.hi; hi.hi alone at 'default'), committed as one
// group
template <int PASSES>
__device__ __forceinline__ void slice_mma(float (&d)[64],
                                          const uint32_t (&hi)[2][4],
                                          const uint32_t (&lo)[2][4],
                                          uint32_t sb, int sl) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t kb = (sl * 32 + h * 16) * 2;  // bytes along K
    const uint64_t dh = sw128_desc(sb + kb);
    if (PASSES == 3) {
      wgmma(d, lo[h], dh, h);
      wgmma(d, hi[h], sw128_desc(sb + kBBytes + kb), 1);
      wgmma(d, hi[h], dh, 1);
    } else {
      wgmma(d, hi[h], dh, h);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait for the slice's group, then add it into the running sums
__device__ __forceinline__ void slice_add(float (&acc)[64], float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += d[i];
}

// one TMA box into the same shared address of every block in `mask`
__device__ __forceinline__ void tma_load_mc(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

// one box of shared memory into a 3-D map (clipped at its bounds)
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a barrier of the 128 threads of consumer warpgroup `wg`
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

struct Item {
  long long b, seg, m0, n0, st0, nst;
};

// work item `it` of a cluster of CN blocks along N, for the block of
// rank cn in it: the cluster's group of column tiles fastest, so the
// clusters that run together share rows of A, then the row tile, segment,
// batch entry
template <int CN>
__device__ __forceinline__ Item item_at(const Gemm& g, long long it,
                                        long long stages, int cn) {
  const long long groups_n = (g.tiles_n + CN - 1) / CN;
  Item w;
  w.n0 = ((it % groups_n) * CN + cn) * kBN;
  it /= groups_n;
  w.m0 = (it % g.tiles_m) * kBM;
  it /= g.tiles_m;
  w.seg = it % g.segs;
  w.b = it / g.segs;
  w.st0 = w.seg * g.seg_stages;
  w.nst = min(g.seg_stages, stages - w.st0);
  return w;
}

// TMA with a cluster of CN blocks along N: each block loads 1/CN of A's
// stage (the rows the CN blocks share) and multicasts it to the others,
// and a stage is released to every block of the cluster
template <int PASSES, bool KFAST, bool TMA, int CN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_bhi,
                const __grid_constant__ CUtensorMap tm_blo,
                const __grid_constant__ CUtensorMap tm_c, const Gemm g) {
  using Cf = Cfg<PASSES>;
  constexpr int S = Cf::kStages, CS = CN;
  static_assert(TMA || CS == 1, "cp.async loads are not shared");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* ring = smem_raw + (base - raw);
  const uint32_t cstage = base + S * Cf::kStageBytes;  // the output tile
  const uint32_t bars = cstage + kCBytes;  // full[S], empty[S]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cn = CS == 1 ? 0 : (int)cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // TMA: the producer's expect_tx; cp.async: also its 32 arrivals
      mbar_init(bars + 8 * s, TMA ? 1 : 33);
      // one release per consumer warpgroup and block of the cluster
      mbar_init(bars + 8 * (S + s), 2 * CS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CS > 1)
    cluster_sync();  // no block loads into another's uninitialised ring
  else
    __syncthreads();
  const long long stages = (g.K + kBK - 1) / kBK;
  const long long first = blockIdx.x / CS, step = gridDim.x / CS;

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == kConsumerWarps) {
      uint32_t it = 0;
      for (long long item = first; item < g.items; item += step) {
        const Item w = item_at<CN>(g, item, stages, cn);
        const int ba = g.a_bcast ? 0 : (int)w.b, bb = g.b_bcast ? 0 : (int)w.b;
        for (long long st = 0; st < w.nst; ++st, ++it) {
          const int s = it % S;
          mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = base + s * Cf::kStageBytes, sb = sa + kABytes;
          const int k0 = (int)((w.st0 + st) * kBK);
          if (lane == 0) {
            mbar_expect_tx(full, (TMA ? kABytes : 0) +
                                     kBBytes * (PASSES == 3 ? 2 : 1));
            if (TMA && CS == 1) {
              if (KFAST) {
                tma_load(sa, &tm_a, full, k0, (int)w.m0, ba);
                tma_load(sa + 16384, &tm_a, full, k0 + 32, (int)w.m0, ba);
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  tma_load(sa + 8192 * j, &tm_a, full, (int)w.m0 + 32 * j, k0,
                           ba);
              }
            } else if (TMA) {
              // A's rows (K-fast) or boxes (M-fast) cn, to every block
              const uint16_t mask = (1u << CN) - 1;
              if (KFAST) {
                constexpr int R = kBM / CN;
                const int m0 = (int)w.m0 + cn * R;
                tma_load_mc(sa + cn * R * 128, &tm_a, full, k0, m0, ba, mask);
                tma_load_mc(sa + 16384 + cn * R * 128, &tm_a, full, k0 + 32, m0,
                            ba, mask);
              } else {
#pragma unroll
                for (int j = cn * (4 / CN); j < (cn + 1) * (4 / CN); ++j)
                  tma_load_mc(sa + 8192 * j, &tm_a, full, (int)w.m0 + 32 * j,
                              k0, ba, mask);
              }
            }
            tma_load(sb, &tm_bhi, full, k0, (int)w.n0, bb);
            if (PASSES == 3)
              tma_load(sb + kBBytes, &tm_blo, full, k0, (int)w.n0, bb);
          }
          if (!TMA) {
            const float* A = g.A + (g.a_bcast ? 0 : w.b * g.sa_b);
            for (int e = lane; e < kBM * kBK; e += 32) {
              // along A's unit stride first, so a warp's reads coalesce
              const int m = KFAST ? e / kBK : e % kBM;
              const int k = KFAST ? e % kBK : e / kBM;
              const long long gm = w.m0 + m, gk = k0 + k;
              const bool ok = gm < g.M && gk < g.K;
              cp_async4(sa + a_off<KFAST>(m, k),
                        ok ? A + gm * g.sa_m + gk * g.sa_k : A, ok ? 4 : 0);
            }
            cp_async_arrive(full);
          }
        }
      }
      if (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
    }
    if (CS > 1) cluster_sync();  // no block leaves while another may
                                 // still release a stage to it
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    // the consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile
    const int g8 = lane >> 2, t4 = lane & 3;
    const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g8;  // and r0 + 8
    uint32_t it = 0;
    float part[64];
    for (long long item = first; item < g.items; item += step) {
      const Item w = item_at<CN>(g, item, stages, cn);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      // A's next slice is loaded and split while the tensor cores form
      // this one's products
      uint32_t hi0[2][4], lo0[2][4], hi1[2][4], lo1[2][4];
      mbar_wait(bars + 8 * (it % S), (it / S) & 1);
      a_frag<PASSES, KFAST>(ring + (it % S) * Cf::kStageBytes, r0, t4, 0,
                            hi0, lo0);
      for (long long st = 0; st < w.nst; ++st, ++it) {
        const int s = it % S;
        const uint8_t* pa = ring + s * Cf::kStageBytes;
        const uint32_t sb = base + s * Cf::kStageBytes + kABytes;
        const long long kst = (w.st0 + st) * kBK;
        // else the second slice is zeros: only at the end of K, so on the
        // item's last stage
        const bool two = kst + 32 < g.K;
        const bool next = st + 1 < w.nst;
        slice_mma<PASSES>(part, hi0, lo0, sb, 0);
        if (two) a_frag<PASSES, KFAST>(pa, r0, t4, 1, hi1, lo1);
        slice_add(acc, part);
        // the next stage's first slice: loaded now if it has landed, else
        // after this stage is released
        const int s1 = (it + 1) % S;
        const uint32_t ph1 = ((it + 1) / S) & 1;
        bool pre = false;
        if (two) {
          slice_mma<PASSES>(part, hi1, lo1, sb, 1);
          pre = next && mbar_ready(bars + 8 * s1, ph1);
          if (pre)
            a_frag<PASSES, KFAST>(ring + s1 * Cf::kStageBytes, r0, t4, 0,
                                  hi0, lo0);
          slice_add(acc, part);
        }
        // the warpgroup's wait covers its four warps' reads of the
        // stage (each wgmma starts only once all four have issued it): one
        // warp releases it, lane r to block r of the cluster
        if ((warp & 3) == 0 && lane < CS) {
          if (CS == 1)
            mbar_arrive(bars + 8 * (S + s));
          else
            mbar_arrive_cluster(bars + 8 * (S + s), lane);
        }
        if (next && !pre) {
          mbar_wait(bars + 8 * s1, ph1);
          a_frag<PASSES, KFAST>(ring + s1 * Cf::kStageBytes, r0, t4, 0, hi0,
                                lo0);
        }
      }

      // accumulator 4j + u: row r0 (+8 for u >= 2), column 8j + 2t (+1
      // for odd u)
      if (g.c_tma) {
        // the warpgroup's 64 x 128 rows, staged as four TMA boxes of
        // [64 rows][32 columns] (128-byte swizzle), then stored by TMA
        // while the warpgroup goes on to its next item
        const int wg = warp >> 2;
        const bool issuer = (warp & 3) == 0 && lane == 0;
        const uint32_t cs = cstage + wg * (kCBytes / 2);
        if (issuer)  // the last item's store has read the staging
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        wg_sync(wg);
        const int rr = r0 - wg * 64;  // row within the warpgroup's 64
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rr + half * 8;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = j * 8 + 2 * t4;  // column, in box c / 32
            const uint32_t off = (c >> 5) * 8192 + r * 128 +
                                 ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                                 ((c & 3) << 2);
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(cs + off),
                         "f"(acc[4 * j + 2 * half]),
                         "f"(acc[4 * j + 2 * half + 1])
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(wg);
        if (issuer) {
          const int row = (int)w.m0 + wg * 64;
          const int z = (int)(g.segs == 1 ? w.b : w.seg * g.batch + w.b);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_store(&tm_c, cs + j * 8192, (int)w.n0 + 32 * j, row, z);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        continue;
      }
      float* out;
      long long sm, sn;
      if (g.segs == 1) {
        out = g.C + w.b * g.sc_b;
        sm = g.sc_m;
        sn = g.sc_n;
      } else {
        out = g.part + (w.seg * g.batch + w.b) * g.M * g.N;
        sm = g.N;
        sn = 1;
      }
      const bool vec = sn == 1 && sm % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = w.m0 + r0 + half * 8;
        if (row >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const long long col = w.n0 + j * 8 + 2 * t4;
          float* p = out + row * sm + col * sn;
          const float v0 = acc[4 * j + 2 * half];
          const float v1 = acc[4 * j + 2 * half + 1];
          if (vec && col + 1 < g.N) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (col < g.N) p[0] = v0;
            if (col + 1 < g.N) p[sn] = v1;
          }
        }
      }
    }
    if (g.c_tma && (warp & 3) == 0 && lane == 0)  // the stores are done
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (CS > 1) cluster_sync();
  }
}

// B (batch, K, N), any strides -> hi (and lo) (batch, N, Kp) bf16, K
// contiguous (zeros in [K, Kp)), through a 64 x 64 tile in shared memory:
// read along B's unit stride, written 16 bytes (8 of K) a thread
template <int PASSES>
__global__ void __launch_bounds__(256)
    split_b_kernel(const float* B, __nv_bfloat16* hi, __nv_bfloat16* lo,
                   long long K, long long N, long long Kp, long long sb_b,
                   long long sb_k, long long sb_n, int k_fast) {
  __shared__ float tile[64][65];  // [n][k]
  const long long k0 = (long long)blockIdx.x * 64, n0 = blockIdx.y * 64;
  const long long b = blockIdx.z;
  const float* Bb = B + b * sb_b;
  const int t = threadIdx.x;
#pragma unroll 4
  for (int e = t; e < 64 * 64; e += 256) {
    const int kk = k_fast ? e & 63 : e >> 6, nn = k_fast ? e >> 6 : e & 63;
    const long long k = k0 + kk, n = n0 + nn;
    tile[nn][kk] = (k < K && n < N) ? Bb[k * sb_k + n * sb_n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int c = t; c < 64 * 8; c += 256) {
    const int nn = c >> 3, kc = (c & 7) * 8;
    const long long n = n0 + nn, k = k0 + kc;
    if (n >= N || k >= Kp) continue;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = make_float2(tile[nn][kc + 2 * i],
                                   tile[nn][kc + 2 * i + 1]);
      split<PASSES>(v, h[i], l[i]);
    }
    const long long o = (b * N + n) * Kp + k;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    if (PASSES == 3)
      *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// C[b, m, n] = the partials of the segments added in segment order (0
// when there are none: K = 0)
__global__ void sum_segments_kernel(const float* part, float* C, long long M,
                                    long long N, long long batch, int segs,
                                    long long sc_b, long long sc_m,
                                    long long sc_n) {
  const long long total = batch * M * N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long n = i % N, m = (i / N) % M, b = i / (M * N);
    float s = 0.f;
    if (segs > 0) {
      s = part[i];
      for (int q = 1; q < segs; ++q) s += part[q * total + i];
    }
    C[b * sc_b + m * sc_m + n * sc_n] = s;
  }
}

// launch one instantiation on a persistent grid: as many clusters as
// can be resident at once (one block per SM), at most one per work item
template <int PASSES, bool KFAST, bool TMA, int CN>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& th,
                   const CUtensorMap& tl, const CUtensorMap& tc,
                   const Gemm& g, cudaStream_t s) {
  auto kernel = gemm_kernel<PASSES, KFAST, TMA, CN>;
  constexpr int CS = CN;
  static int resident = 0;  // clusters at once, found at the first launch
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<PASSES>::kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<PASSES>::kSmem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    int n = sms / CS;
    if (CS > 1) {
      cfg.gridDim = dim3(n * CS);
      if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) !=
          cudaSuccess)
        return err;
    }
    if (n < 1) return cudaErrorInvalidConfiguration;
    resident = n;
  }
  cfg.gridDim = dim3((unsigned)(g.items < resident ? g.items : resident) * CS);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, ta, th, tl, tc, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int PASSES>
cudaError_t launch_variant(bool tma, bool kfast, int cluster,
                           const CUtensorMap* maps, const Gemm& g,
                           cudaStream_t s) {
  const CUtensorMap &ta = maps[0], &th = maps[1], &tl = maps[2],
                    &tc = maps[3];
  if (!tma)
    return kfast ? launch<PASSES, true, false, 1>(ta, th, tl, tc, g, s)
                 : launch<PASSES, false, false, 1>(ta, th, tl, tc, g, s);
  if (cluster == 1)
    return kfast ? launch<PASSES, true, true, 1>(ta, th, tl, tc, g, s)
                 : launch<PASSES, false, true, 1>(ta, th, tl, tc, g, s);
  if (cluster == 4)
    return kfast ? launch<PASSES, true, true, 4>(ta, th, tl, tc, g, s)
                 : launch<PASSES, false, true, 4>(ta, th, tl, tc, g, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C[b] (M, N) = A[b] (M, K) @ B[b] (K, N) for b < batch, every operand f32
// with the element strides given (batch strides may be 0); passes 3
// ('high', bf16x3) or 1 ('default', bf16).  The plan (ops/precision.py::
// gemm_plan): `tma` 1 loads A by TMA (its base and strides meet TMA's
// rules), 0 by cp.async; `a_kfast` stages A K-fast (else M-fast); `seg_k`
// the K of a segment, a multiple of 64.  Scratch: `bsplit` holds 2 (or 1)
// x (batch or 1) x N x Kp bf16, Kp = K rounded up to 8; `part` (segments,
// batch, M, N) f32 when K > seg_k.  Returns a cudaError_t.
int pmg_bf16_gemm(const void* A, const void* B, void* C, long long M,
                  long long N, long long K, long long batch, long long sa_b,
                  long long sa_m, long long sa_k, long long sb_b,
                  long long sb_k, long long sb_n, long long sc_b,
                  long long sc_m, long long sc_n, int passes, int tma,
                  int a_kfast, int cluster, long long seg_k,
                  void* bsplit, void* part, void* stream) {
  if (M < 0 || N < 0 || K < 0 || batch < 1 || batch > 65535 ||
      (passes != 1 && passes != 3) || seg_k < kBK || seg_k % kBK != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long segs = (K + seg_k - 1) / seg_k;
  if (segs > 1 && !part) return (int)cudaErrorInvalidValue;
  const int sum_grid = (int)((batch * M * N + 255) / 256 < 4096
                                 ? (batch * M * N + 255) / 256
                                 : 4096);
  if (K == 0) {
    sum_segments_kernel<<<sum_grid, 256, 0, s>>>(nullptr, (float*)C, M, N,
                                                 batch, 0, sc_b, sc_m, sc_n);
    return (int)cudaGetLastError();
  }

  // B's hi (and lo), split once
  const long long bb = sb_b == 0 ? 1 : batch, Kp = (K + 7) / 8 * 8;
  if ((K + 63) / 64 > 0x7fffffffLL || (N + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(bsplit);
  __nv_bfloat16* lo = hi + bb * N * Kp;
  const dim3 sgrid((unsigned)((K + 63) / 64), (unsigned)((N + 63) / 64),
                   (unsigned)bb);
  const int b_kfast = sb_k == 1 || (sb_n != 1 && sb_k < sb_n);
  if (passes == 3)
    split_b_kernel<3><<<sgrid, 256, 0, s>>>(
        static_cast<const float*>(B), hi, lo, K, N, Kp, sb_b, sb_k, sb_n,
        b_kfast);
  else
    split_b_kernel<1><<<sgrid, 256, 0, s>>>(
        static_cast<const float*>(B), hi, lo, K, N, Kp, sb_b, sb_k, sb_n,
        b_kfast);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[4] = {};  // A, B hi, B lo, the output
  CUtensorMap &ta = maps[0], &th = maps[1], &tl = maps[2], &tc = maps[3];
  const long long bs = N * Kp * 2;  // bytes of one batch entry of hi
  if (!tma) cluster = 1;
  if (!encode(&th, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, hi, K, N, bb, Kp * 2,
              bs, kBK, kBN) ||
      (passes == 3 && !encode(&tl, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, lo, K,
                              N, bb, Kp * 2, bs, kBK, kBN)))
    return (int)cudaErrorInvalidValue;
  const bool a_bcast = sa_b == 0 || batch == 1;
  if (tma) {
    // K-fast: (K, M, batch) in boxes of 32 x 128; M-fast: (M, K, batch)
    // in boxes of 32 x 64
    const long long d0 = a_kfast ? K : M, d1 = a_kfast ? M : K;
    const long long s1 = d1 > 1 ? 4 * (a_kfast ? sa_m : sa_k)
                                : round16(4 * d0);
    const long long s2 = a_bcast ? s1 * d1 : 4 * sa_b;
    if (!encode(&ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, d0, d1,
                a_bcast ? 1 : batch, s1, s2, 32,
                a_kfast ? kBM / cluster : kBK))
      return (int)cudaErrorInvalidValue;
  }

  Gemm g;
  g.A = static_cast<const float*>(A);
  g.C = static_cast<float*>(C);
  g.part = static_cast<float*>(part);
  g.M = M;
  g.N = N;
  g.K = K;
  g.sa_b = sa_b;
  g.sa_m = sa_m;
  g.sa_k = sa_k;
  g.sc_b = sc_b;
  g.sc_m = sc_m;
  g.sc_n = sc_n;
  g.tiles_m = (M + kBM - 1) / kBM;
  g.tiles_n = (N + kBN - 1) / kBN;
  g.segs = segs;
  g.seg_stages = seg_k / kBK;
  g.batch = batch;
  // a cluster's work items: its row and column groups of tiles
  g.items = batch * segs * g.tiles_m * ((g.tiles_n + cluster - 1) / cluster);
  g.a_bcast = a_bcast;
  g.b_bcast = bb == 1;
  // the output by TMA where its rows are 16-byte aligned: C, or the
  // partials (segments x batch, M, N), contiguous
  const float* cbase = segs == 1 ? static_cast<const float*>(C)
                                 : static_cast<const float*>(part);
  const long long csm = segs == 1 ? sc_m : N, csb = segs == 1 ? sc_b : M * N;
  const long long cz = segs == 1 ? batch : segs * batch;
  g.c_tma = (segs > 1 || sc_n == 1) &&
            reinterpret_cast<uintptr_t>(cbase) % 16 == 0 &&
            (M == 1 || (csm % 4 == 0 && csm >= N)) &&
            (cz == 1 || (csb % 4 == 0 && csb > 0));
  if (g.c_tma &&
      !encode(&tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cbase, N, M, cz,
              M > 1 ? 4 * csm : round16(4 * N),
              cz > 1 ? 4 * csb : (M > 1 ? 4 * csm : round16(4 * N)) * M, 32,
              64))
    return (int)cudaErrorInvalidValue;
  err = passes == 3 ? launch_variant<3>(tma, a_kfast, cluster, maps, g, s)
                    : launch_variant<1>(tma, a_kfast, cluster, maps, g, s);
  if (err != cudaSuccess || segs == 1) return (int)err;
  sum_segments_kernel<<<sum_grid, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(C), M, N, batch,
      (int)segs, sc_b, sc_m, sc_n);
  return (int)cudaGetLastError();
}

}  // extern "C"

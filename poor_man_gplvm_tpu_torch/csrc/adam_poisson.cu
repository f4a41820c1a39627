// One trip of the batched Adam runner on the Poisson M-step objective, fused:
// the objective, its gradient and optax's Adam update of B independent runs
// in one pass over each run's statistics, with a plain C interface loaded
// through ctypes by poor_man_gplvm_tpu_torch/ops/mstep.py.
//
// Not the port of a Pallas kernel: the JAX package's M-step is XLA's
// autodiff of poisson_m_step_objective under a vmapped while loop.  The
// port's autograd trip is some seventy kernels, each a pass over the
// (B, L, N) tuning; this replaces it by two launches.
//
// Per run b, with X = basis @ W (L x N), pf = softplus(X) = logaddexp(X, 0)
// and the grouped statistics yw (L x N), t (L):
//   loss = sum_{l,n} [pf t - xlogy(yw, pf + 1e-20)]
//          + sum_{k,n} (log(2 pi s^2) + W^2 / s^2) / 2,
//   grad = basis^T G + W / s^2,  G = sigmoid(X) (t - yw / (pf + 1e-20)),
// and then Adam in optax's order (moment EMAs, count + 1, the bias
// corrections 1 - b^count, mu_hat / (sqrt(nu_hat) + eps), times -step_size),
// each operation rounded on its own as PyTorch's elementwise kernels round
// it, so the update of a gradient has the bits of ops/mstep.py::adam_update.
//
// adam_trip_kernel (A), one block per (run, tile of 64 neurons): a neuron's
// gradient depends on its own column of the tuning alone, so a block owns
// W[b, :, n0:n0+64] with its mu and nu and shares nothing.  It walks the
// latent bins in chunks of 64: X's chunk = basis chunk @ W tile (FFMA, f32,
// W resident in shared memory), G in registers, written over the chunk's
// yw in shared memory, grad tile += basis chunk^T @ G (the accumulator in
// registers, a thread 4 neurons x TM2 basis rows).  The next chunk's yw, t
// and basis rows come by cp.async into a second buffer while a chunk is
// computed; the wrapper hands the basis transposed, (K, Lp) with rows
// padded to whole 16-byte copies, and rows of yw, W, mu and nu move in 16
// bytes where N is a multiple of 4.  G is sigmoid(X) (t - yw / p) as
// a (t p - yw) / ((1 + e) p), e = exp(-|X|), a = 1 or e: one division (an
// approximate one, 2 ulp) where two correctly rounded ones had slow paths
// to branch to.  Then the prior, Adam, and the block's partial sums of the
// loss and of grad^2 (f64, a fixed tree: a replay gives the same bits).
// The basis rows are taken in groups of KG = 16 TM2 (TM2 = ceil(K / 16) up
// to 8); where K is above 128 the block runs its chunks once per group of
// gradient rows, recomputing X from the basis in slabs of KG (loaded
// without overlap), and then writes W out of place (a later group's X
// reads the old W).  A stopped run's block does nothing (its entries keep
// their bits).  Evaluation mode (no `active`): the loss and grad^2
// partials of every run, no update.
//
// Bound: operations.  4 B L K N (two products) = 4.93e9 at the sweep's
// (64, 500, 77, 500): ~74 us at the CUDA cores' 67 TFLOP/s; the bytes, yw
// once (64 MB), W, mu and nu read and written (~60 MB), take ~37 us at
// 3.35 TB/s.  The products read shared memory at under one wavefront a
// clock per SM at the full FFMA rate (float4 loads of 4 x 4 register
// tiles; the basis chunk transposed, rows padded to 68 floats).  Measured
// there: ~0.24 ms a trip, the products about half of it, the data movement
// and the block's barriers most of the rest (two blocks of 256 threads an
// SM: 128 registers a thread).  f32 products throughout (the M-step's
// products stay f32 at every matmul precision); no tensor cores, no float
// atomics.
//
// adam_finish_kernel (B), a thread a run: the run's partials summed in
// order, the loss in f32 and the error sqrt(sum grad^2), and the runner's
// (B,) state of the trip: for a live run loss_prev <- loss, loss, error,
// count + 1, n_iter <- step + 1; the histories' column `step` (0 for a
// stopped run).  The step is a host integer or read from the card (the
// runner's CUDA graph keeps it in a (1,) tensor).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 64;               // neurons a block
constexpr int kCG = kNT / 4;          // column groups: 4 neurons a thread
constexpr int kRG = kThreads / kCG;   // row groups: 16
constexpr int kTM1 = 4;               // X rows a thread
constexpr int kLC = kRG * kTM1;       // latent bins a chunk: 64
constexpr int kLCP = kLC + 4;         // a transposed basis row, padded
constexpr int kMaxTM2 = 8;            // basis rows a thread: KG <= 128

constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
// PyTorch's float of the Python doubles 1 - 0.9 and 1 - 0.999
constexpr float kOneMinusB1 = 0.1f, kOneMinusB2 = 0.001f;
constexpr float kTwoPi = 6.2831855f;  // float(2 * math.pi)
constexpr float kFloor = 1e-20f;      // the objective's floor in xlogy

// shared memory of kernel A: the W slab [KG][kNT], two buffers of the
// basis chunk transposed [KG][kLCP] and two of the statistics' chunk
// [kLC][kNT] (G overwrites it in place) and [kLC]
template <int TM2>
constexpr int smem_floats() {
  return kRG * TM2 * kNT + 2 * kRG * TM2 * kLCP + 2 * kLC * kNT + 2 * kLC;
}

// a 4-byte asynchronous copy to shared memory, zeros where !valid
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a 16-byte asynchronous copy to shared memory of `bytes` (0 or 16; zeros
// past them)
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct TripArgs {
  const float* W_in;
  float* W_out;
  float* mu;
  float* nu;
  const float* basis_t;        // [K][Lp] a run: the basis transposed
  long long basis_run_stride;  // 0: one basis for every run
  const float* yw;
  const float* tw;
  const float* prior_std;
  const int* count;
  const uint8_t* active;  // nullptr: evaluation only
  double* part_loss;
  double* part_gsq;
  int L, Lp, K, N, n_tiles;
  float step_size;
};

__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// the first nc (<= 4) floats at p, as one 16-byte access where `vec`
__device__ __forceinline__ void load4(float* out, const float* p, int nc,
                                      bool vec) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    for (int c = 0; c < nc; ++c) out[c] = p[c];
  }
}

__device__ __forceinline__ void store4(float* p, const float* in, int nc,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    for (int c = 0; c < nc; ++c) p[c] = in[c];
  }
}

template <int TM2>
__global__ void __launch_bounds__(kThreads, 2)
    adam_trip_kernel(const TripArgs a) {
  constexpr int KG = kRG * TM2;
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [KG][kNT]: W slab
  float* Bc0 = Ws + KG * kNT;                   // [2][KG][kLCP]: basis^T
  float* Ys0 = Bc0 + 2 * KG * kLCP;             // [2][kLC][kNT]: yw, then G
  float* Ts0 = Ys0 + 2 * kLC * kNT;             // [2][kLC]: t
  __shared__ double red[kThreads / 32];

  const int tile = blockIdx.x, b = blockIdx.y;
  const int n0 = tile * kNT;
  const int t = threadIdx.x, cg = t % kCG, rg = t / kCG;
  const int L = a.L, K = a.K, N = a.N;
  const size_t off = (size_t)b * K * N;
  const float* W_in = a.W_in + off;
  const bool update = a.active != nullptr;
  if (update && !a.active[b]) {  // a stopped run: every entry as it was
    if (a.W_out != a.W_in)
      for (int i = t; i < K * kNT; i += kThreads) {
        const int n = n0 + i % kNT, k = i / kNT;
        if (n < N) a.W_out[off + (size_t)k * N + n] = W_in[(size_t)k * N + n];
      }
    return;
  }
  const float* bt = a.basis_t + b * a.basis_run_stride;
  const int Lp = a.Lp;
  // rows of N floats are 16-byte aligned: vector loads, stores and copies
  const bool vec = (N & 3) == 0;
  const float* yw = a.yw + (size_t)b * L * N;
  const float* tw = a.tw + (size_t)b * L;
  const int n_slabs = (K + KG - 1) / KG;
  const int n_chunks = (L + kLC - 1) / kLC;

  auto load_w = [&](int k0) {
    for (int i = t; i < KG * kCG; i += kThreads) {
      const int kk = i / kCG, k = k0 + kk, n = n0 + (i % kCG) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && vec && n < N) {
        v = *reinterpret_cast<const float4*>(&W_in[(size_t)k * N + n]);
      } else if (k < K) {
        float* e = reinterpret_cast<float*>(&v);
        for (int c = 0; c < 4 && n + c < N; ++c) e[c] = W_in[(size_t)k * N + n + c];
      }
      *reinterpret_cast<float4*>(&Ws[kk * kNT + (i % kCG) * 4]) = v;
    }
  };
  // the basis rows [k0, k0 + KG) of the chunk at l0, transposed
  auto copy_basis = [&](float* Bc, int k0, int l0) {
    for (int i = t; i < KG * (kLC / 4); i += kThreads) {
      const int kk = i / (kLC / 4), ll = (i % (kLC / 4)) * 4;
      const int k = k0 + kk, l = l0 + ll;
      const bool ok = k < K && l < Lp;  // Lp: zeros past L, 4 floats a copy
      cp16(&Bc[kk * kLCP + ll], ok ? &bt[(size_t)k * Lp + l] : bt,
           ok ? 16 : 0);
    }
  };
  // chunk q of the pass (q = group * n_chunks + chunk) into buffer q & 1:
  // its statistics, and its basis where one slab holds every row
  auto stage = [&](int q) {
    const int l0 = (q % n_chunks) * kLC, buf = q & 1;
    float* Ys = Ys0 + buf * kLC * kNT;
    if (vec) {
      for (int i = t; i < kLC * kCG; i += kThreads) {
        const int ll = i / kCG, nn = (i % kCG) * 4, l = l0 + ll, n = n0 + nn;
        const bool ok = l < L && n < N;
        cp16(&Ys[ll * kNT + nn], ok ? &yw[(size_t)l * N + n] : yw,
             ok ? 16 : 0);
      }
    } else {
      for (int i = t; i < kLC * kNT; i += kThreads) {
        const int ll = i / kNT, nn = i % kNT, l = l0 + ll, n = n0 + nn;
        const bool ok = l < L && n < N;
        cp4(&Ys[i], ok ? &yw[(size_t)l * N + n] : yw, ok);
      }
    }
    if (t < kLC) cp4(&Ts0[buf * kLC + t], l0 + t < L ? &tw[l0 + t] : tw,
                     l0 + t < L);
    if (n_slabs == 1) copy_basis(Bc0 + buf * KG * kLCP, 0, l0);
    cp_commit();
  };

  if (n_slabs == 1) load_w(0);  // W resident for the whole pass
  stage(0);
  double loss = 0.0, gsq = 0.0;
  for (int g = 0; g < n_slabs; ++g) {
    float acc[TM2][4];
#pragma unroll
    for (int j = 0; j < TM2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

    for (int ci = 0; ci < n_chunks; ++ci) {
      const int q = g * n_chunks + ci, l0 = ci * kLC;
      float* Bc = Bc0 + (q & 1) * KG * kLCP;
      float* Ys = Ys0 + (q & 1) * kLC * kNT;
      const float* Ts = Ts0 + (q & 1) * kLC;
      cp_wait_all();
      __syncthreads();  // chunk q landed; chunk q - 1's readers are done
      if (q + 1 < n_slabs * n_chunks) stage(q + 1);
      float x[kTM1][4];
#pragma unroll
      for (int i = 0; i < kTM1; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[i][c] = 0.f;
      for (int s = 0; s < n_slabs; ++s) {
        const int k0 = s * KG;
        if (n_slabs > 1) {  // W and the basis slab by slab, not overlapped
          __syncthreads();
          load_w(k0);
          copy_basis(Bc, k0, l0);
          cp_commit();
          cp_wait_all();
          __syncthreads();
        }
        const int kmax = min(KG, K - k0);
#pragma unroll 4
        for (int k = 0; k < kmax; ++k) {
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bc[k * kLCP + rg * kTM1]);
          const float4 wv =
              *reinterpret_cast<const float4*>(&Ws[k * kNT + cg * 4]);
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
          const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < kTM1; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) x[i][c] = fmaf(bb[i], ww[c], x[i][c]);
        }
      }
      // G = sigmoid(X) (t - yw / (pf + floor)) over yw's own entries (each
      // thread reads and writes the same ones); the likelihood's terms
#pragma unroll
      for (int i = 0; i < kTM1; ++i) {
        const int ll = rg * kTM1 + i, l = l0 + ll;
        float4* yrow = reinterpret_cast<float4*>(&Ys[ll * kNT + cg * 4]);
        const float4 yv4 = *yrow;
        const float yy[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
        const float tt = Ts[ll];
        float gr[4], part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + cg * 4 + c;
          const bool valid = l < L && n < N;
          const float xv = x[i][c];
          const float e = expf(-fabsf(xv));
          const float pf = fmaxf(xv, 0.f) + log1pf(e);  // logaddexp(x, 0)
          const float p = pf + kFloor;
          const float yv = yy[c];
          // sigmoid(x) (t - y / p) = a (t p - y) / ((1 + e) p), a = 1 or e:
          // one division, with no slow path to branch to
          const float a = xv >= 0.f ? 1.f : e;
          gr[c] = valid ? __fdividef(a * (tt * p - yv), (1.f + e) * p) : 0.f;
          // pf t - xlogy(y, p): y log p is 0 where y is (p >= 1e-20)
          part += valid ? pf * tt - yv * logf(p) : 0.f;
        }
        if (g == 0) loss += (double)part;
        *yrow = make_float4(gr[0], gr[1], gr[2], gr[3]);
      }
      if (n_slabs > 1 && g != n_slabs - 1) {  // this group's basis rows
        __syncthreads();
        copy_basis(Bc, g * KG, l0);
        cp_commit();
        cp_wait_all();
      }
      __syncthreads();
      // grad rows rg + 16 j of the group += basis chunk^T @ G chunk
#pragma unroll 2
      for (int l = 0; l < kLC; l += 4) {
        float gv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Ys[(l + r) * kNT + cg * 4]);
          gv[r][0] = v.x, gv[r][1] = v.y, gv[r][2] = v.z, gv[r][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TM2; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(
              &Bc[(rg + j * kRG) * kLCP + l]);
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] = fmaf(bb[r], gv[r][c], acc[j][c]);
        }
      }
    }

    // the prior, then Adam on the group's rows
    const float sd = a.prior_std[b];
    const float var = sd * sd;
    const float log_norm = logf(kTwoPi * var);
    float c1 = 0.f, c2 = 0.f;
    if (update) {
      const float cnt = (float)(a.count[b] + 1);
      c1 = 1.f - powf(kB1, cnt);
      c2 = 1.f - powf(kB2, cnt);
    }
#pragma unroll
    for (int j = 0; j < TM2; ++j) {
      const int k = g * KG + rg + j * kRG, n = n0 + cg * 4;
      if (k >= K || n >= N) continue;
      const int nc = min(4, N - n);
      const size_t idx = (size_t)k * N + n;
      float w[4] = {0.f, 0.f, 0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f},
            v[4] = {0.f, 0.f, 0.f, 0.f};
      load4(w, W_in + idx, nc, vec);
      if (update) {
        load4(m, a.mu + off + idx, nc, vec);
        load4(v, a.nu + off + idx, nc, vec);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nc) continue;
        const float gr = acc[j][c] + w[c] / var;
        gsq += (double)gr * gr;
        loss += 0.5 * ((double)log_norm + (double)((w[c] * w[c]) / var));
        if (!update) continue;
        m[c] = __fadd_rn(__fmul_rn(kOneMinusB1, gr), __fmul_rn(kB1, m[c]));
        v[c] = __fadd_rn(__fmul_rn(kOneMinusB2, __fmul_rn(gr, gr)),
                         __fmul_rn(kB2, v[c]));
        const float u = __fdiv_rn(
            __fdiv_rn(m[c], c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v[c], c2)),
                                           kEps));
        w[c] = __fadd_rn(w[c], __fmul_rn(-a.step_size, u));
      }
      if (update) {
        store4(a.mu + off + idx, m, nc, vec);
        store4(a.nu + off + idx, v, nc, vec);
        store4(a.W_out + off + idx, w, nc, vec);
      }
    }
  }
  loss = block_sum(loss, red);
  gsq = block_sum(gsq, red);
  if (t == 0) {
    a.part_loss[(size_t)b * a.n_tiles + tile] = loss;
    a.part_gsq[(size_t)b * a.n_tiles + tile] = gsq;
  }
}

struct FinishArgs {
  const double* part_loss;
  const double* part_gsq;
  int B, n_tiles;
  const uint8_t* active;  // nullptr: evaluation (loss and error only)
  float* loss;
  float* loss_prev;
  float* error;
  int* count;
  long long* n_iter;
  float* loss_hist;
  float* err_hist;
  int maxiter;
  const long long* step_ptr;  // nullptr: `step`
  long long step;
};

__global__ void adam_finish_kernel(const FinishArgs f) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= f.B) return;
  double sl = 0.0, sg = 0.0;
  for (int i = 0; i < f.n_tiles; ++i) {
    sl += f.part_loss[(size_t)b * f.n_tiles + i];
    sg += f.part_gsq[(size_t)b * f.n_tiles + i];
  }
  const float loss = (float)sl, err = (float)sqrt(sg);
  if (f.active == nullptr) {
    f.loss[b] = loss;
    f.error[b] = err;
    return;
  }
  const long long step = f.step_ptr ? *f.step_ptr : f.step;
  const bool live = f.active[b] != 0;
  if (live) {
    f.loss_prev[b] = f.loss[b];
    f.loss[b] = loss;
    f.error[b] = err;
    f.count[b] += 1;
    f.n_iter[b] = step + 1;
  }
  f.loss_hist[(size_t)b * f.maxiter + step] = live ? loss : 0.f;
  f.err_hist[(size_t)b * f.maxiter + step] = live ? err : 0.f;
}

template <int TM2>
cudaError_t launch_trip(const TripArgs& a, int B, cudaStream_t s) {
  auto kernel = adam_trip_kernel<TM2>;
  const int bytes = smem_floats<TM2>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_tiles, B), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A over B runs: W_in, W_out, mu, nu (B, K, N); basis_t the basis
// transposed, (K, Lp) with basis_run_stride 0, or (B, K, Lp) with stride
// K Lp, Lp a multiple of 4 >= L, zeros past L; yw (B, L, N); tw (B, L);
// prior_std (B,); count (B,) int32, the Adam count before the trip; active
// (B,) bool, or null for evaluation only; part_loss, part_gsq (B,
// ceil(N / 64)) f64.  All f32 and contiguous.  W_out may be W_in where
// K <= 128.  Returns a cudaError_t.
int pmg_adam_poisson_trip(const void* W_in, void* W_out, void* mu, void* nu,
                          const void* basis_t, long long basis_run_stride,
                          const void* yw, const void* tw,
                          const void* prior_std, const void* count,
                          const void* active, void* part_loss,
                          void* part_gsq, int B, int L, int Lp, int K, int N,
                          float step_size, void* stream) {
  if (B < 1 || L < 1 || K < 1 || N < 1 || B > 65535 || Lp < L || Lp % 4)
    return (int)cudaErrorInvalidValue;
  const int tm2 = (K + kRG - 1) / kRG;
  if (active != nullptr && tm2 > kMaxTM2 && W_out == W_in)
    return (int)cudaErrorInvalidValue;
  TripArgs a{static_cast<const float*>(W_in), static_cast<float*>(W_out),
             static_cast<float*>(mu), static_cast<float*>(nu),
             static_cast<const float*>(basis_t), basis_run_stride,
             static_cast<const float*>(yw), static_cast<const float*>(tw),
             static_cast<const float*>(prior_std),
             static_cast<const int*>(count),
             static_cast<const uint8_t*>(active),
             static_cast<double*>(part_loss), static_cast<double*>(part_gsq),
             L, Lp, K, N, (N + kNT - 1) / kNT, step_size};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm2 < kMaxTM2 ? tm2 : kMaxTM2) {
    case 1: return (int)launch_trip<1>(a, B, s);
    case 2: return (int)launch_trip<2>(a, B, s);
    case 3: return (int)launch_trip<3>(a, B, s);
    case 4: return (int)launch_trip<4>(a, B, s);
    case 5: return (int)launch_trip<5>(a, B, s);
    case 6: return (int)launch_trip<6>(a, B, s);
    case 7: return (int)launch_trip<7>(a, B, s);
    default: return (int)launch_trip<8>(a, B, s);
  }
}

// Kernel B: the runs' loss and error from kernel A's partials, and with
// `active` the trip's state (loss, loss_prev, error (B,) f32, count (B,)
// int32, n_iter (B,) int64, the histories (B, maxiter) f32 at column step,
// read from step_ptr (int64 on the card) where it is not null).  Returns a
// cudaError_t.
int pmg_adam_poisson_finish(const void* part_loss, const void* part_gsq,
                            int B, int n_tiles, const void* active,
                            void* loss, void* loss_prev, void* error,
                            void* count, void* n_iter, void* loss_hist,
                            void* err_hist, int maxiter, const void* step_ptr,
                            long long step, void* stream) {
  if (B < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  FinishArgs f{static_cast<const double*>(part_loss),
               static_cast<const double*>(part_gsq), B, n_tiles,
               static_cast<const uint8_t*>(active), static_cast<float*>(loss),
               static_cast<float*>(loss_prev), static_cast<float*>(error),
               static_cast<int*>(count), static_cast<long long*>(n_iter),
               static_cast<float*>(loss_hist), static_cast<float*>(err_hist),
               maxiter, static_cast<const long long*>(step_ptr), step};
  constexpr int kFinishThreads = 128;
  adam_finish_kernel<<<(B + kFinishThreads - 1) / kFinishThreads,
                       kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f);
  return (int)cudaGetLastError();
}

}  // extern "C"

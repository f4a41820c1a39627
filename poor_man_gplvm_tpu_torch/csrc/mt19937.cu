// The random initial posterior of a fit, drawn on the card from the CPU
// torch.Generator's own MT19937 stream, bit for bit, with a plain C
// interface loaded through ctypes by poor_man_gplvm_tpu_torch/ops/rng.py.
//
// Not the port of a Pallas kernel: the JAX package draws its initial
// posterior with jax.random; the port draws it from a CPU torch.Generator,
// torch.rand((T, L), generator=g) * scale, which on the host is 5e7
// serial draws at T = 1e5, L = 500 (0.5 s on one core).  A CPU generator is
// at::mt19937, and a float32 uniform is (w & 0xFFFFFF) * 2^-24 of one
// tempered 32-bit output w.  The generator's state (its 624 words and the
// number of them read) is public, so these kernels draw the same floats
// and give back the words the generator ends with.
//
// mt_draw_kernel (A), one block: the MT19937 recurrence.  A twist renews
// the 624 words; new word i reads old words i and i + 1 and word i + 397,
// old below i = 227 and new (i - 227) from there on: three phases, [0,
// 227), [227, 454), [454, 624) (word 623 reads the new word 0).  Thread t
// computes word t of each phase, so the phases chain in its registers and
// a twist takes one barrier; the words are double-buffered in shared
// memory for the neighbours' old words.  Each thread tempers and stores
// the previous twist's words it holds while its loads are in flight.  The
// output is in stream order from the generator's position; each float is
// scale * uniform in one f32 multiply, the host's `* scale`.  Bound: the
// chain of one barrier and a shared-memory round trip a twist (80,128
// twists for 5e7 floats), not the 4 bytes a float (200 MB, 0.06 ms at
// 3.35 TB/s).
//
// mt_normalise_kernel (B), a warp a row: offset + u in f32 (the host's
// add), the row's sum in f64 rounded once to f32, the f32 quotient and its
// log, a zero's log floored at `zero_log` (the models' JOINT_ACC_INIT);
// post in place, log_post beside it.  The host recipe sums in f32 in
// another order, so the posterior is within a few ulps of it (5 at most
// in 4e8 entries).  Bound: bytes (one read, two writes of T x L floats).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 624;            // MT19937 words
constexpr int kM = 397;            // the recurrence's offset
constexpr int kPhase = kN - kM;    // 227: the words one phase renews
constexpr int kThreads = 256;      // >= kPhase
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7fffffffu;

__device__ __forceinline__ uint32_t twist(uint32_t u, uint32_t v) {
  return (((u & kUpper) | (v & kLower)) >> 1) ^ ((v & 1u) ? kMatrixA : 0u);
}

__device__ __forceinline__ float uniform(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= y >> 18;
  return (float)(y & 0xFFFFFFu) * 5.9604644775390625e-08f;  // 2^-24, exact
}

// Store the word `y` whose output index is `o`, if it is one of the n.
__device__ __forceinline__ void emit(uint32_t y, long long o, long long n,
                                     float scale, float* out) {
  if (o >= 0 && o < n) out[o] = __fmul_rn(uniform(y), scale);
}

// Thread t < 227 owns words t, t + 227 and t + 454 (the last for t < 170)
// in registers.  New word t + 227 reads new word t and new word t + 454
// reads new word t + 227, the thread's own, so a twist needs the others'
// old words only: one barrier a twist, between the buffers.  Word 623
// reads the new word 0, which its thread (169) computes again from old
// words.
__global__ void __launch_bounds__(kThreads, 1)
    mt_draw_kernel(const uint32_t* __restrict__ state_in, int pos,
                   long long n, long long twists, float scale,
                   float* __restrict__ out, uint32_t* __restrict__ state_out) {
  __shared__ uint32_t buf[2][kN];
  const int t = threadIdx.x;
  const bool own = t < kPhase, third = t < kN - 2 * kPhase;
  for (int i = t; i < kN; i += kThreads) buf[0][i] = state_in[i];
  uint32_t r0 = 0, r1 = 0, r2 = 0;
  if (own) {
    r0 = state_in[t];
    r1 = state_in[t + kPhase];
    if (third) r2 = state_in[t + 2 * kPhase];
  }
  __syncthreads();
  for (long long k = 1; k <= twists; ++k) {
    const uint32_t* o = buf[(k - 1) & 1];
    uint32_t* w = buf[k & 1];
    if (own) {
      const uint32_t a = o[t + 1], m = o[t + kM], b = o[t + kPhase + 1];
      uint32_t c = 0;
      if (t == kN - 2 * kPhase - 1)  // word 623 wraps to the new word 0
        c = o[kM] ^ twist(o[0], o[1]);
      else if (third)
        c = o[t + 2 * kPhase + 1];
      // the previous twist's words (block k - 1), stored meanwhile
      const long long base = (k - 1) * kN - pos + t;
      emit(r0, base, n, scale, out);
      emit(r1, base + kPhase, n, scale, out);
      if (third) emit(r2, base + 2 * kPhase, n, scale, out);
      r0 = m ^ twist(r0, a);
      r1 = r0 ^ twist(r1, b);
      w[t] = r0;
      w[t + kPhase] = r1;
      if (third) {
        r2 = r1 ^ twist(r2, c);
        w[t + 2 * kPhase] = r2;
      }
    }
    __syncthreads();
  }
  if (own) {
    const long long base = twists * kN - pos + t;
    emit(r0, base, n, scale, out);
    emit(r1, base + kPhase, n, scale, out);
    state_out[t] = r0;
    state_out[t + kPhase] = r1;
    if (third) {
      emit(r2, base + 2 * kPhase, n, scale, out);
      state_out[t + 2 * kPhase] = r2;
    }
  }
}

__global__ void mt_normalise_kernel(float* __restrict__ post,
                                    float* __restrict__ log_post,
                                    long long rows, int cols, float offset,
                                    float zero_log) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float* p = post + row * cols;
  float* lp = log_post + row * cols;
  // the row's sum in f64, rounded once to f32: within a few ulps of the
  // host's f32 sum, whatever order that adds in
  double sum = 0.0;
  for (int j = lane; j < cols; j += 32) sum += __fadd_rn(offset, p[j]);
  for (int m = 16; m > 0; m >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  const float total = __double2float_rn(sum);
  for (int j = lane; j < cols; j += 32) {
    const float q = __fdiv_rn(__fadd_rn(offset, p[j]), total);
    p[j] = q;
    lp[j] = q == 0.0f ? zero_log : logf(q);
  }
}

}  // namespace

extern "C" {

// Draw n floats of the stream whose 624 words are `state_in` and of which
// `pos` words are read (624: the next draw twists first) into `out`, each
// times `scale`, and write the words the stream ends with to `state_out`
// (both 624 uint32 on the card).  Returns a cudaError_t.
int pmg_mt_draw(const void* state_in, int pos, long long n, float scale,
                void* out, void* state_out, void* stream) {
  if (pos < 0 || pos > kN || n < 0) return (int)cudaErrorInvalidValue;
  const long long twists = n == 0 ? 0 : (pos + n - 1) / kN;
  mt_draw_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state_in), pos, n, twists, scale,
      static_cast<float*>(out), static_cast<uint32_t*>(state_out));
  return (int)cudaGetLastError();
}

// Normalise each of `rows` rows of `cols` floats of `post` in place after
// adding `offset`, and write their logs (zeros at `zero_log`) to
// `log_post`.  Returns a cudaError_t.
int pmg_mt_normalise(void* post, void* log_post, long long rows, int cols,
                     float offset, float zero_log, void* stream) {
  if (rows < 0 || cols < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  constexpr int kRowsPerBlock = 8;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mt_normalise_kernel<<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(post), static_cast<float*>(log_post), rows, cols,
      offset, zero_log);
  return (int)cudaGetLastError();
}

}  // extern "C"

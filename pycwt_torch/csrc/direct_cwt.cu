// Small-nfft CWT (nfft <= 2^12) as one on-chip inverse FFT per row, on Hopper.
//
// Replaces the third Pallas TPU kernel of pycwt_tpu/ops/pallas_fft.py,
// _make_kernel_direct (:360-403, launched by _fused_cwt_small at :448-496).
// The function is the TPU kernel's: for a planar spectrum X of K bins (K = N,
// or K = N/2 for analytic mothers, which read only k < N/2 even of a full
// spectrum) and S scales,
//
//   W[s, t] = (1/N) sum_{k<K} X[k] * Hbar_s[k] * e^{+2 pi i k t / N}
//
// with Hbar_s the envelope * norm * conj(psi_ft_const) of cwt_stage_a, and
// bins k >= N/2 folded to k - N when K = N.  The TPU computed it as a direct
// DFT (four real MXU matmuls against a K x N table); this kernel computes it
// as an inverse FFT in O(N log N).
//
// Design: one block owns whole rows (signal b, scale s): one row for
// N >= 1024, 1024/N rows below, N/16 threads per row.  A row never leaves
// the block, so there is no second launch, no round trip through device
// memory and no sum across blocks: a batch gives the same bits as single
// calls in every output mode.  Per row:
//   1. Filter and first pass.  Each thread loads bins k = lt + r*N/16 of X
//      (r < 16, coalesced along k; only r < 8 when K = N/2, so the zero upper
//      half is never read) before anything else, so that their latency hides
//      under the twiddle build; then it builds Hbar_s[k] in registers,
//      multiplies, and runs a 16-point DFT on them.
//   2. Stockham (autosort) passes: 2^8 = 16*16, 2^9..2^12 = 16*16*(N/256)
//      (ops/fused_cwt.py's _direct_radix_plan; the wrapper passes the plan and
//      the launch refuses any other).  Each pass reads its R inputs from
//      shared memory, multiplies by the twiddles, runs an R-point DFT in
//      registers (radix-2 stages with exact constants) and writes back in the
//      next pass's order: no bit-reversal pass.  The exchange buffer is padded
//      by one slot in 16, so that no pass conflicts on the banks.  Pass 2's
//      twiddles come from a 256-entry table laid out [r][butterfly] (a
//      half-warp reads 16 consecutive entries), pass 3's from the product of
//      two tables of 64 and N/64 roots: a full N-entry table took longer to
//      build in every block than the passes it fed.  Every entry is sincospif
//      of an exact f32 argument.
//   3. Epilogue.  The last pass writes straight to device memory: 1/N, then
//      W planes or |W|^2 (coalesced along t), or Sigma_t |W|^2 summed in a
//      fixed order (per thread, then a tree over the row's threads).
// No fast-math intrinsics (expf, logf, sincospif), as in fused_cwt.cu.
//
// Bound on the card: bytes.  At the WCT shape of a 4,000-point pair (B = 2,
// S = 133, K = 2048, N = 4096, planes) the function reads 16 KB of X per
// signal and writes 8.7 MB of W: 2.6 us at 3.35 TB/s.  Its FFT-route
// arithmetic is 6.9e7 flops, 1 us at the 67 TFLOP/s f32 peak.  No wgmma, TMA
// or clusters: no GEMM is left, and the input is 16 KB per signal, read from
// L2 by all S rows.  The tensor cores would not serve this function at the
// `highest` tier (1e-5 of max|W|) in any case: bf16 misses it, and the direct
// DFT in 3xTF32 would take 3 * 8*S*K*N = 5.4e10 flops, 0.108 ms at 495 TFLOP/s,
// where cuFFT takes 0.0115 ms of device time for the whole function (NVIDIA
// H100 80GB HBM3, 700.00 W, chip_smoke.py).  Short of the byte bound, the
// kernel is held back by latency: at that shape each SM runs only two blocks
// of eight warps, each waiting on its chain of X loads, filter, three passes
// and barriers (PERF.md).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
// Points per block at least: rows of shorter series share a block
// (_DIRECT_BLOCK_POINTS in ops/fused_cwt.py).
constexpr int kMinPoints = 1024;

enum Mother { kMorlet = 0, kPaul = 1, kDog = 2 };
enum Mode { kPlanes = 0, kPower = 1, kPowerSum = 2 };

// The launch shape and shared memory of one size N = 2^LOG_N.
template <int LOG_N>
struct Plan {
  static constexpr int kN = 1 << LOG_N;
  static constexpr int kPoints = kN > kMinPoints ? kN : kMinPoints;
  static constexpr int kRows = kPoints / kN;        // rows per block
  static constexpr int kThreads = kPoints / 16;     // a 16-point DFT each
  static constexpr int kRowThreads = kN / 16;       // threads per row
  static constexpr int kLast = kN / 256;            // third radix; 1: no third pass
  static constexpr int kData = kPoints + kPoints / 16;         // padded slots
  static constexpr int kTw = 256 + (kLast > 1 ? 64 + kN / 64 : 0);   // twiddles
  static constexpr size_t kSmem = sizeof(float2) * (kData + kTw);
};

__device__ __forceinline__ float int_pow(float x, int m) {
  float r = 1.0f;
  float base = x;
  while (m) {
    if (m & 1) r *= base;
    m >>= 1;
    if (m) base *= base;
  }
  return r;
}

// Real envelope env(f) of the mother's spectrum (mothers.py), as fused_cwt.cu.
__device__ __forceinline__ float envelope(int mother, float f, float f0, int m) {
  if (mother == kMorlet) {
    float d = f - f0;
    return expf(-0.5f * (d * d));
  }
  if (mother == kPaul) {
    return f > 0.0f ? expf((float)m * logf(f) - f) : 0.0f;
  }
  return int_pow(f, m) * expf(-0.5f * (f * f));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// v * e^{+2 pi i q / 16} for 0 <= q < 8; 1 and i exactly.
__device__ __forceinline__ float2 rot16(float2 v, int q) {
  constexpr float c1 = 0.92387953251128674f;   // cos(pi/8)
  constexpr float s1 = 0.38268343236508978f;   // sin(pi/8)
  constexpr float h = 0.70710678118654752f;    // cos(pi/4)
  switch (q) {
    case 0: return v;
    case 1: return cmul(v, make_float2(c1, s1));
    case 2: return make_float2((v.x - v.y) * h, (v.x + v.y) * h);
    case 3: return cmul(v, make_float2(s1, c1));
    case 4: return make_float2(-v.y, v.x);
    case 5: return cmul(v, make_float2(-s1, c1));
    case 6: return make_float2(-(v.x + v.y) * h, (v.x - v.y) * h);
    default: return cmul(v, make_float2(-c1, s1));
  }
}

template <int R>
__host__ __device__ constexpr int bit_reverse(int k) {
  int out = 0;
  for (int b = 1; b < R; b <<= 1) {
    out = (out << 1) | (k & 1);
    k >>= 1;
  }
  return out;
}

// Radix-2 decimation-in-frequency stages of span 2*HALF, down to 2.
template <int R, int HALF>
__device__ __forceinline__ void dif_stages(float2* v) {
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int g = 0; g < R; g += 2 * HALF) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float2 a = v[g + i], b = v[g + i + HALF];
        v[g + i] = make_float2(a.x + b.x, a.y + b.y);
        v[g + i + HALF] = rot16(make_float2(a.x - b.x, a.y - b.y), i * (8 / HALF));
      }
    }
    dif_stages<R, HALF / 2>(v);
  }
}

// dst[k] = src[bit_reverse(k)], with every index fixed at compile time.
template <int R, int K = 0>
__device__ __forceinline__ void unscramble(float2* dst, const float2* src) {
  if constexpr (K < R) {
    constexpr int j = bit_reverse<R>(K);
    dst[K] = src[j];
    unscramble<R, K + 1>(dst, src);
  }
}

// In-register inverse DFT of R <= 16 points (positive exponent, unscaled),
// in natural order: radix-2 decimation in frequency, then the bit reversal as
// a renaming of registers.
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  dif_stages<R, R / 2>(v);
  float2 t[R];
  unscramble<R>(t, v);
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = t[k];
}

// Slot of point p of the block's rows: one pad in 16 keeps the stride-16
// writes of the first pass off a single bank.
__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// Twiddle e^{2 pi i c r / (NS R)} of a Stockham pass: for NS = 16 from the
// table tw[r*16 + c] of 256th roots; for NS = 256 (NS R = N) as
// lo[c r % 64] * hi[c r / 64], with lo[j] = w^j and hi[j] = w^{64 j},
// w = e^{2 pi i / N}.
template <int NS>
__device__ __forceinline__ float2 twiddle(const float2* tw, int c, int r) {
  if constexpr (NS == 16) {
    return tw[r * 16 + c];
  } else {
    const int j = c * r;
    return cmul(tw[256 + (j & 63)], tw[256 + 64 + (j >> 6)]);
  }
}

// Stockham pass of radix R over the points already combined in groups of NS:
// butterfly jj of a row (16/R of them per thread) reads x[jj + r*N/R],
// multiplies by the twiddle of (jj % NS, r), and runs an R-point DFT; the
// results stay in v for pass_store.
template <int R, int NS, int N, int TR>
__device__ __forceinline__ void pass_load(float2* v, const float2* buf, const float2* tw,
                                          int base, int lt) {
#pragma unroll
  for (int q = 0; q < 16 / R; ++q) {
    const int jj = lt + q * TR;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[q * R + r] = buf[pad(base + jj + r * (N / R))];
      if (r > 0) v[q * R + r] = cmul(v[q * R + r], twiddle<NS>(tw, jj % NS, r));
    }
    dft<R>(v + q * R);
  }
}

// Output r of butterfly jj goes to (jj / NS) * NS * R + jj % NS + r * NS.
template <int R, int NS, int TR>
__device__ __forceinline__ void pass_store(const float2* v, float2* buf, int base, int lt) {
#pragma unroll
  for (int q = 0; q < 16 / R; ++q) {
    const int jj = lt + q * TR;
    const int d = (jj / NS) * NS * R + jj % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(base + d + r * NS)] = v[q * R + r];
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(Plan<LOG_N>::kThreads)
cwt_direct_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  long long x_stride, const float* __restrict__ scales,
                  float* __restrict__ out0, float* __restrict__ out1,
                  int rows, int S, int K, int mother, float f0, int m,
                  float cre, float cim, float dt, float omega0, int mode) {
  using P = Plan<LOG_N>;
  constexpr int N = P::kN;
  constexpr int TR = P::kRowThreads;
  constexpr int RL = P::kLast;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw = smem + P::kData;

  const int tid = threadIdx.x;
  const int rho = tid / TR;       // row within the block
  const int lt = tid % TR;        // thread within the row
  const int base = rho * N;
  const int row = blockIdx.x * P::kRows + rho;   // b * S + s
  const bool valid = row < rows;

  // X's bins first: their latency hides under the twiddle build.
  float s = 1.0f, hr0 = 0.0f, hi0 = 0.0f;
  float xa[16], xb[16];
  {
    const float* xrs = xr;
    const float* xis = xi;
    if (valid) {
      const int sig = row / S;
      s = scales[row - sig * S];
      const float norm = sqrtf(kTwoPi * s / dt);
      hr0 = norm * cre;
      hi0 = norm * cim;
      xrs += (long long)sig * x_stride;
      xis += (long long)sig * x_stride;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const bool live = valid && r * TR < K;
      xa[r] = live ? xrs[lt + r * TR] : 0.0f;
      xb[r] = live ? xis[lt + r * TR] : 0.0f;
    }
  }

  // Twiddle tables (see twiddle()): tw[r*16 + c] = e^{2 pi i c r / 256},
  // then lo and hi when there is a third pass.
  for (int e = tid; e < P::kTw; e += P::kThreads) {
    float arg;
    if (e < 256) {
      arg = (float)(2 * (e & 15) * (e >> 4)) / 256.0f;
    } else if (e < 256 + 64) {
      arg = (float)(2 * (e - 256)) / (float)N;
    } else {
      arg = (float)(2 * 64 * (e - 256 - 64)) / (float)N;
    }
    float sn, cs;
    sincospif(arg, &sn, &cs);
    tw[e] = make_float2(cs, sn);
  }

  float2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    v[r] = make_float2(0.0f, 0.0f);
    if (valid && r * TR < K) {
      const int kf = r >= 8 ? lt + r * TR - N : lt + r * TR;   // fftfreq fold
      const float env = envelope(mother, s * (omega0 * (float)kf), f0, m);
      const float hr = hr0 * env, hi = hi0 * env;
      v[r] = make_float2(xa[r] * hr - xb[r] * hi, xa[r] * hi + xb[r] * hr);
    }
  }
  dft<16>(v);
  pass_store<16, 1, TR>(v, buf, base, lt);
  __syncthreads();   // pass 1's results and the twiddles are in place

  pass_load<16, 16, N, TR>(v, buf, tw, base, lt);
  constexpr int RO = RL > 1 ? RL : 16;   // radix of the last pass
  if constexpr (RL > 1) {
    __syncthreads();   // every read of pass 2 is done
    pass_store<16, 16, TR>(v, buf, base, lt);
    __syncthreads();
    pass_load<RL, 256, N, TR>(v, buf, tw, base, lt);
  }

  // Epilogue: the last pass (NS = N/RO) leaves output r of butterfly jj at
  // t = jj + r*N/RO; a warp stores consecutive t.
  const float inv_n = 1.0f / (float)N;
  const long long out_row = (long long)row * N;
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 16 / RO; ++q) {
    const int jj = lt + q * TR;
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float wr = v[q * RO + r].x * inv_n;
      const float wi = v[q * RO + r].y * inv_n;
      const float p = wr * wr + wi * wi;
      const long long t = out_row + jj + r * (N / RO);
      if (mode == kPlanes) {
        if (valid) {
          out0[t] = wr;
          out1[t] = wi;
        }
      } else if (mode == kPower) {
        if (valid) out0[t] = p;
      } else {
        acc += p;
      }
    }
  }
  if (mode == kPowerSum) {
    // Fixed-order tree over the row's threads: the same bits for the same
    // row wherever it sits in the block, whatever the batch.
    __syncthreads();   // the last pass's reads of buf are done
    float* red = reinterpret_cast<float*>(buf);
    red[tid] = acc;
    __syncthreads();
    for (int w = TR / 2; w > 0; w >>= 1) {
      if (lt < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (lt == 0 && valid) out0[row] = red[tid];
  }
}

// Above 48 KB a block's dynamic shared memory needs the function attribute:
// set once per process and device (N = 4096 takes 68 KB).
template <int LOG_N>
cudaError_t allow_smem() {
  constexpr size_t bytes = Plan<LOG_N>::kSmem;
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)cwt_direct_kernel<LOG_N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int LOG_N>
cudaError_t launch(const float* xr, const float* xi, long long x_stride,
                   const float* scales, float* out0, float* out1, int rows,
                   int S, int K, int mother, float f0, int m, float cre, float cim,
                   float dt, float omega0, int mode, int r2, cudaStream_t stream) {
  using P = Plan<LOG_N>;
  if (r2 != P::kLast) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<LOG_N>();
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)rows + P::kRows - 1) / P::kRows;
  cwt_direct_kernel<LOG_N><<<(unsigned)blocks, P::kThreads, P::kSmem, stream>>>(
      xr, xi, x_stride, scales, out0, out1, rows, S, K, mother, f0, m, cre, cim,
      dt, omega0, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X: planar rows x_stride apart, B signals, at least K bins each (K = N or
// N/2); scales: S.  mode 0: out0/out1 = W planes (B*S, N); mode 1: out0 =
// |W|^2 (B*S, N); mode 2: out0 = Sigma_t |W|^2 (B*S,).  N is a power of two
// in [2^8, 2^12]; the radix plan (r0, r1, r2) must be 16, 16, N/256 (r2 = 1:
// two passes).
cudaError_t cwt_direct(const float* xr, const float* xi, long long x_stride,
                       const float* scales, float* out0, float* out1,
                       int B, int S, int N, int K, int mother, float f0, int m,
                       float cre, float cim, float dt, float omega0, int mode,
                       int r0, int r1, int r2, void* stream) {
  if (r0 != 16 || r1 != 16 || (K != N && 2 * K != N) || B < 1 || S < 1 ||
      (long long)B * S > 0x7fffffffLL || mode < kPlanes || mode > kPowerSum) {
    return cudaErrorInvalidValue;
  }
  const int rows = B * S;
  const cudaStream_t st = (cudaStream_t)stream;
#define PYCWT_DIRECT_CASE(LOG_N)                                                  \
  case 1 << LOG_N:                                                                \
    return launch<LOG_N>(xr, xi, x_stride, scales, out0, out1, rows, S, K, mother, \
                         f0, m, cre, cim, dt, omega0, mode, r2, st);
  switch (N) {
    PYCWT_DIRECT_CASE(8)
    PYCWT_DIRECT_CASE(9)
    PYCWT_DIRECT_CASE(10)
    PYCWT_DIRECT_CASE(11)
    PYCWT_DIRECT_CASE(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef PYCWT_DIRECT_CASE
}

}  // extern "C"

// Direct-DFT CWT for short series (nfft <= 2^12), on Hopper.
//
// Port of the third Pallas TPU kernel of pycwt_tpu/ops/pallas_fft.py,
// _make_kernel_direct (:360-403, launched by _fused_cwt_small at :448-496).
// For one planar spectrum X of K bins (K = N, or K = N/2 for analytic
// mothers, which read only k < N/2 even of a full spectrum) and S scales:
//
//   Y[s, k] = X[k] * Hbar_s[k]               (filter built in the kernel)
//   W[s, t] = (1/N) sum_{k<K} Y[s, k] e^{+2 pi i k t / N}
//
// with Hbar_s the envelope * norm * conj(psi_ft_const) of cwt_stage_a, and
// negative bins folded (k >= N/2 -> k - N) when K = N.  The TPU ran this as
// four real MXU matmuls against a host DFT table E of K x N entries.
//
// Design: one block per (signal, tile of 32 scales, tile of 64 times); it
// loops over k in chunks of 64 bins.  For each chunk it builds the filtered
// tile Y (64 x 32, complex) in shared memory from the scales and the bin
// index; every thread then accumulates a 4-scale x 2-time micro-tile in f32
// registers, first over the chunk and then into its running sums (two-level
// summation: a rounding error that grows with 64 + K/64 terms, not with K).  The twiddle e^{2 pi i m / N} comes from a table of the N roots
// in shared memory (8 bytes each, 32 KB at N = 4096), indexed by k*t mod N
// computed in unsigned integers: the product wraps modulo 2^32, a multiple of
// N, so the index is exact at every size and no float k*t loses exactness,
// and no K x N table is read from device memory.  Rows s >= S are masked.
// There is no reduction across blocks, so a batch of B gives the same bits as
// B single calls.  No fast-math intrinsics (sincospif, expf, logf), as in
// fused_cwt.cu.
//
// Bound on the card: bytes.  The function needs only O(S*N log N)
// operations (the FFT route of cwt_stage_a + cwt_stage_b); at the WCT shape
// of a 4,000-point pair (B = 2, N = 4096, K = 2048, S = 133) that is 6.9e7
// flops, 1 us at 67 TFLOP/s f32, and its 8.7 MB of output take 2.6 us at
// 3.35 TB/s.  The direct DFT instead does 8*S*K*N flops per signal (a complex
// multiply-add per (s, k, t)): 1.79e10 at that shape, 0.27 ms at the f32
// peak, about 100 times the function's bound.  The design keeps that loop
// compute-dense: per bin and thread, 6 shared-memory loads (2 twiddles, 4
// filter values; at most 8 distinct addresses per warp) feed 8 complex
// multiply-adds (32 FFMA), and 64-time tiles give 640 blocks at that shape,
// 4.8 per SM, so the last wave is nearly full.  It still does the full
// O(K*N) work, so it stays the opt-in route, as in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileS = 32;    // scales per block
constexpr int kTileT = 64;    // times per block
constexpr int kChunkK = 64;   // bins per shared-memory chunk
constexpr int kMs = 4;        // scales per thread: ts + 8*i
constexpr int kMt = 2;        // times per thread: tt + 32*j
constexpr float kTwoPi = 6.283185307179586f;

enum Mother { kMorlet = 0, kPaul = 1, kDog = 2 };

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

__global__ void __launch_bounds__(kThreads)
cwt_direct_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  long long x_stride, const float* __restrict__ scales,
                  float* __restrict__ wr, float* __restrict__ wi,
                  int S, int N, int K, int fold, int mother, float f0, int m,
                  float cre, float cim, float dt, float omega0, float inv_n) {
  extern __shared__ float2 smem[];
  float2* tw = smem;          // tw[j] = e^{+2 pi i j / N}, j < N
  float2* y = tw + N;         // y[kk * kTileS + sl], kk < kChunkK
  __shared__ float sh_s[kTileS], sh_hr[kTileS], sh_hi[kTileS];

  const int tid = threadIdx.x;
  const int t_tiles = N / kTileT;
  const int s_tiles = (S + kTileS - 1) / kTileS;
  const int t_tile = blockIdx.x % t_tiles;
  const int s_tile = (blockIdx.x / t_tiles) % s_tiles;
  const long long sig = blockIdx.x / ((long long)t_tiles * s_tiles);
  const int s0 = s_tile * kTileS;
  const int t0 = t_tile * kTileT;
  const unsigned mask = (unsigned)N - 1u;

  for (int j = tid; j < N; j += kThreads) {
    float sn, cs;
    sincospif((float)(2 * j) / (float)N, &sn, &cs);   // exact f32 argument
    tw[j] = make_float2(cs, sn);
  }
  if (tid < kTileS) {
    const bool valid = s0 + tid < S;
    const float s = valid ? scales[s0 + tid] : 1.0f;
    const float norm = valid ? sqrtf(kTwoPi * s / dt) : 0.0f;
    sh_s[tid] = s;
    sh_hr[tid] = norm * cre;
    sh_hi[tid] = norm * cim;
  }

  const int ts = tid & 7;       // scale group: scales ts + 8*i
  const int tt = tid >> 3;      // time group: times tt + 32*j
  unsigned tq[kMt];
#pragma unroll
  for (int j = 0; j < kMt; ++j) tq[j] = (unsigned)(t0 + tt + 32 * j);

  float accr[kMs][kMt], acci[kMs][kMt];
#pragma unroll
  for (int i = 0; i < kMs; ++i)
#pragma unroll
    for (int j = 0; j < kMt; ++j) accr[i][j] = acci[i][j] = 0.0f;

  const float* xrs = xr + sig * x_stride;
  const float* xis = xi + sig * x_stride;
  const int half = N / 2;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    __syncthreads();   // the previous chunk is consumed (and sh_* are set)
    for (int e = tid; e < kChunkK * kTileS; e += kThreads) {
      const int sl = e % kTileS;
      const int k = k0 + e / kTileS;
      const int kf = (fold && k >= half) ? k - N : k;   // fftfreq fold
      const float f = sh_s[sl] * (omega0 * (float)kf);
      const float env = envelope(mother, f, f0, m);
      const float hr = sh_hr[sl] * env, hi = sh_hi[sl] * env;
      const float vr = xrs[k], vi = xis[k];
      // masked rows have hr = hi = 0 and a finite envelope (s = 1)
      y[e] = make_float2(vr * hr - vi * hi, vr * hi + vi * hr);
    }
    __syncthreads();

    float cr[kMs][kMt], ci[kMs][kMt];   // this chunk's partial sums
#pragma unroll
    for (int i = 0; i < kMs; ++i)
#pragma unroll
      for (int j = 0; j < kMt; ++j) cr[i][j] = ci[i][j] = 0.0f;
    const int kend = min(kChunkK, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      const unsigned k = (unsigned)(k0 + kk);
      float2 w[kMt], yv[kMs];
#pragma unroll
      for (int j = 0; j < kMt; ++j) w[j] = tw[(k * tq[j]) & mask];
#pragma unroll
      for (int i = 0; i < kMs; ++i) yv[i] = y[kk * kTileS + ts + 8 * i];
#pragma unroll
      for (int i = 0; i < kMs; ++i)
#pragma unroll
        for (int j = 0; j < kMt; ++j) {
          cr[i][j] = fmaf(yv[i].x, w[j].x, cr[i][j]);
          cr[i][j] = fmaf(-yv[i].y, w[j].y, cr[i][j]);
          ci[i][j] = fmaf(yv[i].x, w[j].y, ci[i][j]);
          ci[i][j] = fmaf(yv[i].y, w[j].x, ci[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kMs; ++i)
#pragma unroll
      for (int j = 0; j < kMt; ++j) {
        accr[i][j] += cr[i][j];
        acci[i][j] += ci[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < kMs; ++i) {
    const int s = s0 + ts + 8 * i;
    if (s >= S) continue;
    const long long row = (sig * S + s) * (long long)N;
#pragma unroll
    for (int j = 0; j < kMt; ++j) {
      wr[row + tq[j]] = accr[i][j] * inv_n;
      wi[row + tq[j]] = acci[i][j] * inv_n;
    }
  }
}

}  // namespace

extern "C" {

// X: planar rows x_stride apart, B signals, at least K bins each; scales: S;
// W out: two (B*S, N) planes.  fold: 1 when K = N (full spectrum).
// N is a power of two in [kTileT, 2^12]; K a multiple of kChunkK.
cudaError_t cwt_direct(const float* xr, const float* xi, long long x_stride,
                       const float* scales, float* wr, float* wi,
                       int B, int S, int N, int K, int fold, int mother,
                       float f0, int m, float cre, float cim, float dt,
                       float omega0, void* stream) {
  // 48 KB of dynamic shared memory at N = 4096, beside 384 B of static: over
  // the default 48 KB a block may take without the attribute.
  const size_t bytes = sizeof(float2) * ((size_t)N + kChunkK * kTileS);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)cwt_direct_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)B * ((S + kTileS - 1) / kTileS) * (N / kTileT);
  cwt_direct_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      xr, xi, x_stride, scales, wr, wi, S, N, K, fold, mother, f0, m, cre, cim,
      dt, omega0, 1.0f / (float)N);
  return cudaGetLastError();
}

}  // extern "C"

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
//      of an exact f32 argument.  The passes, the DFTs and the tables are
//      fft_common.cuh's, shared with cwt_stage_a and cwt_stage_b.
//   3. Epilogue.  The last pass writes straight to device memory: 1/N, then
//      W planes or |W|^2 (coalesced along t), or Sigma_t |W|^2 summed in a
//      fixed order (per thread, then a tree over the row's threads).
// No fast-math intrinsics (expf, logf, sincospif).
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

#include "fft_common.cuh"

namespace {

// Points per block at least: rows of shorter series share a block
// (_DIRECT_BLOCK_POINTS in ops/fused_cwt.py).
constexpr int kMinPoints = 1024;

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
  const int base = pad(rho * N);   // the row's first slot in buf
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

  // Twiddle tables (fill_twiddles in fft_common.cuh): 256th roots, then lo
  // and hi when there is a third pass.
  fill_twiddles(tw, N, P::kTw, tid, P::kThreads);

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

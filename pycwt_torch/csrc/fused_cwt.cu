// Fused filter-bank x four-step inverse FFT for the forward CWT, on Hopper.
//
// Port of the two Pallas TPU kernels of pycwt_tpu/ops/pallas_fft.py that carry
// the main path.  With N = R2*R1, k = b*R1 + a and t = c + R2*d, the inverse
// DFT of the filtered spectrum Y = X * Hbar_s splits into
//
//   Z[a, c] = sum_b Y[b*R1 + a] e^{+2 pi i b c / R2}       (cwt_stage_a)
//   T[a, c] = Z[a, c] e^{+2 pi i a c / N}                   (cwt_stage_a)
//   W[c + R2*d] = (1/N) sum_a T[a, c] e^{+2 pi i a d / R1} (cwt_stage_b)
//
// Both stages keep one tile of columns in shared memory and run an in-place
// radix-2 FFT (bit-reversed load, decimation in time) per column in f32.
// No fast-math intrinsics: __expf/__sinf lose the 1e-5 bound at large s*omega.
//
// cwt_stage_a replaces _make_kernel_a (pallas_fft.py:252-286, launched at
// :720-727).  One block per (signal*scale row, tile of consecutive columns a):
// it builds Hbar_s for its tile in registers, multiplies planar X (rows
// b < R2/2 only for analytic mothers, as K1 does), runs the length-R2 FFTs,
// applies the twiddle and writes T[row, a, c] coalesced along c.
// Bound on the card: bytes.  At N = 2^20, S = 64 it reads 4.2 MB of half
// planar X and writes 536.9 MB of planar f32 T (about 0.16 ms at 3.35 TB/s);
// its f32 arithmetic is below a tenth of a millisecond at 67 TFLOP/s.
//
// cwt_stage_b replaces _make_kernel_b (pallas_fft.py:289-325, launched at
// :749-761).  One block per (row, tile of consecutive c): it loads T[row, :,
// c-tile], runs the length-R1 FFTs, scales by 1/N and writes W planes, |W|^2,
// or per-block partial sums of |W|^2 that a second, fixed-order pass reduces
// (no float atomics, so a batch gives the same bits as one signal at a time).
// Bound on the card: bytes.  It reads the 536.9 MB of T (about 0.16 ms) and
// writes 268.4 MB more for |W|^2 or 536.9 MB more for the planes.
//
// The design's cost is the round trip of T through device memory (write in
// stage A, read in stage B): twice the bytes of a single-pass kernel.  Keeping
// T on chip is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

enum Mother { kMorlet = 0, kPaul = 1, kDog = 2 };
enum Mode { kPlanes = 0, kPower = 1, kPowerSum = 2 };

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

// Real envelope env(f) of the mother's spectrum (mothers.py).
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

// e^{+2 pi i m / n} for 0 <= m < n, n a power of two.
__device__ __forceinline__ void unit_root(long long m, long long n, float* s, float* c) {
  if (n <= (1LL << 23)) {
    // 2m < 2^24 and n a power of two: the argument is exact in f32.
    sincospif((float)(2 * m) / (float)n, s, c);
  } else {
    double sd, cd;
    sincospi((double)(2 * m) / (double)n, &sd, &cd);
    *s = (float)sd;
    *c = (float)cd;
  }
}

// Table tw[j] = e^{+2 pi i j / R}, j < R/2, in shared memory.
__device__ __forceinline__ void fill_twiddles(float* twr, float* twi, int R) {
  for (int j = threadIdx.x; j < R / 2; j += blockDim.x) {
    float s, c;
    sincospif((float)(2 * j) / (float)R, &s, &c);
    twr[j] = c;
    twi[j] = s;
  }
}

// In-place inverse (positive-exponent, unscaled) radix-2 DIT FFT of length R
// on `cols` columns stored row-major with leading dimension ld; the input
// rows must already be in bit-reversed order.  Ends with a barrier.
__device__ void column_fft(float* re, float* im, const float* twr, const float* twi,
                           int R, int log_r, int log_cols, int ld) {
  const int cols = 1 << log_cols;
  const int work = (R >> 1) << log_cols;
  for (int ls = 1; ls <= log_r; ++ls) {
    const int half = 1 << (ls - 1);
    const int tstride = R >> ls;
    for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
      const int bf = idx >> log_cols;
      const int j = idx & (cols - 1);
      const int g = bf >> (ls - 1);
      const int jj = bf & (half - 1);
      const int i0 = ((g << ls) + jj) * ld + j;
      const int i1 = i0 + half * ld;
      const float wr = twr[jj * tstride];
      const float wi = twi[jj * tstride];
      const float ur = re[i0], ui = im[i0];
      const float xr = re[i1], xi = im[i1];
      const float vr = xr * wr - xi * wi;
      const float vi = xr * wi + xi * wr;
      re[i0] = ur + vr;
      im[i0] = ui + vi;
      re[i1] = ur - vr;
      im[i1] = ui - vi;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return (int)(__brev((unsigned)v) >> (32 - bits));
}

__global__ void __launch_bounds__(kThreads)
cwt_stage_a_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long x_stride, const float* __restrict__ scales,
                   float* __restrict__ tr, float* __restrict__ ti,
                   int S, int R1, int R2, int log_r2, int rows, int log_cols,
                   int mother, float f0, int m, float cre, float cim, float dt,
                   float omega0) {
  extern __shared__ float smem[];
  const int cols = 1 << log_cols;
  const int ld = cols + 1;
  float* sre = smem;
  float* sim = sre + R2 * ld;
  float* twr = sim + R2 * ld;
  float* twi = twr + R2 / 2;

  const int tiles = R1 >> log_cols;
  const long long row = blockIdx.x / tiles;        // signal * S + scale
  const int tile = blockIdx.x - (int)(row * tiles);
  const long long sig = row / S;
  const int a0 = tile << log_cols;
  const long long n = (long long)R1 * R2;

  fill_twiddles(twr, twi, R2);

  const float s = scales[row - sig * S];
  const float norm = sqrtf(kTwoPi * s / dt);
  const float hr0 = norm * cre;
  const float hi0 = norm * cim;
  const float* xrs = xr + sig * x_stride;
  const float* xis = xi + sig * x_stride;
  for (int idx = threadIdx.x; idx < (R2 << log_cols); idx += blockDim.x) {
    const int b = idx >> log_cols;
    const int j = idx & (cols - 1);
    float yr = 0.0f, yi = 0.0f;
    if (b < rows) {
      const long long k = (long long)b * R1 + a0 + j;
      const long long kf = k >= n / 2 ? k - n : k;   // fftfreq fold
      const float f = s * (omega0 * (float)kf);
      const float env = envelope(mother, f, f0, m);
      const float hr = hr0 * env, hi = hi0 * env;
      const float vr = xrs[k], vi = xis[k];
      yr = vr * hr - vi * hi;
      yi = vr * hi + vi * hr;
    }
    const int p = bit_reverse(b, log_r2) * ld + j;
    sre[p] = yr;
    sim[p] = yi;
  }
  __syncthreads();

  column_fft(sre, sim, twr, twi, R2, log_r2, log_cols, ld);

  float* trr = tr + (row * R1 + a0) * (long long)R2;
  float* tir = ti + (row * R1 + a0) * (long long)R2;
  for (int idx = threadIdx.x; idx < (R2 << log_cols); idx += blockDim.x) {
    const int j = idx / R2;
    const int c = idx - j * R2;
    const int p = c * ld + j;
    float ws, wc;
    unit_root((long long)(a0 + j) * c, n, &ws, &wc);
    const float zr = sre[p], zi = sim[p];
    trr[idx] = zr * wc - zi * ws;
    tir[idx] = zr * ws + zi * wc;
  }
}

__global__ void __launch_bounds__(kThreads)
cwt_stage_b_kernel(const float* __restrict__ tr, const float* __restrict__ ti,
                   float* __restrict__ out0, float* __restrict__ out1,
                   int R1, int R2, int log_r1, int log_cols, int mode, float inv_n) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int cols = 1 << log_cols;
  const int ld = cols + 1;
  float* sre = smem;
  float* sim = sre + R1 * ld;
  float* twr = sim + R1 * ld;
  float* twi = twr + R1 / 2;

  const int tiles = R2 >> log_cols;
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)(row * tiles);
  const int c0 = tile << log_cols;
  const long long n = (long long)R1 * R2;

  fill_twiddles(twr, twi, R1);

  const float* trr = tr + row * n;
  const float* tir = ti + row * n;
  for (int idx = threadIdx.x; idx < (R1 << log_cols); idx += blockDim.x) {
    const int a = idx >> log_cols;
    const int j = idx & (cols - 1);
    const long long q = (long long)a * R2 + c0 + j;
    const int p = bit_reverse(a, log_r1) * ld + j;
    sre[p] = trr[q];
    sim[p] = tir[q];
  }
  __syncthreads();

  column_fft(sre, sim, twr, twi, R1, log_r1, log_cols, ld);

  float acc = 0.0f;
  for (int idx = threadIdx.x; idx < (R1 << log_cols); idx += blockDim.x) {
    const int d = idx >> log_cols;
    const int j = idx & (cols - 1);
    const int p = d * ld + j;
    const float wr = sre[p] * inv_n;
    const float wi = sim[p] * inv_n;
    const long long t = row * n + (long long)d * R2 + c0 + j;
    if (mode == kPlanes) {
      out0[t] = wr;
      out1[t] = wi;
    } else if (mode == kPower) {
      out0[t] = wr * wr + wi * wi;
    } else {
      acc += wr * wr + wi * wi;
    }
  }
  if (mode == kPowerSum) {
    // Fixed-order tree over the block: the same bits for the same row,
    // whatever the batch.
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) out0[row * tiles + tile] = red[0];
  }
}

// Second pass of the power_sum epilogue: one thread per row sums its
// per-block partials in index order.
__global__ void cwt_stage_b_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out,
                                          long long rows, int tiles) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + r * tiles;
  float acc = 0.0f;
  for (int i = 0; i < tiles; ++i) acc += p[i];
  out[r] = acc;
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Dynamic shared memory of one block of either stage: planar columns of R
// points, `cols` of them at leading dimension cols + 1, and the R/2-entry
// twiddle table (ops/fused_cwt.py sizes `cols` with the same formula).
size_t smem_bytes(int R, int cols) {
  return sizeof(float) * ((size_t)2 * R * (cols + 1) + R);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// X: planar rows x_stride apart, B signals; scales: S; T out: (B*S, R1, R2).
cudaError_t cwt_stage_a(const float* xr, const float* xi, long long x_stride,
                        const float* scales, float* tr, float* ti,
                        int B, int S, int R1, int R2, int rows, int cols,
                        int mother, float f0, int m, float cre, float cim,
                        float dt, float omega0, void* stream) {
  const size_t bytes = smem_bytes(R2, cols);
  cudaError_t err = set_smem((const void*)cwt_stage_a_kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * S * (R1 / cols);
  cwt_stage_a_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      xr, xi, x_stride, scales, tr, ti, S, R1, R2, log2i(R2), rows, log2i(cols),
      mother, f0, m, cre, cim, dt, omega0);
  return cudaGetLastError();
}

// T: (rows, R1, R2).  mode 0: out0/out1 = W planes (rows, N); mode 1:
// out0 = |W|^2 (rows, N); mode 2: out0 = partials (rows, R2/cols) scratch,
// out1 = sum_t |W|^2 (rows,).
cudaError_t cwt_stage_b(const float* tr, const float* ti, float* out0, float* out1,
                        long long rows, int R1, int R2, int cols, int mode,
                        float inv_n, void* stream) {
  const size_t bytes = smem_bytes(R1, cols);
  cudaError_t err = set_smem((const void*)cwt_stage_b_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = R2 / cols;
  const long long blocks = rows * tiles;
  cwt_stage_b_kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      tr, ti, out0, out1, R1, R2, log2i(R1), log2i(cols), mode, inv_n);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode != kPowerSum) return err;
  const unsigned rblocks = (unsigned)((rows + kThreads - 1) / kThreads);
  cwt_stage_b_reduce_kernel<<<rblocks, kThreads, 0, (cudaStream_t)stream>>>(
      out0, out1, rows, tiles);
  return cudaGetLastError();
}

}  // extern "C"

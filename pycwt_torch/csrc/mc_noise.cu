// The Monte-Carlo null's AR(1) surrogates, drawn on Hopper in one launch.
//
// Replaces no Pallas kernel: pycwt_tpu draws its surrogates with jax.random
// under jit, which XLA fuses into a few device ops.  The port's torch path
// (pycwt_torch/stats.py: _threefry2x32, _normal_f64, _ar1_recurrence) draws
// the same numbers as some 480 small torch ops per call of
// rednoise_members, and at the JAO/JBaltic shape (300 members of 885
// samples) their host dispatch, not the card, set the time.  These kernels
// compute the same numbers, bit for bit, in one launch each:
//
//   mc_fold_in   jax.random.fold_in / split: key j = threefry2x32(key,
//                (0, data[j])) (data = 0..count-1 when it is null).  The key
//                is read from device memory, so no word comes to the host.
//   mc_rednoise  one block a surrogate row: the row's key fold_in(base,
//                idx[m]) (fold_in(fold_in(base, slots[p]), idx[m]) for the
//                pair streams), then for t < L = n + tau the f64 normal of
//                jax.random.normal from threefry2x32(rowkey, (0, t)), cast to
//                the output type and times a, then the AR(1) recurrence
//                y[t] = g*y[t-1] + z[t] as _ar1_recurrence's log-depth scan.
//
// Bit for bit with the torch path on the card.
// * The words: threefry2x32 with 20 rounds on uint32 is the int64 masked
//   arithmetic of stats._threefry2x32.
// * The normal: u = m * 2^-52 from the 52-bit mantissa (hi << 20 | lo >> 12),
//   u * scale + lo (scale = 1 - lo, lo = nextafter(-1, inf), passed from the
//   host as the torch code computes them), clamped at lo, then
//   sqrt(2) * erfinv(u) in f64: erfinv(double) is libdevice's __nv_erfinv,
//   the function torch's CUDA erfinv calls.  Every other step is an explicit
//   round-to-nearest intrinsic, because nvcc contracts a*b + c into an FMA
//   and torch rounds each op on its own.
// * The scan: _ar1_recurrence runs, for d = 1, 2, 4, ... < L,
//   b[t] = a[t]*b[t-d] + b[t] and a[t] = a[t]*a[t-d] for t >= d, with
//   a = g everywhere at the start.  Before the step of width d = 2^k, every
//   a[t] with t >= d holds the same value G_k = G_{k-1} * G_{k-1}, G_0 = g
//   (rounded in the output type at each squaring): a[t] for t >= 2^k - 1 is
//   the product of two entries that are both G_{k-1}.  So the b update
//   needs only the scalar G_k, and this kernel keeps no array a.  Each step
//   runs in place over chunks of blockDim entries from the top down: a chunk
//   reads b[t - d] and b[t] into registers, the block syncs, then writes;
//   chunks below it are still unwritten in this step.  The products and sums
//   are __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn in f64), as torch's mul and
//   add round them.  The CPU tests replay this order and hold it equal to
//   _ar1_recurrence.
// * g == 0 (scan = 0) skips the recurrence, as rednoise_members does.
//
// The scan runs in place in the row's L values of the output, in device
// memory, whatever L is (the long-record nulls have 6,302 samples and more);
// the block's syncs order the reads and writes of its own row, which stay in
// L1/L2.  The output is (rows, L): the caller returns its columns tau: as a
// view, as the torch path returns _ar1_recurrence(z, g)[:, tau:].
//
// Bound on the card: latency.  At the cell's shape (600 rows a call in two
// launches, L ~ 894) the kernel writes 2.1 MB (0.6 us at 3.35 TB/s) and
// computes 540 k threefry blocks and f64 erfinvs, a few microseconds of the
// SMs; each block waits on ~10 scan steps of two barriers each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;           // a surrogate row's block
constexpr int kFoldThreads = 256;

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = ((x1 << R) | (x1 >> (32 - R))) ^ x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix<R0>(x0, x1);
  mix<R1>(x0, x1);
  mix<R2>(x0, x1);
  mix<R3>(x0, x1);
}

// Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax.random's default
// generator and stats._threefry2x32 compute it: returns (x0, x1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.normal's f64 draw t of the stream keyed (k0, k1).
__device__ __forceinline__ double normal_f64(uint32_t k0, uint32_t k1, uint32_t t,
                                             double scale, double lo) {
  const uint2 w = threefry2x32(k0, k1, 0u, t);
  const unsigned long long m = ((unsigned long long)w.x << 20) | (w.y >> 12);
  double u = __dmul_rn((double)m, 0x1p-52);                  // exact
  u = __dadd_rn(__dmul_rn(u, scale), lo);
  u = u < lo ? lo : u;
  return __dmul_rn(erfinv(u), 1.4142135623730951);           // math.sqrt(2.0)
}

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

__global__ void __launch_bounds__(kFoldThreads)
    mc_fold_in_kernel(const long long* __restrict__ k0, const long long* __restrict__ k1,
                      const long long* __restrict__ data, long long count,
                      long long* __restrict__ out0, long long* __restrict__ out1) {
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= count) return;
  const uint32_t x = data ? (uint32_t)data[i] : (uint32_t)i;
  const uint2 w = threefry2x32((uint32_t)*k0, (uint32_t)*k1, 0u, x);
  out0[i] = w.x;
  out1[i] = w.y;
}

// Row r = p * members + m of the (rows, L) output.  g_rows (one g a pair,
// already in T) or, when it is null, g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mc_rednoise_kernel(const long long* __restrict__ k0, const long long* __restrict__ k1,
                       const long long* __restrict__ slots, const long long* __restrict__ idx,
                       int members, int L, T g, const T* __restrict__ g_rows, T a,
                       double scale, double lo, int scan, T* out) {
  const int row = blockIdx.x;
  const int p = row / members;
  const int m = row - p * members;
  uint32_t rk0 = (uint32_t)*k0, rk1 = (uint32_t)*k1;
  if (slots) {
    const uint2 pk = threefry2x32(rk0, rk1, 0u, (uint32_t)slots[p]);
    rk0 = pk.x;
    rk1 = pk.y;
  }
  const uint2 rk = threefry2x32(rk0, rk1, 0u, (uint32_t)idx[m]);
  T* b = out + (long long)row * L;
  for (int t = threadIdx.x; t < L; t += kThreads) {
    b[t] = Rn<T>::mul((T)normal_f64(rk.x, rk.y, (uint32_t)t, scale, lo), a);
  }
  if (!scan) return;
  T G = g_rows ? g_rows[p] : g;
  __syncthreads();
  const int chunks = (L + kThreads - 1) / kThreads;
  for (int d = 1; d < L; d *= 2) {
    for (int c = chunks - 1; c >= 0 && (c + 1) * kThreads > d; --c) {
      const int t = c * kThreads + threadIdx.x;
      const bool live = t >= d && t < L;
      T v = T(0);
      if (live) v = Rn<T>::add(Rn<T>::mul(G, b[t - d]), b[t]);
      __syncthreads();
      if (live) b[t] = v;
      __syncthreads();
    }
    G = Rn<T>::mul(G, G);
  }
}

template <typename T>
cudaError_t rednoise(const long long* k0, const long long* k1, const long long* slots,
                     const long long* idx, int rows, int members, int L, int tau, double g,
                     const T* g_rows, double a, double scale, double lo, int scan, T* out,
                     void* stream) {
  if (rows < 1 || members < 1 || rows % members != 0 || L < 1 || tau < 0 || tau >= L) {
    return cudaErrorInvalidValue;
  }
  mc_rednoise_kernel<T><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, slots, idx, members, L, (T)g, g_rows, (T)a, scale, lo, scan, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Keys j < count: out0[j], out1[j] = threefry2x32((*k0, *k1), (0, data[j]))
// as int64 words in [0, 2^32); data null means data[j] = j (split).
cudaError_t mc_fold_in(const long long* k0, const long long* k1, const long long* data,
                       long long count, long long* out0, long long* out1, void* stream) {
  if (count < 0) return cudaErrorInvalidValue;
  if (count == 0) return cudaSuccess;
  const long long blocks = (count + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mc_fold_in_kernel<<<(unsigned)blocks, kFoldThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, data, count, out0, out1);
  return cudaGetLastError();
}

// rows = P * members surrogate rows of L = n + tau values into out (rows, L),
// contiguous; columns tau: are the surrogates.  slots (P, or null for one
// stream level), idx (members), g_rows (P, or null: g for every row).
// scan = 0 skips the recurrence (g == 0).
cudaError_t mc_rednoise_f32(const long long* k0, const long long* k1, const long long* slots,
                            const long long* idx, int rows, int members, int L, int tau,
                            double g, const float* g_rows, double a, double scale, double lo,
                            int scan, float* out, void* stream) {
  return rednoise<float>(k0, k1, slots, idx, rows, members, L, tau, g, g_rows, a, scale, lo,
                         scan, out, stream);
}

cudaError_t mc_rednoise_f64(const long long* k0, const long long* k1, const long long* slots,
                            const long long* idx, int rows, int members, int L, int tau,
                            double g, const double* g_rows, double a, double scale, double lo,
                            int scan, double* out, void* stream) {
  return rednoise<double>(k0, k1, slots, idx, rows, members, L, tau, g, g_rows, a, scale, lo,
                          scan, out, stream);
}

}  // extern "C"

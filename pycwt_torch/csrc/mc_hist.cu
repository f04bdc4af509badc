// The Monte-Carlo chunk's tail on Hopper: coherence, its bin and the counts
// in one launch.
//
// Replaces no Pallas kernel: pycwt_tpu bins its members' coherence with
// jnp ops under jit, which XLA fuses.  The port's torch path computed, for
// every point of a chunk's (P, B, S, n) smoothed fields, the ratio R^2 in
// five element-wise passes, then floor(R^2 * 1000), the NaN and clamp
// passes, an int64 cell index, and a scatter_add_ of int64 ones into the
// (P, S, 1000) counts, whose atomics collide because neighbouring samples
// of a smoothed row fall in one bin.  This kernel reads the two smoothed
// complex64 fields once and adds each (p, s) row's counts into the int64
// accumulator in place:
//
//   sf  S = S1 + i*S2, the smoothed scale-normalised auto-spectra, as float2
//   cf  C = S12r + i*S12i, the smoothed cross spectrum, as float2
//   mask (S, n) bytes, nonzero outside the cone of influence
//   acc (P, S, 1000) int64, added to
//
// Members b >= valid (the last chunk's overdraw) count nothing, and points
// inside the cone are not read.
//
// Bit for bit with the torch path on the card (coherence._coherence_ratio,
// then coherence._histogram): R^2 = (S12r*S12r + S12i*S12i) / (S1*S2) with
// each product, the sum and the quotient rounded on its own
// (__fmul_rn/__fadd_rn/__fdiv_rn: nvcc would contract a*b + c into an FMA,
// torch rounds each op), then floor(R^2 * 1000.f); NaN counts in bin 0, and
// the bin is clamped to [0, 999], so -inf and every negative R^2 land in bin
// 0 and +inf in bin 999.  The counts are integers, so the order of the adds
// does not matter.
//
// Layout: a cluster of cs blocks a (p, s) row: cs = 1 where the rows fill
// the card (wct_matrix_mc_32st's chunk: 4,950 rows), up to 8 where they are
// few (wct_mc300's chunk: P = 1, S = 76, cs = 8; one block a row took 0.82
// ms there against 0.14 and cost that cell ~5 % of its calls/s, PERF.md).
// A cluster's warps take tasks of 1024 points of one member's row (member
// b, time t0 .. t0 + 1023), each point read once as two float2 by
// consecutive lanes.  Each block counts into an int32 histogram in shared
// memory; at the end the cluster sums its blocks' histograms through
// distributed shared memory, each block summing a slice of the bins, and
// adds the nonzero sums into acc.  Each row of acc has one writer in a
// launch, so the adds are plain.
//
// Contention.  The fields are smoothed in time, so neighbouring samples
// nearly always share a bin, and 32 lanes incrementing one address
// serialise.  So a warp stages its 1024 bins in a padded 32 x 33 tile in
// shared memory (written as loaded, lane = consecutive time), then each lane
// walks 32 consecutive samples and carries the length of the current run of
// one bin in a register, adding it once when the bin changes.  On the H100
// this beat warp-aggregated increments (__match_any_sync, the lowest lane of
// a bin adding the group's popcount) by 6-24 % at both Monte-Carlo cells'
// chunks (PERF.md, the kernel table).
//
// Bound on the card: bytes.  16 bytes a point outside the cone (the mask
// row stays in L1/L2), ~0.05 s for the ~9.9e9 points of a wct_matrix_mc_32st
// call at 3.35 TB/s; a chunk of 405 member pairs runs at ~72 % of it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 1000;       // coherence.NBINS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTask = 1024;       // points of a warp's task: 32 x 32
constexpr int kLd = 33;           // the tile's padded row
constexpr int kMaxCluster = 8;

// The bin of one point: _histogram's clip(floor(R^2 * 1000), 0, 999) with
// NaN in bin 0, of R^2 in the torch path's rounding order.
__device__ __forceinline__ int bin_of(float2 s, float2 c) {
  const float num = __fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y));
  const float r2 = __fdiv_rn(num, __fmul_rn(s.x, s.y));
  const float f = floorf(__fmul_rn(r2, (float)kBins));
  if (!(f > 0.f)) return 0;  // NaN, zero and negatives
  if (f >= (float)(kBins - 1)) return kBins - 1;
  return (int)f;
}

// The bin of point t of a row, or -1 where it counts nothing.
__device__ __forceinline__ int point_bin(const float2* __restrict__ sf,
                                         const float2* __restrict__ cf,
                                         const unsigned char* __restrict__ m, int n, int t) {
  if (t >= n || !__ldg(m + t)) return -1;
  return bin_of(__ldcs(sf + t), __ldcs(cf + t));
}

__global__ void __launch_bounds__(kThreads)
mc_coherence_counts_kernel(const float2* __restrict__ sf, const float2* __restrict__ cf,
                           const unsigned char* __restrict__ mask, long long* __restrict__ acc,
                           int B, int S, int n, int valid, int cs) {
  __shared__ int hist[kBins];
  __shared__ int tiles[kWarps][32 * kLd];
  const long long row = blockIdx.x / cs;  // p * S + s
  const int rank = (int)(blockIdx.x % cs);
  const long long p = row / S;
  const int s = (int)(row - p * S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();

  const unsigned char* m = mask + (long long)s * n;
  const int per_member = (n + kTask - 1) / kTask;
  const int tasks = valid * per_member;
  for (int task = rank * kWarps + warp; task < tasks; task += cs * kWarps) {
    const int b = task / per_member;
    const int t0 = (task - b * per_member) * kTask;
    const long long base = ((p * B + b) * S + s) * (long long)n;
    const float2* srow = sf + base;
    const float2* crow = cf + base;
    int* tile = tiles[warp];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      tile[j * kLd + lane] = point_bin(srow, crow, m, n, t0 + j * 32 + lane);
    }
    __syncwarp();
    // lane walks samples t0 + 32 * lane .. + 31, stored at tile[lane * kLd + c]
    int cur = -1, run = 0;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int bin = tile[lane * kLd + c];
      if (bin != cur) {
        if (cur >= 0) atomicAdd(&hist[cur], run);
        cur = bin;
        run = 0;
      }
      ++run;
    }
    if (cur >= 0) atomicAdd(&hist[cur], run);
    __syncwarp();
  }
  __syncthreads();

  long long* out = acc + row * kBins;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's histogram is complete
  for (int i = rank * kThreads + threadIdx.x; i < kBins; i += cs * kThreads) {
    int sum = 0;
    for (int r = 0; r < cs; ++r) sum += cluster.map_shared_rank(hist, r)[i];
    if (sum) out[i] += sum;
  }
  cluster.sync();  // no block leaves while another still reads its histogram
}

// Blocks a row: 1, or a cluster of up to 8 where the rows alone would leave
// the card short of four blocks an SM, as long as each block keeps four
// tasks a warp.
int cluster_size(long long rows, long long tasks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms = 132;
  }
  int cs = 1;
  while (cs < kMaxCluster && rows * cs < 4LL * sms && tasks >= 4LL * cs * kWarps) cs *= 2;
  return cs;
}

cudaError_t launch(const float2* sf, const float2* cf, const unsigned char* mask,
                   long long* acc, long long rows, int B, int S, int n, int valid,
                   cudaStream_t stream) {
  const long long tasks = (long long)valid * ((n + kTask - 1) / kTask);
  const int cs = cluster_size(rows, tasks);
  if (rows * cs > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mc_coherence_counts_kernel, sf, cf, mask,
                                             acc, B, S, n, valid, cs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the counts of the (P, B, S, n) complex64 fields s (S1 + i S2) and c
// (S12r + i S12i), contiguous, over members b < valid and the points where
// mask (S, n) is nonzero, into acc (P, S, 1000) int64, contiguous.
cudaError_t mc_coherence_counts(const float* s, const float* c, const unsigned char* mask,
                                long long* acc, long long P, int B, int S, int n, int valid,
                                void* stream) {
  if (P < 1 || B < 1 || S < 1 || n < 1 || valid < 0 || valid > B ||
      (long long)valid * n >= 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (valid == 0) return cudaSuccess;
  const auto* sf = reinterpret_cast<const float2*>(s);
  const auto* cf = reinterpret_cast<const float2*>(c);
  const long long rows = P * S;
  return launch(sf, cf, mask, acc, rows, B, S, n, valid, (cudaStream_t)stream);
}

}  // extern "C"

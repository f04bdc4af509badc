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
// cwt_stage_a replaces _make_kernel_a (pallas_fft.py:252-286, launched at
// :720-727), cwt_stage_b replaces _make_kernel_b (pallas_fft.py:289-325,
// launched at :749-761).  T keeps the TPU kernels' layout (rows, R1, R2).
//
// Bound on the card: bytes.  At N = 2^20, S = 64, cwt_stage_a reads 4.2 MB of
// half planar X and writes 536.9 MB of planar f32 T, and cwt_stage_b reads
// the 536.9 MB of T and writes 256 B of sums (power_sum), 268.4 MB of |W|^2
// or 536.9 MB of planes: about 0.16 ms each at 3.35 TB/s.  Their f32
// arithmetic is below a tenth of a millisecond at 67 TFLOP/s.
//
// Design: both kernels run column_stockham (fft_common.cuh).  A block owns
// `cols` whole columns of R points (R = R2 in stage A, R1 in stage B) and
// R/16 threads per column, 16 points each: 512 threads and ~70 KB of shared
// memory at R = 1024 (ops/fused_cwt.py's _tile_cols), two blocks per SM.
// Each column lies contiguous in shared memory, padded one slot in 16, at a
// column stride chosen so that the accesses that cross columns hit 16
// distinct bank pairs in every half-warp (column_ld).  The radix plan is
// 16 | 16*RL | 16*16*RL | 16*16*16*2 with a last radix RL of 2, 4, 8 or 16
// (three passes and three barriers at R = 1024, where a radix-2 FFT took ten
// shared-memory round trips): the first pass is fed from device memory
// straight into registers, and the last pass feeds the epilogue straight
// from registers.  The threads map to (column, point) per pass:
// column-fastest where the pass touches device memory along the columns
// (both first passes, stage B's last pass: its loads run along a or c, its
// W stores along t), point-fastest elsewhere (stage A's last pass stores T
// along c in whole 128-byte lines).
//   cwt_stage_a: one block per (signal*scale row, tile of consecutive a).
//     The first pass loads its 16 bins of X (rows b < R2/2 only for analytic
//     mothers, as K1 does), builds Hbar_s in registers and multiplies; the
//     last pass applies e^{2 pi i a c / N}, as the product of at most three
//     roots (sincospif of exact arguments) that each thread computes once
//     for all its points, and writes T[row, a, c].
//   cwt_stage_b: one block per (row, tile of consecutive c).  The first pass
//     loads T[row, a, c-tile] (32-byte segments at cols = 8); the last pass
//     scales by 1/N and writes W planes, complex64 W (one float2 a point,
//     the layout of a complex tensor), |W|^2, or per-block partial sums of
//     |W|^2 (per thread, then a fixed tree over the block) that a second,
//     fixed-order pass reduces: no float atomics, so a batch gives the same
//     bits as one signal at a time.
// The cost left in the design is the round trip of T through device memory
// (written by stage A, read by stage B): twice the bytes of a single pass.
//
// bf16 T (precision="fast"; pallas_fft.py:699-705).  The TPU package stores
// T in bf16 at its fast tier: kernel A rounds its output (pallas_fft.py:
// 280-283), kernel B widens it back to f32 (:305-306).  Here the element
// type TT of T is a template parameter, float by default: the bf16
// instantiations (entries cwt_stage_a_bf16, cwt_stage_b_bf16) write T with
// __float2bfloat16_rn, round to nearest even as astype(jnp.bfloat16), and
// widen it on load; every other operation is the f32 kernels' own.  This
// halves T's round trip: at N = 2^20, S = 64 stage A writes 268.4 MB of T
// and stage B reads it, about 0.08 ms each at 3.35 TB/s.
//
// Wide blocks (StageB).  Stage B reads T along c and stores W along t in
// rows of `cols` elements, and a row shorter than a 32-byte sector leaves
// the rest of the sector unused.  A 512-thread block holds 8192/R1 columns:
// 8 f32 at R1 = 1024 (32-byte rows; 53-70 % of the byte bound), but 4 at
// R1 = 2048, 16-byte rows of T and of W, where the f32 kernel ran its planes
// at 19.5 % of the bound and its loads alone (power_sum) at 40 %.  So these
// instantiations take blocks of 1024 threads (still 64 registers a thread,
// one block an SM: the same 32 warps an SM as two 512-thread blocks), which
// hold twice the columns, 16384/R1:
//   - R1 = 2048, f32 T: 8 columns, rows of T and of W 32 bytes; the first
//     pass reads T straight into registers, the last stores W along t in
//     rows of 8 floats (of 8 float2, 64 bytes, in the complex epilogue).
//     ~142 KB of shared memory.
//   - R1 = 1024, bf16 T: 16 columns, 32-byte rows of T read straight into
//     registers, W stored in rows of 16 floats (64 bytes).  ~142 KB.
//   - R1 = 2048, bf16 T: 8 columns are 16-byte rows of T, and 32-byte
//     segments read T at 3.4 times the rate of 16-byte ones in planes mode.
//     So a pair of blocks (a thread block cluster) stages its 16 columns:
//     each block copies half of the rows, 32 bytes each, into shared memory
//     after its FFT buffer with cp.async, and each reads its 8 columns from
//     both halves, its own and its peer's (distributed shared memory),
//     before its first pass; a block arrives at a cluster barrier once its
//     reads are done and waits on it only before it exits.  W goes out in
//     rows of 8 floats, as the f32 kernel's.  ~208 KB a block.
// Every other instantiation keeps 512 threads, two blocks an SM: its rows
// are 32 bytes or more up to R1 = 1024 (f32) and 512 (bf16), and 2 and 1
// columns above R1 = 2048 (nfft >= 2^24).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "fft_common.cuh"

namespace {

// Threads of a block at most: cols * R / 16 <= 512, i.e. cols * R <= 8192
// (_BLOCK_POINTS in ops/fused_cwt.py); two such blocks fit on one SM.
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kReduceThreads = 256;
using bf16 = __nv_bfloat16;

template <typename TT>
constexpr bool kIsBf16 = std::is_same_v<TT, bf16>;

// T's elements: f32 as they are, bf16 rounded to nearest even on the store
// and widened (exactly) on the load.
template <typename TT>
__device__ __forceinline__ void store_t(TT* p, float x) {
  if constexpr (kIsBf16<TT>) {
    *p = __float2bfloat16_rn(x);
  } else {
    *p = x;
  }
}

template <typename TT>
__device__ __forceinline__ float load_t(const TT* p) {
  if constexpr (kIsBf16<TT>) {
    return __bfloat162float(*p);
  } else {
    return *p;
  }
}

// Stage B's block: kThreads threads (kBlocksPerSM an SM) over `cols`
// columns.  Both T types at R1 = 2048 and a bf16 T at R1 = 1024 take wide
// blocks of 1024 threads, kCols = 16384/R columns (8 and 16); a bf16 T at
// R1 = 2048 runs a pair of them, a cluster, that stages its 16 columns (the
// note at the top).  Every other instantiation keeps 512 threads, two
// blocks an SM.
template <int LOG_R, typename TT>
struct StageB {
  static constexpr bool kWide = LOG_R == 11 || (kIsBf16<TT> && LOG_R == 10);
  static constexpr bool kPair = kIsBf16<TT> && LOG_R == 11;
  static constexpr int kThreads = kWide ? 2 * kMaxThreads : kMaxThreads;
  static constexpr int kBlocksPerSM = kWide ? 1 : kMinBlocks;
  static constexpr int kCols = (16 * kThreads) >> LOG_R;
};

// One asynchronous copy of 16 bytes from device to shared memory, both
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Waits for every copy this thread issued; a barrier then publishes them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Bytes a pair's staged half-tile takes: [plane][R/2][16] bf16.
template <int LOG_R>
constexpr int kPairHalfBytes = 2 * (1 << LOG_R) / 2 * 16 * 2;

// First float2 slot of a pair's half-tile: after the twiddles (tw slots)
// and the FFT buffer, 16-byte aligned.
__host__ __device__ inline int pair_half_slot(int tw, int cols, int ld) {
  return (tw + cols * ld + 1) & ~1;
}

// v[r] = T[row, lt + r*R/16, c0 + j] of a wide block at R = 2048 (kPair):
// the two blocks of the cluster own columns c0 and c0 + 8 of one 16-column
// group.  Block `rank` copies rows [rank*R/2, (rank+1)*R/2) of all 16, both
// planes, into `half` ([plane][R/2][16], 32-byte rows, 2 pieces of 16 bytes
// by neighbouring threads), the cluster waits, then each reads its 8
// columns: rows below R/2 (r < 8) from block 0's half, the others from
// block 1's, and arrives at the cluster barrier that the kernel waits on
// before it exits (a block's shared memory must outlive its peer's reads).
template <int LOG_R, typename TT>
__device__ __forceinline__ void load_pair(float2* v, TT* half, const TT* tr, const TT* ti,
                                          long long first, int R2, int j, int lt, int tid) {
  namespace cg = cooperative_groups;
  constexpr int R = 1 << LOG_R;
  constexpr int H = R / 2;
  constexpr int TC = R / 16;
  constexpr int C = StageB<LOG_R, TT>::kCols;
  static_assert(StageB<LOG_R, TT>::kPair && 2 * C == 16 && 8 * TC == H,
                "a pair stages 16 columns; rows r < 8 of a thread lie in the first half");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // first: the offset of T[row, 0, c0] for this block; its group starts
  // rank*C columns before, its half rank*H rows below
  const long long base = first - rank * C + (long long)rank * H * R2;
  for (int e = tid; e < 2 * H * 2; e += StageB<LOG_R, TT>::kThreads) {
    const int part = e & 1;
    const int pa = e >> 1;   // plane * H + (a - rank*H)
    const int plane = pa >= H;
    const TT* src = (plane ? ti : tr) + base + (long long)(pa - plane * H) * R2 + part * 8;
    cp_async16(half + pa * 16 + part * 8, src);
  }
  cp_async_wait_all();
  cluster.sync();   // both halves are in place
  const TT* h0 = cluster.map_shared_rank(half, 0);
  const TT* h1 = cluster.map_shared_rank(half, 1);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const TT* h = r < 8 ? h0 : h1;
    const int a = (lt + r * TC) & (H - 1);
    v[r] = make_float2(load_t(h + a * 16 + rank * C + j),
                       load_t(h + (H + a) * 16 + rank * C + j));
  }
  // this block's reads of both halves are done
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// e^{+2 pi i m / n} for 0 <= m < n, n a power of two, inv = 2/n.
__device__ __forceinline__ float2 unit_root(int m, int n, float inv) {
  float s, c;
  if (n <= (1 << 23)) {
    // m < 2^23 and 2/n a power of two: the argument is exact in f32.
    sincospif((float)m * inv, &s, &c);
  } else {
    double sd, cd;
    sincospi((double)(2LL * m) / (double)n, &sd, &cd);
    s = (float)sd;
    c = (float)cd;
  }
  return make_float2(c, s);
}

template <int LOG_R, typename TT = float>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
cwt_stage_a_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long x_stride, const float* __restrict__ scales,
                   TT* __restrict__ tr, TT* __restrict__ ti,
                   int S, int R1, int rows, int log_cols, int ld,
                   int mother, float f0, int m, float cre, float cim, float dt,
                   float omega0) {
  using P = ColumnPlan<LOG_R>;
  constexpr int R = P::kR;            // R2: the column length
  constexpr int TC = P::kTC;
  constexpr int RL = P::kLast;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + P::kTw;

  const int tid = threadIdx.x;
  const int cols = 1 << log_cols;
  const int tiles = R1 >> log_cols;
  const long long row = blockIdx.x / tiles;        // signal * S + scale
  const int a0 = (int)(blockIdx.x - row * tiles) << log_cols;
  const long long sig = row / S;
  const int n = R1 * R;
  // column-fastest (first pass: X's loads run along a) and point-fastest
  // (the other passes; T's stores run along c)
  const int j1 = tid & (cols - 1), l1 = tid >> log_cols;
  const int j2 = tid / TC, l2 = tid % TC;

  // X's bins b = l1 + r*R/16 of column a0 + j1 first: their latency hides
  // under the twiddle build.
  const float* xrs = xr + sig * x_stride;
  const float* xis = xi + sig * x_stride;
  float xa[16], xb[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const bool live = l1 + r * TC < rows;
    const int k = (l1 + r * TC) * R1 + a0 + j1;
    xa[r] = live ? xrs[k] : 0.0f;
    xb[r] = live ? xis[k] : 0.0f;
  }
  fill_twiddles(tw, R, P::kTw, tid, blockDim.x);

  const float s = scales[row - sig * S];
  const float norm = sqrtf(kTwoPi * s / dt);
  const float hr0 = norm * cre;
  const float hi0 = norm * cim;
  float2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    v[r] = make_float2(0.0f, 0.0f);
    if (l1 + r * TC < rows) {
      const int k = (l1 + r * TC) * R1 + a0 + j1;
      const int kf = k >= n / 2 ? k - n : k;   // fftfreq fold
      const float env = envelope(mother, s * (omega0 * (float)kf), f0, m);
      const float hr = hr0 * env, hi = hi0 * env;
      v[r] = make_float2(xa[r] * hr - xb[r] * hi, xa[r] * hi + xb[r] * hr);
    }
  }
  column_stockham<LOG_R, false>(v, buf, tw, j1 * ld, l1, j2 * ld, l2);

  // Epilogue: output c = lt + q*TC + r*NSL of column a is Z[a, c], times
  // e^{2 pi i ac/N} = A_q * lo[r % 4] * hi[r / 4]: the roots of a*(lt + q*TC),
  // a*(r % 4)*NSL and a*(r / 4)*4*NSL.  16/RL + 6 roots per thread at most
  // (7 at R = 1024), not one per point.
  constexpr int NSL = R / RL;
  constexpr int NLO = RL < 4 ? RL : 4;
  constexpr int NHI = RL / NLO;
  const int j = P::kPasses > 1 ? j2 : j1;
  const int lt = P::kPasses > 1 ? l2 : l1;
  const int a = a0 + j;
  const float inv = 2.0f / (float)n;
  float2 lo[NLO], hi[NHI];
#pragma unroll
  for (int r = 1; r < NLO; ++r) lo[r] = unit_root(a * r * NSL, n, inv);
#pragma unroll
  for (int h = 1; h < NHI; ++h) hi[h] = unit_root(a * h * NLO * NSL, n, inv);
  const long long out = (row * R1 + a) * (long long)R;
#pragma unroll
  for (int q = 0; q < 16 / RL; ++q) {
    const float2 aq = unit_root(a * (lt + q * TC), n, inv);
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      float2 w = aq;
      if (r % NLO) w = cmul(w, lo[r % NLO]);
      if (r / NLO) w = cmul(w, hi[r / NLO]);
      const float2 z = cmul(v[q * RL + r], w);
      const int c = lt + q * TC + r * NSL;
      store_t(tr + out + c, z.x);
      store_t(ti + out + c, z.y);
    }
  }
}

// ABLATE (enum Ablate, fft_common.cuh) is kFull for every caller but
// cwt_stage_b_ablation, whose variants take stages out of this same body:
// kNoTwiddle, kNoExchange and kButterflies out of column_stockham, kMemcopy
// all of it (the first pass's loads go straight to the epilogue's stores).
// TT is T's element type; StageB sets the block for it.  COMPLEX selects the
// complex epilogue (mode kComplex) at compile time, so that the other modes'
// instantiations, which test `mode` at run time, compile as they did before
// it (the same registers and spills).
template <int LOG_R, int ABLATE = kFull, typename TT = float, bool COMPLEX = false>
__global__ void
__launch_bounds__(StageB<LOG_R, TT>::kThreads, StageB<LOG_R, TT>::kBlocksPerSM)
cwt_stage_b_kernel(const TT* __restrict__ tr, const TT* __restrict__ ti,
                   float* __restrict__ out0, float* __restrict__ out1,
                   int R2, int log_cols, int ld, int mode, float inv_n) {
  using P = ColumnPlan<LOG_R>;
  constexpr int R = P::kR;            // R1: the column length
  constexpr int TC = P::kTC;
  constexpr int RL = P::kLast;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + P::kTw;

  const int tid = threadIdx.x;
  const int cols = 1 << log_cols;
  const int tiles = R2 >> log_cols;
  const long long row = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  const int c0 = tile << log_cols;
  const long long n = (long long)R * R2;
  // column-fastest (the first pass's loads along c, the last pass's stores
  // along t) and point-fastest (the passes in between)
  const int j = tid & (cols - 1), lt = tid >> log_cols;
  const int j2 = tid / TC, l2 = tid % TC;

  float2 v[16];
  if constexpr (StageB<LOG_R, TT>::kPair) {
    load_pair<LOG_R>(v, reinterpret_cast<TT*>(smem + pair_half_slot(P::kTw, cols, ld)), tr,
                     ti, row * n + c0, R2, j, lt, tid);
  } else {
    // T[row, a, c0 + j] for a = lt + r*R/16 first, under the twiddle build.
    const TT* trr = tr + row * n + c0 + j;
    const TT* tir = ti + row * n + c0 + j;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const long long q = (long long)(lt + r * TC) * R2;
      v[r] = make_float2(load_t(trr + q), load_t(tir + q));
    }
  }
  if constexpr (ABLATE != kMemcopy) {
    fill_twiddles(tw, R, P::kTw, tid, blockDim.x);

    column_stockham<LOG_R, true, ABLATE>(v, buf, tw, j * ld, lt, j2 * ld, l2);
  }

  // Epilogue: output d = jj + r*R/RL of column c0 + j is W[c0 + j + R2*d]*N.
  float acc = 0.0f;
  const long long out = row * n + c0 + j;
#pragma unroll
  for (int q = 0; q < 16 / RL; ++q) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int d = lt + q * TC + r * (R / RL);
      const float wr = v[q * RL + r].x * inv_n;
      const float wi = v[q * RL + r].y * inv_n;
      const long long t = out + (long long)d * R2;
      if constexpr (COMPLEX) {
        reinterpret_cast<float2*>(out0)[t] = make_float2(wr, wi);
      } else if (mode == kPlanes) {
        out0[t] = wr;
        out1[t] = wi;
      } else if (mode == kPower) {
        out0[t] = wr * wr + wi * wi;
      } else {
        acc += wr * wr + wi * wi;
      }
    }
  }
  if (!COMPLEX && mode == kPowerSum) {
    // Fixed-order tree over the block: the same bits for the same row,
    // whatever the batch.
    __syncthreads();   // the last pass's reads of buf are done
    float* red = reinterpret_cast<float*>(buf);
    red[tid] = acc;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) out0[row * tiles + tile] = red[0];
  }
  if constexpr (StageB<LOG_R, TT>::kPair) {
    // the peer's reads of this block's half are done (load_pair)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// Column stride of a block's buffer, in float2 slots: R points padded one in
// 16, plus up to 15 slots so that the stride is 16/min(cols, 16) mod 16.
// Then the accesses that cross columns (a half-warp of 16 threads over
// min(cols, 16) columns and 16/min(cols, 16) consecutive points) hit 16
// distinct bank pairs.  ops/fused_cwt.py's _column_ld has the same formula.
int column_ld(int R, int cols) {
  const int c = cols < 16 ? cols : 16;
  const int padded = R + R / 16;
  return padded + ((16 / c - padded) % 16 + 16) % 16;
}

// Dynamic shared memory of one block: the twiddle tables, then `cols`
// padded columns (ops/fused_cwt.py's _smem_bytes).
template <int LOG_R>
size_t smem_bytes(int cols) {
  return sizeof(float2) * ((size_t)ColumnPlan<LOG_R>::kTw +
                           (size_t)cols * column_ld(1 << LOG_R, cols));
}

// The plan (p[0], .., p[3]) the caller passed, trailing 1s, must be the
// kernel's: 16 for every pass but the last, then kLast.
template <int LOG_R>
bool plan_matches(const int* plan) {
  using P = ColumnPlan<LOG_R>;
  for (int i = 0; i < 4; ++i) {
    const int want = i < P::kPasses - 1 ? 16 : i == P::kPasses - 1 ? P::kLast : 1;
    if (plan[i] != want) return false;
  }
  return true;
}

// A block may take up to 227 KB of dynamic shared memory: the attribute is
// set once per kernel, process and device.
cudaError_t allow_smem(const void* fn, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// cols a power of two that divides `other`, with cols * R <= 16 * threads
// (8192 for the 512 threads of every block but StageB's wide ones).
bool tile_ok(int R, int cols, int other, int threads = kMaxThreads) {
  return cols >= 1 && (cols & (cols - 1)) == 0 && other % cols == 0 &&
         (long long)cols * R <= 16LL * threads;
}

template <int LOG_R, typename TT>
cudaError_t launch_a(const float* xr, const float* xi, long long x_stride,
                     const float* scales, TT* tr, TT* ti, int B, int S, int R1,
                     int rows, int cols, int mother, float f0, int m, float cre,
                     float cim, float dt, float omega0, const int* plan,
                     cudaStream_t stream) {
  constexpr int R = 1 << LOG_R;
  if (!plan_matches<LOG_R>(plan) || !tile_ok(R, cols, R1) || (rows != R && 2 * rows != R)) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem((const void*)cwt_stage_a_kernel<LOG_R, TT>, done);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * S * (R1 / cols);
  cwt_stage_a_kernel<LOG_R, TT><<<(unsigned)blocks, cols * R / 16, smem_bytes<LOG_R>(cols),
                                  stream>>>(
      xr, xi, x_stride, scales, tr, ti, S, R1, rows, log2i(cols), column_ld(R, cols),
      mother, f0, m, cre, cim, dt, omega0);
  return cudaGetLastError();
}

#define PYCWT_COLUMN_CASES(X) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)

// A wide block (StageB) takes exactly kCols columns; a pair of them is
// launched as a cluster of two blocks.
template <int LOG_R, int ABLATE = kFull, typename TT = float, bool COMPLEX = false>
cudaError_t launch_b(const TT* tr, const TT* ti, float* out0, float* out1,
                     long long rows, int R2, int cols, int mode, float inv_n,
                     const int* plan, cudaStream_t stream) {
  using SB = StageB<LOG_R, TT>;
  constexpr int R = 1 << LOG_R;
  if (!plan_matches<LOG_R>(plan) || !tile_ok(R, cols, R2, SB::kThreads) ||
      (SB::kWide && cols != SB::kCols) || (SB::kPair && R2 % (2 * cols) != 0)) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> done{0};
  const auto kernel = cwt_stage_b_kernel<LOG_R, ABLATE, TT, COMPLEX>;
  cudaError_t err = allow_smem((const void*)kernel, done);
  if (err != cudaSuccess) return err;
  const long long blocks = rows * (R2 / cols);
  if constexpr (SB::kPair) {
    cudaLaunchAttribute pair[1];
    pair[0].id = cudaLaunchAttributeClusterDimension;
    pair[0].val.clusterDim.x = 2;
    pair[0].val.clusterDim.y = 1;
    pair[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(cols * R / 16);
    cfg.dynamicSmemBytes =
        sizeof(float2) * pair_half_slot(ColumnPlan<LOG_R>::kTw, cols, column_ld(R, cols)) +
        kPairHalfBytes<LOG_R>;
    cfg.stream = stream;
    cfg.attrs = pair;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, tr, ti, out0, out1, R2, log2i(cols),
                             column_ld(R, cols), mode, inv_n);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<(unsigned)blocks, cols * R / 16, smem_bytes<LOG_R>(cols), stream>>>(
        tr, ti, out0, out1, R2, log2i(cols), column_ld(R, cols), mode, inv_n);
  }
  return cudaGetLastError();
}

template <typename TT>
cudaError_t stage_a(const float* xr, const float* xi, long long x_stride,
                    const float* scales, TT* tr, TT* ti, int B, int S, int R1, int R2,
                    int rows, int cols, int mother, float f0, int m, float cre, float cim,
                    float dt, float omega0, const int* plan, cudaStream_t stream) {
  if (B < 1 || S < 1) return cudaErrorInvalidValue;
#define PYCWT_STAGE_A_CASE(LOG_R)                                                      \
  case 1 << LOG_R:                                                                     \
    return launch_a<LOG_R, TT>(xr, xi, x_stride, scales, tr, ti, B, S, R1, rows, cols, \
                               mother, f0, m, cre, cim, dt, omega0, plan, stream);
  switch (R2) {
    PYCWT_COLUMN_CASES(PYCWT_STAGE_A_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PYCWT_STAGE_A_CASE
}

template <typename TT>
cudaError_t stage_b(const TT* tr, const TT* ti, float* out0, float* out1, long long rows,
                    int R1, int R2, int cols, int mode, float inv_n, const int* plan,
                    cudaStream_t st) {
  if (rows < 1 || mode < kPlanes || mode > kComplex) return cudaErrorInvalidValue;
  cudaError_t err;
#define PYCWT_STAGE_B_CASE(LOG_R)                                                      \
  case 1 << LOG_R:                                                                     \
    err = mode == kComplex                                                             \
              ? launch_b<LOG_R, kFull, TT, true>(tr, ti, out0, out1, rows, R2, cols, mode, \
                                                 inv_n, plan, st)                      \
              : launch_b<LOG_R, kFull, TT>(tr, ti, out0, out1, rows, R2, cols, mode,   \
                                           inv_n, plan, st);                           \
    break;
  switch (R1) {
    PYCWT_COLUMN_CASES(PYCWT_STAGE_B_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PYCWT_STAGE_B_CASE
  if (err != cudaSuccess || mode != kPowerSum) return err;
  const unsigned rblocks = (unsigned)((rows + kReduceThreads - 1) / kReduceThreads);
  cwt_stage_b_reduce_kernel<<<rblocks, kReduceThreads, 0, st>>>(out0, out1, rows,
                                                                R2 / cols);
  return cudaGetLastError();
}

}  // namespace

// cwt_stage_b_ablation's column lengths: 16 to 2048 (nfft 2^8 to 2^23)
#define PYCWT_ABLATION_CASES(X) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11)

extern "C" {

// X: planar rows x_stride apart, B signals; scales: S; T out: (B*S, R1, R2)
// f32.  The radix plan (p0, .., p3) of the length-R2 columns must be
// _column_radix_plan(R2), padded with 1s; any other is refused.
cudaError_t cwt_stage_a(const float* xr, const float* xi, long long x_stride,
                        const float* scales, float* tr, float* ti,
                        int B, int S, int R1, int R2, int rows, int cols,
                        int mother, float f0, int m, float cre, float cim,
                        float dt, float omega0, int p0, int p1, int p2, int p3,
                        void* stream) {
  const int plan[4] = {p0, p1, p2, p3};
  return stage_a<float>(xr, xi, x_stride, scales, tr, ti, B, S, R1, R2, rows, cols,
                        mother, f0, m, cre, cim, dt, omega0, plan, (cudaStream_t)stream);
}

// cwt_stage_a with T bf16, rounded to nearest even (precision="fast").
cudaError_t cwt_stage_a_bf16(const float* xr, const float* xi, long long x_stride,
                             const float* scales, void* tr, void* ti,
                             int B, int S, int R1, int R2, int rows, int cols,
                             int mother, float f0, int m, float cre, float cim,
                             float dt, float omega0, int p0, int p1, int p2, int p3,
                             void* stream) {
  const int plan[4] = {p0, p1, p2, p3};
  return stage_a<bf16>(xr, xi, x_stride, scales, static_cast<bf16*>(tr),
                       static_cast<bf16*>(ti), B, S, R1, R2, rows, cols, mother, f0, m,
                       cre, cim, dt, omega0, plan, (cudaStream_t)stream);
}

// T: (rows, R1, R2) f32.  mode 0: out0/out1 = W planes (rows, N); mode 1:
// out0 = |W|^2 (rows, N); mode 2: out0 = partials (rows, R2/cols) scratch,
// out1 = sum_t |W|^2 (rows,); mode 3: out0 = complex64 W (rows, N) as
// interleaved (re, im) pairs, 8-byte aligned, out1 unused.  cols must be 8
// at R1 = 2048 (StageB's wide block), else _tile_cols(R1, R2):
// ops/fused_cwt.py's _stage_b_cols.  The plan of the length-R1 columns must
// be _column_radix_plan(R1), padded with 1s.
cudaError_t cwt_stage_b(const float* tr, const float* ti, float* out0, float* out1,
                        long long rows, int R1, int R2, int cols, int mode,
                        float inv_n, int p0, int p1, int p2, int p3, void* stream) {
  const int plan[4] = {p0, p1, p2, p3};
  return stage_b<float>(tr, ti, out0, out1, rows, R1, R2, cols, mode, inv_n, plan,
                        (cudaStream_t)stream);
}

// cwt_stage_b on a bf16 T (precision="fast"), widened exactly to f32; at
// R1 = 1024 and 2048 cols must be 16 and 8 (StageB's wide blocks), else
// _tile_cols(R1, R2).
cudaError_t cwt_stage_b_bf16(const void* tr, const void* ti, float* out0, float* out1,
                             long long rows, int R1, int R2, int cols, int mode,
                             float inv_n, int p0, int p1, int p2, int p3, void* stream) {
  const int plan[4] = {p0, p1, p2, p3};
  return stage_b<bf16>(static_cast<const bf16*>(tr), static_cast<const bf16*>(ti), out0,
                       out1, rows, R1, R2, cols, mode, inv_n, plan, (cudaStream_t)stream);
}

// cwt_stage_b's planes mode with the stages of `variant` taken out (enum
// Ablate: 0 full, the kernel itself; 1 no twiddles; 2 no exchange; 3 the
// in-register DFTs alone; 4 loads and stores alone), the same grid, blocks
// (cols as for cwt_stage_b), shared memory and bytes: T (rows, R1, R2) in,
// W planes (rows, N) out, for R1 from 16 to 2048.  Counterpart of tools/tpu_relayout_experiment.py's
// ablated kernel B; every variant but 0 computes wrong numbers by design.
cudaError_t cwt_stage_b_ablation(const float* tr, const float* ti, float* out0,
                                 float* out1, long long rows, int R1, int R2, int cols,
                                 float inv_n, int p0, int p1, int p2, int p3,
                                 int variant, void* stream) {
  const int plan[4] = {p0, p1, p2, p3};
  if (rows < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define PYCWT_ABLATION_VARIANT(LOG_R, V)                                              \
  case V:                                                                             \
    return launch_b<LOG_R, V>(tr, ti, out0, out1, rows, R2, cols, kPlanes, inv_n, plan, \
                              st);
#define PYCWT_ABLATION_CASE(LOG_R)                                                    \
  case 1 << LOG_R:                                                                    \
    switch (variant) {                                                                \
      PYCWT_ABLATION_VARIANT(LOG_R, kFull)                                            \
      PYCWT_ABLATION_VARIANT(LOG_R, kNoTwiddle)                                       \
      PYCWT_ABLATION_VARIANT(LOG_R, kNoExchange)                                      \
      PYCWT_ABLATION_VARIANT(LOG_R, kButterflies)                                     \
      PYCWT_ABLATION_VARIANT(LOG_R, kMemcopy)                                         \
      default:                                                                        \
        return cudaErrorInvalidValue;                                                 \
    }
  switch (R1) {
    PYCWT_ABLATION_CASES(PYCWT_ABLATION_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef PYCWT_ABLATION_CASE
#undef PYCWT_ABLATION_VARIANT
}

}  // extern "C"

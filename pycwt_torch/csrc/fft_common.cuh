// Device helpers shared by the port's CUDA kernels: the mothers' envelopes,
// the in-register radix-2/4/8/16 inverse DFT, the padded shared-memory
// layout and the Stockham (autosort) passes, and the column FFT that
// cwt_stage_a and cwt_stage_b (fused_cwt.cu) run on.  cwt_direct
// (direct_cwt.cu) runs its rows on the same passes.
//
// Every routine computes the positive-exponent, unscaled DFT in f32.  No
// fast-math intrinsics: __expf/__sinf lose the 1e-5 bound at large s*omega,
// and every twiddle is sincospif of an exact f32 argument.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;

enum Mother { kMorlet = 0, kPaul = 1, kDog = 2 };
// Epilogues: W planes, |W|^2, sum_t |W|^2, and interleaved complex64 W
// (cwt_stage_b only; cwt_direct refuses it).
enum Mode { kPlanes = 0, kPower = 1, kPowerSum = 2, kComplex = 3 };
// Stages that an ablation variant of cwt_stage_b takes out of the column FFT
// (pycwt_torch/tools/relayout_experiment.py), bit flags: kNoTwiddle drops the
// twiddle multiplies of the passes after the first, kNoExchange the
// shared-memory round trip between passes, both together leave the
// in-register radix DFTs (kButterflies); kMemcopy runs no pass at all.  0
// (kFull) is the kernel every caller runs.  Wrong numbers by design.
enum Ablate { kFull = 0, kNoTwiddle = 1, kNoExchange = 2, kButterflies = 3, kMemcopy = 4 };

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
  // DOG: exactly 0 wherever e^{-f^2/2} underflows, where f^m alone may
  // overflow f32 (f >~ 2.6e6 at m = 6) and the product be inf * 0 = NaN
  float e = expf(-0.5f * (f * f));
  return e == 0.0f ? 0.0f : int_pow(f, m) * e;
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

// Slot of point p of a padded sequence: one pad in 16 keeps the stride-16
// writes of a first pass off a single bank.
__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// Twiddle tables of the Stockham passes of an R-point sequence, R a power of
// two in [16, 8192], `count` entries: tw[r*16 + c] = e^{2 pi i c r / 256}
// (256 entries), then lo[j] = w^j (64) and hi[j] = w^{64 j} (R/64) with
// w = e^{2 pi i / R} when a pass has NS >= 256.  Filled by the block's
// `nthreads` threads; the caller's next barrier publishes them.
__device__ __forceinline__ void fill_twiddles(float2* tw, int R, int count, int tid,
                                              int nthreads) {
  for (int e = tid; e < count; e += nthreads) {
    float arg;
    if (e < 256) {
      arg = (float)(2 * (e & 15) * (e >> 4)) / 256.0f;
    } else if (e < 256 + 64) {
      arg = (float)(2 * (e - 256)) / (float)R;
    } else {
      arg = (float)(2 * 64 * (e - 256 - 64)) / (float)R;
    }
    float sn, cs;
    sincospif(arg, &sn, &cs);
    tw[e] = make_float2(cs, sn);
  }
}

// Twiddle e^{2 pi i c r / (NS RP)} of a Stockham pass of radix RP over the
// points of an N-point sequence already combined in groups of NS: for NS = 16
// from the table of 256th roots; for NS >= 256 as lo[j % 64] * hi[j / 64]
// with j = c r N / (NS RP) < N.
template <int NS, int RP, int N>
__device__ __forceinline__ float2 twiddle(const float2* tw, int c, int r) {
  static_assert(NS >= 16, "the first pass has no twiddles");
  if constexpr (NS == 16) {
    return tw[r * (16 / RP) * 16 + c];
  } else {
    const int j = c * r * (N / (NS * RP));
    return cmul(tw[256 + (j & 63)], tw[256 + 64 + (j >> 6)]);
  }
}

// Stockham pass of radix R over an N-point sequence whose points are already
// combined in groups of NS, the sequence at slots base + pad(p) of buf:
// butterfly jj (16/R of them per thread, TR apart) reads x[jj + r*N/R],
// multiplies by the twiddle of (jj % NS, r), and runs an R-point DFT; the
// results stay in v for pass_store (or the caller's epilogue).  ABLATE (enum
// Ablate) drops the read of buf, the butterfly then taking v[q*R + r] as the
// thread holds it, and/or the twiddle multiply.
template <int R, int NS, int N, int TR, int ABLATE = kFull>
__device__ __forceinline__ void pass_load(float2* v, const float2* buf, const float2* tw,
                                          int base, int lt) {
#pragma unroll
  for (int q = 0; q < 16 / R; ++q) {
    const int jj = lt + q * TR;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (!(ABLATE & kNoExchange)) v[q * R + r] = buf[base + pad(jj + r * (N / R))];
      if constexpr (!(ABLATE & kNoTwiddle)) {
        if (r > 0) v[q * R + r] = cmul(v[q * R + r], twiddle<NS, R, N>(tw, jj % NS, r));
      }
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
    for (int r = 0; r < R; ++r) buf[base + pad(d + r * NS)] = v[q * R + r];
  }
}

// The column FFT of cwt_stage_a and cwt_stage_b: R = 2^LOG_R points in
// [16, 8192], R/16 threads per column with 16 points each, radix-16 passes
// and a last pass of radix 2, 4, 8 or 16 (ops/fused_cwt.py's
// _column_radix_plan): 16 | 16*2..16*16 | 16*16*2..16*16*16 | 16*16*16*2.
template <int LOG_R>
struct ColumnPlan {
  static_assert(LOG_R >= 4 && LOG_R <= 13, "column length outside [16, 8192]");
  static constexpr int kR = 1 << LOG_R;
  static constexpr int kTC = kR / 16;                        // threads per column
  static constexpr int kPasses = (LOG_R + 3) / 4;
  static constexpr int kLastNS = 1 << (4 * (kPasses - 1));   // groups before the last pass
  static constexpr int kLast = kR / kLastNS;                 // radix of the last pass
  static constexpr int kTw = kPasses < 2 ? 0 : 256 + (kPasses > 2 ? 64 + kR / 64 : 0);
};

template <int NS, int R, int TC, int ABLATE>
__device__ __forceinline__ void inner_pass(float2* v, float2* buf, const float2* tw,
                                           int base, int lt) {
  pass_load<16, NS, R, TC, ABLATE>(v, buf, tw, base, lt);
  if constexpr (!(ABLATE & kNoExchange)) {
    __syncthreads();   // every read of this pass is done
    pass_store<16, NS, TC>(v, buf, base, lt);
    __syncthreads();
  }
}

// Inverse DFT of the block's columns.  The threads map to (column, lt) two
// ways, since the columns sit in shared memory between passes: column-fastest
// (`col_*`) for the first pass, whose points each thread holds on entry as
// v[r] = x[lt + r*R/16], and point-fastest (`pt_*`) for the radix-16 passes
// in between; the last pass loads by columns when LAST_BY_COLUMN, else by
// points.  `*_base` is the column's first slot in buf, `*_lt` the thread's
// index in the column.  On return, v[q*RL + r] holds output jj + r*R/RL,
// jj = lt + q*R/16, of the last pass's map (RL = kLast; the column map when
// there is one pass).  The tw table (fill_twiddles, kTw entries) must be
// filled before the call; every thread of the block calls it.
//
// ABLATE != kFull (enum Ablate; cwt_stage_b's ablation variants only) takes
// stages out.  Without the exchange (kNoExchange) nothing goes through buf:
// every pass runs on the thread's own registers, the thread keeps the column
// map (lt = col_lt in every pass's twiddle index jj = lt + q*R/16), and the
// one barrier left publishes the twiddle table (none without twiddles
// either).  The result is then wrong by design, and the output map above
// holds with lt = col_lt.
template <int LOG_R, bool LAST_BY_COLUMN, int ABLATE = kFull>
__device__ __forceinline__ void column_stockham(float2* v, float2* buf, const float2* tw,
                                                int col_base, int col_lt,
                                                int pt_base, int pt_lt) {
  using P = ColumnPlan<LOG_R>;
  static_assert(ABLATE >= kFull && ABLATE <= kButterflies, "no such column ablation");
  constexpr bool kExchange = !(ABLATE & kNoExchange);
  dft<16>(v);
  if constexpr (P::kPasses > 1) {
    if constexpr (kExchange) pass_store<16, 1, P::kTC>(v, buf, col_base, col_lt);
    // the first pass's results and the twiddles are in place
    if constexpr (ABLATE != kButterflies) __syncthreads();
    const int base = kExchange ? pt_base : col_base;
    const int lt = kExchange ? pt_lt : col_lt;
    if constexpr (P::kPasses > 2) inner_pass<16, P::kR, P::kTC, ABLATE>(v, buf, tw, base, lt);
    if constexpr (P::kPasses > 3) inner_pass<256, P::kR, P::kTC, ABLATE>(v, buf, tw, base, lt);
    pass_load<P::kLast, P::kLastNS, P::kR, P::kTC, ABLATE>(
        v, buf, tw, LAST_BY_COLUMN || !kExchange ? col_base : pt_base,
        LAST_BY_COLUMN || !kExchange ? col_lt : pt_lt);
  }
}

}  // namespace

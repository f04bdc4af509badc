// The coherence head on Hopper: the two packed, scale-normalised fields of
// two planar transforms in one launch.
//
// Replaces no Pallas kernel: pycwt_tpu builds the fields with jnp ops under
// jit, which XLA fuses.  The port's torch path (coherence._planar_fields)
// built them in 18 element-wise launches, each reading and writing a whole
// f32 plane: |W1|^2 and |W2|^2 (square, square, add, divide by the scale),
// the packing into S1 + i*S2, the cross product's four products, its sum
// and difference, the two divisions and the packing into C: ~192 bytes a
// point.  This kernel reads the four planes once and writes the two
// complex64 fields, and the cross planes where the caller keeps them:
//
//   w1r, w1i, w2r, w2i  (R, S, n) f32, point (r, s, t) at r*sr + s*ss + t*st
//   scales              (S,) f32
//   sf  S = (w1r^2 + w1i^2)/s + i*(w2r^2 + w2i^2)/s, (R, S, n) complex64
//   cf  C = (w1r*w2r + w1i*w2i)/s + i*(w1i*w2r - w1r*w2i)/s, the same
//   xr, xi  the unscaled cross planes w1r*w2r + w1i*w2i and
//           w1i*w2r - w1r*w2i, (R, S, n) f32, or null
//
// The strides are the planes' own, so every layout of the planar route is
// read in place: rows of pitch nfft where they are the trimmed views of
// width-nfft transforms (the Monte-Carlo chunks, the WCT), of pitch n where
// they are whole (the overlap-save chunks), and points two floats apart
// where the planes are the real and imaginary views of a complex64 W (the
// plain transform that the planar route runs below nfft 2^8).
//
// Bit for bit with the torch path on the card: each product, sum,
// difference and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc would contract a*b + c into an FMA, torch
// rounds each op), and the scale divides, as torch's division does; its
// reciprocal is never taken.
//
// Layout: a block of 256 threads takes 1024 consecutive points of one (r, s)
// row, four a thread.  Where the points are consecutive, the row and scale
// strides multiples of 4 and the planes 16-byte aligned, a thread reads its
// points as one float4 from each plane;
// where n is even it writes each field as two float4 (two complex points
// each), and where n is a multiple of 4 each cross plane as one float4.
// The row's last, partial group goes point by point.  The inputs are read
// once (__ldcs: streamed, not kept in L2).
//
// Bound on the card: bytes.  32 a point (16 read, 16 written), 40 with the
// cross planes: a wct_matrix_mc_32st chunk of 45 x 9 x 110 x 6302 points
// moves 8.98 GB, 2.68 ms at 3.35 TB/s.  Four IEEE divisions a point cost
// well under that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                    // consecutive points a thread
constexpr int kTile = kThreads * kVec;     // points of a block's row slice

struct Head {
  float s1, s2, cr, ci, xr, xi;
};

// The head of one point in the torch path's rounding order.
__device__ __forceinline__ Head head_of(float a, float b, float c, float d, float s) {
  Head h;
  h.s1 = __fdiv_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), s);
  h.s2 = __fdiv_rn(__fadd_rn(__fmul_rn(c, c), __fmul_rn(d, d)), s);
  h.xr = __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, d));
  h.xi = __fsub_rn(__fmul_rn(b, c), __fmul_rn(a, d));
  h.cr = __fdiv_rn(h.xr, s);
  h.ci = __fdiv_rn(h.xi, s);
  return h;
}

template <bool CROSS>
__global__ void __launch_bounds__(kThreads)
wct_fields_head_kernel(const float* __restrict__ w1r, const float* __restrict__ w1i,
                       const float* __restrict__ w2r, const float* __restrict__ w2i,
                       const float* __restrict__ scales, float2* __restrict__ sf,
                       float2* __restrict__ cf, float* __restrict__ xr,
                       float* __restrict__ xi, int S, int n, long long sr, long long ss,
                       long long st, int tiles, bool vec_in, bool vec_fields,
                       bool vec_cross) {
  const long long row = blockIdx.x / tiles;  // r * S + s
  const int t = (int)(blockIdx.x - row * tiles) * kTile + threadIdx.x * kVec;
  if (t >= n) return;
  const long long r = row / S;
  const int si = (int)(row - r * S);
  const float s = __ldg(scales + si);
  const long long in = r * sr + si * ss + t * st;
  const long long out = row * (long long)n + t;
  const bool full = t + kVec <= n;

  float a[kVec], b[kVec], c[kVec], d[kVec];
  if (full && vec_in) {
    const float4 va = __ldcs(reinterpret_cast<const float4*>(w1r + in));
    const float4 vb = __ldcs(reinterpret_cast<const float4*>(w1i + in));
    const float4 vc = __ldcs(reinterpret_cast<const float4*>(w2r + in));
    const float4 vd = __ldcs(reinterpret_cast<const float4*>(w2i + in));
    a[0] = va.x; a[1] = va.y; a[2] = va.z; a[3] = va.w;
    b[0] = vb.x; b[1] = vb.y; b[2] = vb.z; b[3] = vb.w;
    c[0] = vc.x; c[1] = vc.y; c[2] = vc.z; c[3] = vc.w;
    d[0] = vd.x; d[1] = vd.y; d[2] = vd.z; d[3] = vd.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool here = t + j < n;
      const long long at = in + j * st;
      a[j] = here ? __ldcs(w1r + at) : 0.f;
      b[j] = here ? __ldcs(w1i + at) : 0.f;
      c[j] = here ? __ldcs(w2r + at) : 0.f;
      d[j] = here ? __ldcs(w2i + at) : 0.f;
    }
  }

  Head h[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) h[j] = head_of(a[j], b[j], c[j], d[j], s);

  if (full && vec_fields) {
    float4* so = reinterpret_cast<float4*>(sf + out);
    float4* co = reinterpret_cast<float4*>(cf + out);
    so[0] = make_float4(h[0].s1, h[0].s2, h[1].s1, h[1].s2);
    so[1] = make_float4(h[2].s1, h[2].s2, h[3].s1, h[3].s2);
    co[0] = make_float4(h[0].cr, h[0].ci, h[1].cr, h[1].ci);
    co[1] = make_float4(h[2].cr, h[2].ci, h[3].cr, h[3].ci);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (t + j < n) {
        sf[out + j] = make_float2(h[j].s1, h[j].s2);
        cf[out + j] = make_float2(h[j].cr, h[j].ci);
      }
    }
  }
  if (CROSS) {
    if (full && vec_cross) {
      *reinterpret_cast<float4*>(xr + out) = make_float4(h[0].xr, h[1].xr, h[2].xr, h[3].xr);
      *reinterpret_cast<float4*>(xi + out) = make_float4(h[0].xi, h[1].xi, h[2].xi, h[3].xi);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (t + j < n) {
          xr[out + j] = h[j].xr;
          xi[out + j] = h[j].xi;
        }
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Writes the fields s = S1 + i S2 and c = S12r + i S12i ((R, S, n)
// complex64, contiguous) of the f32 planes w1r, w1i, w2r, w2i (point (r,
// s, t) at r*sr + s*ss + t*st, in floats) over scales (S,), and the cross
// planes xr, xi ((R, S, n) f32, contiguous) unless both are null.
cudaError_t wct_fields_head(const float* w1r, const float* w1i, const float* w2r,
                            const float* w2i, const float* scales, float* s, float* c,
                            float* xr, float* xi, long long R, int S, int n, long long sr,
                            long long ss, long long st, void* stream) {
  if (R < 1 || S < 1 || n < 1 || sr < 0 || ss < 0 || st < 0 ||
      (xr == nullptr) != (xi == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const long long blocks = R * S * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec_in = st == 1 && sr % kVec == 0 && ss % kVec == 0 && aligned16(w1r) &&
                      aligned16(w1i) && aligned16(w2r) && aligned16(w2i);
  const bool vec_fields = n % 2 == 0 && aligned16(s) && aligned16(c);
  const bool cross = xr != nullptr;
  const bool vec_cross = cross && n % kVec == 0 && aligned16(xr) && aligned16(xi);
  auto* sf = reinterpret_cast<float2*>(s);
  auto* cf = reinterpret_cast<float2*>(c);
  const dim3 grid((unsigned)blocks), block(kThreads);
  auto strm = (cudaStream_t)stream;
  if (cross) {
    wct_fields_head_kernel<true><<<grid, block, 0, strm>>>(
        w1r, w1i, w2r, w2i, scales, sf, cf, xr, xi, S, n, sr, ss, st, tiles, vec_in,
        vec_fields, vec_cross);
  } else {
    wct_fields_head_kernel<false><<<grid, block, 0, strm>>>(
        w1r, w1i, w2r, w2i, scales, sf, cf, nullptr, nullptr, S, n, sr, ss, st, tiles,
        vec_in, vec_fields, false);
  }
  return cudaGetLastError();
}

}  // extern "C"

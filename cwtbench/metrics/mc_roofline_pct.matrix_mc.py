"""Share of its roofline bound at which a cold ``wct_matrix_analysis``
call (the maps of every pair and each pair's 300-member Monte-Carlo null)
runs on the card.

The work counted is the call's own, worked out from the entry's ``shape``
whatever implements it, so a change of chunking, fusing or deduplication
in the program leaves it valid:

* the maps: ``matrix_roofline_pct``'s count of a ``wct_matrix`` call (the
  stations' transforms and self-smoothings, every pair's cross row);
* the nulls: the call's distinct nulls, as the reference's deduplication
  counts them (``shape["nulls"]``, one count per network), times
  ``mc_count`` member pairs, each, with an FFT of N points at 5 N log2 N
  (2.5 N log2 N for a real one) on the surrogates' grid (S scales, nfft
  N): two CWTs (a real FFT, then for each scale the filter multiply,
  6 N, and the inverse FFT), two self-smoothings of |W|^2 / s (4 N, a real
  forward and inverse FFT, the Gaussian, 2 N, the L-tap boxcar, 2 L N)
  and the cross smoothing with the ratio (W1 conj(W2) over s, 8 N, a
  complex forward and inverse FFT, the Gaussian, 2 N, the boxcar on both
  planes, 4 L N, |S12|^2 over S1 S2, 5 N); about 0.49 GFLOP at S 110 and
  nfft 8192.  Overdrawn members and padded nulls are the program's and
  are not counted;
* bytes: the maps' (the stations in, WCT and phase out) and the counts,
  S x 1000 int64 a null; the surrogates are drawn on the card;
* bound: the larger of bytes over the HBM bandwidth and operations over the
  float32 peak, summed over the calls of the profiled slice;
* time: the device time of every operation those calls ran, but the
  copies to the host, which are the link's.
"""
import math
import os

from cwtbench import harness, peaks

MAPS = harness.load_module("metrics", "matrix_roofline_pct",
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NBINS = 1000


def member_ops(shape: dict) -> float:
    """Operations of one member pair of a null."""
    S, N, L = shape["S"], shape["nfft_mc"], shape["taps"]
    fft = 5 * N * math.log2(N)
    cwt = fft / 2 + S * (6 * N + fft)
    own = S * (4 * N + fft + 2 * N + 2 * L * N)
    cross = S * (8 * N + 2 * fft + 2 * N + 4 * L * N + 5 * N)
    return 2 * cwt + 2 * own + cross


def call_ops(shape: dict, nulls: int) -> float:
    return MAPS.call_ops(shape) + nulls * shape["mc_count"] * member_ops(shape)


def call_bytes(shape: dict, nulls: int) -> float:
    return MAPS.call_bytes(shape) + 8.0 * nulls * shape["S"] * NBINS


def bound_s(shape: dict, nulls: int) -> float:
    return max(call_bytes(shape, nulls) / peaks.HBM_BYTES_S,
               call_ops(shape, nulls) / peaks.F32_FLOPS)


def read(trace):
    shape = getattr(trace.entry, "shape", None)
    if not shape or shape.get("kind") != "wct_matrix_mc":
        return None
    if not trace.calls or not trace.device_ops:
        return None
    t = sum(e - s for s, e, name in trace.device_ops if "DtoH" not in name) * 1e-6
    nulls = shape["nulls"]
    bound = sum(bound_s(shape, nulls[i % len(nulls)]) for i in range(trace.first, trace.last))
    return 100.0 * bound / t if t else None

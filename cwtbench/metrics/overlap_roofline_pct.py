"""Share of its roofline bound at which a ``wct_overlap_planar`` call runs
on the card.

The work counted is the call's own, worked out from its shape (the entry's
``shape``: B = 2 records of N samples, P = 1 pair, S scales, the chunks'
transform length nfft_c, the boxcar's taps L), whatever implements it,
with the terms of ``matrix_roofline_pct.py`` counted over the N interior
points of each field, so the halo and the padding of the chunks, which are
not the call's own work, count for nothing and a framing that wastes less
reads higher:

* bytes: the records read once (B N float32) and the two float32 maps,
  WCT and phase, written once (2 P S N);
* operations, with an FFT of the chunk's length at 5 log2(nfft_c) a point
  (half that for a real one):
  - B forward CWTs: the real FFT of each record, and for each scale the
    filter multiply, 6 N, and the inverse FFT;
  - B S self-smoothings of |W|^2 / s, a real field: 4 N for it, a real
    forward and inverse FFT, the Gaussian on the half spectrum, 2 N, and
    the L-tap boxcar, 2 L N;
  - P S cross rows: W_1 conj(W_2) over s, 8 N, a complex forward and
    inverse FFT, the Gaussian, 2 N, the boxcar on both planes, 4 L N,
    |S12|^2 over S_1 S_2, 5 N, and atan2, N;
* bound: the larger of bytes over the HBM bandwidth and operations over
  the float32 peak (the ``high`` tier pins float32 arithmetic);
* time: the device time a call of every operation that the calls of the
  profiled slice ran, but the copies across the link, which are the
  link's.
"""
import math

from cwtbench import peaks


def call_bytes(shape: dict) -> float:
    B, P, S, N = shape["B"], shape["P"], shape["S"], shape["N"]
    return 4.0 * B * N + 2 * 4.0 * P * S * N


def call_ops(shape: dict) -> float:
    B, P, S, N, L = shape["B"], shape["P"], shape["S"], shape["N"], shape["taps"]
    fft = 5 * N * math.log2(shape["nfft_c"])
    cwt = B * (fft / 2 + S * (6 * N + fft))
    own = B * S * (4 * N + fft + 2 * N + 2 * L * N)
    cross = P * S * (8 * N + 2 * fft + 2 * N + 4 * L * N + 5 * N + N)
    return cwt + own + cross


def bound_s(shape: dict) -> float:
    return max(call_bytes(shape) / peaks.HBM_BYTES_S,
               call_ops(shape) / peaks.F32_FLOPS)


def read(trace):
    shape = getattr(trace.entry, "shape", None)
    if not shape or shape.get("kind") != "wct_overlap":
        return None
    if not trace.calls or not trace.device_ops:
        return None
    t = sum(e - s for s, e, name in trace.device_ops
            if "HtoD" not in name and "DtoH" not in name) * 1e-6
    return 100.0 * bound_s(shape) / (t / trace.calls) if t else None

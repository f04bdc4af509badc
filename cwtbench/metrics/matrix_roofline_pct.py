"""Share of its roofline bound at which a ``wct_matrix`` call runs on the
card.

The work counted is the call's own, worked out from its shape (the entry's
``shape``: B stations of n0 samples, P pairs, S scales, nfft, the boxcar's
taps L), whatever implements it, so fusing, renaming or removing kernels
leaves it valid:

* bytes: the stations read once (B n0 float32) and the two float32 maps,
  WCT and phase, written once (2 P S n0);
* operations, with an FFT of N points at 5 N log2 N (2.5 N log2 N for a
  real one):
  - B forward CWTs: the real FFT of each station, and for each scale the
    filter multiply, 6 nfft, and the inverse FFT;
  - B S self-smoothings of |W|^2 / s, a real field: 4 nfft for it, a real
    forward and inverse FFT, the Gaussian on the half spectrum, 2 nfft,
    and the L-tap boxcar, 2 L nfft;
  - P S cross rows: W_i conj(W_j) over s, 8 nfft, a complex forward and
    inverse FFT, the Gaussian, 2 nfft, the boxcar on both planes, 4 L
    nfft, |S12|^2 over S_i S_j, 5 nfft, and atan2, nfft;
* bound: the larger of bytes over the HBM bandwidth and operations over the
  float32 peak (the ``high`` tier pins float32 arithmetic);
* time: the device time a call of every operation that the calls of the
  profiled slice ran, but the copies to the host, which are the link's.
"""
import math

from cwtbench import peaks


def call_bytes(shape: dict) -> float:
    return 4.0 * shape["B"] * shape["n0"] + 2 * 4.0 * shape["P"] * shape["S"] * shape["n0"]


def call_ops(shape: dict) -> float:
    B, P, S, N, L = shape["B"], shape["P"], shape["S"], shape["nfft"], shape["taps"]
    fft = 5 * N * math.log2(N)
    cwt = B * (fft / 2 + S * (6 * N + fft))
    own = B * S * (4 * N + fft + 2 * N + 2 * L * N)
    cross = P * S * (8 * N + 2 * fft + 2 * N + 4 * L * N + 5 * N + N)
    return cwt + own + cross


def bound_s(shape: dict) -> float:
    return max(call_bytes(shape) / peaks.HBM_BYTES_S,
               call_ops(shape) / peaks.F32_FLOPS)


def read(trace):
    shape = getattr(trace.entry, "shape", None)
    if not shape or shape.get("kind") != "wct_matrix":
        return None
    if not trace.calls or not trace.device_ops:
        return None
    t = sum(e - s for s, e, name in trace.device_ops if "DtoH" not in name) * 1e-6
    return 100.0 * bound_s(shape) / (t / trace.calls) if t else None

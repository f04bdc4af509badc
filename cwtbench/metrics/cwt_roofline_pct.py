"""Share of its roofline bound at which a forward-CWT call runs.

The work counted is the call's own, worked out from its shapes, whatever
implements it (so fusing, renaming or removing kernels leaves it valid):

* bytes: the real f32 signal read once, and the output written once, S f32
  sums for ``power_sum`` and B S n0 complex64 values for W;
* operations: the forward real FFT, 2.5 nfft log2 nfft, and for each scale
  the filter multiply, 6 nfft, and the inverse FFT, 5 nfft log2 nfft; for
  ``power_sum`` also |W|^2 and the sum, 3 nfft a scale;
* bound: the larger of bytes over the HBM bandwidth and operations over the
  f32 peak (the ``high`` tier pins f32 arithmetic);
* time: the device time per call of every operation that the calls of the
  profiled slice ran.
"""
import math

from cwtbench import peaks


def call_bytes(shape: dict) -> float:
    B, n0, S = shape["B"], shape["n0"], shape["S"]
    out = 4 * B * S if shape["output"] == "power_sum" else 8 * B * S * n0
    return 4.0 * B * n0 + out


def call_ops(shape: dict) -> float:
    nfft, S = shape["nfft"], shape["S"]
    lg = math.log2(nfft)
    per_scale = 6 * nfft + 5 * nfft * lg
    if shape["output"] == "power_sum":
        per_scale += 3 * nfft
    return shape["B"] * (2.5 * nfft * lg + S * per_scale)


def bound_s(shape: dict) -> float:
    return max(call_bytes(shape) / peaks.HBM_BYTES_S,
               call_ops(shape) / peaks.F32_FLOPS)


def read(trace):
    shape = getattr(trace.entry, "shape", None)
    if not shape or shape.get("kind") != "cwt":
        return None
    t = trace.per_call_s()
    if not t:
        return None
    return 100.0 * bound_s(shape) / t

"""Bounds of K1 and K2 with T's element size given, for the ``fast`` tier,
whose T is bf16 (2 bytes): ``kernel_bounds.k1_k2`` with a ``t_bytes``
argument, read by ``k1_bf16_roofline_pct`` and ``k2_bf16_roofline_pct``.
Each kernel's inputs read once and outputs written once, T between them
(two planes of S nfft) at ``t_bytes`` an element, radix-2 FFTs at
5 R log2 R operations and complex multiplies at 6.  A copy, until a
benchmark change folds the argument into ``k1_k2``."""
import math

from cwtbench import peaks


def _bound(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_S, ops / peaks.F32_FLOPS)


def k1_k2(shape: dict, n_in: int, t_bytes: int) -> dict:
    """{kernel name fragment: bound in seconds} a call, for B spectra of
    ``n_in`` bins (nfft/2 for a half spectrum) and T at ``t_bytes``."""
    B, nfft, S = shape["B"], shape["nfft"], shape["S"]
    p = nfft.bit_length() - 1
    R1 = 1 << (p // 2)
    R2 = nfft // R1
    t_total = 2 * S * nfft * t_bytes
    a_bytes = 2 * n_in * 4 + S * 4 + t_total
    a_ops = S * ((n_in // R1) * R1 * 6 + R1 * 5 * R2 * math.log2(R2) + nfft * 6)
    out = {"power_sum": S, "power": S * nfft, "planes": 2 * S * nfft,
           "complex": 2 * S * nfft}[shape["kernel_output"]]
    b_bytes = t_total + 4 * out
    b_ops = S * (R2 * 5 * R1 * math.log2(R1) + nfft * 5)
    return {"cwt_stage_a": B * _bound(a_bytes, a_ops),
            "cwt_stage_b": B * _bound(b_bytes, b_ops)}


def bf16_share(trace, kernel: str):
    """100 × ``kernel``'s bound with T at 2 bytes over its device time a call
    (the ops whose names hold ``kernel``), for the per-layer metrics; None
    unless the entry runs the forward CWT at ``fast``, or where the slice
    holds no such op (the CPU)."""
    entry = trace.entry
    shape = getattr(entry, "shape", None)
    if (not shape or shape.get("kind") != "cwt"
            or getattr(entry, "precision", None) != "fast"):
        return None
    t = trace.per_call_s(kernel)
    if not t:
        return None
    return 100.0 * k1_k2(shape, shape["nfft"] // 2, t_bytes=2)[kernel] / t

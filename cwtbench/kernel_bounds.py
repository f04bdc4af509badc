"""Bounds of the two kernels of today's K1 + K2 route, for the traced
run's ``kernel_bound_pct`` only: each kernel's inputs read once and outputs
written once, the intermediate T between them (two planes of S nfft) at 4
bytes an element, radix-2 FFTs at 5 R log2 R operations and complex
multiplies at 6.  T is an artefact of that route; the per-layer metric
``cwt_roofline_pct`` counts the call's own work instead."""
import math

from cwtbench import peaks


def _bound(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_S, ops / peaks.F32_FLOPS)


def k1_k2(shape: dict, n_in: int) -> dict:
    """{kernel name fragment: bound in seconds} a call, for B spectra of
    ``n_in`` bins (nfft/2 for a half spectrum)."""
    B, nfft, S = shape["B"], shape["nfft"], shape["S"]
    p = nfft.bit_length() - 1
    R1 = 1 << (p // 2)
    R2 = nfft // R1
    t_total = 2 * S * nfft * 4
    a_bytes = 2 * n_in * 4 + S * 4 + t_total
    a_ops = S * ((n_in // R1) * R1 * 6 + R1 * 5 * R2 * math.log2(R2) + nfft * 6)
    out = {"power_sum": S, "power": S * nfft, "planes": 2 * S * nfft}[shape["kernel_output"]]
    b_bytes = t_total + 4 * out
    b_ops = S * (R2 * 5 * R1 * math.log2(R1) + nfft * 5)
    return {"cwt_stage_a": B * _bound(a_bytes, a_ops),
            "cwt_stage_b": B * _bound(b_bytes, b_ops)}

"""The plain reference of ``cwt_f64.py`` one precision below the ``fast``
tier, the control of the cells that run that tier.

The tier keeps the transform's intermediate in bf16: 8 significant bits on
float32's exponent range.  The control keeps ``bits`` (4) instead: the
filtered spectrum Y_s[k] = X[k] H_s[k] has its real and imaginary parts
each rounded to ``bits`` significant bits, to nearest even, with float32's
least normal exponent (below 2^-126 the step stays 2^(-126 - bits + 1), as
in float32's subnormals), and everything else is float64 ``torch.fft`` as in
``cwt_f64.py``:

    W~[s, t] = (1/nfft) sum_k round_bits(Y_s[k]) e^{2 pi i k t / nfft},  t < n0

At ``bits = 8`` the rounding is float32 → bf16's, bit for bit.  It imports
nothing of the program.
"""
from __future__ import annotations

import torch

from .cwt_f64 import morlet_bank

#: a control's name in a cell file (``{"reference": <name>}``) -> its bits
BITS = {"sig4": 4}
#: frexp's exponent of float32's least normal number, 2^-126 = 0.5 * 2^-125
_E_MIN = -125


def round_significant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` (real, float64) rounded to ``bits`` significant bits, to nearest
    even, on float32's exponent range (see the module docstring)."""
    _, e = torch.frexp(x)
    step = torch.ldexp(torch.ones_like(x), torch.clamp(e, min=_E_MIN) - bits)
    return torch.round(x / step) * step


def transform_blocks(x: torch.Tensor, scales: torch.Tensor, *, dt: float,
                     nfft: int, f0: float, bits: int, block: int = 8):
    """Yield ``(lo, hi, W~)`` as ``cwt_f64.transform_blocks`` yields W, with
    the filtered spectrum rounded to ``bits`` significant bits."""
    n0 = x.shape[-1]
    X = torch.fft.fft(x.to(torch.float64), n=nfft)
    for lo in range(0, scales.shape[0], block):
        hi = min(lo + block, scales.shape[0])
        Y = X[None, :] * morlet_bank(scales[lo:hi], nfft, dt, f0, x.device)
        Y = torch.complex(round_significant(Y.real, bits),
                          round_significant(Y.imag, bits))
        yield lo, hi, torch.fft.ifft(Y)[:, :n0]


def power_sum(x: torch.Tensor, scales: torch.Tensor, *, dt: float, nfft: int,
              f0: float, bits: int, block: int = 8) -> torch.Tensor:
    """sum_t |W~[s, t]|^2 per scale, float64 (S,)."""
    out = torch.empty(scales.shape[0], dtype=torch.float64, device=x.device)
    for lo, hi, W in transform_blocks(x, scales, dt=dt, nfft=nfft, f0=f0,
                                      bits=bits, block=block):
        out[lo:hi] = (W.real ** 2 + W.imag ** 2).sum(dim=-1)
    return out

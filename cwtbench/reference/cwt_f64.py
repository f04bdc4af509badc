"""Plain reference of the forward CWT (Torrence & Compo 1998, sec. 3).

For a real record x of n0 samples, zero-padded to nfft:

    X[k]    = sum_t x[t] e^{-2 pi i k t / nfft}
    H_s[k]  = sqrt(2 pi s / dt) pi^{-1/4} exp(-(s w_k - f0)^2 / 2),
              w_k = 2 pi fftfreq(nfft, dt)[k]          (Morlet, TC98 Table 1)
    W[s, t] = (1/nfft) sum_k X[k] H_s[k] e^{2 pi i k t / nfft},  t < n0

as pycwt's ``cwt`` writes it (no Heaviside step: the negative-frequency
tail of the Morlet-6 filter is below exp(-18)).  Everything is float64
``torch.fft`` on the device of the record, in blocks of scales so that a
2^22-sample transform fits beside the program's kept output.  It imports
nothing of the program and takes none of its values: the scale grid is
worked out here from the configuration.
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def scale_grid(n_scales: int, dt: float, dj: float, s0: float) -> torch.Tensor:
    """s_j = s0 2^(j dj), j = 0 .. n_scales - 1, float64 on the host."""
    return s0 * 2.0 ** (torch.arange(n_scales, dtype=torch.float64) * dj)


def morlet_bank(scales: torch.Tensor, nfft: int, dt: float, f0: float,
                device) -> torch.Tensor:
    """(S, nfft) float64 filter bank H_s[k] of the module docstring."""
    w = 2.0 * math.pi * torch.fft.fftfreq(nfft, d=dt, dtype=torch.float64,
                                          device=device)
    s = scales.to(device=device, dtype=torch.float64)[:, None]
    norm = torch.sqrt(2.0 * math.pi * s / dt)
    return norm * math.pi ** -0.25 * torch.exp(-0.5 * (s * w[None, :] - f0) ** 2)


def transform_blocks(x: torch.Tensor, scales: torch.Tensor, *, dt: float,
                     nfft: int, f0: float, block: int = 8):
    """Yield ``(lo, hi, W)``: W[lo:hi] of the record ``x`` (n0,), complex128
    (hi - lo, n0), block after block of scales."""
    n0 = x.shape[-1]
    X = torch.fft.fft(x.to(torch.float64), n=nfft)
    for lo in range(0, scales.shape[0], block):
        hi = min(lo + block, scales.shape[0])
        H = morlet_bank(scales[lo:hi], nfft, dt, f0, x.device)
        yield lo, hi, torch.fft.ifft(X[None, :] * H)[:, :n0]


def power_sum(x: torch.Tensor, scales: torch.Tensor, *, dt: float, nfft: int,
              f0: float, block: int = 8) -> torch.Tensor:
    """sum_t |W[s, t]|^2 per scale, float64 (S,)."""
    out = torch.empty(scales.shape[0], dtype=torch.float64, device=x.device)
    for lo, hi, W in transform_blocks(x, scales, dt=dt, nfft=nfft, f0=f0,
                                      block=block):
        out[lo:hi] = (W.real ** 2 + W.imag ** 2).sum(dim=-1)
    return out

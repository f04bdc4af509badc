"""Plain reference of the wavelet power of one record at pycwt's ``cwt``
defaults (Torrence & Compo 1998, sec. 3, eqs. 9-10).

From the configuration alone (Morlet f0, dt, dj, s0 = -1, J = -1):

    lambda = 4 pi / (f0 + sqrt(2 + f0^2))        Fourier period / scale
    s0     = 2 dt / lambda                       (s0 = -1)
    J      = round(log2(n0 dt / s0) / dj)        (J = -1; round half to even)
    s_j    = s0 2^(j dj),  j = 0 .. J;   freqs_j = 1 / (lambda s_j)
    coi[t] = lambda dt (n0/2 - |t - (n0 - 1)/2|) / sqrt(2)

the COI being T&C's e-folding time sqrt(2) s laid over the record from
both ends, as a Fourier period (pycwt's Bartlett form).  The power is

    P[s, t] = |ifft(X H_s)[t]|^2,  t < n0,

with X the record's spectrum zero-padded to the next power of two and H_s
``cwt_f64``'s Morlet filter, everything float64 ``torch.fft`` on the
record's device, in blocks of scales (``cwt_f64.transform_blocks``).

Departures from pycwt's ``cwt``, whose W this squares:
* pycwt's ``cwt`` returns W; |W|^2 is taken here, in float64;
* pycwt's ``cwt`` drops the scale rows that its filter fills with NaN;
  Morlet's Gaussian underflows to 0 and never makes one, so none is
  dropped here;
* pycwt's spectrum is scipy's; here it is ``torch.fft`` in float64.

It imports nothing of the program and takes none of its values.
"""
from __future__ import annotations

import math

import torch

from .cwt_f64 import transform_blocks

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def flambda(f0: float) -> float:
    """Fourier period of a Morlet scale (T&C Table 1)."""
    return 4.0 * math.pi / (f0 + math.sqrt(2.0 + f0 ** 2))


def grid(n0: int, dt: float, dj: float, f0: float, s0: float = -1,
         J: int = -1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sj, freqs, coi)``, float64 on the host, of the module docstring."""
    lam = flambda(f0)
    if s0 == -1:
        s0 = 2.0 * dt / lam
    if J == -1:
        J = round(math.log2(n0 * dt / s0) / dj)
    sj = s0 * 2.0 ** (torch.arange(J + 1, dtype=torch.float64) * dj)
    t = torch.arange(n0, dtype=torch.float64)
    coi = lam * dt * (n0 / 2 - (t - (n0 - 1) / 2).abs()) / math.sqrt(2.0)
    return sj, 1.0 / (lam * sj), coi


def power_blocks(x: torch.Tensor, sj: torch.Tensor, *, dt: float, f0: float,
                 block: int = 8):
    """Yield ``(lo, hi, P)``: P[lo:hi] = |W|^2 of the record ``x`` (n0,),
    float64 (hi - lo, n0), block after block of scales."""
    nfft = 1 << (x.shape[-1] - 1).bit_length()
    for lo, hi, W in transform_blocks(x, sj, dt=dt, nfft=nfft, f0=f0,
                                      block=block):
        yield lo, hi, W.real ** 2 + W.imag ** 2

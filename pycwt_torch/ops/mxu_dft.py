"""DFT entry points of ``pycwt_tpu/ops/mxu_dft.py`` on ``torch.fft``.

The JAX package computes these as a four-step DFT of matrix products because
the TPU runtime's FFT custom call was unusable; on the card ``torch.fft``
(cuFFT) is the natural port, and on the CPU it is PocketFFT.  The public
names, signatures and return conventions stay: planar functions return
``(re, im)`` pairs, and lengths must be powers of two.  ``precision`` (the
JAX package's matmul precision) is accepted and checked against
``"highest" | "high" | "fast"``; cuFFT and PocketFFT run every tier the same.
"""
from __future__ import annotations

import torch

from ..config import _PRECISIONS

__all__ = ["dft", "idft", "fft_of_real", "fft_of_real_planar", "supported_n"]


def supported_n(n: int) -> bool:
    """Pow-2 lengths ≥ 2."""
    return n >= 2 and (1 << (n.bit_length() - 1)) == n


def _check(n: int, precision: str) -> None:
    if not supported_n(n):
        raise ValueError(f"mxu dft needs pow-2 length, got {n}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def dft(x: torch.Tensor, n: int | None = None, *, sign: int = -1,
        precision: str = "highest") -> torch.Tensor:
    """Complex DFT along the last axis: ``fft(x, n)`` for ``sign=-1``,
    the **unscaled** inverse ``ifft(x, n)·n`` for ``sign=+1``.  Real or
    complex input, zero-padded or truncated to ``n``."""
    n = x.shape[-1] if n is None else n
    _check(n, precision)
    if sign == -1:
        return torch.fft.fft(x, n=n, dim=-1)
    # ifft of a real tensor comes back as a conjugate view: materialize it
    return torch.fft.ifft(x, n=n, dim=-1, norm="forward").resolve_conj()


def idft(x: torch.Tensor, n: int | None = None, *,
         precision: str = "highest") -> torch.Tensor:
    """Inverse complex DFT along the last axis (matches ``ifft``)."""
    n = x.shape[-1] if n is None else n
    _check(n, precision)
    return torch.fft.ifft(x, n=n, dim=-1).resolve_conj()


def fft_of_real(x: torch.Tensor, nfft: int, *,
                precision: str = "highest") -> torch.Tensor:
    """Full complex spectrum of a real signal zero-padded to ``nfft``."""
    return dft(x, nfft, sign=-1, precision=precision)


def fft_of_real_planar(x: torch.Tensor, nfft: int, *, half: bool = False,
                       precision: str = "highest"):
    """Planar ``(re, im)`` spectrum of a real signal zero-padded to
    ``nfft``, in ``x``'s dtype.  ``half=True`` returns only the bins
    ``k < nfft/2`` — all that an analytic-mother CWT reads."""
    _check(nfft, precision)
    half_spec = torch.fft.rfft(x, n=nfft, dim=-1)       # bins 0 .. nfft/2
    if half:
        spec = half_spec[..., : nfft // 2]
    else:
        mirror = torch.conj(half_spec[..., 1 : nfft // 2].flip(-1))
        spec = torch.cat([half_spec, mirror], dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()

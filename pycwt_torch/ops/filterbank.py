"""Wavelet filter-bank construction and application in Fourier space.

Counterpart of ``pycwt_tpu/ops/filterbank.py``.  The forward CWT is, by the
convolution theorem,

    W[b, s, :] = ifft( fft(x[b])[k] · ψ̄̂_s[k] ),
    ψ̄̂_s[k]   = sqrt(2π·s/dt) · conj(ψ̂(s·ω_k))

with a real envelope times a complex constant per mother (``mothers.py``).
The fused CUDA kernel (``ops/fused_cwt.py``) builds the same bank per tile
on the card instead of materializing it.
"""
from __future__ import annotations

import math

import torch

from ..mothers import Mother

__all__ = ["angular_frequencies", "filter_bank", "apply_filter_bank"]


def angular_frequencies(nfft: int, dt: float, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """``2π·fftfreq(nfft, dt)``."""
    freqs = torch.fft.fftfreq(nfft, d=dt, dtype=torch.float64, device=device)
    return (2 * math.pi) * freqs.to(dtype)


def filter_bank(mother: Mother, scales: torch.Tensor, ftfreqs: torch.Tensor,
                dt: float) -> torch.Tensor:
    """The (S, nfft) complex bank ``sqrt(2π·s/dt)·conj(ψ̂(s·ω))``."""
    scales = torch.as_tensor(scales, dtype=ftfreqs.dtype, device=ftfreqs.device)
    norm = torch.sqrt(2 * math.pi * scales / dt)
    env = mother.psi_ft_envelope(scales[:, None] * ftfreqs[None, :])
    cbar = complex(mother.psi_ft_const()).conjugate()
    return (norm[:, None] * env) * cbar


def apply_filter_bank(signal_ft: torch.Tensor, mother: Mother,
                      scales: torch.Tensor, ftfreqs: torch.Tensor,
                      dt: float) -> torch.Tensor:
    """Product spectrum ``X[b,k]·ψ̄̂[s,k]`` as a (B, S, nfft) complex tensor."""
    scales = torch.as_tensor(scales, dtype=ftfreqs.dtype, device=ftfreqs.device)
    norm = torch.sqrt(2 * math.pi * scales / dt)
    env = mother.psi_ft_envelope(scales[:, None] * ftfreqs[None, :])
    bank = (norm[:, None] * env).to(signal_ft.real.dtype)
    cbar = complex(mother.psi_ft_const()).conjugate()
    return signal_ft[:, None, :] * bank[None, :, :] * cbar

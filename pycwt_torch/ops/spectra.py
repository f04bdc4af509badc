"""Frequency-domain shortcut for the time-summed wavelet power.

Counterpart of ``pycwt_tpu/ops/spectra.py``.  By Parseval,

    Σ_t |W_s[t]|²  =  (1/N) Σ_k |X[k]·ψ̄̂_s[k]|²

so the global wavelet spectrum needs no inverse FFT: one pass over the
(S × nfft/2+1) filter grid.  Exact when ``nfft == n0``; with zero padding
it includes the pad region's power.
"""
from __future__ import annotations

import math

import torch

from ..mothers import Mother
from ._precision import full_f32_matmul
from .fft import fft_of_real_full

__all__ = ["global_power_parseval"]


def global_power_parseval(signals: torch.Tensor, scales, *, dt: float,
                          mother: Mother, nfft: int,
                          engine: str | None = None) -> torch.Tensor:
    """Time-summed wavelet power per scale, ``(B, S)``, without an iFFT.

    ``signals``: (B, n0) real; ``scales``: (S,).  Divide by ``n0`` for the
    mean (global wavelet spectrum).  The sum over bins is a full-f32
    product whatever the process sets (``ops/_precision.py``).
    """
    signals = torch.as_tensor(signals)
    rdt = signals.dtype
    K = nfft // 2 + 1
    X = fft_of_real_full(signals, nfft, engine=engine)[..., :K]
    half = (2 * math.pi / (nfft * dt)) * torch.arange(K, dtype=rdt,
                                                      device=signals.device)
    scales = torch.as_tensor(scales, dtype=rdt, device=signals.device)
    norm2 = 2 * math.pi * scales / dt
    c2 = abs(complex(mother.psi_ft_const())) ** 2
    f = scales[:, None] * half[None, :]
    # The filter is not Hermitian: the mirror bins see −ω.  Interior bins
    # get env(+)²+env(−)², DC env(0)², Nyquist env(−s·π/dt)².
    env_p2 = mother.psi_ft_envelope(f) ** 2
    env_m2 = mother.psi_ft_envelope(-f) ** 2
    both = env_p2 + env_m2
    if nfft % 2 == 0:
        bank2 = torch.cat([env_p2[:, :1], both[:, 1:-1], env_m2[:, -1:]], dim=1)
    else:
        bank2 = torch.cat([env_p2[:, :1], both[:, 1:]], dim=1)
    bank2 = (norm2[:, None] * c2) * bank2
    p_half = X.abs() ** 2
    with full_f32_matmul():        # an f32 einsum is a matrix product
        return torch.einsum("bk,sk->bs", p_half, bank2) / nfft

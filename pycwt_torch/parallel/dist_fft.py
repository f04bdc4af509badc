"""Distributed (pencil / transpose) FFT over the ranks of one mesh dim.

Counterpart of ``pycwt_tpu/parallel/dist_fft.py``: the exact global
spectrum of a time-sharded pow-2 signal, for workloads that want the global
transform with no overlap-save truncation.  Four-step Cooley-Tukey with the
split ``N = R1·R2``, ``n = n1·R2 + n2``, ``k = k1 + R1·k2``:

    X[k1 + R1·k2] = Σ_{n2} e^{s·2πi·n2·k1/N} · F2[n2, k2] ·
                    (Σ_{n1} F1[k1, n1] · x[n1·R2 + n2])

With the time axis sharded in contiguous slabs (n1-major), the stages are

    all_to_all (slab → n2-pencil) → FFT over n1 → twiddle →
    all_to_all (n2-pencil → k1-pencil) → FFT over n2 →
    all_to_all (k1-pencil → natural-order k-slab)

three tiled ``all_to_all_single`` collectives (``parallel._collectives``)
and two local ``torch.fft`` stages (cuFFT on the card, where the JAX package
runs DFT matmuls on the MXU).  Each rank holds O(N/D) at all times.  The
planar surfaces take and return real ``(re, im)`` planes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ._collectives import (all_to_all_tiled, axis_rank, axis_size, local_block,
                           mesh_device, to_dtensor)

__all__ = ["sharded_dft", "sharded_idft", "sharded_cwt_spectral",
           "sharded_dft_planar", "sharded_cwt_spectral_planar"]


def _split_for(N: int, D: int) -> tuple[int, int]:
    """Balanced pow-2 split N = R1·R2 with D | R1 and D | R2."""
    p = N.bit_length() - 1
    if (1 << p) != N:
        raise ValueError(f"distributed DFT needs pow-2 N, got {N}")
    d = D.bit_length() - 1
    if (1 << d) != D:
        raise ValueError(f"mesh axis size must be pow-2, got {D}")
    R1 = 1 << (p // 2)
    R2 = N // R1
    if R1 % D or R2 % D:
        raise ValueError(
            f"N={N} too small to pencil-decompose over {D} devices "
            f"(needs {D} | {R1} and {D} | {R2})")
    return R1, R2


def _fft_stage(x: torch.Tensor, dim: int, sign: int) -> torch.Tensor:
    """Σ_n x[n]·e^{s·2πi·nk/R} along ``dim``: the forward FFT for s = −1,
    the unscaled inverse for s = +1."""
    if sign == -1:
        return torch.fft.fft(x, dim=dim)
    return torch.fft.ifft(x, dim=dim, norm="forward")


def _dft_local(x_loc: torch.Tensor, mesh, axis_name: str, N: int,
               sign: int) -> torch.Tensor:
    """One rank's part of the pencil DFT: ``(..., N/D)`` slab in (complex)
    → ``(..., N/D)`` natural-order k-slab out."""
    D = axis_size(mesh, axis_name)
    R1, R2 = _split_for(N, D)
    A, R2l = R1 // D, R2 // D
    lead = x_loc.shape[:-1]
    b = len(lead)
    X = x_loc.reshape(lead + (A, R2))
    X = all_to_all_tiled(X, mesh, axis_name, b + 1, b)            # (..., R1, R2l)
    Y = _fft_stage(X, b, sign)
    # twiddle e^{s·2πi·n2·k1/N} with the GLOBAL n2 of this rank's pencil
    dev = x_loc.device
    n2g = axis_rank(mesh, axis_name) * R2l + torch.arange(R2l, device=dev,
                                                          dtype=torch.float64)
    k1 = torch.arange(R1, device=dev, dtype=torch.float64)
    phase = (sign * 2 * math.pi / N) * torch.outer(k1, n2g)
    Y = Y * torch.polar(torch.ones_like(phase), phase).to(Y.dtype)
    U = all_to_all_tiled(Y, mesh, axis_name, b, b + 1)            # (..., R1/D, R2)
    Z = _fft_stage(U, b + 1, sign)
    V = all_to_all_tiled(Z, mesh, axis_name, b + 1, b)            # (..., R1, R2l)
    # k = k1 + R1·k2: the k2-major flatten of (R2l, R1)
    return V.transpose(-1, -2).reshape(lead + (R1 * R2l,))


def _complex_dtype(t: torch.Tensor) -> torch.dtype:
    f64 = t.dtype in (torch.float64, torch.complex128)
    return torch.complex128 if f64 else torch.complex64


def _as_global(mesh, x):
    if isinstance(x, torch.Tensor):
        return x if type(x) is not torch.Tensor else x.to(mesh_device(mesh))
    return torch.as_tensor(np.asarray(x), device=mesh_device(mesh))


def _slab(mesh, x, axis_name: str) -> tuple[torch.Tensor, int]:
    """(this rank's time slab of ``x``, the global N), validated first."""
    x = _as_global(mesh, x)
    N = x.shape[-1]
    _split_for(N, axis_size(mesh, axis_name))
    return local_block(x, mesh, axis_name, x.ndim - 1), N


def _shard_last(t: torch.Tensor, mesh, axis_name: str):
    return to_dtensor(t.contiguous(), mesh, {axis_name: t.ndim - 1})


def sharded_dft(mesh, x, *, sign: int = -1, axis_name: str = "data"):
    """DFT of a pow-2 signal (leading batch axes allowed) whose time axis is
    sharded in contiguous slabs over ``axis_name``.

    Matches ``torch.fft.fft(x)`` (``sign=-1``) / the UNSCALED inverse
    (``sign=+1``) while every rank holds only O(N/D).  ``x`` is the global
    array (every rank passes the same) or a DTensor sharded so.  Returns the
    complex spectrum, sharded ``P(..., axis_name)`` in natural frequency
    order.
    """
    x_loc, N = _slab(mesh, x, axis_name)
    x_loc = x_loc.to(_complex_dtype(x_loc))
    return _shard_last(_dft_local(x_loc, mesh, axis_name, N, sign), mesh, axis_name)


def sharded_idft(mesh, X, *, axis_name: str = "data"):
    """Inverse of :func:`sharded_dft` (matches ``torch.fft.ifft``)."""
    X_loc, N = _slab(mesh, X, axis_name)
    X_loc = X_loc.to(_complex_dtype(X_loc))
    return _shard_last(_dft_local(X_loc, mesh, axis_name, N, +1) / N, mesh, axis_name)


def _planes(z: torch.Tensor, mesh, axis_name: str):
    return _shard_last(z.real, mesh, axis_name), _shard_last(z.imag, mesh, axis_name)


def sharded_dft_planar(mesh, xr, xi=None, *, sign: int = -1,
                       axis_name: str = "data"):
    """:func:`sharded_dft` on PLANAR ``(re, im)`` planes: ``xi=None`` marks
    real input.  Returns ``(Xr, Xi)``, real tensors each sharded
    ``P(..., axis_name)`` in natural frequency order."""
    xr_loc, N = _slab(mesh, xr, axis_name)
    cdt = _complex_dtype(xr_loc)
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    if xi is None:
        z = xr_loc.to(cdt)
    else:
        xi_loc, _ = _slab(mesh, xi, axis_name)
        z = torch.complex(xr_loc.to(rdt), xi_loc.to(rdt))
    return _planes(_dft_local(z, mesh, axis_name, N, sign), mesh, axis_name)


def _spectral_w(mesh, x, scales, dt: float, mother, axis_name: str, name: str):
    """This rank's ``(S, N/D)`` time slab of the exact CWT: its pencil of
    the global spectrum times the filter bank at its GLOBAL frequencies,
    then the batched pencil inverse."""
    x = _as_global(mesh, x)
    if x.ndim != 1:
        raise ValueError(f"{name} expects a 1-D signal")
    x_loc, N = _slab(mesh, x, axis_name)
    cdt = _complex_dtype(x_loc)
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    spec = _dft_local(x_loc.to(cdt), mesh, axis_name, N, -1)
    Nl = spec.shape[-1]
    dev = spec.device
    sj = torch.as_tensor(np.asarray(scales, np.float64) if not isinstance(
        scales, torch.Tensor) else scales).to(device=dev, dtype=rdt)
    k = axis_rank(mesh, axis_name) * Nl + torch.arange(Nl, device=dev,
                                                       dtype=torch.float64)
    kf = torch.where(k >= N // 2, k - N, k)
    omega = ((2 * math.pi / (N * dt)) * kf).to(rdt)
    env = mother.psi_ft_envelope(sj[:, None] * omega[None, :]).to(rdt)
    norm = torch.sqrt(2 * math.pi * sj / dt)
    bank = (norm[:, None] * env) * complex(mother.psi_ft_const()).conjugate()
    Y = spec[None, :] * bank.to(cdt)
    return _dft_local(Y, mesh, axis_name, N, +1) / N


def sharded_cwt_spectral(mesh, x, scales, dt: float, *, mother,
                         axis_name: str = "data"):
    """EXACT sequence-parallel CWT through the distributed FFT: the global
    spectrum of a time-sharded pow-2 signal, the filter bank applied to each
    rank's frequency pencil, and a batched distributed inverse.  Unlike
    ``ops.overlap.sharded_cwt_overlap_save`` there is no blocked-convolution
    truncation: every scale equals the single-device global transform to
    round-off.  Returns ``(S, N)`` complex W, time-sharded ``P(None,
    axis_name)``.  ``N`` must be a power of two."""
    W = _spectral_w(mesh, x, scales, dt, mother, axis_name, "sharded_cwt_spectral")
    return _shard_last(W, mesh, axis_name)


def sharded_cwt_spectral_planar(mesh, x, scales, dt: float, *, mother,
                                axis_name: str = "data"):
    """:func:`sharded_cwt_spectral` on planes: returns ``(wr, wi)``, real
    tensors each ``(S, N)`` time-sharded ``P(None, axis_name)``."""
    W = _spectral_w(mesh, x, scales, dt, mother, axis_name,
                    "sharded_cwt_spectral_planar")
    return _planes(W, mesh, axis_name)

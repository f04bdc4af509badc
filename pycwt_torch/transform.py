"""Batched forward / inverse continuous wavelet transform.

Counterpart of ``pycwt_tpu/transform.py``:

    (B, n0) real ──rFFT+mirror──► (B, nfft) spectrum
                 ──filter bank──► (B, S, nfft) product spectrum
                 ──batched iFFT─► (B, S, nfft) ──trim──► (B, S, n0) W

On a CUDA tensor under engine ``"pallas"``/``"planar"`` (the CUDA default
for f32; f64 resolves to ``"xla"``, cuFFT in f64) the filter bank and the iFFT run as the fused CUDA kernels
(``ops/fused_cwt.py``), and an f32 CPU tensor runs their plain version.  On
those two engines the forward spectrum is taken in f64 from the rows as
given and rounded once to the compute dtype (``ops/fft._spectrum_f64``);
``"xla"`` and ``"mxu"`` take it in the compute dtype.

Every surface builds its host grid in :func:`_host_grid`: scales, NaN-row
drop and FFT length, host numpy float64, before any device work; the COI
and the angular frequencies are built on first read.  The
planar route (``ops/fft._planar_route``) enters the kernels through
``ops/fused_cwt._planar_cwt_of_real`` alone.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .config import DEFAULT, CWTConfig, round_half_even
from .mothers import DOG, Morlet, Mother, as_mother
from .ops.fft import (_spectrum_f64, fft_of_real_full, ifft as engine_ifft,
                      resolve_engine)
from .ops.filterbank import angular_frequencies, apply_filter_bank
from .utils import profiling
from .utils.profiling import span

__all__ = [
    "ScaleGrid",
    "build_scale_grid",
    "drop_reference_nan_rows",
    "cwt_batch",
    "icwt_batch",
    "icwt_planar",
    "coi_bartlett",
]


class ScaleGrid(NamedTuple):
    """Host-side scale grid (numpy float64)."""

    sj: np.ndarray      # (S,) wavelet scales  s0·2^(j·dj)
    freqs: np.ndarray   # (S,) Fourier-equivalent frequencies 1/(λ·s)
    dj: float
    s0: float
    J: int


def build_scale_grid(
    n0: int,
    dt: float,
    dj: float = 1 / 12,
    s0: float = -1,
    J: int = -1,
    mother: Mother | str = "morlet",
    freqs: np.ndarray | None = None,
) -> ScaleGrid:
    """Scale grid per the TC98 defaults: ``s0 = 2·dt/λ`` and
    ``J = round(log2(n0·dt/s0)/dj)`` when unset; a custom ``freqs`` vector
    instead derives scales as ``1/(λ·freqs)``."""
    mother = as_mother(mother)
    flambda = mother.flambda()
    if freqs is None:
        if s0 == -1:
            s0 = 2 * dt / flambda
        if J == -1:
            J = int(round_half_even(np.log2(n0 * dt / s0) / dj))
        sj = s0 * 2.0 ** (np.arange(0, J + 1, dtype=np.float64) * dj)
        freqs = 1.0 / (flambda * sj)
    else:
        freqs = np.asarray(freqs, dtype=np.float64)
        sj = 1.0 / (flambda * freqs)
        J = len(sj) - 1
        s0 = float(sj[0]) if len(sj) else -1.0
    return ScaleGrid(sj=np.asarray(sj, dtype=np.float64), freqs=freqs, dj=dj,
                     s0=float(s0), J=int(J))


def drop_reference_nan_rows(mother: Mother, sj: np.ndarray, freqs: np.ndarray,
                            nfft: int, dt: float):
    """Drop the scale rows that the reference's naive f64 filter formula
    would fill with non-finite values — keeping every row when all are bad,
    as the reference does.  Returns the (possibly filtered) ``(sj, freqs)``."""
    return _finite_rows(mother, sj, freqs, 2 * np.pi * np.fft.fftfreq(nfft, dt))


def _finite_rows(mother: Mother, sj, freqs, ftfreqs):
    """:func:`drop_reference_nan_rows` on the angular FFT frequencies
    ``ftfreqs`` = 2π·fftfreq(nfft, dt)."""
    bad = mother.reference_nan_rows(sj, ftfreqs)
    if (~bad).any():
        return sj[~bad], freqs[~bad]
    return sj, freqs


def coi_bartlett(n0: int, dt: float, mother: Mother) -> np.ndarray:
    """Cone of influence as Fourier periods:
    ``λ·coi·dt·(n0/2 − |t − (n0−1)/2|)``, built in place in one array by
    that expression's operations in its order, so bit for bit the
    expression."""
    coi = np.arange(0, n0, dtype=np.float64)
    coi -= (n0 - 1) / 2
    np.abs(coi, out=coi)
    np.subtract(n0 / 2, coi, out=coi)
    coi *= mother.flambda() * mother.coi() * dt
    return coi


#: the mothers whose ``reference_nan_rows`` keeps every row whatever the
#: frequencies, so their grid needs no angular-frequency array
_ALL_ROWS_FINITE = (Morlet, DOG)


class _HostGrid:
    """A transform's host grid (numpy float64), from :func:`_host_grid`.

    ``coi`` and ``ftfreqs`` are built on first read: a caller reads ``coi``
    once its device work is queued, so the host builds it while the card
    runs, and ``ftfreqs`` is built only where a NaN-row check or a caller
    reads it."""

    def __init__(self, grid: ScaleGrid, nfft: int, n0: int, dt: float,
                 mother: Mother):
        self.sj = grid.sj        # (S,) scales left by the NaN-row drop
        self.freqs = grid.freqs  # (S,) their Fourier-equivalent frequencies
        self.nfft = nfft
        self.s0 = grid.s0        # the scale grid's s0 and J, defaults resolved
        self.J = grid.J
        self._n0, self._dt, self._mother = n0, dt, mother

    @functools.cached_property
    def ftfreqs(self) -> np.ndarray:
        """(nfft,) ``2π·fftfreq(nfft, dt)``, counted in
        ``profiling.GRID_FTFREQ_ARRAYS``."""
        profiling.GRID_FTFREQ_ARRAYS += 1
        return 2 * np.pi * np.fft.fftfreq(self.nfft, self._dt)

    @functools.cached_property
    def coi(self) -> np.ndarray:
        """(n0,) Bartlett COI (:func:`coi_bartlett`); the span ``coi``
        holds its build."""
        with span("coi"):
            return coi_bartlett(self._n0, self._dt, self._mother)


@span("grid")
def _host_grid(n0: int, dt: float, dj: float, s0: float, J: int,
               mother: Mother, fft_length, freqs=None) -> _HostGrid:
    """The host grid of ``n0`` samples padded to ``fft_length(n0)``:
    :func:`build_scale_grid`, then the NaN-row drop on the angular
    frequencies where the mother's check reads them (not Morlet's or
    DOG's), in f64; counted in ``profiling.HOST_GRIDS``, and the span
    ``grid`` holds it."""
    grid = build_scale_grid(n0, dt, dj=dj, s0=s0, J=J, mother=mother,
                            freqs=freqs)
    g = _HostGrid(grid, fft_length(n0), n0, dt, mother)
    profiling.HOST_GRIDS += 1
    if not isinstance(mother, _ALL_ROWS_FINITE):
        g.sj, g.freqs = _finite_rows(mother, g.sj, g.freqs, g.ftfreqs)
    return g


@span("cwt_batch")
def cwt_batch(
    signals,
    scales,
    dt: float,
    *,
    mother: Mother,
    nfft: int,
    config: CWTConfig = DEFAULT,
    engine: str | None = None,
):
    """Batched forward CWT on the signals' device.

    Parameters
    ----------
    signals: ``(B, n0)`` real tensor (numpy input lands on the CPU).  On
        the ``"pallas"``/``"planar"`` engines its spectrum is taken in f64
        from the rows as given (f64 rows keep their digits); the other
        engines round the rows to ``config``'s dtype first.
    scales: ``(S,)`` wavelet scales.
    dt: sampling interval.
    mother: mother-wavelet dataclass.
    nfft: FFT length (pad-to-pow-2 under the default policy).
    config: numeric policy; ``engine`` overrides ``config.engine``.

    Returns
    -------
    W: ``(B, S, n0)`` complex wavelet transform.
    signal_ft: ``(B, nfft)`` complex spectrum of the zero-padded signals.
    """
    signals = torch.as_tensor(signals)
    device = signals.device
    rdt = config.real_dtype
    cdt = config.complex_dtype
    engine = resolve_engine(engine if engine is not None else config.engine,
                            device, rdt)
    if engine == "planar":
        engine = "pallas"
    if signals.ndim != 2:
        raise ValueError(f"signals must be (B, n0), got {tuple(signals.shape)}")
    scales = torch.as_tensor(scales, dtype=rdt, device=device)
    n0 = signals.shape[-1]

    if engine != "pallas":
        signal_ft = fft_of_real_full(signals.to(rdt), nfft, engine=engine).to(cdt)
    else:
        from .ops.fused_cwt import fused_cwt, supported_nfft

        # the kernels' route: the rows' spectrum in f64, rounded once to cdt
        signal_ft = _spectrum_f64(signals, nfft, dtype=cdt, engine=engine)

        # The kernels serve pow-2 nfft >= 256 on CUDA tensors, and their
        # plain version f32 on the CPU; every other case runs torch.fft
        # below (non-pow-2 lengths already warned).
        if supported_nfft(nfft) and (device.type == "cuda" or rdt == torch.float32):
            W_full = fused_cwt(signal_ft.to(torch.complex64),
                               scales.to(torch.float32), mother=mother,
                               nfft=nfft, dt=float(dt),
                               precision=config.precision)
            return W_full[..., :n0], signal_ft
        engine = "mxu"

    ftfreqs = angular_frequencies(nfft, dt, rdt, device)
    prod = apply_filter_bank(signal_ft, mother, scales, ftfreqs, dt)
    W = engine_ifft(prod, engine=engine)[..., :n0]
    return W, signal_ft


def _icwt_norm(mother: Mother, dt: float, dj: float) -> float:
    psi0 = mother.psi0()
    if isinstance(psi0, complex) and psi0.imag == 0:
        psi0 = psi0.real
    return dj * math.sqrt(dt) / (mother.cdelta * psi0)


def icwt_batch(W: torch.Tensor, scales, dt: float, dj: float, *,
               mother: Mother) -> torch.Tensor:
    """Batched inverse CWT, TC98 eq. 11:

        x̂[t] = dj·√dt / (C_δ·ψ(0)) · Σ_s Re(W[s, t]) / √s

    ``W`` is ``(..., S, n0)`` with the scale axis second-to-last."""
    return icwt_planar(W.real, scales, dt, dj, mother=mother)


def icwt_planar(wr: torch.Tensor, scales, dt: float, dj: float, *,
                mother: Mother) -> torch.Tensor:
    """:func:`icwt_batch` on the planar real part alone (TC98 eq. 11 reads
    only Re(W)); ``wr`` is ``(..., S, n)``, the result ``(..., n)`` on
    ``wr``'s device."""
    wr = torch.as_tensor(wr)
    scales = torch.as_tensor(scales, dtype=wr.dtype, device=wr.device)
    norm = _icwt_norm(mother, dt, dj)
    return norm * torch.sum(wr / torch.sqrt(scales)[..., :, None], dim=-2)

"""High-level analysis pipelines — the application layer.

Counterpart of ``pycwt_tpu/analysis.py``:

* :func:`cwt_analysis` — the Torrence & Compo Figure-1 flow: normalize →
  CWT → power → pointwise significance → global wavelet spectrum (+
  time-average significance) → scale-average power (+ scale-average
  significance) → inverse transform, returned as a typed record;
* :func:`xwt_analysis` / :func:`wct_analysis` — the ``sample_xwt.py`` flow,
  with the boxpdf preprocessing option and the Torrence & Webster
  phase-arrow helper;
* :func:`wct_matrix_analysis` — all-pairs coherence of ``B`` signals with
  each pair's Monte-Carlo null;
* :func:`global_spectrum` — the global wavelet spectrum by Parseval.

Each takes ``device=None``, meaning the card; on a CUDA device the
transforms run the planar route (the CUDA kernels), on the CPU the complex
route in ``torch.get_default_dtype()``, as ``ops/fft._planar_route`` decides
for the default policy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import api
from .coherence import wct as _wct
from .coherence import xwt as _xwt
from .config import DEFAULT
from .mothers import Mother, as_mother
from .ops.fft import _planar_route
from .stats import ar1, ar1_batch
from .utils.helpers import boxpdf
from .utils.profiling import span

__all__ = ["CWTAnalysis", "cwt_analysis", "global_spectrum", "xwt_analysis",
           "wct_analysis", "wct_matrix_analysis", "phase_arrows"]


def global_spectrum(signal, dt: float, dj: float = 1 / 12, s0: float = -1,
                    J: int = -1, wavelet: Mother | str = "morlet",
                    variance_scaled: bool = True,
                    engine: str | None = None,
                    exact_trim: bool = False, device=None):
    """Global wavelet spectrum WITHOUT materializing the transform.

    By Parseval the time-mean wavelet power per scale needs no inverse FFT
    (:func:`pycwt_torch.ops.spectra.global_power_parseval`).  Exact when the
    signal length is a power of two; with padding the difference is confined
    to COI-masked edge energy.  ``exact_trim=True`` switches to the
    materialized transform-then-trimmed-mean, matching the reference demo's
    sum exactly at the cost of holding (S × nfft).

    Returns ``(global_power, scales, freqs)`` with the reference demo's
    variance scaling when ``variance_scaled``.
    """
    from .ops.spectra import global_power_parseval
    from .transform import build_scale_grid, cwt_batch

    device = api._resolve_device(device)
    mother = as_mother(wavelet)
    signal = np.asarray(signal)
    n0 = len(signal)
    std = signal.std()
    x = torch.as_tensor((signal - signal.mean()) / std,
                        dtype=DEFAULT.real_dtype, device=device)[None]
    grid = build_scale_grid(n0, dt, dj=dj, s0=s0, J=J, mother=mother)
    sj = torch.as_tensor(grid.sj, dtype=DEFAULT.real_dtype, device=device)
    nfft = DEFAULT.fft_length(n0)
    if exact_trim and nfft != n0:
        W, _ = cwt_batch(x, sj, dt, mother=mother, nfft=nfft, engine=engine)
        gws = api._host((W[..., :n0].abs() ** 2).mean(-1)[0])
    else:
        p = global_power_parseval(x, sj, dt=dt, mother=mother, nfft=nfft,
                                  engine=engine)
        gws = api._host(p[0]) / n0
    if variance_scaled:
        gws = gws * float(std) ** 2
    return gws, grid.sj, grid.freqs


@dataclasses.dataclass(frozen=True)
class CWTAnalysis:
    """Complete single-series wavelet analysis (TC98 Figure-1 contents)."""

    signal: np.ndarray          # standardized input
    t: np.ndarray               # time axis
    dt: float
    W: np.ndarray               # (S, N) wavelet transform
    scales: np.ndarray
    freqs: np.ndarray
    period: np.ndarray
    coi: np.ndarray
    power: np.ndarray           # |W|²
    alpha: float                # AR(1) coefficient used for the red-noise null
    sig95: np.ndarray           # (S, N) power / pointwise significance ratio
    global_power: np.ndarray    # variance-scaled global wavelet spectrum
    global_signif: np.ndarray
    scale_avg: np.ndarray       # scale-averaged power over `avg_band`
    scale_avg_signif: float
    avg_band: tuple
    iwave: np.ndarray           # inverse transform (reconstruction)
    std: float                  # original std (denormalization factor)


def cwt_analysis(
    signal,
    dt: float,
    t0: float = 0.0,
    dj: float = 1 / 12,
    s0: float = -1,
    J: int = -1,
    mother: Mother | str = "morlet",
    significance_level: float = 0.95,
    avg_band: tuple = (2.0, 8.0),
    normalize: bool = True,
    alpha: float | None = None,
    rectify: bool = False,
    device=None,
) -> CWTAnalysis:
    """Run the complete TC98 analysis on one series.

    AR(1) fit with a white-noise fallback (``alpha = 0.0`` where the fit
    raises, the intent of the reference sample's comment), pointwise
    chi-square test (eq. 18), global spectrum with eq. 23 time-average
    significance (dof = N − scales), and eq. 24 scale-average power over
    ``avg_band`` with eq. 26-28 significance.
    """
    device = api._resolve_device(device)
    mother = as_mother(mother)
    signal = np.asarray(signal, dtype=np.float64)
    n0 = signal.size
    std = float(signal.std())
    x = (signal - signal.mean()) / std if normalize else signal.copy()
    var = std ** 2 if normalize else float(signal.var())

    if alpha is None:
        try:
            alpha, _, _ = ar1(x)
        except Warning:
            alpha = 0.0  # white-noise fallback, as the sample scripts do

    if _planar_route(DEFAULT.engine, device, DEFAULT.real_dtype,
                     DEFAULT.fft_length(n0)):
        # power from the kernels' planes; W reassembled on the host
        wr, wi, sj, freqs, coi = api._cwt_planar_parts(
            x, dt, dj=dj, s0=s0, J=J, wavelet=mother, device=device)
        power = wr ** 2 + wi ** 2
        W = wr + 1j * wi
    else:
        W, sj, freqs, coi, _, _ = api.cwt(x, dt, dj=dj, s0=s0, J=J,
                                          wavelet=mother, device=device)
        power = np.abs(W) ** 2
    period = 1.0 / freqs

    signif, _ = api.significance(1.0, dt, sj, 0, alpha=alpha,
                                 significance_level=significance_level,
                                 wavelet=mother)
    sig95 = power / (signif[:, None] * np.ones((1, n0)))

    # Global wavelet spectrum + eq. 23 time-average significance.
    glbl_power = var * power.mean(axis=1)
    dof = n0 - sj
    glbl_signif, _ = api.significance(var, dt, sj, 1, alpha=alpha,
                                      significance_level=significance_level,
                                      dof=dof, wavelet=mother)

    # Scale-average power over avg_band (TC98 eq. 24) + eq. 26-28 significance.
    lo, hi = avg_band
    sel = (period >= lo) & (period < hi)
    cd = mother.cdelta
    scale_avg_full = power / sj[:, None]
    scale_avg = var * dj * dt / cd * scale_avg_full[sel, :].sum(axis=0)
    try:
        scale_avg_signif, _ = api.significance(
            var, dt, sj, 2, alpha=alpha,
            significance_level=significance_level,
            dof=[sj[sel].min(), sj[sel].max()], wavelet=mother)
    except ValueError:
        scale_avg_signif = float("nan")

    iwave = api.icwt(W, sj, dt, dj=dj, wavelet=mother)

    if rectify:
        # Liu, Liang & Weisberg (2007) bias rectification, applied after the
        # significance ratio and the TC98 global/scale averages.
        power = power / sj[:, None]

    return CWTAnalysis(
        signal=x, t=t0 + np.arange(n0) * dt, dt=dt, W=W, scales=sj,
        freqs=freqs, period=period, coi=coi, power=power, alpha=float(alpha),
        sig95=sig95, global_power=glbl_power, global_signif=glbl_signif,
        scale_avg=scale_avg, scale_avg_signif=float(np.atleast_1d(scale_avg_signif)[0]),
        avg_band=avg_band, iwave=np.real(iwave) * (std if normalize else 1.0),
        std=std,
    )


def xwt_analysis(y1, y2, dt, dj=1 / 12, s0=-1, J=-1,
                 significance_level: float = 0.8646,
                 mother="morlet", boxpdf_transform: bool = False, device=None):
    """Cross-wavelet analysis of a signal pair (``sample_xwt.py:139-141``).

    ``significance_level`` defaults to 0.8646 per the Grinsted Z₂
    convention.  ``boxpdf_transform`` rank-transforms strongly non-Gaussian
    series first.
    """
    device = api._resolve_device(device)
    y1 = np.asarray(y1, dtype=np.float64)
    y2 = np.asarray(y2, dtype=np.float64)
    if boxpdf_transform:
        y1, _, _ = boxpdf(y1)
        y2, _, _ = boxpdf(y2)
    kw = dict(dj=dj, s0=s0, J=J, significance_level=significance_level,
              wavelet=mother, device=device)
    if _planar_route(DEFAULT.engine, device, DEFAULT.real_dtype,
                     DEFAULT.fft_length(y1.size)):
        from .coherence import xwt_planar

        cross_power, phase, coi, freq, signif = xwt_planar(y1, y2, dt, **kw)
        W12 = cross_power * np.exp(1j * phase)   # on the host
    else:
        W12, coi, freq, signif = _xwt(y1, y2, dt, **kw)
        cross_power = np.abs(W12)
        phase = np.angle(W12)
    cross_sig = cross_power / (signif[:, None])
    return dict(W12=W12, cross_power=cross_power, cross_sig=cross_sig,
                phase=phase, coi=coi, freq=freq, period=1 / freq,
                signif=signif)


def wct_analysis(y1, y2, dt, dj=1 / 12, s0=-1, J=-1,
                 significance_level: float = 0.8646, mother="morlet",
                 sig: bool = True, device=None, **kwargs):
    """Wavelet-coherence analysis of a signal pair (``sample_xwt.py:151-154``).
    ``sig=True`` adds the Monte-Carlo significance curve
    (:func:`~pycwt_torch.coherence.wct_significance`, which takes
    ``kwargs``)."""
    WCT, aWCT, coi, freq, sig95 = _wct(
        np.asarray(y1, np.float64), np.asarray(y2, np.float64), dt, dj=dj,
        s0=s0, J=J, sig=sig, significance_level=significance_level,
        wavelet=mother, device=device, **kwargs)
    return dict(WCT=WCT, phase=aWCT, coi=coi, freq=freq, period=1 / freq,
                sig95=sig95)


@span("wct_matrix_analysis")
def wct_matrix_analysis(y, dt, dj=1 / 12, s0=-1, J=-1, mother="morlet",
                        significance_level=0.8646, sig: bool = True,
                        pairs=None, mc_count=300, seed=0, cache=True,
                        normalize=True, alpha_quant=None, as_numpy=True,
                        device=None):
    """All-pairs coherence analysis of ``B`` signals with per-pair
    Monte-Carlo nulls: :func:`~pycwt_torch.coherence.wct_matrix` (each
    signal's CWT and self-smoothing computed once) and
    :func:`~pycwt_torch.coherence.wct_significance_batch` as one call.

    AR(1) coefficients are fitted per signal (:func:`ar1_batch`), with the
    white-noise fallback where a fit is degenerate and non-stationary fits
    clipped to ±0.99; the nulls are deduplicated to distinct rounded
    coefficient pairs and cached as ``wct_significance_batch`` does.  With
    ``cache=True`` every pair whose α > 0.25 shares one cache entry, and so
    one curve, as in pycwt (the entry's name folds α through
    round(arctanh(4α)), NaN there); ``cache=False`` gives each pair the
    null of its own coefficients.

    Returns a dict with ``WCT``/``phase`` ``(P, S, n0)`` (tensors on
    ``device`` when ``as_numpy=False``), ``pairs`` ``(P, 2)``, ``sig95``
    ``(P, S)`` (or 0 when ``sig=False``), ``alpha`` ``(B,)``, ``coi``,
    ``freq``, ``period``.

    **Tracing** (``utils.profiling``): the span ``wct_matrix_analysis``
    holds the call; inside it ``wct_matrix``, ``ar1`` (the stations'
    AR(1) fits) and ``mc.batch`` (``wct_significance_batch``, with its
    ``mc.setup``, ``mc.chunks``, ``fetch`` and ``mc.readout``), so its
    self time is the glue.  The counters
    ``profiling.MC_NULLS``, ``MC_NULL_MEMBERS`` and ``MC_NULL_CHUNKS`` add
    the distinct nulls, member pairs and chunks of the significance.
    """
    from .coherence import wct_matrix, wct_significance_batch

    device = api._resolve_device(device)
    m = as_mother(mother)
    y = np.asarray(y, np.float64)
    B, n0 = y.shape
    if s0 == -1:
        s0 = 2 * dt / m.flambda()
    if J == -1:
        J = int(np.round(np.log2(n0 * dt / s0) / dj))
    WCT, aWCT, coi, freq, pairs_out = wct_matrix(
        y, dt, dj=dj, s0=s0, J=J, wavelet=m, pairs=pairs,
        normalize=normalize, as_numpy=as_numpy, device=device)

    with span("ar1"):
        g, _, _ = ar1_batch(y)
    g = np.clip(np.where(np.isfinite(g), g, 0.0), -0.99, 0.99)
    if sig:
        sig95 = wct_significance_batch(
            g[pairs_out[:, 0]], g[pairs_out[:, 1]], dt=dt, dj=dj, s0=s0,
            J=J, significance_level=significance_level, wavelet=m,
            mc_count=mc_count, seed=seed, cache=cache, progress=False,
            alpha_quant=alpha_quant, device=device)
    else:
        sig95 = np.asarray([0])
    return dict(WCT=WCT, phase=aWCT, pairs=pairs_out, sig95=sig95,
                alpha=g, coi=coi, freq=freq, period=1 / freq)


def phase_arrows(phase: np.ndarray):
    """(u, v) quiver components for the Torrence & Webster convention:
    in-phase points up/N (reference ``sample_xwt.py:160-168``)."""
    u, v = np.sin(phase), np.cos(phase)
    return u, v

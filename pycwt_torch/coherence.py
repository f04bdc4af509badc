"""Cross-wavelet transform (XWT) and wavelet coherence (WCT).

Counterpart of the single-pair surfaces of ``pycwt_tpu/coherence.py``:

* :func:`xwt`, :func:`xwt_planar` — reference ``wavelet.py:316-419``;
* :func:`wct` — reference ``wavelet.py:422-528``, for every mother with a
  tabulated ``deltaj0`` (the reference only defines smoothing on Morlet).

The entry points take ``device=None``, meaning the card; without one they
raise and name ``device="cpu"``.  On a CUDA tensor the WCT runs the planar
pipeline (:func:`_wct_core_planar`): the forward CWTs go through
``fused_cwt_planar``, so the CUDA kernels ``cwt_stage_a``/``cwt_stage_b``
run, or ``cwt_direct`` for nfft ≤ 2^12 under ``PYCWT_TPU_SMALL_KERNEL=1``.
``wct(sig=True)``, the reference's default, needs the Monte-Carlo
significance, which this package does not have yet: it raises
``NotImplementedError``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import CWTConfig, DEFAULT
from .mothers import Mother, as_mother
from .ops.fft import resolve_engine
from .ops.smoothing import smooth, smooth_planar_pair
from .stats import ar1, ar1_spectrum
from .transform import (build_scale_grid, coi_bartlett, cwt_batch,
                        drop_reference_nan_rows)

__all__ = ["xwt", "xwt_planar", "wct"]


def _normalized(y1, y2, normalize: bool):
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    std1 = y1.std()
    std2 = y2.std()
    if normalize:
        return y1, y2, (y1 - y1.mean()) / std1, (y2 - y2.mean()) / std2, 1.0, 1.0
    return y1, y2, y1, y2, std1, std2


def _xwt_signif(y1, y2, freq, dt, mother: Mother, significance_level, std1, std2):
    """Theoretical XWT significance ``std1·std2·sqrt(Pk1·Pk2)·PPF/dof`` with
    the AR(1) coefficients of the raw inputs."""
    a1, _, _ = ar1(y1)
    a2, _, _ = ar1(y2)
    Pk1 = ar1_spectrum(freq * dt, a1)
    Pk2 = ar1_spectrum(freq * dt, a2)
    dof = mother.dofmin
    PPF = _chi2_ppf_host(significance_level, dof)
    return std1 * std2 * (Pk1 * Pk2) ** 0.5 * PPF / dof


def xwt(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, significance_level=0.95,
        wavelet="morlet", normalize=True, config: CWTConfig = DEFAULT,
        device=None):
    """Cross-wavelet transform of two signals.

    Returns ``(W12, coi, freq, signif)`` as the reference — including
    computing the AR(1) coefficients on the *raw* (un-normalized) inputs and
    the theoretical significance ``std1·std2·sqrt(Pk1·Pk2)·PPF/dof``.  Use
    an 86.46% confidence level to match Grinsted et al. (2004)'s Z₂ = 3.999.
    """
    from .api import cwt

    wavelet = as_mother(wavelet)
    y1, y2, y1_n, y2_n, std1, std2 = _normalized(y1, y2, normalize)
    kw = dict(dj=dj, s0=s0, J=J, wavelet=wavelet, config=config, device=device)
    W1, sj, freq, coi, _, _ = cwt(y1_n, dt, **kw)
    W2, sj, freq, coi, _, _ = cwt(y2_n, dt, **kw)
    W12 = W1 * W2.conj()
    signif = _xwt_signif(y1, y2, freq, dt, wavelet, significance_level, std1, std2)
    return W12, coi, freq, signif


def xwt_planar(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, significance_level=0.95,
               wavelet="morlet", normalize=True, config: CWTConfig = DEFAULT,
               device=None):
    """:func:`xwt` on ``(re, im)`` planes through ``fused_cwt_planar``.

    Returns ``(mag, phase, coi, freq, signif)`` where ``mag = |W12|`` and
    ``phase = arg W12`` (radians); needs a power-of-two FFT length.
    """
    from .api import _cwt_planar_parts
    from .ops.mxu_dft import supported_n

    mother = as_mother(wavelet)
    nfft_gate = config.fft_length(len(np.asarray(y1)))
    if not supported_n(nfft_gate):
        raise ValueError(
            f"xwt_planar requires a power-of-two FFT length, got nfft="
            f"{nfft_gate} (n={len(y1)}, pad_pow2={config.pad_pow2}). Use "
            "CWTConfig(pad_pow2=True) or the complex-engine xwt().")
    y1, y2, y1_n, y2_n, std1, std2 = _normalized(y1, y2, normalize)
    kw = dict(dj=dj, s0=s0, J=J, wavelet=mother, config=config, device=device)
    w1r, w1i, sj, freq, coi = _cwt_planar_parts(y1_n, dt, **kw)
    w2r, w2i, _, _, _ = _cwt_planar_parts(y2_n, dt, **kw)

    w12r = w1r * w2r + w1i * w2i          # W1 · conj(W2), planar
    w12i = w1i * w2r - w1r * w2i
    mag = np.hypot(w12r, w12i)
    phase = np.arctan2(w12i, w12r)
    signif = _xwt_signif(y1, y2, freq, dt, mother, significance_level, std1, std2)
    return mag, phase, coi, freq, signif


def _chi2_ppf_host(p: float, df) -> float:
    """Host float64 chi-square PPF (``ops.special.chi2_ppf_host``)."""
    from .ops.special import chi2_ppf_host

    return float(chi2_ppf_host(p, df))


def _wct_core_planar(y1n, y2n, scales, dt, *, mother: Mother, nfft: int,
                     dj: float):
    """:func:`_wct_core` on real planes in f32: planar forward DFT →
    ``fused_cwt_planar`` (the CUDA kernels on a CUDA tensor) → plane-packed
    smoothing → coherence and arctan2 phase.  Needs a pow-2 nfft; below the
    kernels' 2^8 the plain version runs.

    Returns ``(WCT, aWCT, (W12r, W12i))``.
    """
    from .ops.fused_cwt import (_fused_cwt_planar_reference, fused_cwt_planar,
                                supported_nfft)
    from .ops.mxu_dft import fft_of_real_planar, supported_n

    if not supported_n(nfft):
        raise ValueError(
            f"planar WCT needs a power-of-two nfft, got {nfft}. Use "
            "CWTConfig(pad_pow2=True) or a complex engine ('xla'/'mxu').")
    y1n = torch.as_tensor(y1n).to(torch.float32)
    y2n = torch.as_tensor(y2n).to(device=y1n.device, dtype=torch.float32)
    scales = torch.as_tensor(scales).to(device=y1n.device, dtype=torch.float32)
    n0 = y1n.shape[-1]
    transform = (fused_cwt_planar if supported_nfft(nfft)
                 else _fused_cwt_planar_reference)

    def planar_w(y):
        sr, si = fft_of_real_planar(y, nfft)
        wr, wi = transform(sr, si, scales, mother=mother, nfft=nfft, dt=float(dt))
        return wr[..., :n0], wi[..., :n0]

    w1r, w1i = planar_w(y1n)
    w2r, w2i = planar_w(y2n)
    s_col = scales[:, None]
    # Two plane-packed smoothing calls instead of four single-plane ones.
    S1, S2 = smooth_planar_pair((w1r ** 2 + w1i ** 2) / s_col,
                                (w2r ** 2 + w2i ** 2) / s_col,
                                dt, dj, scales, mother)
    w12r = w1r * w2r + w1i * w2i          # W1 · conj(W2), planar
    w12i = w1i * w2r - w1r * w2i
    S12r, S12i = smooth_planar_pair(w12r / s_col, w12i / s_col,
                                    dt, dj, scales, mother)
    WCT = (S12r ** 2 + S12i ** 2) / (S1 * S2)
    aWCT = torch.atan2(w12i, w12r)
    return WCT, aWCT, (w12r, w12i)


def _wct_core(y1n, y2n, scales, dt, *, mother: Mother, nfft: int, dj: float,
              engine: str | None = None):
    """WCT pipeline on normalized batched tensors ``(B, n0)`` (reference
    ``wavelet.py:499-514``): two CWTs, three smoothings of the
    scale-normalized (co)spectra, coherence magnitude and phase, on the
    inputs' device and, off the planar engine, in their dtype.

    Returns ``(WCT, aWCT, W12)``.  Under engine ``"planar"`` (the CUDA
    default) the pipeline is :func:`_wct_core_planar` and ``W12`` is the
    planar pair ``(W12r, W12i)``.
    """
    y1n = torch.as_tensor(y1n)
    if resolve_engine(engine, y1n.device) == "planar":
        if y1n.dtype == torch.float64:
            # The planar kernels are f32-only; never downgrade f64 parity
            # inputs silently.
            warnings.warn(
                "engine='planar' computes in float32; float64 inputs are "
                "downcast. Use engine='xla' (or 'mxu') for f64 parity runs.",
                stacklevel=2,
            )
        return _wct_core_planar(y1n, y2n, scales, dt, mother=mother,
                                nfft=nfft, dj=dj)
    cfg = CWTConfig(dtype=y1n.dtype)
    scales = torch.as_tensor(scales, dtype=y1n.dtype, device=y1n.device)
    kw = dict(mother=mother, nfft=nfft, config=cfg, engine=engine)
    W1, _ = cwt_batch(y1n, scales, dt, **kw)
    W2, _ = cwt_batch(torch.as_tensor(y2n), scales, dt, **kw)
    s_col = scales[:, None]
    S1 = smooth(W1.abs() ** 2 / s_col, dt, dj, scales, mother, engine=engine)
    S2 = smooth(W2.abs() ** 2 / s_col, dt, dj, scales, mother, engine=engine)
    W12 = W1 * torch.conj(W2)
    S12 = smooth(W12 / s_col, dt, dj, scales, mother, engine=engine)
    WCT = S12.abs() ** 2 / (S1 * S2)
    aWCT = torch.angle(W12)
    return WCT, aWCT, W12


def wct(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, sig=True, significance_level=0.95,
        wavelet="morlet", normalize=True, config: CWTConfig = DEFAULT,
        device=None, **kwargs):
    """Wavelet coherence transform of two signals.

    Returns ``(WCT, aWCT, coi, freq, sig)`` as the reference, with
    ``sig = [0]`` under ``sig=False``.  ``config`` selects padding policy,
    dtype and engine.  ``sig=True`` (the default) raises
    ``NotImplementedError``: the Monte-Carlo significance
    (``wct_significance``) is not ported yet (ROADMAP.md queue 1 item 7).
    """
    from .api import _host, _resolve_device

    if sig:
        raise NotImplementedError(
            "wct(sig=True) needs the Monte-Carlo significance "
            "(wct_significance), which pycwt_torch does not have yet "
            "(ROADMAP.md queue 1 item 7); pass sig=False")
    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)

    if s0 == -1:
        s0 = 2 * dt / mother.flambda()
    if J == -1:
        J = int(np.round(np.log2(y1.size * dt / s0) / dj))

    _, _, y1_n, y2_n, _, _ = _normalized(y1, y2, normalize)
    n0 = y1.size
    grid = build_scale_grid(n0, dt, dj=dj, s0=s0, J=J, mother=mother)
    nfft = config.fft_length(n0)
    # The reference's wct inherits cwt's NaN-row drop: apply the same
    # host-side drop so Paul-type mothers keep the reference's scale axis.
    sj, freq = drop_reference_nan_rows(mother, grid.sj, grid.freqs, nfft, dt)
    rdt = config.real_dtype
    WCT, aWCT, _ = _wct_core(
        torch.as_tensor(y1_n, dtype=rdt, device=device)[None],
        torch.as_tensor(y2_n, dtype=rdt, device=device)[None],
        torch.as_tensor(sj, dtype=rdt, device=device),
        dt, mother=mother, nfft=nfft, dj=dj, engine=config.engine,
    )
    coi = coi_bartlett(n0, dt, mother)
    return _host(WCT[0]), _host(aWCT[0]), coi, freq, np.asarray([0])

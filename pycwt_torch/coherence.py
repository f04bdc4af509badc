"""Cross-wavelet transform (XWT), wavelet coherence (WCT) and its
Monte-Carlo significance.

Counterpart of the single-device surfaces of ``pycwt_tpu/coherence.py``:

* :func:`xwt`, :func:`xwt_planar` — reference ``wavelet.py:316-419``;
* :func:`wct` — reference ``wavelet.py:422-528``, for every mother with a
  tabulated ``deltaj0`` (the reference only defines smoothing on Morlet);
* :func:`xwt_pairs`, :func:`xwt_pairs_planar`, :func:`wct_pairs` — the
  same for ``B`` pairs, in blocks of pairs; :func:`wct_matrix` — coherence
  of many pairs of ``B`` signals, each signal's transform computed once;
* :func:`wct_significance` — reference ``wavelet.py:531-647``, and
  :func:`wct_significance_batch`, the same for many AR(1) nulls at once.

The entry points take ``device=None``, meaning the card; without one they
raise and name ``device="cpu"``; each builds its grid in
``transform._host_grid``.  Where ``ops/fft._planar_route`` says so (f32 on
the card) the WCT runs :func:`_wct_core_planar`: the rows reach the CUDA
kernels through ``ops/fused_cwt._planar_cwt_of_real`` (``cwt_direct`` for
nfft ≤ 2^12 under ``PYCWT_TPU_SMALL_KERNEL=1``), and
:func:`_planar_coherence`, shared with ``ops/overlap.py``, smooths them;
on the card one ``wct_fields_head`` launch (``ops/wct_head.py``) builds
the fields that the smoothing takes from the W planes.

The Monte-Carlo significance draws its AR(1) surrogates from ``jax.random``'s
own threefry streams (``stats.rednoise_members*``), so for one seed the port
and ``pycwt_tpu`` simulate the same members.  Each chunk of members is one
batched pipeline on the device (:func:`_mc_counts`): surrogates → the
smoothed fields of :func:`_planar_fields` → integer counts of
floor(R²·1000) outside the COI, by one ``mc_coherence_counts`` launch
(``ops/mc_hist.py``) on the card, and elsewhere by :func:`_histogram`
(``scatter_add_``) of the ratio or of :func:`_wct_core`'s coherence; the
chunks accumulate on the device and only the (J+1, 1000) histogram comes
back to the host for the empirical CDF.
"""
from __future__ import annotations

import math
import os
import zipfile
import zlib

import numpy as np
import torch

from .config import CWTConfig, DEFAULT
from .mothers import Mother, as_mother
from .ops import mc_hist, wct_head
from .ops.fft import _planar_route, resolve_engine
from .ops.smoothing import smooth, smooth_planar_pair
from .stats import (PRNGKey, _burn_in, ar1, ar1_batch, ar1_spectrum,
                    rednoise_members, rednoise_members_pairs, split)
from .transform import _host_grid, build_scale_grid, coi_bartlett, cwt_batch
from .utils import profiling
from .utils.helpers import find, get_cache_dir
from .utils.profiling import span

__all__ = ["xwt", "xwt_pairs", "xwt_pairs_planar", "xwt_planar", "wct",
           "wct_pairs", "wct_matrix", "wct_significance",
           "wct_significance_batch"]

NBINS = 1000  # histogram resolution of the MC coherence CDF (wavelet.py:606)


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

    mother = as_mother(wavelet)
    y1, y2, y1_n, y2_n, std1, std2 = _normalized(y1, y2, normalize)
    kw = dict(dj=dj, s0=s0, J=J, wavelet=mother, config=config, device=device)
    w1r, w1i, sj, freq, coi = _cwt_planar_parts(y1_n, dt, **kw)
    w2r, w2i, _, _, _ = _cwt_planar_parts(y2_n, dt, **kw)

    w12r, w12i = _cross((w1r, w1i), (w2r, w2i))
    mag = np.hypot(w12r, w12i)
    phase = np.arctan2(w12i, w12r)
    signif = _xwt_signif(y1, y2, freq, dt, mother, significance_level, std1, std2)
    return mag, phase, coi, freq, signif


def _chi2_ppf_host(p: float, df) -> float:
    """Host float64 chi-square PPF (``ops.special.chi2_ppf_host``)."""
    from .ops.special import chi2_ppf_host

    return float(chi2_ppf_host(p, df))


def _planar_w(y, scales, *, mother: Mother, nfft: int, dt: float,
              precision: str = "highest"):
    """Planar W ``(wr, wi)``, each ``(..., S, n)`` f32, of real rows ``y``
    ``(..., n)``: ``_planar_cwt_of_real`` (their spectrum in f64, rounded
    once; the kernels on a CUDA tensor), trimmed to the signal length."""
    from .ops.fused_cwt import _planar_cwt_of_real

    n = y.shape[-1]
    wr, wi = _planar_cwt_of_real(y, scales, mother=mother, nfft=nfft, dt=dt,
                                 precision=precision)
    return wr[..., :n], wi[..., :n]


def _cross(w1, w2):
    """W1 · conj(W2) of two planar pairs ``(re, im)``, as a planar pair."""
    (w1r, w1i), (w2r, w2i) = w1, w2
    return w1r * w2r + w1i * w2i, w1i * w2r - w1r * w2i


def _torch_head(w1, w2, scales, *, cross: bool = True):
    """The coherence head in torch ops, ``wct_fields_head``'s plain version
    (``ops/wct_head.py``): the scale-normalized auto-spectra packed as ``S =
    |W1|²/s + i·|W2|²/s``, the cross spectrum as ``C = W12r/s + i·W12i/s``,
    and the cross planes ``(W12r, W12i)`` where ``cross``, else None."""
    (w1r, w1i), (w2r, w2i) = w1, w2
    s_col = scales[:, None]
    S = torch.complex((w1r ** 2 + w1i ** 2) / s_col, (w2r ** 2 + w2i ** 2) / s_col)
    w12r, w12i = _cross(w1, w2)
    C = torch.complex(w12r / s_col, w12i / s_col)
    profiling.WCT_HEAD_PLAIN_POINTS += w1r.numel()
    return S, C, ((w12r, w12i) if cross else None)


def _head_on_card(w1, w2, scales) -> bool:
    """Whether the head runs in ``wct_fields_head``: f32 planes and scales
    on a CUDA device, of which no gradient is asked."""
    ts = (*w1, *w2, scales)
    return (wct_head.on_card(ts[0]) and all(t.dtype == torch.float32 for t in ts)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def _planar_fields(w1, w2, scales, *, dt: float, dj: float, mother: Mother,
                   cross: bool = True):
    """The smoothed fields of the coherence of two planar transforms ``(wr,
    wi)``, each ``(..., S, n)`` f32 over ``scales`` ``(S,)``: the
    scale-normalized auto-spectra packed as ``S1 + i·S2`` and the cross
    spectrum ``W12r + i·W12i``, each smoothed in one complex pass (as
    ``smooth_planar_pair`` does, whose planes are their real and imaginary
    views).  The head before the smoothing is one ``wct_fields_head``
    launch (``ops/wct_head.py``) where :func:`_head_on_card`, else
    :func:`_torch_head`: the same fields, bit for bit.

    Returns ``(S, C, (W12r, W12i))``: ``S = S1 + i·S2`` and ``C = S12r +
    i·S12i``, complex ``(..., S, n)``; the cross planes are None unless
    ``cross``.
    """
    if _head_on_card(w1, w2, scales):
        S, C, w12 = wct_head.fields_head(*w1, *w2, scales, cross=cross)
    else:
        S, C, w12 = _torch_head(w1, w2, scales, cross=cross)
    Sm = smooth(S, dt, dj, scales, mother)
    del S  # freed before the second smoothing allocates its workspace
    return Sm, smooth(C, dt, dj, scales, mother), w12


def _coherence_ratio(Sm, Cm):
    """R² = (S12r² + S12i²) / (S1·S2) of :func:`_planar_fields`' fields,
    each op rounded on its own (``mc_coherence_counts`` rounds alike)."""
    return (Cm.real ** 2 + Cm.imag ** 2) / (Sm.real * Sm.imag)


def _planar_coherence(w1, w2, scales, *, dt: float, dj: float,
                      mother: Mother):
    """The coherence of two planar transforms ``(wr, wi)``, each ``(..., S,
    n)`` f32 over ``scales`` ``(S,)``: :func:`_planar_fields`, then R²
    (:func:`_coherence_ratio`) and the arctan2 phase.

    Returns ``(WCT, aWCT, (W12r, W12i))``.
    """
    Sm, Cm, (w12r, w12i) = _planar_fields(w1, w2, scales, dt=dt, dj=dj,
                                          mother=mother)
    return _coherence_ratio(Sm, Cm), torch.atan2(w12i, w12r), (w12r, w12i)


def _planar_ws(y1n, y2n, scales, dt, *, mother: Mother, nfft: int):
    """Each row's trimmed planar CWT (:func:`_planar_w`: the spectrum in f64
    rounded once to f32 planes, the CUDA kernels on a CUDA tensor, their
    plain version below 2^8) and the f32 scales on the rows' device.

    Returns ``(w1, w2, scales)``.
    """
    y1n = torch.as_tensor(y1n)
    y2n = torch.as_tensor(y2n).to(device=y1n.device)
    scales = torch.as_tensor(scales).to(device=y1n.device, dtype=torch.float32)
    kw = dict(mother=mother, nfft=nfft, dt=dt)
    return _planar_w(y1n, scales, **kw), _planar_w(y2n, scales, **kw), scales


def _wct_core_planar(y1n, y2n, scales, dt, *, mother: Mother, nfft: int,
                     dj: float):
    """:func:`_wct_core` on real f32 planes: :func:`_planar_ws`, then
    :func:`_planar_coherence`.  Needs a pow-2 nfft.

    Returns ``(WCT, aWCT, (W12r, W12i))``.
    """
    w1, w2, scales = _planar_ws(y1n, y2n, scales, dt, mother=mother, nfft=nfft)
    return _planar_coherence(w1, w2, scales, dt=dt, dj=dj, mother=mother)


def _wct_core(y1n, y2n, scales, dt, *, mother: Mother, nfft: int, dj: float,
              engine: str | None = None):
    """WCT pipeline on normalized batched tensors ``(B, n0)`` (reference
    ``wavelet.py:499-514``): two CWTs, three smoothings of the
    scale-normalized (co)spectra, coherence magnitude and phase, on the
    inputs' device and, off the planar engine, in their dtype.

    Returns ``(WCT, aWCT, W12)``.  On the planar route (``_planar_route``:
    engine ``"planar"``, the CUDA default for f32, and a pow-2 nfft) the
    pipeline is :func:`_wct_core_planar` and ``W12`` is the planar pair
    ``(W12r, W12i)``.
    """
    # a block, not a decorator, whose frame would shift the warning's stacklevel
    with span("wct.core"):
        y1n = torch.as_tensor(y1n)
        if _planar_route(engine, y1n.device, y1n.dtype, nfft):
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


@span("wct")
def wct(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, sig=True, significance_level=0.95,
        wavelet="morlet", normalize=True, config: CWTConfig = DEFAULT,
        device=None, **kwargs):
    """Wavelet coherence transform of two signals.

    Returns ``(WCT, aWCT, coi, freq, sig)`` as the reference, with
    ``sig = [0]`` under ``sig=False``.  ``config`` selects padding policy,
    dtype and engine for the whole pipeline, the Monte-Carlo significance
    included; ``kwargs`` go to :func:`wct_significance` (``mc_count``,
    ``cache``, ``progress``, ``seed``, ...), which runs on ``device`` too.
    """
    from .api import _host, _resolve_device, _upload

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)

    _, _, y1_n, y2_n, _, _ = _normalized(y1, y2, normalize)
    # The reference's wct inherits cwt's grid and NaN-row drop, so Paul-type
    # mothers keep the reference's scale axis.
    g = _host_grid(y1.size, dt, dj, s0, J, mother, config.fft_length)
    rdt = config.real_dtype
    with span("upload"):
        x1 = _upload(y1_n, device, rdt)[None]
        x2 = _upload(y2_n, device, rdt)[None]
        sj = _upload(g.sj, device, rdt)
    WCT, aWCT, _ = _wct_core(x1, x2, sj, dt, mother=mother, nfft=g.nfft,
                             dj=dj, engine=config.engine)

    if sig:
        with span("ar1"):
            a1, _, _ = ar1(y1)
            a2, _, _ = ar1(y2)
        sig_out = wct_significance(
            a1, a2, dt=dt, dj=dj, s0=g.s0, J=g.J,
            significance_level=significance_level, wavelet=mother,
            config=config, device=device, **kwargs,
        )
    else:
        sig_out = np.asarray([0])
    return _host(WCT[0]), _host(aWCT[0]), g.coi, g.freqs, sig_out


# --------------------------------------------------------------------------
# Many pairs: xwt_pairs, xwt_pairs_planar, wct_pairs, wct_matrix
# --------------------------------------------------------------------------

def _pair_rows(y1, y2, name: str):
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    if y1.ndim != 2 or y1.shape != y2.shape:
        raise ValueError(
            f"{name} expects matching (B, n0) arrays, got {y1.shape} vs "
            f"{y2.shape}")
    return y1, y2


def _rows_normalized(y: np.ndarray, normalize: bool) -> np.ndarray:
    if normalize:
        return (y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True)
    return y


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _pairs_signif(y1, y2, freqs, dt, mother: Mother, significance_level,
                  normalize: bool) -> np.ndarray:
    """Per-pair theoretical XWT significance ``(B, S)``: the reference's
    ``std1·std2·sqrt(Pk1·Pk2)·PPF/dof`` with the AR(1) coefficients of the
    raw rows (:func:`ar1_batch`, NaN where :func:`ar1` would raise)."""
    ones = np.ones(y1.shape[0])
    std1, std2 = (ones, ones) if normalize else (y1.std(-1), y2.std(-1))
    dof = mother.dofmin
    PPF = _chi2_ppf_host(significance_level, dof)
    a1, _, _ = ar1_batch(y1)
    a2, _, _ = ar1_batch(y2)
    Pk1 = ar1_spectrum(freqs[None, :] * dt, a1[:, None])     # (B, S)
    Pk2 = ar1_spectrum(freqs[None, :] * dt, a2[:, None])
    return std1[:, None] * std2[:, None] * (Pk1 * Pk2) ** 0.5 * PPF / dof


def _pairs_block(B: int, S: int, nfft: int, itemsize: int,
                 planes: int = 112, budget_bytes: float = 25e9) -> int:
    """Largest block of pairs whose live intermediates fit ``budget_bytes``:
    ``planes`` (S, nfft) planes of ``itemsize`` bytes a pair at the peak
    (112 for :func:`wct_pairs`, 24 for the XWT pairs, 48 for
    :func:`wct_matrix`'s cross smoothing, the JAX package's models).  The
    budget is :func:`_mc_auto_batch`'s 25e9 bytes of the 80 GB H100, where
    the JAX package budgets 2e9 of a 16 GB v5e.  ``chip_smoke.py`` measures
    each caller's peak a pair beside its model: 8.0, 7.8, 9.7 and 10.0
    planes (xwt_pairs, xwt_pairs_planar, wct_pairs, wct_matrix) at S = 110,
    nfft 1024 on the H100.  At most ``B``, at least 1."""
    per_pair = planes * S * nfft * itemsize
    blk = int(budget_bytes // max(per_pair, 1))
    return max(1, min(B, blk))


def xwt_pairs(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, significance_level=0.95,
              wavelet="morlet", normalize=True, config: CWTConfig = DEFAULT,
              pair_block: int | None = None, device=None):
    """Cross-wavelet transform of ``B`` signal pairs (the batched
    :func:`xwt`; the reference computes one pair per call).

    ``y1, y2``: ``(B, n0)``.  Returns ``(W12, coi, freq, signif)`` with
    ``W12`` of shape ``(B, S, n0)`` (complex) and ``signif`` ``(B, S)``, the
    per-pair theoretical AR(1) significance with the reference's semantics
    (AR(1) fitted on the RAW rows; ``std1·std2·sqrt(Pk1·Pk2)·PPF/dof``).
    The pairs run in blocks of ``pair_block`` (``None``: the largest that
    :func:`_pairs_block`'s bytes model admits) written into one ``(B, S,
    n0)`` output, so memory stays bounded; the last block may be shorter.
    """
    from .api import _host, _resolve_device

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y1, y2 = _pair_rows(y1, y2, "xwt_pairs")
    B, n0 = y1.shape
    g = _host_grid(n0, dt, dj, s0, J, mother, config.fft_length)
    rdt = config.real_dtype
    blk = pair_block if pair_block is not None else _pairs_block(
        B, len(g.sj), g.nfft, _itemsize(rdt), planes=24)
    y1_n = _rows_normalized(y1, normalize)
    y2_n = _rows_normalized(y2, normalize)
    sj_t = torch.as_tensor(g.sj, dtype=rdt, device=device)
    W12 = torch.empty((B, len(g.sj), n0), dtype=config.complex_dtype, device=device)
    for b0 in range(0, B, blk):
        W1, _ = cwt_batch(torch.as_tensor(y1_n[b0:b0 + blk], dtype=rdt, device=device),
                          sj_t, dt, mother=mother, nfft=g.nfft, config=config)
        W2, _ = cwt_batch(torch.as_tensor(y2_n[b0:b0 + blk], dtype=rdt, device=device),
                          sj_t, dt, mother=mother, nfft=g.nfft, config=config)
        W12[b0:b0 + blk] = W1 * W2.conj()
    signif = _pairs_signif(y1, y2, g.freqs, dt, mother, significance_level, normalize)
    return _host(W12), g.coi, g.freqs, signif


def xwt_pairs_planar(y1, y2, dt, dj=1 / 12, s0=-1, J=-1,
                     significance_level=0.95, wavelet="morlet",
                     normalize=True, config: CWTConfig = DEFAULT,
                     pair_block: int | None = None, device=None):
    """:func:`xwt_pairs` on ``(re, im)`` f32 planes through
    ``fused_cwt_planar`` (the kernels on the card): each block's planar
    forward DFT, the planar CWTs, then ``|W12|`` and its ``atan2`` phase.

    Returns ``(mag, phase, coi, freq, signif)`` with ``mag``/``phase`` of
    shape ``(B, S, n0)`` and ``signif`` ``(B, S)`` as :func:`xwt_pairs`;
    ``mag·e^{i·phase}`` equals its ``W12`` to f32 round-off.  Needs a
    power-of-two FFT length.
    """
    from .api import _host, _resolve_device

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y1, y2 = _pair_rows(y1, y2, "xwt_pairs_planar")
    B, n0 = y1.shape
    g = _host_grid(n0, dt, dj, s0, J, mother, config.fft_length)
    blk = pair_block if pair_block is not None else _pairs_block(
        B, len(g.sj), g.nfft, 4, planes=24)
    y1_n = _rows_normalized(y1, normalize)
    y2_n = _rows_normalized(y2, normalize)
    sj32 = torch.as_tensor(g.sj, dtype=torch.float32, device=device)
    kw = dict(mother=mother, nfft=g.nfft, dt=dt, precision=config.precision)
    mag = torch.empty((B, len(g.sj), n0), dtype=torch.float32, device=device)
    phase = torch.empty_like(mag)
    for b0 in range(0, B, blk):
        w12r, w12i = _cross(
            _planar_w(torch.as_tensor(y1_n[b0:b0 + blk], dtype=torch.float32,
                                      device=device), sj32, **kw),
            _planar_w(torch.as_tensor(y2_n[b0:b0 + blk], dtype=torch.float32,
                                      device=device), sj32, **kw))
        mag[b0:b0 + blk] = torch.sqrt(w12r * w12r + w12i * w12i)
        phase[b0:b0 + blk] = torch.atan2(w12i, w12r)
    signif = _pairs_signif(y1, y2, g.freqs, dt, mother, significance_level, normalize)
    return _host(mag), _host(phase), g.coi, g.freqs, signif


def wct_pairs(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
              normalize=True, config: CWTConfig = DEFAULT,
              pair_block: int | None = None, device=None):
    """Wavelet coherence of ``B`` signal pairs (the reference's ``wct`` is
    one pair per call).

    Parameters are as :func:`wct` with ``y1, y2`` of shape ``(B, n0)``, each
    pair normalized on its own when ``normalize``.  Returns ``(WCT, aWCT,
    coi, freq)`` with ``WCT``/``aWCT`` of shape ``(B, S, n0)``.  No
    significance: each pair has its own AR(1) null
    (:func:`wct_significance_batch`).  The pairs run through
    :func:`_wct_core` (the planar kernels' route for f32 on the card) in
    blocks of ``pair_block`` (``None``: :func:`_pairs_block`'s bytes
    model); the results do not depend on the blocking.
    """
    from .api import _host, _resolve_device

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y1, y2 = _pair_rows(y1, y2, "wct_pairs")
    B, n0 = y1.shape
    g = _host_grid(n0, dt, dj, s0, J, mother, config.fft_length)
    rdt = config.real_dtype
    blk = pair_block if pair_block is not None else _pairs_block(
        B, len(g.sj), g.nfft, _itemsize(rdt))
    y1_n = _rows_normalized(y1, normalize)
    y2_n = _rows_normalized(y2, normalize)
    sj_t = torch.as_tensor(g.sj, dtype=rdt, device=device)
    WCT = aWCT = None
    for b0 in range(0, B, blk):
        R, A, _ = _wct_core(
            torch.as_tensor(y1_n[b0:b0 + blk], dtype=rdt, device=device),
            torch.as_tensor(y2_n[b0:b0 + blk], dtype=rdt, device=device),
            sj_t, dt, mother=mother, nfft=g.nfft, dj=dj, engine=config.engine)
        if WCT is None:     # the route sets the dtype: f32 on the planar one
            WCT = R.new_empty((B,) + R.shape[1:])
            aWCT = A.new_empty((B,) + A.shape[1:])
        WCT[b0:b0 + blk] = R
        aWCT[b0:b0 + blk] = A
    return _host(WCT), _host(aWCT), g.coi, g.freqs


@span("wct_matrix")
def wct_matrix(y, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
               normalize=True, config: CWTConfig = DEFAULT, pairs=None,
               pair_block: int | None = None, max_bytes: float = 12e9,
               as_numpy: bool = True, device=None):
    """Wavelet coherence of many pairs drawn from ``B`` signals, each
    signal's CWT and self-smoothing computed once and shared by its pairs.

    For ``pairs=None`` (every ``i < j`` pair, ``B·(B−1)/2`` of them) each
    transform serves ``B−1`` pairs, so a pair costs one cross smoothing.
    On the planar route (f32 on the card) the transforms run through
    ``fused_cwt_planar`` and the smoothing on planes; each block of
    ``pair_block`` pairs gathers its rows with ``index_select``, forms the
    cross spectrum and runs one ``smooth_planar_pair``.  The complex route
    (``cwt_batch`` + ``smooth``) serves f64 and the CPU.

    **Memory bound:** the signals' transforms and self-smoothings stay
    resident across the pair loop, about ``6·B·S·nfft·itemsize`` bytes at
    the peak.  A request whose resident set exceeds ``max_bytes`` (default
    12 GB) raises before any device allocation: split the station list with
    ``pairs=``, raise ``max_bytes`` (an 80 GB H100 holds several times
    the default), or shard the pairs over ranks with
    :func:`pycwt_torch.parallel.sharded_wct_matrix`.

    Parameters
    ----------
    y: ``(B, n0)`` signals (each normalized on its own when ``normalize``).
    pairs: ``(P, 2)`` integer array of (i, j) indices into ``y``, or ``None``
        for all ``i < j`` pairs.
    pair_block: pairs a block (``None``: :func:`_pairs_block`'s model).
    max_bytes: resident-set budget for the shared ``(B, S, nfft)`` fields.
    as_numpy: ``True`` (the default) fetches both maps to host numpy
        through ``api._host``, ``2·P·S·n0·4`` bytes in f32: ~450 MB for 32
        stations of 1024 samples (496 pairs, 110 scales).  ``False``
        returns them as tensors on ``device``, unfetched.

    Returns ``(WCT, aWCT, coi, freq, pairs)`` with ``WCT``/``aWCT`` of shape
    ``(P, S, n0)`` and ``pairs`` the ``(P, 2)`` index array used.

    **Tracing** (``utils.profiling``): the span ``wct_matrix`` holds the
    call, ``grid`` its host grid, ``upload`` the copies of the rows, the
    pair indices and the scales to the device, ``wct_matrix.fields`` the
    shared transforms and self-smoothings, ``wct_matrix.pairs`` the loop
    over the blocks of pairs, and ``fetch`` each map's copy to the host;
    the counters ``profiling.MATRIX_PAIRS`` and
    ``profiling.MATRIX_PAIR_BLOCKS`` add the pairs computed and the blocks
    run.
    """
    from .api import _host, _resolve_device, _upload

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    y = np.asarray(y)
    if y.ndim != 2:
        raise ValueError(f"wct_matrix expects (B, n0), got {y.shape}")
    B, n0 = y.shape
    if pairs is None:
        pairs = np.array([(i, j) for i in range(B) for j in range(i + 1, B)],
                         dtype=np.int32)
    else:
        pairs = np.asarray(pairs, dtype=np.int32)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"pairs must be (P, 2), got {pairs.shape}")
        if pairs.size and (pairs.min() < 0 or pairs.max() >= B):
            raise ValueError("pair indices out of range")
    P = len(pairs)
    if P == 0:
        raise ValueError("no pairs to compute")

    g = _host_grid(n0, dt, dj, s0, J, mother, config.fft_length)
    nfft = g.nfft
    rdt = config.real_dtype
    S = len(g.sj)
    # The shared per-signal fields (W planes, self-smoothing and the batched
    # transients at the padded length, ~6 (B, S, nfft) planes at the peak)
    # scale with B, not P: fail fast, on the host, with the alternatives.
    resident = 6 * B * S * nfft * _itemsize(rdt)
    if resident > max_bytes:
        raise ValueError(
            f"wct_matrix resident set ~{resident / 1e9:.1f} GB for B={B} "
            f"signals x {S} scales x nfft={nfft} ({_dtype_name(rdt)})"
            f" exceeds max_bytes={max_bytes / 1e9:.1f} GB. Split the station"
            f" list into sub-blocks via pairs=, use "
            f"pycwt_torch.parallel.sharded_wct_matrix over a mesh, or raise "
            f"max_bytes if the device has more memory.")
    blk = pair_block if pair_block is not None else _pairs_block(
        P, S, nfft, _itemsize(rdt), planes=48)
    blk = int(min(P, blk))
    rows = _rows_normalized(y, normalize)
    with span("upload"):
        y_n = _upload(rows, device, rdt)
        i1 = _upload(pairs[:, 0], device, torch.int64)
        i2 = _upload(pairs[:, 1], device, torch.int64)
        sj = _upload(g.sj, device, rdt)
    WCT, aWCT = _wct_matrix_blocks(
        y_n, i1, i2, sj, dt, mother=mother, nfft=nfft, dj=dj,
        engine=config.engine, block=blk, precision=config.precision)
    if not as_numpy:
        return WCT, aWCT, g.coi, g.freqs, pairs
    return _host(WCT), _host(aWCT), g.coi, g.freqs, pairs


def _wct_matrix_blocks(yn, pi, pj, scales, dt, *, mother: Mother, nfft: int,
                       dj: float, engine: str | None, block: int,
                       precision: str = "high"):
    """All-pairs coherence core (``pycwt_tpu``'s ``_wct_matrix_scan``): each
    signal's CWT and self-smoothing are computed once from the normalized
    ``(B, n0)`` rows ``yn``, then the pairs ``(pi[p], pj[p])`` run in blocks
    of ``block`` (the last may be shorter), each a gather, its cross
    spectrum and one cross smoothing.  On the planar route (f32 on the
    card) the transforms are ``fused_cwt_planar`` (the kernels) and the
    smoothing runs on planes; the complex route (``cwt_batch`` + ``smooth``)
    serves f64 and the CPU.  Returns ``(WCT, aWCT)``, each ``(P, S, n0)``
    on ``yn``'s device."""
    from .ops.smoothing import smooth_planar_real

    rdt = yn.dtype
    with span("wct_matrix.fields"):
        if _planar_route(engine, yn.device, rdt, nfft):
            scales = scales.to(torch.float32)
            s_col = scales[:, None]
            wr, wi = _planar_w(yn, scales, mother=mother, nfft=nfft, dt=dt,
                               precision=precision)
            Sself = smooth_planar_real((wr ** 2 + wi ** 2) / s_col, dt, dj,
                                       scales, mother)

            def pair_block_maps(ib, jb):
                w12r, w12i = _cross((wr.index_select(0, ib), wi.index_select(0, ib)),
                                    (wr.index_select(0, jb), wi.index_select(0, jb)))
                S12r, S12i = smooth_planar_pair(w12r / s_col, w12i / s_col,
                                                dt, dj, scales, mother)
                R2 = (S12r ** 2 + S12i ** 2) / (
                    Sself.index_select(0, ib) * Sself.index_select(0, jb))
                return R2, torch.atan2(w12i, w12r)
        else:
            s_col = scales[:, None]
            cfg = CWTConfig(dtype=rdt, engine=engine, precision=precision)
            W, _ = cwt_batch(yn, scales, dt, mother=mother, nfft=nfft, config=cfg)
            Sself = smooth(W.abs() ** 2 / s_col, dt, dj, scales, mother,
                           engine=engine)

            def pair_block_maps(ib, jb):
                W12 = W.index_select(0, ib) * torch.conj(W.index_select(0, jb))
                S12 = smooth(W12 / s_col, dt, dj, scales, mother, engine=engine)
                R2 = S12.abs() ** 2 / (Sself.index_select(0, ib)
                                       * Sself.index_select(0, jb))
                return R2, torch.angle(W12)

    P = pi.shape[0]
    WCT = aWCT = None
    with span("wct_matrix.pairs"):
        for b0 in range(0, P, block):
            R2, A = pair_block_maps(pi[b0:b0 + block], pj[b0:b0 + block])
            if WCT is None:
                WCT = R2.new_empty((P,) + R2.shape[1:])
                aWCT = A.new_empty((P,) + A.shape[1:])
            WCT[b0:b0 + block] = R2
            aWCT[b0:b0 + block] = A
            profiling.MATRIX_PAIR_BLOCKS += 1
            profiling.MATRIX_PAIRS += R2.shape[0]
    return WCT, aWCT


# --------------------------------------------------------------------------
# Monte-Carlo significance
# --------------------------------------------------------------------------

@span("mc.histogram")
def _histogram(R2, outsidecoi, valid=None, nbins: int = NBINS):
    """Integer counts of ``clip(floor(R²·nbins), 0, nbins−1)`` over the
    cells outside the COI (wavelet.py:628): ``R2`` is ``(..., B, S, n)``,
    ``outsidecoi`` ``(S, n)`` bool and ``valid`` an optional ``(B,)`` member
    mask; returns ``(..., S, nbins)`` int64 counts, summed over B.

    One ``scatter_add_`` of ones into ``s·nbins + bin``, with every cell
    left out sent to one spare slot past the end: no host sync, and the
    counts are exact in any order.  A NaN R² counts in bin 0 and ±inf in
    the end bins, as ``pycwt_tpu``'s int cast puts them (and no index
    falls outside the counts)."""
    *lead, _, S, _ = R2.shape
    groups = math.prod(lead)
    dev = R2.device
    bins = torch.nan_to_num(torch.floor(R2 * nbins), nan=0.0)
    bins = bins.clamp_(0, nbins - 1).to(torch.int64)
    cell = torch.arange(groups * S, device=dev).view(*lead, 1, S, 1) * nbins
    keep = outsidecoi if valid is None else outsidecoi & valid[:, None, None]
    idx = torch.where(keep, cell + bins, groups * S * nbins).reshape(-1)
    counts = torch.zeros(groups * S * nbins + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, idx, torch.ones((), dtype=torch.int64,
                                           device=dev).expand(idx.numel()))
    return counts[:-1].view(*lead, S, nbins)


def _mc_counts(acc, noise1, noise2, scales, outsidecoi, dt, *, valid: int,
               mother: Mother, nfft: int, dj: float, engine: str | None = None):
    """Add one Monte-Carlo chunk's counts into ``acc`` ``(P, S, NBINS)``
    int64, in place: the coherence of the surrogate pairs ``noise1``,
    ``noise2`` ``(P, B, n)``, binned as :func:`_histogram` bins it, outside
    the COI ``outsidecoi`` ``(S, n)``, over members ``b < valid``.

    On the planar route the smoothed fields of :func:`_planar_fields` go,
    on a CUDA device, to one ``mc_coherence_counts`` launch
    (``ops/mc_hist.py``), and elsewhere to :func:`_histogram` of
    :func:`_coherence_ratio`, the kernel's plain version; neither computes
    the phase.  Off it, :func:`_histogram` of :func:`_wct_core`'s
    coherence.  The counts are the same integers on every road."""
    P, B, n = noise1.shape
    y1, y2 = noise1.reshape(P * B, n), noise2.reshape(P * B, n)
    planar = _planar_route(engine, y1.device, y1.dtype, nfft)
    if planar:
        with span("wct.core"):
            w1, w2, sj = _planar_ws(y1, y2, scales, dt, mother=mother, nfft=nfft)
            Sm, Cm, _ = _planar_fields(w1, w2, sj, dt=dt, dj=dj, mother=mother,
                                       cross=False)
    else:
        R2, _, _ = _wct_core(y1, y2, scales, dt, mother=mother, nfft=nfft,
                             dj=dj, engine=engine)
    S = scales.shape[0]
    if planar and mc_hist.on_card(Sm):
        with span("mc.histogram"):
            mc_hist.coherence_counts(Sm.view(P, B, S, n), Cm.view(P, B, S, n),
                                     outsidecoi, valid, acc)
        return
    if planar:
        R2 = _coherence_ratio(Sm, Cm)
    keep = None if valid >= B else torch.arange(B, device=acc.device) < valid
    acc += _histogram(R2.reshape(P, B, S, n), outsidecoi, valid=keep)
    profiling.MC_HIST_PLAIN_CELLS += P * valid * S * n


def _mc_histogram_chunk(key, start: int, scales, outsidecoi, dt, *,
                        mother: Mother, nfft: int, dj: float, batch: int,
                        n: int, al1: float, al2: float,
                        engine: str | None = None, acc=None):
    """One Monte-Carlo chunk on the device: ``batch`` surrogate pairs →
    coherence → per-scale counts ``(S, NBINS)`` int64 (:func:`_mc_counts`),
    added into ``acc`` in place where one is given.

    ``start`` is the chunk's first *global* ensemble index: member streams
    are keyed by global index (:func:`pycwt_torch.stats.rednoise_members`),
    so the summed histogram is the same for any chunking of one
    ``(seed, mc_count)``."""
    if acc is None:
        acc = torch.zeros((scales.shape[0], NBINS), dtype=torch.int64,
                          device=scales.device)
    k1, k2 = split(key)
    idx = start + torch.arange(batch, device=scales.device)
    noise1 = rednoise_members(k1, idx, n, al1, 1.0, dtype=scales.dtype)
    noise2 = rednoise_members(k2, idx, n, al2, 1.0, dtype=scales.dtype)
    _mc_counts(acc[None], noise1[None], noise2[None], scales, outsidecoi, dt,
               valid=batch, mother=mother, nfft=nfft, dj=dj, engine=engine)
    return acc


def _mc_histogram_run(key, start: int, scales, outsidecoi, dt, *,
                      mother: Mother, nfft: int, dj: float, batch: int,
                      nchunks: int, n: int, al1: float, al2: float,
                      engine: str | None = None):
    """``nchunks`` consecutive chunks of ``batch`` members from ``start``,
    their ``(S, NBINS)`` counts summed on the device: nothing comes back to
    the host between chunks.  Equal to ``nchunks`` chunk calls."""
    acc = torch.zeros((scales.shape[0], NBINS), dtype=torch.int64,
                      device=scales.device)
    for i in range(nchunks):
        _mc_histogram_chunk(
            key, start + i * batch, scales, outsidecoi, dt, mother=mother,
            nfft=nfft, dj=dj, batch=batch, n=n, al1=al1, al2=al2,
            engine=engine, acc=acc)
    return acc


@span("mc.quantile")
def mc_significance_from_histogram(wlc: np.ndarray, maxscale: int,
                                   significance_level: float,
                                   outsidecoi_any: np.ndarray) -> np.ndarray:
    """Host-side empirical-CDF readout of the MC histogram, replicating the
    reference's masked-cumsum + interp (``wavelet.py:632-640``) including its
    initialization quirks: rows that never poke outside the COI stay 0, and
    row ``maxscale`` itself remains NaN."""
    J1 = wlc.shape[0]
    sig95 = np.zeros(J1)
    sig95[outsidecoi_any] = np.nan
    R2y = (np.arange(NBINS) + 0.5) / NBINS
    for s in range(maxscale):
        sel = wlc[s, :] > 0
        if not sel.any():
            continue
        P = wlc[s, sel].cumsum()
        P = (P - 0.5) / P[-1]
        sig95[s] = np.interp(significance_level, P, R2y[sel])
    return sig95


def _sig_alpha_fold(al1: float, al2: float) -> np.ndarray:
    """The reference's α quantization for MC-cache filenames
    (``wavelet.py:575-576``): ``round(arctanh(4α))`` folded to positives with
    a .5 offset for negatives.  α > 0.25 puts arctanh out of domain: the
    reference formats the nan into the filename, so every such pair shares
    one entry; replicated."""
    with np.errstate(invalid="ignore"):
        aa = np.round(np.arctanh(np.array([al1, al2]) * 4))
    return np.abs(aa) + 0.5 * (aa < 0)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _resolved_policy(config: CWTConfig, device=None) -> tuple[str, str, int]:
    """(engine, real dtype, pad_pow2) as they resolve on ``device``."""
    rdt = config.real_dtype
    return (resolve_engine(config.engine, device, rdt), _dtype_name(rdt),
            int(config.pad_pow2))


def _sig_cache_name(al1: float, al2: float, dj: float, s0: float, dt: float,
                    J: int, mother: Mother, mc_count: int, seed: int,
                    config: CWTConfig, device=None) -> str:
    """``pycwt_tpu``'s MC-cache filename, byte for byte: the reference's
    name (``wavelet.py:575-578``) for the default ``(mc_count=300, seed=0)``
    under f64 ``xla`` with pow-2 padding, suffixed for other counts and
    seeds and for every other resolved numeric policy (resolved on
    ``device``: f32 on the card is ``planar``)."""
    aa = _sig_alpha_fold(al1, al2)
    name = "wct_sig_{:0.5f}_{:0.5f}_{:0.5f}_{:0.5f}_{:d}_{}".format(
        aa[0], aa[1], dj, s0 / dt, J, mother.name)
    if (mc_count, seed) != (300, 0):
        name += f"_mc{mc_count}_seed{seed}"
    eng, rdt, pp = _resolved_policy(config, device)
    if (eng, rdt, pp) != ("xla", "float64", 1):
        name += f"_cfg{eng}-{rdt}-p{pp}"
    return name


def _sig_cfg_tag(config: CWTConfig, device=None) -> str:
    eng, rdt, pp = _resolved_policy(config, device)
    return f"pycwt_tpu cfg={eng}-{rdt}-p{pp}"


def _sig_cache_read(path: str, config: CWTConfig, device=None):
    """Read a cached significance curve, honoring the numeric-policy header.

    Curves carry a ``# pycwt_tpu cfg=...`` header naming the resolved policy
    that computed them (``np.loadtxt`` skips it, so the reference reads the
    files too).  A header naming another policy raises ``OSError``, a miss;
    headerless files (the reference's own) are accepted."""
    import gzip

    with gzip.open(path, "rt") as f:
        first = f.readline()
    if first.startswith("#") and "cfg=" in first:
        if first.lstrip("# ").rstrip() != _sig_cfg_tag(config, device):
            raise OSError(
                f"cached curve {path} was computed under a different "
                "resolved numeric policy")
    return np.loadtxt(path, unpack=True)


def _sig_cache_lookup(path: str, config: CWTConfig, device=None):
    """:func:`_sig_cache_read`, or None on a miss: a missing, foreign or
    unreadable entry (a truncated .gz raises EOFError, a garbled one
    ValueError) is recomputed, never an error."""
    try:
        return _sig_cache_read(path, config, device)
    except (OSError, EOFError, ValueError):
        return None


def _sig_cache_write(path: str, curve: np.ndarray, config: CWTConfig,
                     device=None) -> None:
    """Write a curve through a temporary file and ``os.replace``, so a
    reader never sees a half-written entry."""
    root, ext = os.path.splitext(path)
    tmp = f"{root}.tmp{os.getpid()}{ext}"   # keeps .gz: savetxt compresses
    np.savetxt(tmp, curve, header=_sig_cfg_tag(config, device))
    os.replace(tmp, path)


def _auto_alpha_quant(mc_count: int) -> float:
    """Default null-dedup quantization, matched to the ensemble's own
    sampling noise: ``clip(0.05·sqrt(300/mc_count), 0.01, 0.05)``."""
    return float(np.clip(0.05 * np.sqrt(300.0 / max(mc_count, 1)),
                         0.01, 0.05))


def _canonical_null_key(a1: float, a2: float, q: float) -> tuple:
    """Sorted, ``q``-rounded canonical key of an unordered coefficient pair
    — the unit of Monte-Carlo null deduplication.  The top quantization cell
    clamps to q/2 inside the stationarity boundary (|α| in [1 − q/2, 1)
    would otherwise round to ±1, where the burn-in diverges).  ``q=0``
    shares only exactly-equal sorted pairs."""
    if not q:
        return tuple(sorted((float(a1), float(a2))))

    def _one(v):
        v = round(v / q) * q
        return float(np.sign(v) * min(abs(v), 1.0 - q / 2))

    return tuple(sorted((_one(a1), _one(a2))))


def _mc_member_bytes(S: int, nfft: int, n: int) -> int:
    """Live bytes per member (one surrogate pair) of a Monte-Carlo chunk in
    this package's pipeline, counted in f32 planes: 10 on the (S, nfft) grid
    at the peak (both W's planes, K1's T and the smoothing's FFT chain) and
    9 on the (S, n) grid (the smoothing's inputs and outputs, and the
    histogram's int64 bins and indices).  ``chip_smoke.py`` measures the
    peak beside it: 5.29e6 bytes at the JAO/JBaltic shape (S = 76,
    nfft = 1024, n = 885) on the H100, against this model's 5.53e6."""
    return 4 * (10 * S * nfft + 9 * S * n)


def _mc_auto_batch(mc_count: int, S: int, nfft: int, n: int,
                   budget_bytes: float = 25e9) -> int:
    """Largest Monte-Carlo chunk whose live bytes (:func:`_mc_member_bytes`
    a member) fit ``budget_bytes``: the JAX package's 5e9 of a 16 GB v5e
    scaled to the 80 GB H100 (the same 31 %).  At most 1024 members, and a
    count that does not fit is split into equal chunks."""
    fit = max(1, int(budget_bytes // _mc_member_bytes(S, nfft, n)))
    cap = min(mc_count, fit, 1024)
    if cap < mc_count:
        nch = -(-mc_count // cap)
        cap = -(-mc_count // nch)
    return cap


def _surrogate_grid(dt, dj, s0, J, mother: Mother):
    """Surrogate length n = ceil(6·s0·2^(J·dj)/dt), so the largest scale
    pokes outside the COI (wavelet.py:592-593), its scales, and the COI
    masks: ``(n, sj, outsidecoi (S, n), outsidecoi_any (S,), maxscale)``."""
    ms = s0 * (2 ** (J * dj)) / dt
    n = int(np.ceil(ms * 6))
    grid = build_scale_grid(n, dt, dj=dj, s0=s0, J=J, mother=mother)
    coi = coi_bartlett(n, dt, mother)
    period = 1.0 / grid.freqs[:, None] * np.ones((1, n))
    outsidecoi = period <= coi[None, :]
    outsidecoi_any = outsidecoi.any(axis=1)
    return n, grid.sj, outsidecoi, outsidecoi_any, int(find(outsidecoi_any)[-1])


@span("mc")
def wct_significance(al1, al2, dt, dj, s0, J, significance_level=0.95,
                     wavelet="morlet", mc_count=300, progress=True, cache=True,
                     seed=0, mc_batch=None, config: CWTConfig = DEFAULT,
                     checkpoint: str | None = None, device=None):
    """Monte-Carlo WCT significance levels.

    Same contract and cache format as the reference (``wavelet.py:531-647``)
    and ``pycwt_tpu``: ``mc_count`` AR(1) surrogate pairs of length
    ``ceil(6·maxscale/dt)``, a 1000-bin coherence histogram per scale, and
    the ``significance_level`` quantile of its empirical CDF.

    * Members are drawn in device chunks of ``mc_batch`` (``None``: the
      largest that fits :func:`_mc_auto_batch`'s bytes model) from JAX's
      threefry streams keyed by ``seed`` and global member index, so
      chunking never changes the result, and the curve is ``pycwt_tpu``'s
      for the same seed (to the last bits of the WCT).
    * The disk cache under ``get_cache_dir()`` uses ``pycwt_tpu``'s file
      names and header; an unreadable entry is a miss, and entries are
      written through a temporary file.
    * ``checkpoint`` (a path) writes the (J+1, 1000) histogram and the
      done-count after every chunk, in ``pycwt_tpu``'s format; a restarted
      call resumes from the next undone member, bit-identical to an
      uninterrupted run.  Without one, the chunks run back to back on the
      device and the histogram is fetched once.
    * ``device=None`` means the card (it raises without one).
    * Tracing (``utils.profiling``): the span ``mc`` holds the call;
      ``mc.setup`` the work from the cache's miss to the first chunk (the
      surrogate grid, the chunk sizing, the ``upload`` of the grid and the
      key, the checkpoint's read); ``mc.chunks`` the host's enqueue of the
      chunks; ``fetch`` the counts' copy home; ``mc.quantile`` the
      readout of the counts into the curve.
    * In a process group of several ranks (``pycwt_torch.parallel``), only
      rank 0 reads and writes the cache and the checkpoint; a hit or a
      resumed state is broadcast, so every rank returns the same curve.
      Every rank calls this together.
    """
    from .api import _resolve_device, _upload
    from .parallel.distributed import (host_broadcast_array, is_coordinator,
                                       process_count)

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    is_coord, multi = is_coordinator(), process_count() > 1

    if cache:
        cache_file = _sig_cache_name(al1, al2, dj, s0, dt, J, mother,
                                     mc_count, seed, config, device)
        cache_path = f"{get_cache_dir()}/{cache_file}.gz"
        cached = _sig_cache_lookup(cache_path, config, device) if is_coord else None
        if cached is not None:
            print("NOTE: WCT significance loaded from cache.\n")
        if multi:
            cached = np.atleast_1d(cached) if cached is not None else None
            size = host_broadcast_array(np.array(
                [-1.0 if cached is None else float(cached.size)]))[0]
            if size >= 0:
                cached = host_broadcast_array(
                    cached if cached is not None else np.zeros(int(size)))
        if cached is not None:
            return cached

    with span("mc.setup"):
        if progress:
            print("Calculating wavelet coherence significance")

        n, sj, outsidecoi, outsidecoi_any, maxscale = _surrogate_grid(
            dt, dj, s0, J, mother)
        nfft = config.fft_length(n)
        if mc_batch is None:
            mc_batch = _mc_auto_batch(mc_count, J + 1, nfft, n)
            if progress:
                print(f"  mc_batch auto-sized to {mc_batch}")
        dtype = config.real_dtype
        with span("upload"):
            scales_t = _upload(sj, device, dtype)
            oc = _upload(outsidecoi, device)
            key = PRNGKey(seed, device=device)
        kw = dict(mother=mother, nfft=nfft, dj=dj, n=n, al1=float(al1),
                  al2=float(al2), engine=config.engine)

        wlc = np.zeros((J + 1, NBINS), dtype=np.float64)
        done = 0

        # pycwt_tpu's checkpoint fingerprint: every input that shapes the
        # histogram except mc_count (members are keyed by global index, so
        # a checkpoint of members [0, done) serves any count >= done).
        config_tag = float(zlib.crc32(
            f"{mother!r}|{config.engine}|{_dtype_name(dtype)}".encode()))
        ckpt_meta = np.array([seed, J, float(al1), float(al2), dj,
                              s0, dt, config_tag], dtype=np.float64)
        if checkpoint is not None and is_coord:
            try:
                z = np.load(checkpoint)
                if (z["meta"].shape == ckpt_meta.shape
                        and np.allclose(z["meta"], ckpt_meta)
                        and z["wlc"].shape == wlc.shape
                        and int(z["done"]) <= mc_count):
                    wlc = np.asarray(z["wlc"], np.float64)
                    done = int(z["done"])
                    if progress:
                        print(f"  resumed MC from checkpoint at "
                              f"{done}/{mc_count}")
            except (OSError, EOFError, ValueError, KeyError,
                    zipfile.BadZipFile):
                pass   # no, foreign or truncated checkpoint: start afresh
        if checkpoint is not None and multi:
            state = host_broadcast_array(
                np.concatenate([[float(done)], wlc.ravel()]))
            done = int(state[0])
            wlc = state[1:].reshape(wlc.shape)

    if checkpoint is None:
        nch, tail = divmod(mc_count - done, mc_batch)
        with span("mc.chunks"):
            hist = _mc_histogram_run(key, done, scales_t, oc, dt,
                                     batch=mc_batch, nchunks=nch, **kw)
            if tail:
                _mc_histogram_chunk(key, done + nch * mc_batch, scales_t, oc,
                                    dt, batch=tail, acc=hist, **kw)
        with span("fetch"):
            wlc += hist.cpu().numpy()
        done = mc_count
        if progress:
            print(f"  MC surrogates: {done}/{mc_count}", end="\r")
    while done < mc_count:
        b = min(mc_batch, mc_count - done)
        with span("mc.chunks"):
            hist = _mc_histogram_chunk(key, done, scales_t, oc, dt, batch=b,
                                       **kw)
        with span("fetch"):
            wlc += hist.cpu().numpy()
        done += b
        if is_coord:
            tmp = f"{checkpoint}.tmp"
            with open(tmp, "wb") as f:  # exact name (np.savez would append .npz)
                np.savez(f, meta=ckpt_meta, wlc=wlc, done=np.int64(done))
            os.replace(tmp, checkpoint)
        if progress:
            print(f"  MC surrogates: {done}/{mc_count}", end="\r")
    if progress:
        print()

    sig95 = mc_significance_from_histogram(wlc, maxscale, significance_level,
                                           outsidecoi_any)
    if cache and is_coord:
        _sig_cache_write(cache_path, sig95, config, device)
    return sig95


def _mc_histogram_run_pairs(key, scales, outsidecoi, slots, g1, g2,
                            mc_count: int, dt, *, mother: Mother, nfft: int,
                            dj: float, batch: int, nchunks: int, n: int,
                            tau: int, engine: str | None = None):
    """Monte-Carlo counts ``(P, S, NBINS)`` int64 for ``P`` coefficient
    pairs (``g1``, ``g2``: ``(P,)`` tensors) in ``nchunks`` chunks of
    ``batch`` members, accumulated on the device.  Member ``(p, m)`` is
    keyed by the pair's global slot ``slots[p]`` and the global member index
    (:func:`pycwt_torch.stats.rednoise_members_pairs`); members with index ≥
    ``mc_count`` (the last chunk's overdraw) count nothing, so the ensemble
    holds exactly ``mc_count`` members for any ``batch``."""
    P = g1.shape[0]
    S = scales.shape[0]
    dev = scales.device
    k1, k2 = split(key)
    acc = torch.zeros((P, S, NBINS), dtype=torch.int64, device=dev)
    for i in range(nchunks):
        idx = i * batch + torch.arange(batch, device=dev)
        noise1 = rednoise_members_pairs(k1, slots, idx, n, g1, tau,
                                        dtype=scales.dtype)
        noise2 = rednoise_members_pairs(k2, slots, idx, n, g2, tau,
                                        dtype=scales.dtype)
        _mc_counts(acc, noise1, noise2, scales, outsidecoi, dt,
                   valid=min(batch, max(0, mc_count - i * batch)),
                   mother=mother, nfft=nfft, dj=dj, engine=engine)
    return acc


@span("mc.batch")
def wct_significance_batch(al1, al2, dt, dj, s0, J, significance_level=0.95,
                           wavelet="morlet", mc_count=300, progress=True,
                           cache=True, seed=0, mc_batch=None,
                           config: CWTConfig = DEFAULT,
                           pair_block: int | None = None,
                           alpha_quant: float | None = None,
                           mesh=None, mesh_axis: str = "mc", device=None):
    """:func:`wct_significance` for many ``(al1, al2)`` pairs in one run.

    ``al1, al2``: ``(P,)`` arrays; returns ``(P, J+1)`` curves with
    ``pycwt_tpu``'s contract: exactly ``mc_count`` members per null for any
    ``mc_batch`` or ``pair_block``, the distinct nulls streamed through
    blocks of ``pair_block`` pairs (default ≤ 64, or fewer where the bytes
    model says so).

    * **Null deduplication** (``alpha_quant``): pairs are canonicalized to
      sorted, ``alpha_quant``-rounded coefficients (default
      ``clip(0.05·sqrt(300/mc_count), 0.01, 0.05)``, ``0`` for exact
      matches only); one ensemble per distinct key is simulated at the
      quantized values and fanned out to every pair sharing it.  Its member
      streams are keyed by ``crc32`` of the key, so a key draws the same
      surrogates in any batch and whatever was cached.
    * **Incremental cache** (``cache=True``): each pair's curve is read from
      and written to the single-pair surface's cache entry; only the
      missing nulls are computed, and each entry name is written once per
      call.  The name folds α through round(arctanh(4α)), which is NaN for
      every α > 0.25, as in the reference: all such pairs share one entry,
      and so a warm call hands them all one curve.  Per-pair nulls at
      those coefficients need ``cache=False``.
    * **Multi-device** (``mesh``, a ``pycwt_torch.parallel.make_mesh``
      mesh): the distinct nulls of each block spread over the ranks of
      ``mesh_axis`` (:func:`pycwt_torch.parallel.sharded_mc_histogram_pairs`,
      the block rounded up to a multiple of the dim's size) and the counts
      are gathered on every rank; the curves are bit-identical to the
      single-device run.  The computation runs on the mesh's device.
    * In a process group of several ranks, only rank 0 reads the cache;
      it broadcasts which pairs it holds and their curves before the
      deduplication, so every rank computes the same nulls, and only it
      writes.  (``pycwt_tpu`` reads on every process, which lets ranks with
      different cache contents disagree.)  Every rank calls this together.

    **Tracing** (``utils.profiling``): the span ``mc.batch`` holds the
    call; ``mc.setup`` the deduplication, the surrogate grid, the block
    sizing and padding and the ``upload`` of the grid and the key;
    ``mc.chunks`` the loop over the blocks (each block's coefficients'
    ``upload``, the chunks' ``mc.generate``, ``wct.core`` and
    ``mc.histogram``); ``fetch`` the copy of the counts to the host (with
    the wait for the card's queue); and ``mc.readout`` the readout of each
    distinct null (an ``mc.quantile`` each) and its fan-out to the
    pairs.  The counters
    ``profiling.MC_NULLS``, ``MC_NULL_MEMBERS`` and ``MC_NULL_CHUNKS`` add
    the distinct nulls simulated, the member pairs drawn for them (a
    block's padding and the last chunk's overdraw included) and the chunks
    run.  They count the whole call: under a mesh every rank adds the same
    totals, not the share that it drew itself.
    """
    from .api import _resolve_device, _upload
    from .parallel.distributed import (host_broadcast_array, is_coordinator,
                                       process_count)

    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        from .parallel._collectives import axis_size, mesh_device

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"mesh must be a DeviceMesh (pycwt_torch.parallel.make_mesh), got "
                f"{type(mesh).__name__}")
        device = mesh_device(mesh) if device is None else torch.device(device)
        D = axis_size(mesh, mesh_axis)
    else:
        device = _resolve_device(device)
        D = 1
    mother = as_mother(wavelet)
    al1 = np.atleast_1d(np.asarray(al1, np.float64))
    al2 = np.atleast_1d(np.asarray(al2, np.float64))
    if al1.shape != al2.shape or al1.ndim != 1:
        raise ValueError(
            f"al1/al2 must be matching (P,) arrays, got {al1.shape} vs "
            f"{al2.shape}")
    if not (np.isfinite(al1).all() and np.isfinite(al2).all()):
        bad = np.nonzero(~(np.isfinite(al1) & np.isfinite(al2)))[0]
        raise ValueError(
            f"non-finite AR(1) coefficients at pair slots {bad.tolist()} — "
            "ar1_batch returns NaN for rows where ar1 would raise Warning; "
            "mask those pairs or substitute a white-noise null (alpha=0)")
    if (np.abs(al1) >= 1).any() or (np.abs(al2) >= 1).any():
        bad = np.nonzero((np.abs(al1) >= 1) | (np.abs(al2) >= 1))[0]
        raise ValueError(
            f"|alpha| >= 1 at pair slots {bad.tolist()} — the AR(1) null is "
            "only defined for stationary coefficients (and the burn-in would "
            "explode); clip strong-trend fits inside (-1, 1) or use alpha=0")
    P = len(al1)

    sig = np.full((P, J + 1), np.nan)
    have = np.zeros(P, dtype=bool)
    if cache:
        cache_dir = get_cache_dir()
        paths = [f"{cache_dir}/" + _sig_cache_name(
            al1[p], al2[p], dj, s0, dt, J, mother, mc_count, seed, config,
            device) + ".gz" for p in range(P)]
        if is_coordinator():
            for p in range(P):
                cached = _sig_cache_lookup(paths[p], config, device)
                if cached is not None:
                    sig[p] = cached
                    have[p] = True
        if process_count() > 1:
            state = host_broadcast_array(np.concatenate([have, sig.ravel()]))
            have = state[:P] > 0.5
            sig = state[P:].reshape(sig.shape)
        if have.all():
            if progress:
                print("NOTE: WCT significance batch loaded from cache.\n")
            return sig

    with span("mc.setup"):
        if alpha_quant is None:
            alpha_quant = _auto_alpha_quant(mc_count)
        canon = [_canonical_null_key(al1[p], al2[p], alpha_quant)
                 for p in range(P)]
        key_index: dict = {}
        owner = np.full(P, -1)
        for p in range(P):
            if not have[p]:
                owner[p] = key_index.setdefault(canon[p], len(key_index))
        nulls = list(key_index)                    # distinct keys, in order
        Pd = len(nulls)
        rep_a1 = np.asarray([k[0] for k in nulls], np.float64)
        rep_a2 = np.asarray([k[1] for k in nulls], np.float64)
        # Member streams are keyed by a stable hash of the canonical key
        # (not a position): the same null draws the same surrogates in any
        # batch.
        rep_slot = np.asarray([zlib.crc32(f"{a:.17g}|{b:.17g}".encode())
                               & 0x7FFFFFFF for a, b in nulls], np.int64)

        if progress:
            print(f"Calculating wavelet coherence significance "
                  f"({P} alpha-pairs: {int(have.sum())} cached, "
                  f"{Pd} distinct nulls)")

        n, sj, outsidecoi, outsidecoi_any, maxscale = _surrogate_grid(
            dt, dj, s0, J, mother)
        nfft = config.fft_length(n)
        # A chunk holds pair_block·mc_batch members: the block shrinks below
        # 64 where the bytes model says the members do not fit.
        members_fit = _mc_auto_batch(mc_count * 64, J + 1, nfft, n)
        if pair_block is not None:
            Pblk = max(1, min(int(pair_block), Pd))
        else:
            Pblk = max(1, min(Pd, 64, members_fit))
        if D > 1:
            # Sharded: the block spreads over the mesh dim, so it must
            # divide by D, and the bytes model bounds one rank's slice of it.
            Pblk = -(-Pblk // D) * D
        if mc_batch is None:
            mc_batch = max(1, members_fit // max(1, Pblk // D))
        mc_batch = min(int(mc_batch), mc_count)
        nchunks = -(-mc_count // mc_batch)
        # One burn-in for the block, sized for the largest |g| and rounded
        # up to a power of two (>= 8), as pycwt_tpu buckets it.
        tau = _burn_in(float(np.max(np.abs(np.concatenate([rep_a1, rep_a2])))))
        if tau > 0:
            tau = 1 << max(3, (tau - 1).bit_length())

        dtype = config.real_dtype
        npad = (-Pd) % Pblk
        a1p = np.concatenate([rep_a1, np.repeat(rep_a1[-1], npad)])
        a2p = np.concatenate([rep_a2, np.repeat(rep_a2[-1], npad)])
        slots_p = np.concatenate([rep_slot, np.repeat(rep_slot[-1], npad)])
        with span("upload"):
            key = PRNGKey(seed, device=device)
            sj_t = _upload(sj, device, dtype)
            oc_t = _upload(outsidecoi, device)
    profiling.MC_NULLS += Pd
    with span("mc.chunks"):
        blocks = []
        for b0 in range(0, Pd + npad, Pblk):
            profiling.MC_NULL_MEMBERS += Pblk * mc_batch * nchunks
            profiling.MC_NULL_CHUNKS += nchunks
            blk = slice(b0, b0 + Pblk)
            if D > 1:
                from .parallel._collectives import gather
                from .parallel.sharded import sharded_mc_histogram_pairs

                counts = sharded_mc_histogram_pairs(
                    mesh, key, sj_t, oc_t, slots_p[blk], a1p[blk], a2p[blk],
                    mc_count, dt, mother=mother, nfft=nfft, dj=dj,
                    batch=mc_batch, nchunks=nchunks, n=n, tau=tau,
                    engine=config.engine, axis_name=mesh_axis)
                blocks.append(gather(counts.to_local(), mesh, mesh_axis))
                continue
            with span("upload"):
                slots_t = _upload(slots_p[blk], device)
                g1 = _upload(a1p[blk], device, dtype)
                g2 = _upload(a2p[blk], device, dtype)
            blocks.append(_mc_histogram_run_pairs(
                key, sj_t, oc_t, slots_t, g1, g2, mc_count, dt,
                mother=mother, nfft=nfft, dj=dj, batch=mc_batch,
                nchunks=nchunks, n=n, tau=tau, engine=config.engine))
            if progress and len(blocks) > 1:
                print(f"  null blocks: {min(len(blocks) * Pblk, Pd)}/{Pd}",
                      end="\r")
    with span("fetch"):
        wlc = torch.cat(blocks).cpu().numpy().astype(np.float64)[:Pd]
    if progress:
        print(f"  MC surrogates per distinct null: {mc_count}")

    with span("mc.readout"):
        sig_d = np.empty((Pd, J + 1))
        for d in range(Pd):
            sig_d[d] = mc_significance_from_histogram(
                wlc[d], maxscale, significance_level, outsidecoi_any)
        for p in range(P):
            if not have[p]:
                sig[p] = sig_d[owner[p]]

    if cache and is_coordinator():
        # One write per entry name: pairs whose names fold together (every
        # alpha > 0.25) share one file, which takes the last such pair's
        # curve, as the per-pair writes of pycwt_tpu leave it.
        last = {paths[p]: p for p in range(P) if not have[p]}
        for path, p in last.items():
            _sig_cache_write(path, sig[p], config, device)
    return sig

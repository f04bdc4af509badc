"""Statistical primitives: AR(1) estimation, red-noise spectra and surrogates,
and the TC98 chi-square significance tests.

Counterpart of ``pycwt_tpu/stats.py`` with the same names and contracts:

* :func:`ar1` — Allen & Smith (1996) unbiased lag-1 estimator via Grinsted's
  quadratic substitution, raising ``Warning`` on a non-positive discriminant;
* :func:`ar1_spectrum` — theoretical AR(1) power spectrum;
* :func:`rednoise_batch` / :func:`rednoise` — AR(1) surrogates drawn from an
  explicit ``torch.Generator`` (a ``jax.random`` key gives other bits, so the
  two packages agree in distribution, not bit for bit), with the g = 0 fix;
* :func:`significance` — TC98 eqs. 16/18/23/25-28 with the f64 host PPF
  (``ops/special.py``), keeping deviations 3 and 4 of ``docs/parity.md``.

The Monte-Carlo member generators (``rednoise_members*``) belong to the
Monte-Carlo significance surface and are not here.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .mothers import as_mother
from .utils.helpers import find

__all__ = ["ar1", "ar1_batch", "ar1_spectrum", "rednoise", "rednoise_batch",
           "significance"]


def ar1(x):
    """Unbiased AR(1) lag-1 autocorrelation (Allen & Smith 1996).

    Returns ``(g, a, mu2)``: the lag-1 coefficient, the innovation standard
    deviation, and the normalized squared mean bias (A&S footnote 4).
    Raises ``Warning`` when the discriminant is non-positive (series too
    short or trend too large), which callers catch to fall back to white
    noise.
    """
    x = np.asarray(x, dtype=np.float64)
    N = x.size
    x = x - x.mean()

    c0 = float(x.dot(x)) / N
    c1 = float(x[: N - 1].dot(x[1:])) / (N - 1)

    # Grinsted's substitution reduces the A&S bias equation to a quadratic
    # A·g² + B·g + C = 0 in the lag-1 coefficient g.
    B = -c1 * N - c0 * N ** 2 - 2 * c0 + 2 * c1 - c1 * N ** 2 + c0 * N
    A = c0 * N ** 2
    C = N * (c0 + c1 * N - c1)
    D = B ** 2 - 4 * A * C

    if D <= 0:
        raise Warning(
            "Cannot place an upperbound on the unbiased AR(1). "
            "Series is too short or trend is to large."
        )
    g = (-B - D ** 0.5) / (2 * A)

    # Allen & Smith (1996), footnote 4: squared mean of a finite AR(1) segment.
    mu2 = -1 / N + (2 / N ** 2) * ((N - g ** N) / (1 - g) - g * (1 - g ** (N - 1)) / (1 - g) ** 2)
    c0t = c0 / (1 - mu2)
    a = ((1 - g ** 2) * c0t) ** 0.5
    return g, a, mu2


def ar1_batch(x):
    """Batched :func:`ar1` over the rows of a ``(B, N)`` array, in float64
    on the host.  Rows whose discriminant is non-positive (where :func:`ar1`
    raises ``Warning``) return NaN instead: a batch cannot abort on one bad
    member.

    Returns ``(g, a, mu2)`` — each a ``(B,)`` float64 array.
    """
    x = np.asarray(x, np.float64)
    if x.ndim != 2:
        raise ValueError(f"ar1_batch expects (B, N), got {x.shape}")
    N = x.shape[-1]
    xd = x - x.mean(-1, keepdims=True)
    c0 = np.einsum("bn,bn->b", xd, xd) / N
    c1 = np.einsum("bn,bn->b", xd[:, :-1], xd[:, 1:]) / (N - 1)

    B = -c1 * N - c0 * N ** 2 - 2 * c0 + 2 * c1 - c1 * N ** 2 + c0 * N
    A = c0 * N ** 2
    C = N * (c0 + c1 * N - c1)
    D = B ** 2 - 4 * A * C
    ok = D > 0
    with np.errstate(invalid="ignore"):
        g = np.where(ok, (-B - np.sqrt(np.where(ok, D, 0.0))) / (2 * A),
                     np.nan)
        mu2 = -1 / N + (2 / N ** 2) * (
            (N - g ** N) / (1 - g) - g * (1 - g ** (N - 1)) / (1 - g) ** 2)
        c0t = c0 / (1 - mu2)
        a = ((1 - g ** 2) * c0t) ** 0.5
    return g, a, mu2


def ar1_spectrum(freqs, ar1_coeff: float = 0.0):
    """Theoretical AR(1) power spectrum ``(1−g²)/|1−g·e^(−2πif)|²``."""
    freqs = np.asarray(freqs)
    return (1 - ar1_coeff ** 2) / np.abs(1 - ar1_coeff * np.exp(-2j * np.pi * freqs)) ** 2


def _ar1_recurrence(innovations: torch.Tensor, g) -> torch.Tensor:
    """y[t] = g·y[t−1] + innovations[t] along the last axis, y[−1] = 0, as a
    log-depth (Hillis–Steele) scan of the pairs (a, b) ↦ y = a·y_prev + b:
    ⌈log2 n⌉ vectorized steps instead of a sequential filter.  ``g`` is a
    scalar or a tensor broadcastable to ``innovations`` (per-row
    coefficients)."""
    b = innovations
    a = torch.broadcast_to(torch.as_tensor(g, dtype=b.dtype, device=b.device),
                           b.shape)
    n = b.shape[-1]
    d = 1
    while d < n:
        # element t absorbs the segment ending at t − d
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], dim=-1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    return b


def rednoise_batch(generator: torch.Generator, shape_n: int, g, a: float = 1.0,
                   batch: int = 1, dtype=torch.float32):
    """Batch of AR(1) red-noise surrogates on ``generator``'s device.

    Innovations ``z·a`` with a burn-in of ``tau = ceil(−2/log|g|)`` samples
    (twice the decorrelation time) that are generated and then discarded,
    as the reference does.  For g = 0 this is white noise (the reference
    crashes there — fixed).

    Returns a ``(batch, shape_n)`` tensor.
    """
    g = float(g)
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    if g == 0.0:
        return a * torch.randn((batch, shape_n), **kw)
    tau = int(np.ceil(-2 / np.log(np.abs(g))))
    z = a * torch.randn((batch, shape_n + tau), **kw)
    return _ar1_recurrence(z, g)[:, tau:]


def rednoise(N: int, g: float, a: float = 1.0, seed: int | None = None,
             device=None):
    """Single red-noise series as a numpy array, drawn on ``device`` (the
    card unless ``device="cpu"``) in ``torch.get_default_dtype()``.

    With ``seed=None`` (the default) every call draws fresh entropy, so two
    successive calls return independent surrogates, as the reference's
    global numpy RNG does.  Pass an explicit ``seed`` for a deterministic
    series."""
    from .api import _resolve_device

    device = _resolve_device(device)
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    gen = torch.Generator(device=device).manual_seed(seed)
    y = rednoise_batch(gen, N, g, a, batch=1, dtype=torch.get_default_dtype())
    return y[0].cpu().numpy()


def significance(
    signal,
    dt: float,
    scales,
    sigma_test: int = 0,
    alpha: float | None = None,
    significance_level: float = 0.95,
    dof=-1,
    wavelet="morlet",
):
    """Wavelet-power significance vs a red-noise background (TC98 §4-5).

    Modes:

    * ``sigma_test=0`` — pointwise chi-square test, TC98 eq. 18;
    * ``sigma_test=1`` — time-average test, eq. 23 (``dof`` = number of
      averaged spectra per scale; scalars are broadcast — the reference
      crashes on scalar ``dof`` here, fixed);
    * ``sigma_test=2`` — scale-average test, eqs. 25-28 (``dof=[s1, s2]``).

    Returns ``(signif, fft_theor)``, host float64.  In mode 1 the reference
    returns a ``fft_theor`` overwritten with the significance levels (buffer
    aliasing); this returns the true theoretical spectrum.
    """
    from .ops.special import chi2_ppf_host

    wavelet = as_mother(wavelet)

    signal = np.asarray(signal)
    n0 = 1 if signal.ndim == 0 else len(signal)
    J = len(scales) - 1
    scales = np.asarray(scales, dtype=np.float64)
    dj = np.log2(scales[1] / scales[0])

    variance = float(signal) if n0 == 1 else float(signal.std() ** 2)

    if alpha is None:
        alpha, _, _ = ar1(signal)

    period = scales * wavelet.flambda()
    freq = dt / period
    dofmin = wavelet.dofmin
    Cdelta = wavelet.cdelta
    gamma_fac = wavelet.gamma
    dj0 = wavelet.deltaj0

    # Gilman et al. (1963) / TC98 eq. 16 red-noise spectrum, scaled by the
    # series variance.
    fft_theor = variance * (1 - alpha ** 2) / (
        1 + alpha ** 2 - 2 * alpha * np.cos(2 * np.pi * freq / n0)
    )

    def _ppf(p, df):
        return chi2_ppf_host(p, np.asarray(df, np.float64))

    if sigma_test == 0:
        dof = dofmin
        chisquare = float(_ppf(significance_level, dof)) / dof
        signif = fft_theor * chisquare
    elif sigma_test == 1:
        dof = np.asarray(dof, dtype=np.float64)
        if dof.ndim == 0:
            dof = np.full(J + 1, float(dof))
        dof = dof.copy()
        dof[dof < 1] = 1
        # TC98 eq. 23.
        dof = dofmin * (1 + (dof * dt / gamma_fac / scales) ** 2) ** 0.5
        dof[dof < dofmin] = dofmin
        chisquare = _ppf(significance_level, dof) / dof
        signif = fft_theor * chisquare
    elif sigma_test == 2:
        if len(dof) != 2:
            raise Exception("DOF must be set to [s1, s2], the range of scale-averages")
        if Cdelta == -1:
            raise ValueError(
                f"Cdelta and dj0 not defined for {wavelet.name} with these parameters"
            )
        s1, s2 = dof
        sel = find((scales >= s1) & (scales <= s2))
        navg = sel.size
        if navg == 0:
            raise ValueError(f"No valid scales between {s1} and {s2}.")
        # TC98 eq. 25 (Savg), power-of-two midpoint, eq. 28 (dof),
        # eq. 27 (spectrum), eq. 26 (level).
        Savg = 1 / np.sum(1.0 / scales[sel])
        Smid = np.exp((np.log(s1) + np.log(s2)) / 2.0)
        dof = (dofmin * navg * Savg / Smid) * ((1 + (navg * dj / dj0) ** 2) ** 0.5)
        fft_theor = Savg * np.sum(fft_theor[sel] / scales[sel])
        chisquare = float(_ppf(significance_level, float(dof))) / dof
        signif = (dj * dt / Cdelta / Savg) * fft_theor * chisquare
    else:
        raise ValueError("sigma_test must be either 0, 1, or 2.")

    return signif, fft_theor

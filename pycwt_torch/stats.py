"""Statistical primitives: AR(1) estimation, red-noise spectra and surrogates,
and the TC98 chi-square significance tests.

Counterpart of ``pycwt_tpu/stats.py`` with the same names and contracts:

* :func:`ar1` — Allen & Smith (1996) unbiased lag-1 estimator via Grinsted's
  quadratic substitution, raising ``Warning`` on a non-positive discriminant;
* :func:`ar1_spectrum` — theoretical AR(1) power spectrum;
* :func:`rednoise_batch` / :func:`rednoise` — AR(1) surrogates drawn from an
  explicit ``torch.Generator`` (a ``jax.random`` key gives other bits, so the
  two packages agree in distribution, not bit for bit), with the g = 0 fix;
* :func:`rednoise_members` / :func:`rednoise_members_pairs` — the
  Monte-Carlo members, keyed by global member index, drawn from JAX's own
  streams: threefry2x32 in int64 tensor ops (:func:`_threefry2x32`) keyed
  as ``jax.random`` keys them (:func:`PRNGKey`, :func:`fold_in`,
  :func:`split`), and f64 normals as ``jax.random.normal`` makes them
  (:func:`_normal_f64`).  The same seed gives ``pycwt_tpu``'s f64
  surrogates, on the CPU and on the card alike.  A key on a CUDA device
  takes the generator kernels of ``ops/mc_noise.py`` (one launch for a
  split or fold-in, one for a chunk of surrogate rows), which give the
  torch code's words, normals and rows bit for bit; a CPU key runs the torch
  code, their plain version;
* :func:`significance` — TC98 eqs. 16/18/23/25-28 with the f64 host PPF
  (``ops/special.py``), keeping deviations 3 and 4 of ``docs/parity.md``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .mothers import as_mother
from .ops import mc_noise
from .utils import profiling
from .utils.helpers import find
from .utils.profiling import span

__all__ = ["ar1", "ar1_batch", "ar1_spectrum", "rednoise", "rednoise_batch",
           "rednoise_members", "rednoise_members_pairs", "significance"]


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
    if isinstance(g, torch.Tensor):
        a = torch.broadcast_to(g.to(device=b.device, dtype=b.dtype), b.shape)
    else:   # a fill on the device, not a host-to-device copy of the scalar
        a = torch.full_like(b, float(g))
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
    tau = _burn_in(g)
    z = a * torch.randn((batch, shape_n + tau), **kw)
    return _ar1_recurrence(z, g)[:, tau:]


# --------------------------------------------------------------------------
# JAX's counter-based streams
# --------------------------------------------------------------------------
#
# A key is a pair (k0, k1) of int64 tensors holding 32-bit words; every word
# is kept in [0, 2^32) by masking, so no step relies on unsigned arithmetic.

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: nextafter(−1, +∞): the low end of jax.random.normal's uniform draw
_NORMAL_LO = float(np.nextafter(-1.0, np.inf))


def _on_card(key) -> bool:
    """A key on a CUDA device takes the generator kernels
    (``ops/mc_noise.py``); a CPU key the torch code of this module."""
    return key[0].device.type == "cuda"


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), the block cipher of
    ``jax.random``'s default generator: key words ``(k0, k1)`` encrypt the
    counter words ``(x0, x1)``; all are int64 tensors (broadcast together)
    of 32-bit words, and so is the returned pair."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def PRNGKey(seed: int, device=None):
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed)`` of the
    64-bit seed, as 0-d int64 tensors on ``device``."""
    seed = int(seed)
    return (torch.tensor((seed >> 32) & _MASK32, dtype=torch.int64, device=device),
            torch.tensor(seed & _MASK32, dtype=torch.int64, device=device))


def fold_in(key, data):
    """``jax.random.fold_in``: the key threefry2x32(key, (0, data)), for an
    int64 tensor (or int) ``data`` of any shape — one key per element."""
    if _on_card(key):
        return mc_noise.fold_in(key, data)
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device)
    return _threefry2x32(key[0], key[1], torch.zeros_like(data), data & _MASK32)


def split(key, num: int = 2):
    """``jax.random.split``: key j is threefry2x32(key, (0, j)); returns a
    list of ``num`` keys."""
    if _on_card(key):
        return mc_noise.split(key, num)
    k0, k1 = fold_in(key, torch.arange(num, device=key[0].device))
    return [(k0[j], k1[j]) for j in range(num)]


def _normal_f64(key, length: int) -> torch.Tensor:
    """``jax.random.normal(k, (length,), float64)`` for every key ``k`` of a
    batch of keys (words of shape ``K``): returns ``K + (length,)`` f64.

    Element i takes the 64 bits ``hi << 32 | lo`` of threefry2x32(k, (0, i));
    their top 52 bits, ``((hi << 20) | (lo >> 12))``, scaled by 2^-52 give u
    in [0, 1), mapped onto [nextafter(−1, ∞), 1) and clamped at the low end;
    the normal is √2·erfinv(u)."""
    k0, k1 = key[0][..., None], key[1][..., None]
    count = torch.arange(length, dtype=torch.int64, device=k0.device)
    hi, lo = _threefry2x32(k0, k1, torch.zeros_like(count), count)
    mantissa = ((hi << 20) | (lo >> 12)) & ((1 << 52) - 1)
    u = mantissa.to(torch.float64) * 2.0 ** -52
    u = torch.clamp_min(u * (1.0 - _NORMAL_LO) + _NORMAL_LO, _NORMAL_LO)
    return math.sqrt(2.0) * torch.erfinv(u)


def _count_plain(z: torch.Tensor) -> None:
    """Count the rows the torch code draws on the card
    (``profiling.MC_PLAIN_ROWS``)."""
    if z.is_cuda:
        profiling.MC_PLAIN_ROWS += z.numel() // z.shape[-1]


def _burn_in(g: float) -> int:
    """tau = ceil(−2/log|g|): twice the decorrelation time (0 for g = 0)."""
    return 0 if g == 0.0 else int(np.ceil(-2 / np.log(np.abs(g))))


@span("mc.generate")
def rednoise_members(base_key, member_idx, shape_n: int, g, a: float = 1.0,
                     dtype=torch.float32):
    """Batch of AR(1) surrogates where member ``i``'s stream is
    ``fold_in(base_key, member_idx[i])``: it depends only on the member's
    global ensemble index, never on how the ensemble is chunked.  Normals
    are drawn in f64 and cast to ``dtype``, so the integer words, and the
    f64 draws, are the same on the CPU and the card.  On the card the chunk
    is one ``mc_rednoise`` launch, bit for bit this torch code; it draws f32
    and f64 rows of |g| < 1 and raises for any other.

    Returns ``(len(member_idx), shape_n)`` on the key's device.
    """
    g = float(g)
    tau = _burn_in(g)
    if _on_card(base_key):
        return mc_noise.rednoise(base_key, member_idx, shape_n, tau, g, a=a,
                                 dtype=dtype)
    z = a * _normal_f64(fold_in(base_key, member_idx), shape_n + tau).to(dtype)
    _count_plain(z)
    if g == 0.0:
        return z
    return _ar1_recurrence(z, g)[:, tau:]


@span("mc.generate")
def rednoise_members_pairs(base_key, pair_slots, member_idx, shape_n: int,
                           g, tau: int, dtype=torch.float32):
    """AR(1) surrogates for many coefficients at once: member ``(p, m)``'s
    stream is ``fold_in(fold_in(base_key, pair_slots[p]), member_idx[m])``,
    fixed by (seed, global pair slot, global member index) however the
    members are chunked or the pairs blocked.  ``g`` is a ``(P,)`` tensor;
    the caller sizes the burn-in ``tau`` for the largest |g| (a longer
    burn-in only discards more samples).  On the card the chunk is one
    ``mc_rednoise`` launch, bit for bit this torch code; it draws f32 and f64
    rows and raises for any other.

    Returns ``(P, len(member_idx), shape_n)``.
    """
    if _on_card(base_key):
        return mc_noise.rednoise(base_key, member_idx, shape_n, tau, g,
                                 dtype=dtype, slots=pair_slots)
    dev = base_key[0].device
    slots = torch.as_tensor(pair_slots, dtype=torch.int64, device=dev)
    idx = torch.as_tensor(member_idx, dtype=torch.int64, device=dev)
    p0, p1 = fold_in(base_key, slots)
    keys = _threefry2x32(p0[:, None], p1[:, None], torch.zeros_like(idx),
                         idx & _MASK32)                           # (P, M) keys
    z = _normal_f64(keys, shape_n + tau).to(dtype)
    _count_plain(z)
    g = torch.as_tensor(g, dtype=dtype, device=dev)
    return _ar1_recurrence(z, g[:, None, None])[..., tau:]


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

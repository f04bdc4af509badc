"""Plain reference of the per-pair Monte-Carlo nulls of a station network:
for every pair (i, j), i < j, of B stations, the significance curve that
``wct_matrix_analysis(y, dt, dj, sig=True, mc_count, seed, cache=False)``
gives it, written from the documented contract of that call and of
``wct_significance_batch`` and from pycwt's ``wct_significance``
(``wavelet.py:531-647``; Grinsted, Moore & Jevrejeva 2004).

1. Each station's lag-1 coefficient is Allen & Smith's fit with Grinsted's
   quadratic (``wct_f64.ar1``); a fit with no real root falls back to 0
   (white noise), and fits are clipped to +-0.99.
2. A pair's null is its canonical key: the two coefficients sorted, each
   rounded to the quantum q = clip(0.05 sqrt(300 / mc_count), 0.01, 0.05)
   and clamped inside 1 - q/2 of +-1.  Pairs with one key share one null;
   the distinct keys are taken in the order of their first pair.
3. A key's slot is crc32 of ``f"{a:.17g}|{b:.17g}"`` masked to 31 bits.
4. One burn-in tau serves every null of the call: ceil(-2 / log|g|) for the
   largest |g| of the keys, rounded up to a power of two of at least 8.
5. Member m of a null's first (second) series draws its normals from JAX's
   threefry stream fold_in(fold_in(split(PRNGKey(seed))[0 (1)], slot), m)
   (``threefry.py``), n + tau of them in float64; the AR(1) recursion
   y[t] = g y[t-1] + z[t] runs from y[-1] = 0 with the key's coefficient,
   and its first tau samples are dropped.  n = ceil(6 s_J / dt).
6. The CWT is pycwt's, through ``torch.fft``: the record zero-padded to
   nfft = 2^ceil(log2 n), its spectrum times sqrt(2 pi s / dt) pi^-1/4
   exp(-(s w - f0)^2 / 2), w = 2 pi fftfreq(nfft, dt), inverted, the first
   n samples kept.
7. The smoothing is pycwt's Morlet ``smooth``: in time, the field
   zero-padded to nfft, its spectrum times exp(-(s/dt)^2 k^2 / 2),
   k = 2 pi fftfreq(nfft), inverted, the first n samples kept (the same
   product as ``wct_f64.smooth``'s circulant matrices, which take ~35 GB
   at n = 6302); in scale, the boxcar of round(2 * 0.6 / dj) taps whose end
   taps are 0.5, normalised, as scipy's 'same' convolution.
8. R^2 = |S(W1 conj(W2) / s)|^2 / (S(|W1|^2 / s) S(|W2|^2 / s)); the counts
   of floor(R^2 1000), clipped to [0, 999] with NaN in bin 0, per scale
   over the cells outside the COI (period <= coi); the significance level
   read off each scale below the largest that reaches outside the COI by
   pycwt's interpolation of the empirical CDF, the rows that reach outside
   it from there on NaN and the others 0.

Departures from the published description, each of the arithmetic only:
the recursion of step 5 runs as log2(n) doubling steps of the affine maps
y -> a y + b (Hillis & Steele 1986), the order in which the program's rows
are rounded, so that in float64 the rows are bit for bit the program's
(a sequential recursion differs in the last bits); the members run in
blocks of ``BLOCK`` so that 300 members of 110 scales at nfft 8192 fit on
one card.

``mode="f64"`` is the reference proper.  ``mode="tf32"``, the control,
computes in float32 with every operand of a transform or of a product
with a filter or the boxcar rounded to TF32 (10 stored mantissa bits), and
fits the coefficients to the records rounded to TF32: what the H100's
tensor cores would make of the pipeline written as products.  The module
imports nothing of the program and takes none of its values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry
from .wct_f64 import _boxcar, ar1, coi, flambda, grid, tf32_round
from .wct_matrix_f64 import all_pairs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Nulls", "alpha_quant", "burn_in", "members", "null_keys",
           "station_alphas", "surrogate_grid"]

NBINS = 1000
#: Morlet's scale-decorrelation length (Torrence & Compo 1998, Table 2)
DELTAJ0 = 0.6
#: members of a null computed together
BLOCK = 50
MODES = ("f64", "tf32")


def _check_mode(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return torch.float64 if mode == "f64" else torch.float32


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` as an operand in ``mode``: itself in f64, rounded to TF32
    (both parts of a complex number) in tf32."""
    if mode == "f64":
        return x
    if x.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(x)))
    return tf32_round(x)


def station_alphas(y, mode: str = "f64") -> np.ndarray:
    """(B,) lag-1 coefficients of the stations ``y`` (B, n0): the fit, 0
    where it has no real root, clipped to +-0.99."""
    _check_mode(mode)
    y = np.asarray(y, np.float64)
    if mode == "tf32":
        y = tf32_round(torch.as_tensor(y, dtype=torch.float32)).double().numpy()
    out = np.empty(len(y))
    for b, row in enumerate(y):
        try:
            out[b] = ar1(row)
        except ValueError:
            out[b] = 0.0
    return np.clip(out, -0.99, 0.99)


def alpha_quant(mc_count: int) -> float:
    return float(np.clip(0.05 * np.sqrt(300.0 / mc_count), 0.01, 0.05))


def _quantized(v: float, q: float) -> float:
    v = round(v / q) * q
    return float(np.sign(v) * min(abs(v), 1.0 - q / 2))


def null_keys(alpha: np.ndarray, pairs: np.ndarray, mc_count: int):
    """``(keys, owner)``: the distinct canonical keys (a, b), a <= b, of the
    pairs in the order of their first pair, and each pair's index into
    them."""
    q = alpha_quant(mc_count)
    index: dict = {}
    owner = np.empty(len(pairs), np.int64)
    for p, (i, j) in enumerate(pairs):
        key = tuple(sorted((_quantized(alpha[i], q), _quantized(alpha[j], q))))
        owner[p] = index.setdefault(key, len(index))
    return list(index), owner


def crc32(data: bytes) -> int:
    """CRC-32 of IEEE 802.3 (the reflected polynomial 0xEDB88320, initial
    value and final XOR 0xFFFFFFFF), bit by bit."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0xEDB88320 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def slot(key: tuple) -> int:
    a, b = key
    return crc32(f"{a:.17g}|{b:.17g}".encode()) & 0x7FFFFFFF


def burn_in(keys: list) -> int:
    """The one burn-in of a call's nulls."""
    tau = threefry.burn_in(max(abs(v) for key in keys for v in key))
    return 1 << max(3, (tau - 1).bit_length()) if tau > 0 else 0


def surrogate_grid(dt: float, dj: float, s0: float, J: int, f0: float) -> dict:
    """The surrogates' length n, nfft, scales, the cells outside the COI
    (S, n), the rows that reach outside it and the largest of them."""
    n = int(np.ceil(s0 * 2.0 ** (J * dj) / dt * 6))
    sj = s0 * 2.0 ** (np.arange(J + 1, dtype=np.float64) * dj)
    outside = (flambda(f0) * sj)[:, None] <= coi(n, dt, f0)[None, :]
    any_out = outside.any(axis=1)
    return {"n": n, "nfft": 1 << (n - 1).bit_length(), "sj": sj,
            "outside": outside, "any_out": any_out,
            "maxscale": int(np.flatnonzero(any_out)[-1])}


def _scan(z: torch.Tensor, g: float) -> torch.Tensor:
    """y[t] = g y[t-1] + z[t] along the last axis from y[-1] = 0, by
    doubling: after the step of span d, element t holds the recursion over
    (t - 2d, t]."""
    b, a = z, torch.full_like(z, g)
    n, d = z.shape[-1], 1
    while d < n:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], dim=-1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    return b


def members(key, slot_: int, idx: torch.Tensor, n: int, g: float, tau: int) -> torch.Tensor:
    """(len(idx), n) float64 surrogates: member m from
    fold_in(fold_in(key, slot_), m), its first tau samples dropped."""
    s0, s1 = threefry.fold_in(key, torch.tensor([slot_], device=idx.device))
    z = threefry.normal_f64(threefry.fold_in((s0, s1), idx), n + tau)
    return _scan(z, g)[:, tau:]


def smooth(T: torch.Tensor, sj: np.ndarray, dt: float, dj: float,
           mode: str = "f64") -> torch.Tensor:
    """pycwt's Morlet smoothing of a real or complex field T (..., S, n),
    zero-padded to the next power of two in time."""
    dtype = _check_mode(mode)
    n = T.shape[-1]
    nfft = 1 << (n - 1).bit_length()
    dev = T.device
    s = torch.as_tensor(sj, dtype=torch.float64, device=dev)[:, None]
    # a real field takes the half spectrum: the Gaussian is even in k
    freqs = torch.fft.fftfreq if T.is_complex() else torch.fft.rfftfreq
    k = 2.0 * math.pi * freqs(nfft, dtype=torch.float64, device=dev)
    F = _round(torch.exp(-0.5 * (s / dt) ** 2 * k ** 2).to(dtype), mode)
    if T.is_complex():
        X = torch.fft.fft(_round(T, mode), n=nfft, dim=-1)
        timed = torch.fft.ifft(_round(X, mode) * F, dim=-1)[..., :n]
    else:
        X = torch.fft.rfft(_round(T, mode), n=nfft, dim=-1)
        timed = torch.fft.irfft(_round(X, mode) * F, n=nfft, dim=-1)[..., :n]
    box = _round(_boxcar(len(sj), float(dj), DELTAJ0, mode, dev), mode)
    if timed.is_complex():
        box = box.to(timed.dtype)
    return torch.matmul(box, _round(timed, mode))


def _cwt(rows: torch.Tensor, sj: np.ndarray, dt: float, f0: float, nfft: int,
         mode: str) -> torch.Tensor:
    """Complex W (M, S, n) of the rows (M, n)."""
    dtype = _check_mode(mode)
    n = rows.shape[-1]
    dev = rows.device
    X = torch.fft.fft(_round(rows.to(dtype), mode), n=nfft, dim=-1)
    w = 2.0 * math.pi * torch.fft.fftfreq(nfft, d=dt, dtype=torch.float64, device=dev)
    s = torch.as_tensor(sj, dtype=torch.float64, device=dev)[:, None]
    H = (torch.sqrt(2.0 * math.pi * s / dt) * math.pi ** -0.25
         * torch.exp(-0.5 * (s * w[None, :] - f0) ** 2)).to(dtype)
    return torch.fft.ifft(_round(X, mode)[:, None, :] * _round(H, mode), dim=-1)[..., :n]


def coherence(r1: torch.Tensor, r2: torch.Tensor, sj: np.ndarray, dt: float,
              dj: float, f0: float, mode: str = "f64") -> torch.Tensor:
    """R^2 (M, S, n) of the row pairs (M, n)."""
    nfft = 1 << (r1.shape[-1] - 1).bit_length()
    W1 = _cwt(r1, sj, dt, f0, nfft, mode)
    W2 = _cwt(r2, sj, dt, f0, nfft, mode)
    s = torch.as_tensor(sj, dtype=W1.real.dtype, device=W1.device)[:, None]
    S1 = smooth(W1.abs() ** 2 / s, sj, dt, dj, mode)
    S2 = smooth(W2.abs() ** 2 / s, sj, dt, dj, mode)
    S12 = smooth(W1 * W2.conj() / s, sj, dt, dj, mode)
    return S12.abs() ** 2 / (S1 * S2)


def readout(counts: np.ndarray, maxscale: int, level: float,
            any_out: np.ndarray) -> np.ndarray:
    """pycwt's significance curve from the (S, NBINS) counts."""
    sig = np.zeros(counts.shape[0])
    sig[any_out] = np.nan
    r2y = (np.arange(NBINS) + 0.5) / NBINS
    for s in range(maxscale):
        sel = counts[s] > 0
        if not sel.any():
            continue
        P = counts[s, sel].cumsum()
        sig[s] = np.interp(level, (P - 0.5) / P[-1], r2y[sel])
    return sig


class Nulls:
    """The nulls of one call: the stations ``y`` (B, n0) at ``dt``, ``dj``,
    Morlet ``f0``, ``mc_count`` members each, drawn from ``seed``; the
    curves are computed on ``device`` when asked for and kept."""

    def __init__(self, y, dt: float, dj: float, f0: float, mc_count: int,
                 seed: int, level: float, device, mode: str = "f64"):
        _check_mode(mode)
        y = np.asarray(y, np.float64)
        B, n0 = y.shape
        self.dt, self.dj, self.f0, self.mode = float(dt), float(dj), float(f0), mode
        self.mc_count, self.seed, self.level = int(mc_count), int(seed), float(level)
        self.device = device
        s0, J, _, _ = grid(n0, dt, dj, f0)
        self.grid = surrogate_grid(dt, dj, s0, J, f0)
        self.alpha = station_alphas(y, mode)
        self.pairs = all_pairs(B)
        self.keys, self.owner = null_keys(self.alpha, self.pairs, mc_count)
        self.tau = burn_in(self.keys)
        self._curves: dict = {}

    def curve(self, d: int) -> np.ndarray:
        """The (S,) curve of the distinct null ``d``."""
        if d not in self._curves:
            self._curves[d] = self._simulate(d)
        return self._curves[d]

    def sig95(self) -> np.ndarray:
        """(P, S) curves of every pair."""
        curves = np.stack([self.curve(d) for d in range(len(self.keys))])
        return curves[self.owner]

    def _simulate(self, d: int) -> np.ndarray:
        g, dev = self.grid, self.device
        (a, b), s = self.keys[d], slot(self.keys[d])
        k1, k2 = threefry.split2(threefry.prng_key(self.seed, dev))
        S = len(g["sj"])
        keep = torch.as_tensor(g["outside"], device=dev)
        cell = (torch.arange(S, device=dev) * NBINS)[:, None]
        counts = torch.zeros(S * NBINS, dtype=torch.int64, device=dev)
        for lo in range(0, self.mc_count, BLOCK):
            idx = torch.arange(lo, min(lo + BLOCK, self.mc_count), device=dev)
            r1 = members(k1, s, idx, g["n"], a, self.tau)
            r2 = members(k2, s, idx, g["n"], b, self.tau)
            r2_ = coherence(r1, r2, g["sj"], self.dt, self.dj, self.f0, self.mode)
            bins = torch.nan_to_num(torch.floor(r2_ * NBINS), nan=0.0)
            bins = bins.clamp(0, NBINS - 1).to(torch.int64) + cell
            counts += torch.bincount(bins[:, keep].reshape(-1), minlength=S * NBINS)
        return readout(counts.view(S, NBINS).cpu().numpy(), g["maxscale"],
                       self.level, g["any_out"])

"""Plain reference of the wavelet coherence and its Monte-Carlo null
(Grinsted, Moore & Jevrejeva 2004; pycwt's ``wct`` and
``wct_significance``, whose semantics it follows step by step).

* Each series is normalised to zero mean and unit (population) variance.
* Scales s_j = s0 2^(j dj), s0 = 2 dt / lambda, J = round(log2(n0 dt / s0) / dj)
  (numpy's round half to even), lambda = 4 pi / (f0 + sqrt(2 + f0^2)).
* The CWT is pycwt's (``cwt_f64``'s formula), zero-padded to the next power
  of two, written as products with DFT matrices.
* The smoothing is pycwt's Morlet ``smooth``: in time, the padded spectrum
  times exp(-(s/dt)^2 k^2 / 2), k = 2 pi fftfreq(nfft) with unit spacing,
  here as one (n, n) circulant-block matrix per scale; in scale, scipy's
  ``convolve2d(T, win[:, None], 'same')`` with the boxcar of
  round(2 deltaj0 / dj) taps whose end taps are 0.5, normalised, here as a
  banded (S, S) matrix.
* WCT = |S(W12 / s)|^2 / (S(|W1|^2 / s) S(|W2|^2 / s)), the phase
  atan2(Im W12, Re W12), W12 = W1 conj(W2).
* The null: ``mc_count`` AR(1) surrogate pairs of length ceil(6 s_J / dt),
  member i of series 1 (2) drawn from JAX's threefry stream
  fold_in(split(PRNGKey(seed))[0 (1)], i) (``threefry.py``), the AR(1)
  recursion y[t] = g y[t-1] + z[t] run from y[-1] = 0 and its first
  tau = ceil(-2 / log g) samples dropped; a 1000-bin histogram of R^2 per
  scale over the cells outside the COI (period <= coi), floor(R^2 1000)
  clipped to [0, 999], NaN in bin 0; the significance level read off each
  scale's empirical CDF by linear interpolation, as pycwt's
  ``wavelet.py:632-640`` reads it, with its NaN and zero rows.

Every product is a matrix product so that ``Arith("tf32")``, the control,
computes the whole pipeline in float32 with its matrix operands rounded to
TF32 (10 stored mantissa bits, round to nearest even; the accumulation in
float32), what the H100's tensor cores do to a float32 product when TF32
is allowed.  ``Arith("f64")`` is the reference proper.  The module imports
nothing of the program and takes none of its values.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import threefry

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NBINS = 1000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (to nearest, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


class Arith:
    """The reference's arithmetic: ``"f64"``, or ``"tf32"`` (float32, matrix
    operands in TF32)."""

    def __init__(self, mode: str = "f64"):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"arithmetic must be 'f64' or 'tf32', got {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def host(self, v: np.ndarray) -> np.ndarray:
        """A host float64 result as this arithmetic would give it."""
        if self.mode == "f64":
            return np.asarray(v, np.float64)
        return tf32_round(torch.as_tensor(v, dtype=torch.float32)).double().numpy()


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def flambda(f0: float) -> float:
    return 4.0 * math.pi / (f0 + math.sqrt(2.0 + f0 * f0))


def grid(n0: int, dt: float, dj: float, f0: float):
    """(s0, J, sj, freqs) of pycwt's default grid for n0 samples."""
    lam = flambda(f0)
    s0 = 2.0 * dt / lam
    J = int(np.round(np.log2(n0 * dt / s0) / dj))
    sj = s0 * 2.0 ** (np.arange(J + 1, dtype=np.float64) * dj)
    return s0, J, sj, 1.0 / (lam * sj)


def coi(n0: int, dt: float, f0: float) -> np.ndarray:
    """Cone of influence as Fourier periods, one per sample."""
    tri = n0 / 2.0 - np.abs(np.arange(n0, dtype=np.float64) - (n0 - 1) / 2.0)
    return flambda(f0) / math.sqrt(2.0) * dt * tri


def ar1(x) -> float:
    """Allen & Smith (1996) lag-1 coefficient with Grinsted's quadratic."""
    x = np.asarray(x, np.float64)
    N = x.size
    x = x - x.mean()
    c0 = float(x.dot(x)) / N
    c1 = float(x[:-1].dot(x[1:])) / (N - 1)
    B = -c1 * N - c0 * N ** 2 - 2 * c0 + 2 * c1 - c1 * N ** 2 + c0 * N
    A = c0 * N ** 2
    C = N * (c0 + c1 * N - c1)
    D = B ** 2 - 4 * A * C
    if D <= 0:
        raise ValueError("AR(1) fit has no real root: series too short")
    return (-B - D ** 0.5) / (2 * A)


@functools.lru_cache(maxsize=8)
def _dft(n: int, nfft: int, mode: str, device):
    """(cos, sin) of 2 pi t k / nfft for t < n, k < nfft, (n, nfft)."""
    tk = (torch.arange(n, device=device)[:, None]
          * torch.arange(nfft, device=device)[None, :]) % nfft
    ang = (2.0 * math.pi / nfft) * tk.to(torch.float64)
    dtype = Arith(mode).dtype
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


@functools.lru_cache(maxsize=8)
def _time_kernel(sj_key: tuple, dt: float, n: int, mode: str, device):
    """(S, n, n) matrices K_s[t', t] = g_s((t - t') mod nfft) of the time
    smoothing, g_s the inverse DFT of exp(-(s/dt)^2 k^2 / 2)."""
    nfft = next_pow2(n)
    sj = torch.tensor(sj_key, dtype=torch.float64, device=device)
    k = 2.0 * math.pi * torch.fft.fftfreq(nfft, dtype=torch.float64, device=device)
    F = torch.exp(-0.5 * (sj[:, None] / dt) ** 2 * k[None, :] ** 2)
    g = torch.fft.ifft(F).real
    t = torch.arange(n, device=device)
    lag = (t[None, :] - t[:, None]) % nfft
    return g[:, lag].to(Arith(mode).dtype)


@functools.lru_cache(maxsize=8)
def _boxcar(S: int, dj: float, deltaj0: float, mode: str, device):
    """(S, S) band matrix of scipy's 'same' convolution with the boxcar."""
    L = int(np.round(2.0 * deltaj0 / dj))
    win = np.ones(L)
    win[0] = win[-1] = 0.5
    win /= win.sum()
    start = (L - 1) // 2
    M = np.zeros((S, S))
    for i in range(S):
        for c in range(S):
            if 0 <= i + start - c < L:
                M[i, c] = win[i + start - c]
    return torch.as_tensor(M, device=device).to(Arith(mode).dtype)


def cwt(y: torch.Tensor, sj: np.ndarray, dt: float, f0: float, ar: Arith):
    """Planar W (re, im), each (B, S, n), of the rows y (B, n)."""
    B, n = y.shape
    nfft = next_pow2(n)
    dev = y.device
    C, Sn = _dft(n, nfft, ar.mode, dev)
    Xr, Xi = ar.mm(y, C), -ar.mm(y, Sn)
    w = 2.0 * math.pi * torch.fft.fftfreq(nfft, d=dt, dtype=torch.float64, device=dev)
    s = torch.as_tensor(sj, dtype=torch.float64, device=dev)[:, None]
    H = (torch.sqrt(2.0 * math.pi * s / dt) * math.pi ** -0.25
         * torch.exp(-0.5 * (s * w[None, :] - f0) ** 2)).to(ar.dtype)
    Pr = (Xr[:, None, :] * H).reshape(-1, nfft)
    Pi = (Xi[:, None, :] * H).reshape(-1, nfft)
    Ci, Si = C.T, Sn.T
    Wr = (ar.mm(Pr, Ci) - ar.mm(Pi, Si)) / nfft
    Wi = (ar.mm(Pr, Si) + ar.mm(Pi, Ci)) / nfft
    return Wr.reshape(B, -1, n), Wi.reshape(B, -1, n)


def smooth(T: torch.Tensor, sj: np.ndarray, dt: float, dj: float,
           ar: Arith, deltaj0: float = 0.6) -> torch.Tensor:
    """pycwt's Morlet smoothing of a real field T (B, S, n)."""
    B, S, n = T.shape
    K = _time_kernel(tuple(float(v) for v in sj), float(dt), n, ar.mode, T.device)
    timed = ar.mm(T.permute(1, 0, 2), K).permute(1, 0, 2)
    return ar.mm(_boxcar(S, float(dj), deltaj0, ar.mode, T.device), timed)


def wct_core(y1: torch.Tensor, y2: torch.Tensor, sj: np.ndarray, dt: float,
             dj: float, f0: float, ar: Arith):
    """(WCT, phase, |W12|), each (B, S, n), of row pairs (B, n)."""
    w1r, w1i = cwt(y1.to(ar.dtype), sj, dt, f0, ar)
    w2r, w2i = cwt(y2.to(ar.dtype), sj, dt, f0, ar)
    s = torch.as_tensor(sj, dtype=ar.dtype, device=y1.device)[:, None]
    S1 = smooth((w1r ** 2 + w1i ** 2) / s, sj, dt, dj, ar)
    S2 = smooth((w2r ** 2 + w2i ** 2) / s, sj, dt, dj, ar)
    w12r = w1r * w2r + w1i * w2i
    w12i = w1i * w2r - w1r * w2i
    S12r = smooth(w12r / s, sj, dt, dj, ar)
    S12i = smooth(w12i / s, sj, dt, dj, ar)
    wct_ = (S12r ** 2 + S12i ** 2) / (S1 * S2)
    return wct_, torch.atan2(w12i, w12r), torch.sqrt(w12r ** 2 + w12i ** 2)


def wct(y1: np.ndarray, y2: np.ndarray, dt: float, dj: float, f0: float,
        ar: Arith, device):
    """What ``wct(y1, y2, dt, dj, sig=False)`` returns, and |W12|:
    ``(WCT, phase, coi, freqs, |W12|)``, the maps (S, n0) float64 numpy."""
    n0 = len(y1)
    _, _, sj, freqs = grid(n0, dt, dj, f0)
    rows = [np.asarray(y, np.float64) for y in (y1, y2)]
    y1n, y2n = ((torch.as_tensor((y - y.mean()) / y.std(), device=device)[None])
                for y in rows)
    w, ph, mag = wct_core(y1n, y2n, sj, dt, dj, f0, ar)
    maps = [m[0].double().cpu().numpy() for m in (w, ph, mag)]
    return maps[0], maps[1], ar.host(coi(n0, dt, f0)), ar.host(freqs), maps[2]


def _members(key, idx: torch.Tensor, n: int, g: float) -> torch.Tensor:
    """AR(1) surrogates (len(idx), n) float64, member i from fold_in(key, i)."""
    tau = threefry.burn_in(g)
    z = threefry.normal_f64(threefry.fold_in(key, idx), n + tau).cpu().numpy()
    y = np.empty_like(z)
    y[:, 0] = z[:, 0]
    for t in range(1, z.shape[1]):
        y[:, t] = g * y[:, t - 1] + z[:, t]
    return torch.as_tensor(y[:, tau:], device=idx.device)


def mc_significance(al1: float, al2: float, dt: float, dj: float, s0: float,
                    J: int, f0: float, mc_count: int, seed: int, level: float,
                    ar: Arith, device, block: int = 100) -> np.ndarray:
    """The (J + 1,) significance curve of the coherence null."""
    n = int(np.ceil(s0 * 2.0 ** (J * dj) / dt * 6))
    sj = s0 * 2.0 ** (np.arange(J + 1, dtype=np.float64) * dj)
    period = flambda(f0) * sj
    outside = period[:, None] <= coi(n, dt, f0)[None, :]
    any_out = outside.any(axis=1)
    maxscale = int(np.flatnonzero(any_out)[-1])
    S = J + 1
    k1, k2 = threefry.split2(threefry.prng_key(seed, device))
    cell = (torch.arange(S, device=device) * NBINS)[:, None]
    keep = torch.as_tensor(outside, device=device)
    wlc = torch.zeros(S * NBINS, dtype=torch.int64, device=device)
    for lo in range(0, mc_count, block):
        idx = torch.arange(lo, min(lo + block, mc_count), device=device)
        r2, _, _ = wct_core(_members(k1, idx, n, al1), _members(k2, idx, n, al2),
                            sj, dt, dj, f0, ar)
        bins = torch.nan_to_num(torch.floor(r2.double() * NBINS), nan=0.0)
        bins = bins.clamp(0, NBINS - 1).to(torch.int64) + cell
        wlc += torch.bincount(bins[:, keep].reshape(-1), minlength=S * NBINS)
    wlc = wlc.view(S, NBINS).cpu().numpy()
    sig = np.zeros(S)
    sig[any_out] = np.nan
    r2y = (np.arange(NBINS) + 0.5) / NBINS
    for s in range(maxscale):
        sel = wlc[s] > 0
        if not sel.any():
            continue
        P = wlc[s, sel].cumsum()
        sig[s] = np.interp(level, (P - 0.5) / P[-1], r2y[sel])
    return sig

"""Parity mode (``cwt_twofloat``, ``xwt_twofloat``, ``wct_twofloat``) on
native float64.

Counterpart of ``pycwt_tpu/ops/twofloat.py``, with the same names,
signatures, defaults and return types (host numpy out, complex128 for W and
W12) and one addition, ``device=None`` (the card unless the caller passes
``device="cpu"``).  The TPU has no float64, so the JAX module carries every
value as an unevaluated (hi, lo) pair of f32s through a Stockham FFT of
error-free transformations, with the filter bank built in f64 on the host.
The H100 has float64 and cuFFT runs Z2Z transforms in it, so here parity
mode is the port's own f64 pipeline on the device:

* :func:`cwt_twofloat` is ``transform.cwt_batch`` with
  ``CWTConfig(dtype=torch.float64)`` and ``engine="xla"`` passed explicitly:
  the rFFT, the filter bank (``ops/filterbank.py``, built in f64 on the
  device) and the inverse FFT all in f64.  The explicit engine matters:
  ``resolve_engine`` reads ``PYCWT_TPU_ENGINE`` before the device default,
  and ``planar`` there would send an implicit engine through the f32
  kernels.  Parity mode launches no hand kernel;
* :func:`smooth_twofloat` is ``smoothing.smooth(..., engine="xla")`` in f64,
  the same function as the JAX module's (unit-spacing time Gaussian on the
  pow-2 padded field, then the 'same' scale boxcar);
* :func:`xwt_twofloat` and :func:`wct_twofloat` compose them as the JAX
  module does, normalizing with the population standard deviation.

:func:`fft_df` keeps the planar (hi, lo) contract, the one state format the
two packages share: the pairs are joined exactly into f64, transformed by one
``torch.fft`` call in complex128 and split back.  The error-free primitives
(``_two_sum``, ``_two_prod``, ``df_add``, ...) are kept as plain tensor
functions for callers of the JAX module's names; the pipeline needs none.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CWTConfig, next_pow2
from ..mothers import Mother, as_mother
from ..transform import _host_grid, cwt_batch

__all__ = ["df_from_f64", "df_to_f64", "fft_df", "cwt_twofloat",
           "smooth_twofloat", "xwt_twofloat", "wct_twofloat"]

_SPLIT = 4097.0  # Veltkamp factor 2^12 + 1 for binary32
_F64 = CWTConfig(dtype=torch.float64)


# ---------------------------------------------------------------- df32 core

def _two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly (no magnitude precondition)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Fast two-sum; requires |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker two-product via Veltkamp splitting: p + err == a·b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def df_from_f64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host split of an f64 array into an (hi, lo) f32 pair (hi + lo == x to
    f64 round-off; |lo| <= ulp(hi)/2)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_to_f64(hi, lo) -> np.ndarray:
    """Host reassembly: exact f64 sum of the two components."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ---------------------------------------------------------------------- FFT

def _split_f64(x: torch.Tensor):
    hi = x.to(torch.float32)
    return hi, (x - hi.to(torch.float64)).to(torch.float32)


def fft_df(rh, rl, ih, il, nfft: int, sign: int = -1, device=None):
    """FFT of planar two-float values ``(..., nfft)`` (tensors or numpy),
    returned as four f32 planes on ``device``: ``sign=-1`` forward, ``+1``
    the inverse WITHOUT the 1/N scale, as in the JAX module.  ``None`` is a
    tensor ``rh``'s own device, else the card (which raises without one).
    The pairs are joined exactly in f64 (``hi + lo`` is exact), transformed
    by ``torch.fft`` in complex128 and split back."""
    from .overlap import _on_device

    if nfft & (nfft - 1) or nfft < 2:
        raise ValueError(f"two-float FFT needs a power-of-two length, "
                         f"got {nfft}")
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    rh = _on_device(rh, device, torch.float64)
    rl, ih, il = (_on_device(t, rh.device, torch.float64) for t in (rl, ih, il))
    if rh.shape[-1] != nfft:
        raise ValueError(f"planes of length {rh.shape[-1]} do not fit nfft={nfft}")
    z = torch.complex(rh + rl, ih + il)
    # norm="forward" leaves the inverse unscaled (the JAX module's sign=+1)
    Z = (torch.fft.fft(z, dim=-1) if sign < 0
         else torch.fft.ifft(z, dim=-1, norm="forward"))
    return (*_split_f64(Z.real), *_split_f64(Z.imag))


# ------------------------------------------------------------ CWT pipeline

def _check_resident(B: int, S: int, nfft: int, max_bytes: float) -> None:
    """The JAX module's guard on its resident two-float planes, kept with
    its formula and message so that the same call raises in both packages."""
    resident = 16 * B * S * nfft * 4
    if resident > max_bytes:
        raise ValueError(
            f"cwt_twofloat batch needs ~{resident / 1e9:.1f} GB of two-float "
            f"planes for B={B} x {S} scales x nfft={nfft}, over "
            f"max_bytes={max_bytes / 1e9:.1f} GB. Split the batch into "
            f"smaller chunks (results are independent per signal) or raise "
            f"max_bytes on larger devices.")


def _cwt_f64(x: torch.Tensor, sj, dt: float, mother: Mother,
             nfft: int) -> torch.Tensor:
    """W ``(B, S, n0)`` complex128 of the f64 rows ``x`` ``(B, n0)`` on their
    device: ``cwt_batch`` in f64 on the explicit ``"xla"`` engine."""
    W, _ = cwt_batch(
        x, torch.as_tensor(sj, dtype=torch.float64, device=x.device), dt,
        mother=mother, nfft=nfft, config=_F64, engine="xla")
    return W


def _cwt_device(y, dt, dj, s0, J, mother: Mother, freqs, max_bytes, device):
    """:func:`cwt_twofloat` up to the host fetch: ``(W, sj, freqs, coi)``
    with W a complex128 tensor on the device, ``(S, n0)`` or ``(B, S, n0)``
    as ``y`` is 1-D or 2-D."""
    from ..api import _resolve_device

    y = np.asarray(y, np.float64)
    if y.ndim not in (1, 2):
        raise ValueError(
            f"cwt_twofloat expects a 1-D signal or a (B, n0) batch, got "
            f"{y.shape}")
    n0 = y.shape[-1]
    g = _host_grid(n0, dt, dj, s0, J, mother, next_pow2, freqs)
    B = y.shape[0] if y.ndim == 2 else 1
    _check_resident(B, len(g.sj), g.nfft, max_bytes)
    device = _resolve_device(device)
    x = torch.as_tensor(y.reshape(B, n0), device=device)
    W = _cwt_f64(x, g.sj, dt, mother, g.nfft)
    return (W if y.ndim == 2 else W[0]), g.sj, g.freqs, g.coi


def cwt_twofloat(y, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet", freqs=None,
                 max_bytes: float = 12e9, device=None):
    """Forward CWT in parity mode: float64 end to end on ``device``.

    Accepts a 1-D signal or a ``(B, n0)`` batch (one device call; W comes
    back ``(B, S, n0)``).  A batch over the JAX module's resident-bytes
    guard (``16·B·S·nfft·4 > max_bytes``) raises before any device work,
    with its split-the-batch remedy.  Same grid/COI/NaN-row semantics as
    :func:`pycwt_torch.api.cwt` (reference ``wavelet.py:13-124``).

    Returns ``(W, sj, freqs, coi)`` with W complex128 on the host.
    """
    from ..api import _host

    W, sj, fr, coi = _cwt_device(y, dt, dj, s0, J, as_mother(wavelet), freqs,
                                 max_bytes, device)
    return _host(W), sj, fr, coi


# ------------------------------------------------------- smoothing and WCT

def smooth_twofloat(T, scales, dt: float, dj: float, mother: Mother,
                    device=None):
    """Parity-mode WCT smoothing of a real or complex f64 host array
    ``(S, n)``: ``ops.smoothing.smooth`` in f64 on ``device`` (time Gaussian
    with unit-spacing ``k`` and ``scales/dt`` on the pow-2 padded field,
    then the 'same' scale boxcar), returned to the host."""
    from ..api import _host, _resolve_device

    device = _resolve_device(device)
    T = np.asarray(T)
    T = torch.as_tensor(T.astype(np.complex128 if np.iscomplexobj(T)
                                 else np.float64), device=device)
    return _host(_smooth_f64(T, scales, dt, dj, mother))


def _smooth_f64(T: torch.Tensor, scales, dt: float, dj: float, mother: Mother):
    from .smoothing import smooth

    scales = torch.as_tensor(scales, dtype=torch.float64, device=T.device)
    return smooth(T, dt, dj, scales, mother, engine="xla")


def _normalized(y, normalize: bool) -> np.ndarray:
    """``(y − mean)/std`` with numpy's population std (``ddof=0``), as the
    JAX module and the reference normalize."""
    y = np.asarray(y, np.float64)
    return (y - y.mean()) / y.std() if normalize else y


def xwt_twofloat(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
                 normalize=True, device=None):
    """Cross-wavelet transform in parity mode (reference
    ``wavelet.py:385-399`` semantics; significance belongs to
    :func:`pycwt_torch.coherence.xwt`).  Returns ``(W12, coi, freq)``."""
    from ..api import _host

    mother = as_mother(wavelet)
    kw = dict(freqs=None, max_bytes=12e9, device=device)
    W1, sj, fr, coi = _cwt_device(_normalized(y1, normalize), dt, dj, s0, J,
                                  mother, **kw)
    W2, *_ = _cwt_device(_normalized(y2, normalize), dt, dj, s0, J, mother, **kw)
    return _host(W1 * torch.conj(W2)), coi, fr


def wct_twofloat(y1, y2, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
                 normalize=True, device=None):
    """Wavelet coherence in parity mode (reference ``wavelet.py:489-514``):
    two f64 CWTs, three f64 smoothings and the coherence ratio, on
    ``device``.  Returns ``(WCT, aWCT, coi, freq)``."""
    from ..api import _host

    mother = as_mother(wavelet)
    kw = dict(freqs=None, max_bytes=12e9, device=device)
    W1, sj, fr, coi = _cwt_device(_normalized(y1, normalize), dt, dj, s0, J,
                                  mother, **kw)
    W2, *_ = _cwt_device(_normalized(y2, normalize), dt, dj, s0, J, mother, **kw)
    s_col = torch.as_tensor(sj, device=W1.device)[:, None]
    S1 = _smooth_f64(W1.abs() ** 2 / s_col, sj, dt, dj, mother)
    S2 = _smooth_f64(W2.abs() ** 2 / s_col, sj, dt, dj, mother)
    W12 = W1 * torch.conj(W2)
    S12 = _smooth_f64(W12 / s_col, sj, dt, dj, mother)
    WCT = S12.abs() ** 2 / (S1 * S2)
    return _host(WCT), _host(torch.angle(W12)), coi, fr

"""WCT smoothing operator: Gaussian in time (Fourier domain) + boxcar in scale.

Counterpart of the single-device parts of ``pycwt_tpu/ops/smoothing.py``,
with the reference's semantics:

* time axis: multiply the (pow-2 padded) spectrum by ``exp(−(s/dt)²k²/2)``
  where ``k = 2π·fftfreq(nfft)`` with **unit** sample spacing (the reference
  passes no ``d`` to fftfreq), then inverse FFT and trim;
* scale axis: 'same' 2-D convolution with a normalized boxcar of width
  ``round(deltaj0/dj·2)`` whose end taps are 0.5, as one real
  ``torch.matmul`` with a banded (S, S) matrix (kept on the tensor's
  device: no host copy per call) over the real view of the field.

Batched over leading axes, and defined for every mother with a tabulated
``deltaj0``.  The FFTs are ``torch.fft``; the planar functions keep the JAX
package's real-plane contracts on top of :func:`smooth` of complex tensors.
On the card the band matrix product runs in full f32 while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default); its
rows came out bit-identical at every batch count tried on the H100 (1, 7,
64, 300 members of the Monte-Carlo shape), which the Monte-Carlo curves'
independence of ``mc_batch`` rests on (``chip_smoke.py`` checks it).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import next_pow2
from ..mothers import Mother
from .fft import fft as engine_fft, ifft as engine_ifft

__all__ = ["smooth", "smooth_planar_real", "smooth_planar_pair",
           "rect_window", "scale_boxcar_same", "time_gaussian_smooth"]


def rect_window(width: int, normalize: bool = True) -> np.ndarray:
    """Boxcar with 0.5 end-weights (reference ``helpers.py:176-191``)."""
    if width < 1:
        raise ValueError("window width must be >= 1")
    win = np.ones(width, dtype=np.float64)
    win[0] = win[-1] = 0.5
    if normalize:
        win /= win.sum()
    return win


def time_gaussian_smooth(W, scales, dt: float, nfft: int, *,
                         engine: str | None = None):
    """Per-scale Gaussian smoothing along the time axis via the convolution
    theorem: the spectrum times ``exp(−(s/dt)²k²/2)``, k = 2π·fftfreq(nfft);
    the FFT pair honors the engine policy (``ops/fft.py``)."""
    W = torch.as_tensor(W)
    n = W.shape[-1]
    real_in = not W.is_complex()
    rdt = W.real.dtype
    k = (2 * math.pi) * torch.fft.fftfreq(nfft, dtype=torch.float64,
                                          device=W.device).to(rdt)
    snorm = torch.as_tensor(scales, dtype=rdt, device=W.device) / dt
    F = torch.exp(-0.5 * (snorm[:, None] ** 2) * (k ** 2)[None, :])   # (S, nfft)
    spec = engine_fft(W, n=nfft, engine=engine)
    out = engine_ifft(F * spec, engine=engine)[..., :n]
    return out.real if real_in else out


@functools.lru_cache(maxsize=64)
def _boxcar_band_matrix(S: int, win_key: tuple, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """Dense (S, S) 'same'-convolution operator for the scale boxcar:
    ``M[i, t] = win[i + start - t]`` (zero outside the window), so the
    L-term shifted-slice sum collapses into one matmul along the scale axis.
    Built once per (S, window, dtype, device) and kept on the device.
    """
    win = np.asarray(win_key, np.float64)
    L = len(win)
    start = (L - 1) // 2
    M = np.zeros((S, S), np.float64)
    for i in range(S):
        for t in range(max(0, i + start - (L - 1)), min(S, i + start + 1)):
            M[i, t] = win[i + start - t]
    return torch.as_tensor(M, device=device).to(dtype)


def scale_boxcar_same(T, win: np.ndarray):
    """'same'-mode convolution along the scale axis (axis −2), matching
    ``scipy.signal.convolve2d(T, win[:, None], 'same')`` including the
    even-width centering, as one banded-matrix product over the scale axis.
    A complex ``T`` is multiplied as its real view ``(..., S, 2N)``: the
    matrix is real, so the product of the planes is the complex product.
    """
    L = len(win)
    if L == 1:
        return T * float(win[0])
    S = T.shape[-2]
    M = _boxcar_band_matrix(S, tuple(np.asarray(win).tolist()), T.real.dtype,
                            T.device)
    if not T.is_complex():
        return torch.matmul(M, T)
    planes = torch.view_as_real(T.resolve_conj()).reshape(*T.shape[:-1],
                                                          2 * T.shape[-1])
    out = torch.matmul(M, planes)
    return torch.view_as_complex(out.reshape(*T.shape, 2))


def _scale_window(mother: Mother, dj: float) -> np.ndarray:
    if mother.deltaj0 == -1:
        raise ValueError(
            f"deltaj0 is not tabulated for {mother.name} with these parameters; "
            "cannot build the scale-smoothing window (TC98 Table 2)."
        )
    wsize = mother.deltaj0 / dj * 2
    return rect_window(int(round_half_even_np(wsize)), normalize=True)


def smooth_planar_real(T, dt: float, dj: float, scales, mother: Mother):
    """:func:`smooth` of a REAL ``(..., S, N)`` tensor, which is real."""
    return smooth(T, dt, dj, scales, mother)


def smooth_planar_pair(Ta, Tb, dt: float, dj: float, scales, mother: Mother):
    """Smooth TWO real ``(..., S, N)`` planes in one complex pass: with
    ``x = Ta + i·Tb`` the real smoothing kernel commutes with Re/Im, so the
    real and imaginary planes of ``smooth(x)`` ARE the two smoothed fields.
    Equal to two :func:`smooth_planar_real` calls to round-off.  The WCT
    path (``coherence._wct_core_planar``) packs (|W1|², |W2|²) and
    (Re W12, Im W12) this way."""
    sm = smooth(torch.complex(torch.as_tensor(Ta), torch.as_tensor(Tb)), dt, dj,
                scales, mother)
    return sm.real, sm.imag


def smooth(W, dt: float, dj: float, scales, mother: Mother, *,
           engine: str | None = None):
    """Full WCT smoothing: time Gaussian then scale boxcar.

    Parameters
    ----------
    W: ``(..., S, N)`` real or complex tensor (e.g. ``|W|²/s`` or ``W₁W₂*/s``).
    dt: sampling interval.
    dj: scale spacing (sets the boxcar width ``round(deltaj0/dj·2)``).
    scales: (S,) wavelet scales.
    mother: mother wavelet providing ``deltaj0``.
    engine: FFT engine for the time-Gaussian pass (``ops/fft.py``).
    """
    win = _scale_window(mother, dj)
    W = torch.as_tensor(W)
    T = time_gaussian_smooth(W, scales, dt, next_pow2(W.shape[-1]), engine=engine)
    return scale_boxcar_same(T, win)


def round_half_even_np(x: float) -> int:
    """int(np.round(x)) — banker's rounding, as the reference uses."""
    return int(np.round(x))

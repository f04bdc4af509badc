"""WCT smoothing operator: Gaussian in time (Fourier domain) + boxcar in scale.

Counterpart of ``pycwt_tpu/ops/smoothing.py``, with the reference's
semantics:

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
:func:`smooth_scale_sharded` is the same operator when the scale axis is
sharded over a mesh dim (``parallel/sharded.py``): the time pass stays
row-local and the boxcar exchanges halo rows with the neighbouring ranks
(:func:`scale_boxcar_same_sharded`).
The band matrix product, forward and backward, runs in full f32 whatever
the process sets (``ops/_precision.full_f32_matmul``), as ``pycwt_tpu``
pins ``Precision.HIGHEST``: TF32 or bf16 set by ``allow_tf32`` or
``torch.set_float32_matmul_precision`` does not reach it.  Its rows came out
bit-identical at every batch count tried on the H100 (1, 7, 64, 300 members
of the Monte-Carlo shape), which the Monte-Carlo curves' independence of
``mc_batch`` rests on (``chip_smoke.py`` checks it).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import _PRECISIONS, next_pow2
from ..mothers import Mother
from ..utils.profiling import span
from ._precision import full_f32_matmul
from .fft import fft as engine_fft, ifft as engine_ifft

__all__ = ["smooth", "smooth_planar_real", "smooth_planar_pair",
           "rect_window", "scale_boxcar_same", "time_gaussian_smooth",
           "scale_boxcar_same_sharded", "smooth_scale_sharded"]


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
                        device: torch.device, offset: int = 0,
                        cols: int | None = None) -> torch.Tensor:
    """Dense (S, cols) 'same'-convolution operator for the scale boxcar:
    ``M[i, t] = win[i + offset + start - t]`` (zero outside the window), so
    the L-term shifted-slice sum collapses into one matmul along the scale
    axis.  ``offset``/``cols`` (default 0 / S) serve a block whose rows are
    extended by ``offset`` halo rows below (the sharded boxcar).  Built once
    per shape, window, dtype and device and kept on the device.
    """
    win = np.asarray(win_key, np.float64)
    L = len(win)
    start = (L - 1) // 2
    cols = S if cols is None else cols
    M = np.zeros((S, cols), np.float64)
    for i in range(S):
        c = i + offset + start
        for t in range(max(0, c - (L - 1)), min(cols, c + 1)):
            M[i, t] = win[c - t]
    return torch.as_tensor(M, device=device).to(dtype)


class _PinnedMatmul(torch.autograd.Function):
    """``torch.matmul(M, T)`` for a constant matrix ``M``, forward and
    backward under :func:`full_f32_matmul`: a backward runs after the
    forward's scope has closed, so without its own pin Mᵀ·grad would follow
    the caller's setting."""

    @staticmethod
    def forward(ctx, M, T):
        ctx.save_for_backward(M)
        with full_f32_matmul():
            return torch.matmul(M, T)

    @staticmethod
    def backward(ctx, grad):
        (M,) = ctx.saved_tensors
        with full_f32_matmul():
            return None, torch.matmul(M.mT, grad)


def _band_product(M: torch.Tensor, T):
    """``M @ T`` along the scale axis (−2), in full f32 whatever the process
    sets (:class:`_PinnedMatmul`); a complex ``T`` is multiplied as its real
    view ``(..., rows, 2N)``: the matrix is real, so the product of the
    planes is the complex product."""
    if not T.is_complex():
        return _PinnedMatmul.apply(M, T)
    planes = torch.view_as_real(T.resolve_conj()).reshape(*T.shape[:-1],
                                                          2 * T.shape[-1])
    out = _PinnedMatmul.apply(M, planes)
    return torch.view_as_complex(out.reshape(*T.shape[:-2], M.shape[0],
                                             T.shape[-1], 2))


def scale_boxcar_same(T, win: np.ndarray):
    """'same'-mode convolution along the scale axis (axis −2), matching
    ``scipy.signal.convolve2d(T, win[:, None], 'same')`` including the
    even-width centering, as one banded-matrix product over the scale axis.
    """
    L = len(win)
    if L == 1:
        return T * float(win[0])
    S = T.shape[-2]
    M = _boxcar_band_matrix(S, tuple(np.asarray(win).tolist()), T.real.dtype,
                            T.device)
    return _band_product(M, T)


def _boxcar_halos(L: int, S_loc: int) -> tuple[int, int]:
    """(rows needed above, rows needed below) a block of ``S_loc`` scale
    rows for an ``L``-tap boxcar; raises when a halo exceeds the block (the
    exchange reaches one neighbour only)."""
    h_up = (L - 1) // 2
    h_dn = L - 1 - h_up
    if max(h_up, h_dn) > S_loc:
        raise ValueError(
            f"boxcar halo {max(h_up, h_dn)} exceeds local scale block {S_loc}; "
            "use fewer 'scale' shards or a coarser dj"
        )
    return h_up, h_dn


def scale_boxcar_same_sharded(T, win: np.ndarray, axis_name: str = "scale", *,
                              mesh):
    """Scale-axis 'same' boxcar when the scale axis (−2) is SHARDED over the
    ``axis_name`` dim of ``mesh``: ``T`` is this rank's block ``(..., S_loc,
    N)`` and every rank of the dim calls this together.

    The boxcar couples each scale row to its ⌈(L−1)/2⌉ neighbours, so each
    block gets halo rows from the neighbouring ranks through one
    ``all_to_all_single`` (``parallel._collectives.shift``); the first and
    last ranks receive zero rows, the 'same' convolution's zero padding at
    the global edges.  Then one band product with an ``(S_loc, S_loc +
    halos)`` matrix, as :func:`scale_boxcar_same`.  Requires halo ≤ S_loc.
    """
    from ..parallel._collectives import shift

    L = len(win)
    if L == 1:
        return T * float(win[0])
    S_loc = T.shape[-2]
    h_up, h_dn = _boxcar_halos(L, S_loc)
    T = torch.as_tensor(T)
    rows_first = T.movedim(-2, 0)
    T_ext = shift(rows_first.contiguous(), mesh, axis_name, up=h_up,
                  down=h_dn).movedim(0, -2)
    M = _boxcar_band_matrix(S_loc, tuple(np.asarray(win).tolist()), T.real.dtype,
                            T.device, offset=h_dn, cols=S_loc + h_dn + h_up)
    return _band_product(M, T_ext)


def _scale_window(mother: Mother, dj: float) -> np.ndarray:
    if mother.deltaj0 == -1:
        raise ValueError(
            f"deltaj0 is not tabulated for {mother.name} with these parameters; "
            "cannot build the scale-smoothing window (TC98 Table 2)."
        )
    wsize = mother.deltaj0 / dj * 2
    return rect_window(int(round_half_even_np(wsize)), normalize=True)


def smooth_scale_sharded(W, dt: float, dj: float, scales_local, mother: Mother,
                         *, axis_name: str = "scale",
                         n_true_scales: int | None = None,
                         engine: str | None = None, mesh):
    """:func:`smooth` of this rank's scale block ``(..., S_loc, N)`` when the
    scale axis is sharded over the ``axis_name`` dim of ``mesh``.

    The time-Gaussian pass is row-local (each rank smooths its own rows with
    its local scales); the scale boxcar exchanges halo rows
    (:func:`scale_boxcar_same_sharded`).  ``n_true_scales`` zeroes the rows
    padded by ``parallel.sharded.pad_scales`` (global row index ≥ it)
    *before* the boxcar, so they contribute exactly the zero padding the
    unsharded 'same' convolution sees.
    """
    from ..parallel._collectives import axis_rank

    win = _scale_window(mother, dj)
    W = torch.as_tensor(W)
    T = time_gaussian_smooth(W, scales_local, dt, next_pow2(W.shape[-1]),
                             engine=engine)
    if n_true_scales is not None:
        S_loc = T.shape[-2]
        row = axis_rank(mesh, axis_name) * S_loc + torch.arange(S_loc, device=T.device)
        T = torch.where((row < n_true_scales)[:, None], T, torch.zeros((), dtype=T.dtype,
                                                                       device=T.device))
    return scale_boxcar_same_sharded(T, win, axis_name=axis_name, mesh=mesh)


def _check_precision(precision) -> None:
    """``pycwt_tpu``'s smoothing precision: ``None`` (its ``HIGHEST``) or a
    tier name.  Every tier runs the same full-f32 band product."""
    if precision is not None and precision not in _PRECISIONS:
        raise ValueError(f"precision must be None or one of {_PRECISIONS}, "
                         f"got {precision!r}")


def smooth_planar_real(T, dt: float, dj: float, scales, mother: Mother,
                       precision=None):
    """:func:`smooth` of a REAL ``(..., S, N)`` tensor, which is real.
    ``precision`` is ``pycwt_tpu``'s: ``None`` means ``"highest"``, and each
    tier (``"highest"``, ``"high"``, ``"fast"``) runs the same full-f32
    product; any other value raises."""
    _check_precision(precision)
    return smooth(T, dt, dj, scales, mother)


def smooth_planar_pair(Ta, Tb, dt: float, dj: float, scales, mother: Mother,
                       precision=None):
    """Smooth TWO real ``(..., S, N)`` planes in one complex pass: with
    ``x = Ta + i·Tb`` the real smoothing kernel commutes with Re/Im, so the
    real and imaginary planes of ``smooth(x)`` ARE the two smoothed fields.
    Equal to two :func:`smooth_planar_real` calls to round-off.  The WCT
    path (``coherence._planar_fields``) packs (|W1|², |W2|²) and
    (Re W12, Im W12) this way, and keeps the complex results.  ``precision`` as in
    :func:`smooth_planar_real`."""
    _check_precision(precision)
    sm = smooth(torch.complex(torch.as_tensor(Ta), torch.as_tensor(Tb)), dt, dj,
                scales, mother)
    return sm.real, sm.imag


@span("smooth")
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

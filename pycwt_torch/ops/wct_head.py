"""The coherence head on the card: ``csrc/wct_head.cu``.

``coherence._planar_fields`` calls :func:`fields_head` where the four f32
planes of two planar transforms lie on a CUDA device and no gradient is
asked of them; elsewhere (the CPU, f64, autograd) it runs the torch code,
``coherence._torch_head``, which is the kernel's plain version.  Both give
the same fields, bit for bit (the card tests hold the kernel against the
torch code on the card).

One ``wct_fields_head`` launch reads the planes ``w1r, w1i, w2r, w2i`` once
and writes the two complex64 fields that the smoothing takes, ``S =
|W1|²/s + i·|W2|²/s`` and ``C = W12r/s + i·W12i/s`` with ``W12 = W1 ·
conj(W2)``, each op rounded as the torch code rounds it, and the cross
planes ``(W12r, W12i)`` where the caller keeps them.  The kernel reads the
planes at their own strides, without a copy: the trimmed views of
width-``nfft`` rows, whole rows, and the real and imaginary views of a
complex W (the planar route's plain transform below nfft 2^8).  :data:`LAUNCHES` counts the launches, and
``profiling.WCT_HEAD_KERNEL_POINTS`` the points it made.
"""
from __future__ import annotations

import math

import torch

from ..utils import profiling
from ._build import library

__all__ = ["fields_head", "on_card", "LAUNCHES"]

#: Launches of the kernel in this process
LAUNCHES = {"wct_fields_head": 0}


def on_card(plane: torch.Tensor) -> bool:
    """Whether ``plane`` lies where the kernel runs: a CUDA device."""
    return plane.is_cuda


def _layout(plane: torch.Tensor) -> tuple[int, int, int] | None:
    """The strides, in elements, of ``plane`` ``(..., S, n)`` read as ``(R,
    S, n)``: between rows, between scales and between points, each 0 where
    its size is 1; None where the leading dims do not merge into one."""
    *lead, nS, n = plane.shape
    *lead_strides, ss, st = plane.stride()
    sr, size = 0, 1
    for dim, stride in zip(reversed(lead), reversed(lead_strides)):
        if dim == 1:
            continue
        if size == 1:
            sr = stride
        elif stride != sr * size:
            return None
        size *= dim
    return sr, (ss if nS > 1 else 0), (st if n > 1 else 0)


def fields_head(w1r: torch.Tensor, w1i: torch.Tensor, w2r: torch.Tensor,
                w2i: torch.Tensor, scales: torch.Tensor, *, cross: bool = False):
    """The fields ``(S, C)`` of the planes ``w1r, w1i, w2r, w2i`` (f32
    ``(..., S, n)`` on one CUDA device, of one shape and one layout whose
    leading dims merge into one) over ``scales`` (f32 ``(S,)``,
    contiguous): two contiguous complex64 tensors of the planes' shape, and
    the contiguous cross planes ``(W12r, W12i)`` as a third item where
    ``cross``, else None.

    Raises ``TypeError`` for another dtype and ``ValueError`` for another
    device, shape or layout.
    """
    planes = (w1r, w1i, w2r, w2i)
    if any(t.dtype != torch.float32 for t in (*planes, scales)):
        raise TypeError("the planes and the scales are float32, not "
                        f"{[t.dtype for t in (*planes, scales)]}")
    dev = w1r.device
    if not on_card(w1r) or any(t.device != dev for t in (*planes, scales)):
        raise ValueError("the planes and the scales lie on one CUDA device")
    shape = w1r.shape
    if w1r.dim() < 2 or any(t.shape != shape for t in planes):
        raise ValueError(f"the planes are four (..., S, n) tensors of one shape, got "
                         f"{[tuple(t.shape) for t in planes]}")
    *lead, nS, n = shape
    if scales.shape != (nS,) or not scales.is_contiguous():
        raise ValueError(f"the scales are a contiguous ({nS},) tensor, got "
                         f"{tuple(scales.shape)}")
    layout = _layout(w1r)
    if layout is None or any(_layout(t) != layout for t in planes[1:]):
        raise ValueError("the planes share one layout whose leading dims merge into one, "
                         f"got strides {[t.stride() for t in planes]}")
    R = math.prod(lead)
    S = torch.empty(shape, dtype=torch.complex64, device=dev)
    C = torch.empty(shape, dtype=torch.complex64, device=dev)
    w12 = (torch.empty(shape, dtype=torch.float32, device=dev),
           torch.empty(shape, dtype=torch.float32, device=dev)) if cross else None
    if R * nS * n:
        with torch.cuda.device(dev):
            err = library("wct_head").wct_fields_head(
                *(t.data_ptr() for t in planes), scales.data_ptr(), S.data_ptr(),
                C.data_ptr(), *((t.data_ptr() for t in w12) if cross else (None, None)),
                R, nS, n, *layout, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"wct_fields_head launch failed: cudaError_t {err}")
        LAUNCHES["wct_fields_head"] += 1
        profiling.WCT_HEAD_KERNEL_POINTS += R * nS * n
    return S, C, w12

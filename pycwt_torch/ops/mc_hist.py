"""The Monte-Carlo chunk's counts on the card: ``csrc/mc_hist.cu``.

``coherence._mc_counts`` calls :func:`coherence_counts` for a chunk whose
smoothed fields lie on a CUDA device (the planar route); elsewhere it runs
the torch code, ``coherence._histogram`` of ``coherence._coherence_ratio``,
which is the kernel's plain version.  Both give the same counts, bit for
bit (the card tests hold the kernel against the torch code on the card).

One ``mc_coherence_counts`` launch reads the two smoothed complex64 fields
``S = S1 + i·S2`` and ``C = S12r + i·S12i`` once, computes R² in the torch
path's rounding order, its bin ``clip(floor(R²·1000), 0, 999)`` (NaN in bin
0) and adds the counts of the points outside the COI, over the members
below ``valid``, into the ``(P, S, 1000)`` int64 accumulator in place.
:data:`LAUNCHES` counts the launches, and ``profiling.MC_HIST_KERNEL_CELLS``
the points of the members it binned.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from ._build import library

__all__ = ["coherence_counts", "on_card", "LAUNCHES", "NBINS"]

#: Launches of the kernel in this process
LAUNCHES = {"mc_coherence_counts": 0}
#: Bins of a row's counts, fixed in the kernel (``coherence.NBINS``)
NBINS = 1000


def on_card(fields: torch.Tensor) -> bool:
    """Whether ``fields`` lie where the kernel runs: a CUDA device."""
    return fields.is_cuda


def coherence_counts(S: torch.Tensor, C: torch.Tensor, outsidecoi: torch.Tensor,
                     valid: int, acc: torch.Tensor) -> torch.Tensor:
    """Add the counts of the fields ``S``, ``C`` (complex64 ``(P, B, S, n)``,
    contiguous, on one CUDA device) outside the COI ``outsidecoi`` (bool
    ``(S, n)``) over members ``b < valid`` into ``acc`` (int64 ``(P, S,
    1000)``, contiguous), in place; returns ``acc``.

    Raises ``TypeError`` for another dtype and ``ValueError`` for another
    device, shape or layout.
    """
    if S.dtype != torch.complex64 or C.dtype != torch.complex64:
        raise TypeError(f"the fields are complex64, not {S.dtype} and {C.dtype}")
    if outsidecoi.dtype != torch.bool or acc.dtype != torch.int64:
        raise TypeError(f"the mask is bool and the counts int64, not {outsidecoi.dtype} "
                        f"and {acc.dtype}")
    dev = S.device
    if not on_card(S) or any(t.device != dev for t in (C, outsidecoi, acc)):
        raise ValueError("the fields, the mask and the counts lie on one CUDA device")
    if S.dim() != 4 or C.shape != S.shape:
        raise ValueError(f"the fields are two (P, B, S, n) tensors, got {tuple(S.shape)} "
                         f"and {tuple(C.shape)}")
    P, B, nS, n = S.shape
    if outsidecoi.shape != (nS, n) or acc.shape != (P, nS, NBINS):
        raise ValueError(f"the mask is ({nS}, {n}) and the counts ({P}, {nS}, {NBINS}), "
                         f"got {tuple(outsidecoi.shape)} and {tuple(acc.shape)}")
    if not all(t.is_contiguous() for t in (S, C, outsidecoi, acc)):
        raise ValueError("the fields, the mask and the counts must be contiguous")
    valid = int(valid)
    if not 0 <= valid <= B:
        raise ValueError(f"valid members {valid} outside [0, {B}]")
    if valid * n >= 1 << 31:
        raise ValueError(f"{valid} members of {n} points overflow a row's int32 counts")
    if valid and P * nS:
        with torch.cuda.device(dev):
            err = library("mc_hist").mc_coherence_counts(
                S.data_ptr(), C.data_ptr(), outsidecoi.data_ptr(), acc.data_ptr(),
                P, B, nS, n, valid, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mc_coherence_counts launch failed: cudaError_t {err}")
        LAUNCHES["mc_coherence_counts"] += 1
        profiling.MC_HIST_KERNEL_CELLS += P * valid * nS * n
    return acc

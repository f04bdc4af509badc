"""The Monte-Carlo surrogates' generator on the card: ``csrc/mc_noise.cu``.

``stats.fold_in``, ``stats.split``, ``stats.rednoise_members`` and
``stats.rednoise_members_pairs`` call these wrappers for a key that lies on
a CUDA device; for a CPU key they run their torch code, which is the
kernels' plain version.  Both give the same integer words, the same f64
normals and the same rows, bit for bit (the card tests hold the kernels
against the torch code on the card):

* :func:`fold_in` / :func:`split`: one ``mc_fold_in`` launch, the key read
  from device memory by pointer;
* :func:`rednoise`: one ``mc_rednoise`` launch for a chunk of surrogate
  rows, from the key words to the rows: each row's key, its threefry words,
  its f64 normals, the cast and the scale ``a``, and the AR(1) recurrence
  in ``_ar1_recurrence``'s rounding order, in place in the output rows.

They take f32 and f64 rows of a stationary AR(1) process (|g| < 1) and
raise for anything else: on the card there is no other road.  Each launch
runs on the key's card, whichever card is current.  :data:`LAUNCHES` counts
the launches, and ``profiling.MC_KERNEL_ROWS`` the rows drawn.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from ._build import library

__all__ = ["fold_in", "split", "rednoise", "LAUNCHES"]

#: Launches of each kernel in this process
LAUNCHES = {"mc_fold_in": 0, "mc_rednoise": 0}
#: nextafter(−1, +∞) and 1 − it, as ``stats._normal_f64`` computes them
_NORMAL_LO = float(np.nextafter(-1.0, np.inf))
_NORMAL_SCALE = 1.0 - _NORMAL_LO
_ENTRY = {torch.float32: "mc_rednoise_f32", torch.float64: "mc_rednoise_f64"}


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _key_words(key) -> tuple[torch.Tensor, torch.Tensor]:
    k0, k1 = key
    if k0.dtype != torch.int64 or k1.dtype != torch.int64 or k0.numel() != 1 \
            or k1.numel() != 1 or k0.device != k1.device or k0.device.type != "cuda":
        raise ValueError("a key is two one-element int64 tensors on one CUDA device")
    return k0, k1


def _indices(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.int64, device=device).contiguous()


def _fold(key, data: torch.Tensor | None, count: int) -> torch.Tensor:
    """(2, count) int64: the words of threefry2x32(key, (0, data[j]))."""
    k0, k1 = _key_words(key)
    dev = k0.device
    out = torch.empty((2, count), dtype=torch.int64, device=dev)
    if count:
        with torch.cuda.device(dev):
            err = library("mc_noise").mc_fold_in(
                k0.data_ptr(), k1.data_ptr(), None if data is None else data.data_ptr(),
                count, out.data_ptr(), out.data_ptr() + 8 * count,
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "mc_fold_in")
        LAUNCHES["mc_fold_in"] += 1
    return out


def fold_in(key, data):
    """``stats.fold_in`` on the card: one key per element of ``data`` (an
    int64 tensor or int), as two int64 tensors of ``data``'s shape."""
    data = _indices(data, key[0].device)
    out = _fold(key, data, data.numel())
    return out[0].view(data.shape), out[1].view(data.shape)


def split(key, num: int = 2):
    """``stats.split`` on the card: keys ``fold_in(key, j)``, j < ``num``."""
    k0, k1 = _fold(key, None, int(num))
    return [(k0[j], k1[j]) for j in range(num)]


def rednoise(base_key, member_idx, shape_n: int, tau: int, g, *, a: float = 1.0,
             dtype=torch.float32, slots=None):
    """Surrogate rows on the card, each from its own stream.

    One stream level (``slots=None``): row m is keyed ``fold_in(base_key,
    member_idx[m])``, ``g`` is a float, and ``g == 0`` skips the recurrence;
    returns ``(M, shape_n)``.  Two levels: row (p, m) is keyed
    ``fold_in(fold_in(base_key, slots[p]), member_idx[m])``, ``g`` is a
    ``(P,)`` tensor of ``dtype`` on the key's device, and every row runs the
    recurrence; returns ``(P, M, shape_n)``.  Either is the view ``[..., tau:]``
    of rows of ``shape_n + tau`` values, as the torch path returns it.

    Raises ``TypeError`` for rows other than f32 and f64, and ``ValueError``
    for a one-level ``g`` with |g| ≥ 1 or a negative ``tau``.
    """
    k0, k1 = _key_words(base_key)
    dev = k0.device
    if dtype not in _ENTRY:
        raise TypeError(f"mc_rednoise draws float32 or float64 rows, not {dtype}")
    idx = _indices(member_idx, dev)
    if idx.dim() != 1:
        raise ValueError(f"member indices are one row, got shape {tuple(idx.shape)}")
    L = int(shape_n) + int(tau)
    if slots is None and not abs(float(g)) < 1.0:
        raise ValueError(f"mc_rednoise draws stationary AR(1) rows, |g| < 1, not g = {g}")
    if tau < 0 or shape_n < 1:
        raise ValueError(f"a surrogate needs shape_n >= 1 and tau >= 0, got {shape_n}, {tau}")
    members = idx.numel()
    if slots is None:
        pairs, slot_t, g_rows, g_val, scan = 1, None, None, float(g), float(g) != 0.0
    else:
        slot_t = _indices(slots, dev)
        g_rows = torch.as_tensor(g, dtype=dtype, device=dev).contiguous()
        if slot_t.dim() != 1 or g_rows.shape != slot_t.shape:
            raise ValueError("slots and g are (P,) tensors of one length")
        pairs, g_val, scan = slot_t.numel(), 0.0, True
    rows = pairs * members
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed a CUDA grid; draw fewer members a chunk")
    out = torch.empty((rows, L), dtype=dtype, device=dev)
    if rows:
        with torch.cuda.device(dev):
            err = getattr(library("mc_noise"), _ENTRY[dtype])(
                k0.data_ptr(), k1.data_ptr(),
                None if slot_t is None else slot_t.data_ptr(), idx.data_ptr(),
                rows, members, L, int(tau), g_val,
                None if g_rows is None else g_rows.data_ptr(), float(a),
                _NORMAL_SCALE, _NORMAL_LO, int(scan), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, _ENTRY[dtype])
        LAUNCHES["mc_rednoise"] += 1
        profiling.MC_KERNEL_ROWS += rows
    if slots is not None:
        out = out.view(pairs, members, L)
    return out[..., tau:] if tau else out


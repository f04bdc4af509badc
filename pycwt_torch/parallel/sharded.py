"""Sharded transforms over a ``(data × scale × mc)`` DeviceMesh.

Counterpart of ``pycwt_tpu/parallel/sharded.py``.  Each JAX ``shard_map`` or
sharded ``jit`` becomes the same per-device function run on every rank:

* **inputs** — every rank passes the same global input (as every JAX
  process hands the same host array to ``device_put``) and cuts its own
  block by its mesh coordinates;
* **compute** — the rank's block goes through the single-device port
  (``cwt_batch``, ``_wct_core``, the Monte-Carlo chunk), so the card's
  kernels (``cwt_stage_a``/``cwt_stage_b``, or ``cwt_direct`` where opted
  in) run on every rank;
* **collectives** — ``psum`` over ``scale`` for the inverse transform and
  the scale-averaged power, the halo ``shift`` of the scale boxcar, one
  ``psum`` over ``mc`` of the integer Monte-Carlo counts
  (``parallel._collectives``);
* **outputs** — ``DTensor``s whose placements mirror JAX's
  ``PartitionSpec``: ``P('data', 'scale', None)`` is ``[Shard(0), Shard(1),
  Replicate()]``.  ``.to_local()`` is this rank's block, ``.full_tensor()``
  the global array (a collective).

Every check runs on the host, on every rank, before the first collective,
so a bad call raises everywhere instead of leaving ranks waiting.

Divisibility: the scale axis shards the filter-bank rows; S must divide by
the 'scale' dim (pad the grid with :func:`pad_scales` and pass the true
count, whose padded rows are masked out of reductions).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CWTConfig
from ..mothers import Mother
from ..ops.smoothing import _boxcar_halos, _scale_window, smooth_scale_sharded
from ..transform import cwt_batch, icwt_batch
from ._collectives import axis_rank, axis_size, mesh_device, psum, to_dtensor
from ._collectives import block as _block

__all__ = [
    "pad_scales",
    "sharded_cwt",
    "sharded_power_pipeline",
    "sharded_wct",
    "sharded_wct_pairs",
    "sharded_wct_matrix",
    "sharded_mc_histogram",
    "sharded_mc_histogram_pairs",
]

_DS = {"data": 0, "scale": 1}        # P('data', 'scale', ...)


def pad_scales(scales: np.ndarray, parts: int) -> tuple[np.ndarray, int]:
    """Pad the scale vector so its length divides the 'scale' mesh axis.

    Padded entries replicate the last scale; callers mask them out of
    reductions using the returned true length.
    """
    scales = np.asarray(scales)
    S = len(scales)
    rem = (-S) % parts
    if rem:
        scales = np.concatenate([scales, np.full(rem, scales[-1])])
    return scales, S


def _on(mesh, x, dtype=None) -> torch.Tensor:
    """``x`` (array-like or tensor) on the mesh's device; floating inputs
    keep their dtype unless ``dtype`` is given."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=mesh_device(mesh), dtype=dtype)


def _divides(n: int, parts: int, what: str, dim: str) -> None:
    if n % parts:
        raise ValueError(f"{what} ({n}) not divisible by the '{dim}' axis ({parts})")


def _normalized_rows(y: torch.Tensor) -> torch.Tensor:
    return (y - y.mean(-1, keepdim=True)) / y.std(-1, correction=0, keepdim=True)


def sharded_cwt(mesh, signals, scales, dt, *, mother: Mother, nfft: int,
                engine: str | None = None):
    """Batched CWT with the batch on 'data' and the filter-bank rows on
    'scale': each rank transforms its batch block at its scale rows
    (``cwt_batch`` on the rank's device: the kernels on a card), with no
    communication.  Returns ``(W, signal_ft)``: ``W[b, s, t]`` sharded
    ``P('data', 'scale', None)``, the spectra ``P('data', None)``."""
    x = _on(mesh, signals)
    sc = _on(mesh, scales, x.dtype)
    _divides(x.shape[0], axis_size(mesh, "data"), "batch", "data")
    _divides(sc.shape[0], axis_size(mesh, "scale"), "scales", "scale")
    W, ft = cwt_batch(_block(x, mesh, "data", 0), _block(sc, mesh, "scale", 0), dt,
                      mother=mother, nfft=nfft, config=CWTConfig(dtype=x.dtype),
                      engine=engine)
    return to_dtensor(W, mesh, _DS), to_dtensor(ft, mesh, {"data": 0})


def sharded_power_pipeline(mesh, signals, scales, dt, dj, *,
                           mother: Mother, nfft: int, n_true_scales: int,
                           engine: str | None = None):
    """The flagship analysis step, sharded: normalize → CWT → power →
    global wavelet spectrum (time mean) → inverse CWT (psum over 'scale')
    → scale-averaged power (TC98 eq. 24, psum over 'scale').

    Rows at or past ``n_true_scales`` (padding) are left out of both sums.
    Returns ``(power, global_ws, iwave, scale_avg)`` sharded ``P('data',
    'scale', None)``, ``P('data', 'scale')``, ``P('data', None)`` and
    ``P('data', None)``.
    """
    x = _on(mesh, signals)
    sc = _on(mesh, scales, x.dtype)
    _divides(x.shape[0], axis_size(mesh, "data"), "batch", "data")
    _divides(sc.shape[0], axis_size(mesh, "scale"), "scales", "scale")
    xl = _normalized_rows(_block(x, mesh, "data", 0))
    sj = _block(sc, mesh, "scale", 0)
    S_loc = sj.shape[0]
    row = axis_rank(mesh, "scale") * S_loc + torch.arange(S_loc, device=sj.device)
    mask = (row < n_true_scales)[:, None]
    W, _ = cwt_batch(xl, sj, dt, mother=mother, nfft=nfft,
                     config=CWTConfig(dtype=x.dtype), engine=engine)
    power = W.abs() ** 2
    global_ws = power.mean(-1)
    zero = torch.zeros((), dtype=W.dtype, device=W.device)
    iw = psum(icwt_batch(torch.where(mask, W, zero), sj, dt, dj, mother=mother),
              mesh, "scale")
    cd = mother.cdelta if mother.cdelta != -1 else 1.0
    scale_avg = psum((dj * dt / cd) * torch.sum(
        torch.where(mask, power, 0.0) / sj[:, None], dim=-2), mesh, "scale")
    return (to_dtensor(power, mesh, _DS), to_dtensor(global_ws, mesh, _DS),
            to_dtensor(iw, mesh, {"data": 0}), to_dtensor(scale_avg, mesh, {"data": 0}))


def sharded_wct(mesh, y1, y2, scales, dt, dj, *, mother: Mother, nfft: int,
                engine: str | None = None, n_true_scales: int | None = None):
    """Batched wavelet coherence sharded over 'data' and, when the mesh's
    'scale' dim is > 1, over 'scale': output ``P('data', 'scale', None)``.

    With one 'scale' rank each rank runs ``_wct_core`` on its batch block
    (the planar kernels' route for f32 on the card, whose ``W12`` is the
    planar pair).  With scales sharded, each rank computes its scale rows'
    CWTs (``cwt_batch``) and time smoothing, and the scale boxcar
    exchanges halo rows with the neighbouring ranks
    (:func:`pycwt_torch.ops.smoothing.smooth_scale_sharded`).

    ``scales`` must be padded to a multiple of the 'scale' dim
    (:func:`pad_scales`); pass the true count as ``n_true_scales`` so the
    padded rows are masked to the zero padding the unsharded 'same'
    convolution sees.  Rows ≥ ``n_true_scales`` of the output are garbage —
    slice them off.  Returns ``(WCT, aWCT, W12)``.
    """
    from ..coherence import _wct_core

    dt = float(dt)
    n_scale = axis_size(mesh, "scale")
    a = _on(mesh, y1)
    b = _on(mesh, y2, a.dtype)
    sc = _on(mesh, scales, a.dtype)
    _divides(a.shape[0], axis_size(mesh, "data"), "batch", "data")
    a, b = _block(a, mesh, "data", 0), _block(b, mesh, "data", 0)

    if n_scale == 1:
        R, A, W12 = _wct_core(a, b, sc, dt, mother=mother, nfft=nfft, dj=dj,
                              engine=engine)
        out = lambda t: to_dtensor(t, mesh, {"data": 0})        # noqa: E731
        return out(R), out(A), (tuple(map(out, W12)) if isinstance(W12, tuple)
                                else out(W12))

    S_pad = sc.shape[0]
    if S_pad % n_scale:
        raise ValueError(
            f"{S_pad} scales not divisible by scale-axis size {n_scale}; "
            "use pad_scales()")
    _boxcar_halos(len(_scale_window(mother, dj)), S_pad // n_scale)
    n_true = S_pad if n_true_scales is None else n_true_scales
    sj = _block(sc, mesh, "scale", 0)
    cfg = CWTConfig(dtype=a.dtype)
    W1, _ = cwt_batch(a, sj, dt, mother=mother, nfft=nfft, config=cfg, engine=engine)
    W2, _ = cwt_batch(b, sj, dt, mother=mother, nfft=nfft, config=cfg, engine=engine)
    s_col = sj[:, None]
    kw = dict(axis_name="scale", n_true_scales=n_true, engine=engine, mesh=mesh)
    S1 = smooth_scale_sharded(W1.abs() ** 2 / s_col, dt, dj, sj, mother, **kw)
    S2 = smooth_scale_sharded(W2.abs() ** 2 / s_col, dt, dj, sj, mother, **kw)
    W12 = W1 * torch.conj(W2)
    S12 = smooth_scale_sharded(W12 / s_col, dt, dj, sj, mother, **kw)
    WCT = S12.abs() ** 2 / (S1 * S2)
    return (to_dtensor(WCT, mesh, _DS), to_dtensor(torch.angle(W12), mesh, _DS),
            to_dtensor(W12, mesh, _DS))


def sharded_wct_pairs(mesh, y1, y2, scales, dt, dj, *,
                      mother: Mother, nfft: int, engine: str | None = None):
    """``B`` independent coherence pairs data-parallel over the mesh: each
    rank runs the whole WCT pipeline (``_wct_core``) on its block of pairs
    with the scale grid replicated, with no communication.  Each pair is
    normalized on its own.  Returns ``(WCT, aWCT)`` sharded ``P('data',
    None, None)``."""
    from ..coherence import _wct_core

    a = _on(mesh, y1)
    b = _on(mesh, y2, a.dtype)
    _divides(a.shape[0], axis_size(mesh, "data"), "pairs", "data")
    a = _normalized_rows(_block(a, mesh, "data", 0))
    b = _normalized_rows(_block(b, mesh, "data", 0))
    WCT, aWCT, _ = _wct_core(a, b, _on(mesh, scales, a.dtype), dt, mother=mother,
                             nfft=nfft, dj=dj, engine=engine)
    return to_dtensor(WCT, mesh, {"data": 0}), to_dtensor(aWCT, mesh, {"data": 0})


def sharded_wct_matrix(mesh, y, pairs, scales, dt, dj, *,
                       mother: Mother, nfft: int, engine: str | None = None,
                       block: int = 8, axis_name: str = "data",
                       precision: str = "high"):
    """All-pairs coherence (:func:`pycwt_torch.coherence.wct_matrix`'s core,
    ``_wct_matrix_blocks``) with the PAIR axis sharded over ``axis_name``:
    every rank holds the whole signal set, computes its transforms and
    self-smoothings once, and runs its block of the pair list in blocks of
    ``block`` pairs, with no communication.

    ``y``: ``(B, n0)`` raw signals (normalized per signal); ``pairs``:
    ``(P, 2)`` indices with ``P`` divisible by ``n_devices·block``.  Returns
    ``(WCT, aWCT)`` sharded ``P(axis_name, None, None)``.
    """
    from ..coherence import _wct_matrix_blocks

    pairs = np.asarray(pairs, np.int64)
    B = np.shape(y)[0]
    if pairs.size and (pairs.min() < 0 or pairs.max() >= B):
        raise ValueError(f"pair indices out of range for B={B} signals")
    D = axis_size(mesh, axis_name)
    if pairs.shape[0] % (D * block):
        raise ValueError(
            f"pair count {pairs.shape[0]} must be divisible by "
            f"n_devices*block = {D * block} (pad by repeating pairs)")
    yt = _on(mesh, y)
    mine = _block(_on(mesh, pairs), mesh, axis_name, 0)
    R, A = _wct_matrix_blocks(_normalized_rows(yt), mine[:, 0], mine[:, 1],
                              _on(mesh, scales, yt.dtype), dt, mother=mother,
                              nfft=nfft, dj=dj, engine=engine, block=block,
                              precision=precision)
    return to_dtensor(R, mesh, {axis_name: 0}), to_dtensor(A, mesh, {axis_name: 0})


def sharded_mc_histogram(mesh, key, scales, outsidecoi, dt, *,
                         mother: Mother, nfft: int, dj: float,
                         per_device_batch: int, n: int, al1: float, al2: float,
                         nbins: int = 1000, engine: str | None = None):
    """Monte-Carlo coherence histogram sharded over 'mc'.

    Each rank runs one chunk of ``per_device_batch`` AR(1) surrogate pairs
    (``coherence._mc_histogram_chunk``: the whole CWT → smoothing →
    coherence pipeline, counted in ``(S, NBINS)`` integers outside the COI)
    and one ``psum`` over 'mc' reduces the counts.  Members are keyed by
    their *global* ensemble index (``rank·per_device_batch + arange``,
    through :func:`pycwt_torch.stats.rednoise_members`), so the counts are
    bit-identical across every 'mc' factorization of the same total and to
    the single-device chunks of ``coherence.wct_significance``.  ``nbins``
    must be ``NBINS`` (1000).  Returns the int64 counts, replicated
    (``P()``).
    """
    from ..coherence import NBINS, _mc_histogram_chunk

    if nbins != NBINS:
        raise ValueError(f"nbins must be {NBINS}, the bins the counts are kept in, "
                         f"got {nbins}")
    dev = mesh_device(mesh)
    sj = _on(mesh, scales)
    oc = _on(mesh, outsidecoi).to(torch.bool)
    key = tuple(k.to(dev) for k in key)
    start = axis_rank(mesh, "mc") * per_device_batch
    hist = _mc_histogram_chunk(key, start, sj, oc, dt, mother=mother, nfft=nfft, dj=dj,
                               batch=per_device_batch, n=n, al1=al1, al2=al2,
                               engine=engine)
    return to_dtensor(psum(hist, mesh, "mc"), mesh, {})


def sharded_mc_histogram_pairs(mesh, key, scales, outsidecoi, slots,
                               g1, g2, mc_count, dt, *, mother: Mother,
                               nfft: int, dj: float, batch: int, nchunks: int,
                               n: int, tau: int, engine: str | None = None,
                               axis_name: str = "mc"):
    """Distinct-null Monte-Carlo counts with the NULL axis sharded over
    ``axis_name``: each rank runs the whole ensemble for its block of null
    slots (``coherence._mc_histogram_run_pairs``), with no communication.
    Member streams are keyed by (slot, global member index), so the result
    is bit-identical to the single-device run over the same slots for any
    mesh factorization.  ``len(slots)`` must divide by the dim's size (pad
    with repeats of the last slot and drop the tail).  Returns ``(P, S,
    NBINS)`` int64 counts sharded ``P(axis_name)``.
    """
    from ..coherence import _mc_histogram_run_pairs

    D = axis_size(mesh, axis_name)
    if len(slots) % D:
        raise ValueError(
            f"slots ({len(slots)}) must divide the '{axis_name}' axis ({D});"
            " pad with repeats of the last slot and drop the tail rows")
    dev = mesh_device(mesh)
    sj = _on(mesh, scales)
    mine = lambda x, dtype=None: _block(_on(mesh, x, dtype), mesh, axis_name, 0)  # noqa: E731
    counts = _mc_histogram_run_pairs(
        tuple(k.to(dev) for k in key), sj, _on(mesh, outsidecoi).to(torch.bool),
        mine(np.asarray(slots, np.int64)), mine(g1, sj.dtype), mine(g2, sj.dtype),
        int(mc_count), dt, mother=mother, nfft=nfft, dj=dj, batch=batch,
        nchunks=nchunks, n=n, tau=tau, engine=engine)
    return to_dtensor(counts, mesh, {axis_name: 0})

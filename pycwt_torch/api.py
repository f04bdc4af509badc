"""pycwt-compatible user API on PyTorch.

Counterpart of ``pycwt_tpu/api.py``: the same names, signatures, defaults
and return conventions (``cwt``, ``cwt_power``, ``icwt``, and
``significance``, implemented in :mod:`pycwt_torch.stats`).  Inputs are
numpy/array-likes and outputs numpy arrays; the transform runs on
``device``, which defaults to ``"cuda"``.  Without a card the call raises
and names ``device="cpu"``: there is no silent CPU run.  ``icwt`` stays host
numpy, as in the JAX package.

Grids come from ``transform._host_grid``.  ``cwt_power`` asks
``ops/fft._planar_route``; on the planar route it, ``cwt_analysis`` and
``xwt_planar`` run :func:`_cwt_planar_parts`: the grid, the kernels' one
entry ``ops/fused_cwt._planar_cwt_of_real``, the COI while they run, the
trim.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .config import DEFAULT, CWTConfig
from .mothers import as_mother
from .stats import significance  # noqa: F401  (re-exported, implemented in stats)
from .transform import _host_grid, cwt_batch
from .utils import profiling
from .utils.profiling import span

__all__ = ["cwt", "cwt_power", "icwt", "significance"]


def _resolve_device(device) -> torch.device:
    """``None`` means the card; asking for it without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "transform on the CPU")
    return device


def _quarter_of_ram() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4
    except (AttributeError, ValueError, OSError):
        return 0


#: a result of at least this many bytes comes home through page-locked
#: memory: on an H100 this fetch beats a fresh pageable one from 256 KiB up
#: and loses at 128 KiB and below (the probe in PERF.md §6), so a ~45 KB
#: coherence map stays on the pageable path
_PINNED_MIN_BYTES = 1 << 18
#: the most page-locked memory torch's host allocator may hold in this
#: process when a fetch asks it for a block: its cache keeps a freed block
#: until the process ends or the cache is emptied
_PINNED_CAP_BYTES = _quarter_of_ram()


def _pool_bytes() -> int:
    """Bytes of the blocks torch's caching host allocator holds, free or in
    use."""
    stats = torch.cuda.memory.host_memory_stats_as_nested_dict()
    return stats.get("allocated_bytes", {}).get("current", 0)


def _pinned(t: torch.Tensor):
    """``t`` copied into a page-locked block of torch's caching host
    allocator, as a numpy view of it; the block goes back to the cache when
    the array dies, so the next fetch of its size finds it faulted in.
    Where the block (rounded up to a power of two, as the allocator does)
    could take the pool past :data:`_PINNED_CAP_BYTES`, the cache's idle
    blocks go back to the system first.  None where ``t`` is under
    :data:`_PINNED_MIN_BYTES`, where the blocks in use leave no room under
    the cap, or where the allocation fails."""
    nbytes = t.numel() * t.element_size()
    if nbytes < _PINNED_MIN_BYTES:
        return None
    size = 1 << (nbytes - 1).bit_length()
    if _pool_bytes() + size > _PINNED_CAP_BYTES:
        torch._C._host_emptyCache()     # what torch.cuda.graphs calls too
        if _pool_bytes() + size > _PINNED_CAP_BYTES:
            return None
    try:
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    except RuntimeError:
        return None
    dst.copy_(t)        # blocking: the call ends synchronised
    profiling.HOST_PINNED_FETCHES += 1
    return dst.numpy()  # holds the block until the array and its views die


@span("fetch")
def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    out = _pinned(t) if t.is_cuda else None
    if out is None:
        out = t.cpu().numpy()
    profiling.HOST_BYTES += out.nbytes
    return out


def _upload(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)`` of a host array,
    its bytes as the device holds them added to ``profiling.UPLOAD_BYTES``.
    The caller puts its copies in one span ``upload``."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    profiling.UPLOAD_BYTES += t.numel() * t.element_size()
    return t


def cwt(signal, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet", freqs=None,
        config: CWTConfig = DEFAULT, device=None):
    """Continuous wavelet transform of a 1-D signal.

    Returns ``(W, sj, freqs, coi, fft, fftfreqs)`` with ``W`` of shape
    ``(n_scales, n0)``, pow-2 padded FFTs, Bartlett-triangle COI, and the
    normalized one-sided signal spectrum.  The reference's data-dependent
    NaN-row drop is decided host-side from the mother's overflow criterion.
    """
    out, g = _cwt_parts(signal, dt, dj, s0, J, wavelet, freqs, config, device)
    return out + (g.ftfreqs[1 : g.nfft // 2] / (2 * np.pi),)


def _cwt_parts(signal, dt, dj, s0, J, wavelet, freqs, config, device):
    """:func:`cwt`'s ``(W, sj, freqs, coi, fft)`` and its host grid, whose
    angular frequencies are built only where the caller reads them."""
    device = _resolve_device(device)
    mother = as_mother(wavelet)
    signal = np.asarray(signal)
    g = _host_grid(len(signal), dt, dj, s0, J, mother, config.fft_length, freqs)

    # f64 rows: the kernels' route takes their spectrum in f64 and rounds it
    # once; the other routes round the rows to config.real_dtype first
    with span("upload"):
        x = _upload(signal[None, :], device, torch.float64)
        sj = _upload(g.sj, device)
    W, signal_ft = cwt_batch(x, sj, dt, mother=mother, nfft=g.nfft,
                             config=config)
    coi = g.coi     # built while the device runs
    W = _host(W[0])
    signal_ft = _host(signal_ft[0])
    return (W, g.sj, g.freqs, coi, signal_ft[1 : g.nfft // 2] / g.nfft ** 0.5), g


def _cwt_planar_parts(signal, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
                      freqs=None, config: CWTConfig = DEFAULT,
                      output: str = "planes", device=None):
    """The :func:`cwt` pipeline on the planar route (same grid/COI/NaN-row
    semantics as :func:`cwt`): the host grid, ``_planar_cwt_of_real`` on the
    record's f64 row, the trim to ``n0``.  ``output="planes"`` returns
    ``(wr, wi, sj, freqs, coi)`` with each plane ``(n_scales, n0)`` f32;
    ``output="power"`` returns ``(power, sj, freqs, coi)`` with |W|²
    written by the kernel's epilogue.  Needs a pow-2 ``nfft``; f32 planes
    whatever ``config.dtype`` says."""
    from .ops.fused_cwt import _planar_cwt_of_real

    device = _resolve_device(device)
    mother = as_mother(wavelet)
    signal = np.asarray(signal)
    n0 = len(signal)
    g = _host_grid(n0, dt, dj, s0, J, mother, config.fft_length, freqs)
    with span("upload"):
        x = _upload(signal, device, torch.float64)
        sj = _upload(g.sj, device, torch.float32)
    out = _planar_cwt_of_real(x, sj, mother=mother, nfft=g.nfft, dt=dt,
                              precision=config.precision, output=output)
    coi = g.coi     # built while the kernels run
    if output == "power":
        return _host(out[:, :n0]), g.sj, g.freqs, coi
    wr, wi = out
    return _host(wr[:, :n0]), _host(wi[:, :n0]), g.sj, g.freqs, coi


@span("cwt_power")
def cwt_power(signal, dt, dj=1 / 12, s0=-1, J=-1, wavelet="morlet",
              freqs=None, config: CWTConfig = DEFAULT, device=None):
    """Wavelet power ``|W|²``, same grid/COI/NaN-row semantics as
    :func:`cwt`.  On the planar route (engine ``"planar"``, the CUDA default
    for f32, and a pow-2 ``nfft``) the kernels write |W|² in their epilogue,
    so W never leaves the card; below the kernels' 2^8 their plain version
    does.

    Returns ``(power, sj, freqs, coi)`` with ``power`` of shape
    ``(n_scales, n0)``.
    """
    from .ops.fft import _planar_route

    device = _resolve_device(device)
    signal = np.asarray(signal)
    if _planar_route(config.engine, device, config.real_dtype,
                     config.fft_length(len(signal))):
        return _cwt_planar_parts(signal, dt, dj=dj, s0=s0, J=J,
                                 wavelet=wavelet, freqs=freqs, config=config,
                                 output="power", device=device)
    (W, sj, out_freqs, coi, _), _ = _cwt_parts(signal, dt, dj, s0, J, wavelet,
                                               freqs, config, device)
    return np.abs(W) ** 2, sj, out_freqs, coi


def icwt(W, sj, dt, dj=1 / 12, wavelet="morlet"):
    """Inverse continuous wavelet transform, TC98 eq. 11, on the host.

    Replicates the reference's orientation auto-detection and summation,
    including the ``Warning`` raised on a shape mismatch.
    """
    mother = as_mother(wavelet)
    W = np.asarray(W)
    sj = np.asarray(sj)

    a, b = W.shape
    c = sj.size
    if a == c:
        sj_mat = (np.ones([b, 1]) * sj).transpose()
    elif b == c:
        sj_mat = np.ones([a, 1]) * sj
    else:
        raise Warning("Input array dimensions do not match.")

    psi0 = mother.psi0()
    if isinstance(psi0, complex) and psi0.imag == 0:
        psi0 = psi0.real
    return (
        dj
        * np.sqrt(dt)
        / (mother.cdelta * psi0)
        * (np.real(W) / np.sqrt(sj_mat)).sum(axis=0)
    )

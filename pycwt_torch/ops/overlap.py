"""Overlap-save blocked CWT, XWT and WCT of long signals on one device.

Counterpart of the single-device surfaces of ``pycwt_tpu/ops/overlap.py``.
The global transform pads the whole signal to one power of two and holds the
(S × nfft) transform and its intermediates at once; here the time axis is cut
into chunks and each chunk is transformed on its own — the classic
overlap-save scheme, with the halo sized by the mother wavelet's e-folding
support at the largest scale:

    halo = ceil(ζ · s_max / dt) samples,  ζ = sqrt(−2·ln ε)

Interior outputs match the global transform to round-off; the outer ``halo``
samples of the first and last chunk follow zero-padding semantics, inside
the cone of influence either way.

The chunks run in a Python loop: each chunk's slab of ``chunk + 2·halo``
samples goes through the transform and its interior ``[H, H + chunk)`` is
written in place into one preallocated ``(S, n_chunks·chunk)`` output, so
the peak memory is the output plus ONE chunk's workspace.  On a CUDA f32
signal the planar surfaces' chunk transforms are ``fft_of_real_planar`` →
``fused_cwt_planar``: two kernel launches (``cwt_stage_a``, ``cwt_stage_b``)
a chunk and signal.  :func:`streamed_global_power` and its planar variant
keep only the ``(S,)`` accumulator of Σ_t |W|², independent of N.

Each single-device surface is one span of the recorder
(``utils/profiling.py``): ``wct_overlap`` for :func:`wct_overlap_planar`,
the function's own name for the others; inside it ``upload`` holds the
host→device copies of the signals and scales (their bytes in
``profiling.UPLOAD_BYTES``) and ``overlap.chunks`` the chunk loop, whose
own time is the host's enqueue of the chunks' work.  Each chunk of the
loop (not the one global transform of a signal no longer than a chunk)
adds 1 to ``profiling.OVERLAP_CHUNKS``, ``S·nfft_c`` a signal to
``OVERLAP_POINTS`` and ``S`` × its interior samples kept (the last
chunk's zero tail left out) a signal to ``OVERLAP_INTERIOR_POINTS``:
their ratio is the share of the transformed points the output keeps,
``chunk / nfft_c`` with ``nfft_c = pow2(chunk + 2·halo)``.

**Near-Nyquist caveat.** For scales where the mother's spectrum is still
large at the Nyquist frequency (Morlet-6 at the TC98 default smallest scale
``s0 = 2dt/λ`` has ψ̂(s·π/dt) ≈ 0.96), the frequency-truncated filter's
impulse response rings with only ~1/t decay, so any finite halo leaves
blocked-vs-global differences of order ψ̂(s·Ω_nyq)/t.  Scales with
``s ≳ 4dt`` agree with the global transform to f32 round-off; the finest one
or two scales agree to ~1e-2 relative.

Entry points take ``device=None``: a tensor's own device, else the card.
The time-sharded surfaces (:func:`sharded_cwt_overlap_save`,
:func:`sharded_wct_overlap_planar`) run one ``torch.distributed`` rank per
device over a ``pycwt_torch.parallel`` mesh: each rank holds a contiguous
slab of the signal, takes the halo from its neighbours in one exchange
(zeros at the global edges, the global transform's zero padding), and runs
the same chunk loop on its slab.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..config import next_pow2
from ..mothers import Mother
from ..transform import cwt_batch
from ..utils import profiling
from ..utils.profiling import span
from .fused_cwt import _planar_cwt_of_real

__all__ = [
    "halo_samples",
    "cwt_overlap_save",
    "cwt_overlap_save_planar",
    "streamed_global_power",
    "streamed_global_power_planar",
    "sharded_cwt_overlap_save",
    "wct_overlap_planar",
    "sharded_wct_overlap_planar",
    "xwt_overlap_planar",
]


def halo_samples(max_scale: float, dt: float, eps: float = 1e-7) -> int:
    """Samples of wavelet support to overlap: ζ·s_max/dt, ζ = sqrt(−2 ln ε)."""
    zeta = math.sqrt(-2.0 * math.log(eps))
    return int(math.ceil(zeta * max_scale / dt))


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def _warn_near_nyquist(scales, dt: float, mother: Mother,
                       tol: float = 1e-3) -> None:
    """Warn where the mother's spectrum is non-negligible at the Nyquist
    frequency for the finest scale: the blocked transform there agrees with
    the global one only to ~1e-2 (the near-Nyquist caveat above).  TC98
    default grids (``s0 = 2dt/λ``) warn; ``s ≳ 4dt`` grids do not."""
    sj = _host_f64(scales).ravel()
    env = mother.psi_ft_envelope(
        torch.as_tensor(sj * math.pi / dt, dtype=torch.float32)).numpy()
    worst = int(np.argmax(env))
    if env[worst] > tol:
        warnings.warn(
            f"overlap-save: scale {sj[worst]:.4g} has |psi_ft| = "
            f"{env[worst]:.2g} at the Nyquist frequency; its blocked "
            f"transform agrees with the global one only to ~1e-2 relative "
            f"near the edges of each chunk (scales >= ~4*dt = {4 * dt:.4g} "
            "agree to round-off). See pycwt_torch/ops/overlap.py near-Nyquist "
            "caveat.",
            stacklevel=4,
        )


def _halo(scales, dt: float, mother: Mother, eps: float, factor: int = 1,
          chunk: int | None = None) -> int:
    """``factor`` wavelet halos of the largest scale, after the near-Nyquist
    check; a ``chunk`` that is given must be positive."""
    H = factor * halo_samples(float(_host_f64(scales).max()), dt, eps)
    _warn_near_nyquist(scales, dt, mother)
    if chunk is not None and chunk <= 0:
        raise ValueError("chunk must be positive")
    return H


def _on_device(x, device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``; ``None`` is a tensor's own
    device, else the card (which raises without one)."""
    from ..api import _resolve_device

    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    else:
        device = _resolve_device(device)
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _uploaded(dtype: torch.dtype, device, first, *rest) -> list:
    """``first`` and ``rest`` as ``dtype`` tensors on one device
    (:func:`_on_device`: ``first``'s own, else ``device``), in one span
    ``upload``; each that was not a tensor already there adds its bytes,
    as the device holds them, to ``profiling.UPLOAD_BYTES``."""
    with span("upload"):
        out = [_on_device(first, device, dtype)]
        out += [_on_device(a, out[0].device, dtype) for a in rest]
    for a, t in zip((first, *rest), out):
        if not (isinstance(a, torch.Tensor) and a.device == t.device):
            profiling.UPLOAD_BYTES += t.numel() * t.element_size()
    return out


def _count_chunk(S: int, nfft: int, kept: int, signals: int) -> None:
    """One chunk's counters, counted whether the recorder is on or off:
    ``S·nfft`` transformed points and ``S·kept`` interior points for each
    of ``signals`` signals."""
    profiling.OVERLAP_CHUNKS += 1
    profiling.OVERLAP_POINTS += signals * S * nfft
    profiling.OVERLAP_INTERIOR_POINTS += signals * S * kept


def _pad_for_chunks(signal: torch.Tensor, chunk: int, H: int):
    N = signal.shape[-1]
    n_chunks = (N + chunk - 1) // chunk
    padded = signal.new_zeros(n_chunks * chunk + 2 * H)
    padded[H:H + N] = signal
    return padded, N, n_chunks


def _slab(padded: torch.Tensor, i: int, chunk: int, H: int) -> torch.Tensor:
    return padded[i * chunk:(i + 1) * chunk + 2 * H]


def cwt_overlap_save(signal, scales, dt: float, *, mother: Mother,
                     chunk: int = 1 << 18, eps: float = 1e-7,
                     engine: str | None = None, device=None):
    """Blocked CWT of a long 1-D signal with bounded working memory.

    Each chunk's ``(S × nfft_c)`` transform (``nfft_c = pow2(chunk +
    2·halo)``, through ``cwt_batch`` with ``engine``) is freed before the
    next, so the peak memory is the ``(S, N)`` output plus one chunk.
    Computes in ``torch.get_default_dtype()``.  Returns ``(S, N)`` complex
    W: interior samples (≥ halo from either end) equal the global
    transform's; a signal of at most ``chunk`` samples is one global
    transform.
    """
    rdt = torch.get_default_dtype()
    with span("cwt_overlap_save"):
        H = _halo(scales, dt, mother, eps, chunk=chunk)
        x, sc = _uploaded(rdt, device, signal, scales)
        kw = dict(mother=mother, engine=engine)
        N = x.shape[-1]
        if N <= chunk:
            W, _ = cwt_batch(x[None], sc, dt, nfft=next_pow2(N), **kw)
            return W[0]
        padded, N, n_chunks = _pad_for_chunks(x, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        out = None
        with span("overlap.chunks"):
            for i in range(n_chunks):
                W, _ = cwt_batch(_slab(padded, i, chunk, H)[None], sc, dt, nfft=nfft,
                                 **kw)
                if out is None:
                    out = W.new_empty((W.shape[1], n_chunks * chunk))
                out[:, i * chunk:(i + 1) * chunk] = W[0, :, H:H + chunk]
                _count_chunk(sc.shape[0], nfft, min(chunk, N - i * chunk), 1)
        return out[:, :N]


def streamed_global_power(signal, scales, dt: float, *, mother: Mother,
                          chunk: int = 1 << 18, eps: float = 1e-7,
                          engine: str | None = None, device=None):
    """Σ_t |W[s, t]|² of a long signal with peak memory ∝ chunk,
    independent of N (the TC98 eq. 22 numerator without the transform).
    Returns ``(S,)`` real; divide by N for the mean."""
    rdt = torch.get_default_dtype()
    with span("streamed_global_power"):
        H = _halo(scales, dt, mother, eps)
        x, sc = _uploaded(rdt, device, signal, scales)
        padded, N, n_chunks = _pad_for_chunks(x, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        acc = torch.zeros(sc.shape[0], dtype=rdt, device=x.device)
        with span("overlap.chunks"):
            for i in range(n_chunks):
                W, _ = cwt_batch(_slab(padded, i, chunk, H)[None], sc, dt,
                                 mother=mother, nfft=nfft, engine=engine)
                # the zero-pad tail of the last chunk stays out of the sum
                kept = min(chunk, N - i * chunk)
                acc += (W[0, :, H:H + kept].abs() ** 2).sum(-1)
                _count_chunk(sc.shape[0], nfft, kept, 1)
        return acc


def _slab_checks(N: int, n_dev: int, chunk: int, H: int, pad_hint: str = "") -> int:
    """The time-sharded surfaces' validation, on the host before any
    collective; returns the local slab length."""
    if N % n_dev:
        raise ValueError(f"N={N} not divisible by {n_dev} devices{pad_hint}")
    N_loc = N // n_dev
    if N_loc % chunk:
        raise ValueError(f"local slab {N_loc} not a multiple of chunk {chunk}")
    if H > N_loc:
        raise ValueError(f"halo {H} exceeds local slab {N_loc}; "
                         "use fewer shards or a larger slab")
    return N_loc


def _with_halo(slabs: torch.Tensor, mesh, axis_name: str, H: int) -> torch.Tensor:
    """``(..., N_loc)`` local slabs → ``(..., N_loc + 2H)``: the previous
    rank's last H samples, the slab, the next rank's first H (zeros at the
    global edges), in one exchange for all rows."""
    from ..parallel._collectives import shift

    return shift(slabs.movedim(-1, 0).contiguous(), mesh, axis_name, up=H,
                 down=H).movedim(0, -1).contiguous()


def sharded_cwt_overlap_save(mesh, signal, scales, dt: float, *,
                             mother: Mother, chunk: int = 1 << 16,
                             eps: float = 1e-7, engine: str | None = None,
                             axis_name: str = "data", auto_pad: bool = False):
    """Time-axis-SHARDED overlap-save CWT over the ``axis_name`` dim of
    ``mesh`` (every rank passes the same global ``(N,)`` signal and calls
    this together).

    Each rank owns a contiguous slab of N/n_dev samples (N must divide
    evenly and the slab must be a multiple of ``chunk``), exchanges
    ``halo`` edge samples with its neighbours (zeros at the global edges),
    then runs :func:`cwt_overlap_save`'s chunk loop on its slab with no
    further communication.  Computes in ``torch.get_default_dtype()``.
    Returns ``(S, N)`` complex W as a DTensor sharded ``P(None,
    axis_name)``; the ``(S, N)`` transform never exists on one rank.
    ``auto_pad`` zero-pads N up to a multiple of ``n_dev·chunk`` and trims
    the tail: the trimmed map's slabs are uneven, so it comes back
    replicated on every rank.
    """
    from ..parallel._collectives import (axis_size, block, gather, mesh_device,
                                         to_dtensor)

    rdt = torch.get_default_dtype()
    H = _halo(scales, dt, mother, eps)
    x = _on_device(signal, mesh_device(mesh), rdt)
    sc = torch.as_tensor(scales).to(device=x.device, dtype=rdt)
    N = x.shape[-1]
    n_dev = axis_size(mesh, axis_name)
    if auto_pad:
        step = n_dev * chunk
        N_pad = -(-N // step) * step
        if N_pad != N:
            W = sharded_cwt_overlap_save(
                mesh, torch.nn.functional.pad(x, (0, N_pad - N)), sc, dt,
                mother=mother, chunk=chunk, eps=eps, engine=engine,
                axis_name=axis_name)
            full = gather(W.to_local(), mesh, axis_name, axis=1)[:, :N]
            return to_dtensor(full.contiguous(), mesh, {})
    N_loc = _slab_checks(N, n_dev, chunk, H, " (pass auto_pad=True to zero-pad)")
    padded = _with_halo(block(x, mesh, axis_name, 0), mesh, axis_name, H)
    nfft = next_pow2(chunk + 2 * H)
    out = None
    for i in range(N_loc // chunk):
        W, _ = cwt_batch(_slab(padded, i, chunk, H)[None], sc, dt, mother=mother,
                         nfft=nfft, engine=engine)
        if out is None:
            out = W.new_empty((W.shape[1], N_loc))
        out[:, i * chunk:(i + 1) * chunk] = W[0, :, H:H + chunk]
    return to_dtensor(out, mesh, {axis_name: 1})


def cwt_overlap_save_planar(signal, scales, dt: float, *, mother: Mother,
                            chunk: int = 1 << 18, eps: float = 1e-7,
                            precision: str = "high", device=None):
    """:func:`cwt_overlap_save` on f32 planes: each chunk is
    ``fft_of_real_planar`` → ``fused_cwt_planar`` (the kernels on the
    card), and the output is the planar pair ``(wr, wi)``, each ``(S, N)``
    float32.  Same halo contract and near-Nyquist caveat."""
    with span("cwt_overlap_save_planar"):
        H = _halo(scales, dt, mother, eps, chunk=chunk)
        x, sc = _uploaded(torch.float32, device, signal, scales)
        kw = dict(mother=mother, dt=dt, precision=precision)
        N = x.shape[-1]
        if N <= chunk:
            wr, wi = _planar_cwt_of_real(x, sc, nfft=next_pow2(N), **kw)
            return wr[:, :N], wi[:, :N]
        padded, N, n_chunks = _pad_for_chunks(x, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        cr = torch.empty((sc.shape[0], n_chunks * chunk), dtype=torch.float32,
                         device=x.device)
        ci = torch.empty_like(cr)
        with span("overlap.chunks"):
            for i in range(n_chunks):
                wr, wi = _planar_cwt_of_real(_slab(padded, i, chunk, H), sc,
                                             nfft=nfft, **kw)
                cr[:, i * chunk:(i + 1) * chunk] = wr[:, H:H + chunk]
                ci[:, i * chunk:(i + 1) * chunk] = wi[:, H:H + chunk]
                _count_chunk(sc.shape[0], nfft, min(chunk, N - i * chunk), 1)
        return cr[:, :N], ci[:, :N]


def streamed_global_power_planar(signal, scales, dt: float, *,
                                 mother: Mother, chunk: int = 1 << 18,
                                 eps: float = 1e-7, precision: str = "high",
                                 device=None):
    """:func:`streamed_global_power` on f32 planes: each chunk's |W|² comes
    from the kernels' ``power`` epilogue and only the running ``(S,)``
    accumulator survives a chunk."""
    with span("streamed_global_power_planar"):
        H = _halo(scales, dt, mother, eps)
        x, sc = _uploaded(torch.float32, device, signal, scales)
        padded, N, n_chunks = _pad_for_chunks(x, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        acc = torch.zeros(sc.shape[0], dtype=torch.float32, device=x.device)
        with span("overlap.chunks"):
            for i in range(n_chunks):
                pw = _planar_cwt_of_real(_slab(padded, i, chunk, H), sc,
                                         mother=mother, nfft=nfft, dt=dt,
                                         precision=precision, output="power")
                kept = min(chunk, N - i * chunk)
                acc += pw[:, H:H + kept].sum(-1)
                _count_chunk(sc.shape[0], nfft, kept, 1)
        return acc


def _signal_pair(y1, y2, scales, device, normalize: bool, name: str):
    """Two matching 1-D f32 signals and the f32 scales on one device
    (:func:`_uploaded`), each signal normalized there (population std, as
    numpy's) when ``normalize``."""
    y1, y2, sc = _uploaded(torch.float32, device, y1, y2, scales)
    if y1.shape != y2.shape or y1.ndim != 1:
        raise ValueError(
            f"{name} expects matching 1-D signals, got {tuple(y1.shape)} vs "
            f"{tuple(y2.shape)}")
    if normalize:
        y1 = (y1 - y1.mean()) / y1.std(correction=0)
        y2 = (y2 - y2.mean()) / y2.std(correction=0)
    return y1, y2, sc


def _wct_chunk_pipeline(slab1, slab2, scales, mother: Mother, nfft: int,
                        dt: float, dj: float, precision: str):
    """One chunk of the blocked coherence: the WCT's planar coherence body
    (``coherence._planar_coherence``) on the two slabs' untrimmed planar
    chunk CWTs; the coherence ratio and phase, ``(S, nfft)`` each."""
    from ..coherence import _planar_coherence

    kw = dict(mother=mother, nfft=nfft, dt=dt, precision=precision)
    R, A, _ = _planar_coherence(_planar_cwt_of_real(slab1, scales, **kw),
                                _planar_cwt_of_real(slab2, scales, **kw),
                                scales, dt=dt, dj=dj, mother=mother)
    return R, A


def wct_overlap_planar(y1, y2, scales, dt: float, *, mother: Mother,
                       dj: float, chunk: int = 1 << 18, eps: float = 1e-7,
                       precision: str = "high", normalize: bool = True,
                       smooth_precision: str | None = None, device=None):
    """Wavelet coherence of two long signals: overlap-save through the
    whole WCT chain.

    The chunk CWTs have the mother's e-folding support and the time-Gaussian
    smoothing kernel the same Gaussian family, so one composed halo of
    ``2·ζ·s_max/dt`` samples makes each chunk's interior coherence equal the
    global computation to round-off for s ≳ 4·dt (the scale boxcar couples
    scales, not time, and runs whole per chunk).  Normalization runs on the
    device.  Peak memory is the two ``(S, N)`` f32 outputs plus one chunk's
    pipeline.  Near-Nyquist scales depend on where the chunk edges fall:
    match ``chunk`` when comparing runs.

    ``smooth_precision`` (``None`` or ``"high"``) is accepted for calls
    written against ``pycwt_tpu``: both run the port's one f32 band product,
    at least as accurate as the JAX package's 3-pass tier.

    Returns ``(WCT, aWCT)``, each ``(S, N)`` float32.
    """
    if smooth_precision not in (None, "high"):
        raise ValueError(
            f"smooth_precision must be None or 'high', got {smooth_precision!r}")
    with span("wct_overlap"):
        H = _halo(scales, dt, mother, eps, factor=2, chunk=chunk)
        y1, y2, sc = _signal_pair(y1, y2, scales, device, normalize,
                                  "wct_overlap_planar")
        p1, N, n_chunks = _pad_for_chunks(y1, chunk, H)
        p2, _, _ = _pad_for_chunks(y2, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        cR = torch.empty((sc.shape[0], n_chunks * chunk), dtype=torch.float32,
                         device=y1.device)
        cA = torch.empty_like(cR)
        with span("overlap.chunks"):
            for i in range(n_chunks):
                R, A = _wct_chunk_pipeline(_slab(p1, i, chunk, H),
                                           _slab(p2, i, chunk, H),
                                           sc, mother, nfft, dt, dj, precision)
                cR[:, i * chunk:(i + 1) * chunk] = R[:, H:H + chunk]
                cA[:, i * chunk:(i + 1) * chunk] = A[:, H:H + chunk]
                _count_chunk(sc.shape[0], nfft, min(chunk, N - i * chunk), 2)
        return cR[:, :N], cA[:, :N]


def sharded_wct_overlap_planar(mesh, y1, y2, scales, dt: float, *,
                               mother: Mother, dj: float,
                               chunk: int = 1 << 16, eps: float = 1e-7,
                               precision: str = "high",
                               smooth_precision: str | None = None,
                               normalize: bool = True,
                               axis_name: str = "data"):
    """Time-axis-SHARDED blocked coherence: :func:`wct_overlap_planar` with
    the pair's time axis over the ``axis_name`` dim of ``mesh`` (every rank
    passes the same global signals and calls this together).

    Each rank owns contiguous slabs of both signals (normalized over the
    whole signal first), takes the composed wavelet⊗smoothing halo
    (``2·ζ·s_max``) of the stacked pair from its neighbours in one exchange
    (zeros at the global edges), and runs the chunk loop on its slab with
    no further communication, writing each interior in place.  Returns
    ``(WCT, aWCT)``, each ``(S, N)`` float32 as a DTensor sharded ``P(None,
    axis_name)``; each shard equals :func:`wct_overlap_planar`'s to f32
    round-off.
    """
    from ..parallel._collectives import axis_size, block, mesh_device, to_dtensor

    if smooth_precision not in (None, "high"):
        raise ValueError(
            f"smooth_precision must be None or 'high', got {smooth_precision!r}")
    H = _halo(scales, dt, mother, eps, factor=2, chunk=chunk)
    y1, y2, sc = _signal_pair(y1, y2, scales, mesh_device(mesh), normalize,
                              "sharded_wct_overlap_planar")
    N_loc = _slab_checks(y1.shape[-1], axis_size(mesh, axis_name), chunk, H)
    padded = _with_halo(block(torch.stack([y1, y2]), mesh, axis_name, 1), mesh,
                        axis_name, H)
    nfft = next_pow2(chunk + 2 * H)
    cR = torch.empty((sc.shape[0], N_loc), dtype=torch.float32, device=y1.device)
    cA = torch.empty_like(cR)
    for i in range(N_loc // chunk):
        R, A = _wct_chunk_pipeline(_slab(padded[0], i, chunk, H),
                                   _slab(padded[1], i, chunk, H),
                                   sc, mother, nfft, dt, dj, precision)
        cR[:, i * chunk:(i + 1) * chunk] = R[:, H:H + chunk]
        cA[:, i * chunk:(i + 1) * chunk] = A[:, H:H + chunk]
    return to_dtensor(cR, mesh, {axis_name: 1}), to_dtensor(cA, mesh, {axis_name: 1})


def xwt_overlap_planar(y1, y2, scales, dt: float, *, mother: Mother,
                       chunk: int = 1 << 18, eps: float = 1e-7,
                       precision: str = "high", normalize: bool = True,
                       device=None):
    """Cross-wavelet transform of two long signals by overlap-save: two
    planar chunk CWTs, the planar cross spectrum, then ``|W12|`` and its
    phase (wavelet halo only: no smoothing).  Returns ``(|W12|, phase)``,
    each ``(S, N)`` float32, with :func:`cwt_overlap_save_planar`'s
    interior and near-Nyquist contract.  The theoretical XWT significance
    is a per-grid curve of the fitted AR(1) coefficients
    (:func:`pycwt_torch.stats.ar1`, ``ar1_spectrum``)."""
    with span("xwt_overlap_planar"):
        H = _halo(scales, dt, mother, eps, chunk=chunk)
        y1, y2, sc = _signal_pair(y1, y2, scales, device, normalize,
                                  "xwt_overlap_planar")
        p1, N, n_chunks = _pad_for_chunks(y1, chunk, H)
        p2, _, _ = _pad_for_chunks(y2, chunk, H)
        nfft = next_pow2(chunk + 2 * H)
        kw = dict(mother=mother, nfft=nfft, dt=dt, precision=precision)
        cM = torch.empty((sc.shape[0], n_chunks * chunk), dtype=torch.float32,
                         device=y1.device)
        cA = torch.empty_like(cM)
        with span("overlap.chunks"):
            for i in range(n_chunks):
                w1r, w1i = (w[:, H:H + chunk] for w in
                            _planar_cwt_of_real(_slab(p1, i, chunk, H), sc, **kw))
                w2r, w2i = (w[:, H:H + chunk] for w in
                            _planar_cwt_of_real(_slab(p2, i, chunk, H), sc, **kw))
                w12r = w1r * w2r + w1i * w2i          # W1 · conj(W2), planar
                w12i = w1i * w2r - w1r * w2i
                cM[:, i * chunk:(i + 1) * chunk] = torch.sqrt(w12r ** 2 + w12i ** 2)
                cA[:, i * chunk:(i + 1) * chunk] = torch.atan2(w12i, w12r)
                _count_chunk(sc.shape[0], nfft, min(chunk, N - i * chunk), 2)
        return cM[:, :N], cA[:, :N]

"""Engine-dispatched FFT primitives — one policy for every FFT consumer.

Counterpart of ``pycwt_tpu/ops/fft.py`` with the same four engine names:

* ``"xla"`` and ``"mxu"`` — ``torch.fft`` (cuFFT on the card);
* ``"pallas"`` and ``"planar"`` — the forward CWT runs the fused CUDA
  kernels (``ops/fused_cwt.py``) for a supported ``nfft`` on a CUDA tensor;
  every auxiliary FFT rides ``torch.fft``.

:func:`_planar_route` decides, for every caller, whether a forward CWT of
real rows takes the planar route into the kernels.

A non-pow-2 length under a non-``"xla"`` engine goes to ``torch.fft`` with
the JAX package's fallback warning.

Resolution order for ``engine=None``: the ``PYCWT_TPU_ENGINE`` environment
variable, then a default by device and compute dtype: ``"planar"`` for f32
on CUDA (the choice the JAX package made on the platform its numbers came
from; the kernels are f32) and ``"xla"`` otherwise, so f64 on the card runs
cuFFT in native f64.  Callers holding a
:class:`~pycwt_torch.config.CWTConfig` pass ``config.engine`` as the
explicit argument first and its ``real_dtype`` as the dtype.
"""
from __future__ import annotations

import os
import warnings

import torch

from ..utils.profiling import span
from . import mxu_dft

__all__ = ["resolve_engine", "warn_planar_downcast", "fft", "ifft",
           "fft_of_real_full"]

_VALID = ("xla", "mxu", "pallas", "planar")


def _device_default(device, dtype) -> str:
    if dtype is None:
        dtype = torch.get_default_dtype()
    if (device is not None and torch.device(device).type == "cuda"
            and dtype == torch.float32):
        return "planar"
    return "xla"


def resolve_engine(engine: str | None = None, device=None, dtype=None) -> str:
    """Resolve an engine name: explicit argument → ``PYCWT_TPU_ENGINE`` →
    default by device and real compute dtype (f32 on CUDA → "planar", else
    "xla"; ``dtype=None`` means ``torch.get_default_dtype()``)."""
    if engine is None:
        engine = (os.environ.get("PYCWT_TPU_ENGINE")
                  or _device_default(device, dtype))
    if engine not in _VALID:
        raise ValueError(f"engine must be one of {_VALID}, got {engine!r}")
    return engine


def warn_planar_downcast(dtype) -> None:
    """The planar route is f32: say so, at the caller of the function that
    asked :func:`_planar_route`, when an f64 computation is sent there (the
    JAX package's warning), never downcast silently."""
    if dtype == torch.float64:
        warnings.warn(
            "engine='planar' computes in float32; float64 inputs are "
            "downcast. Use engine='xla' (or 'mxu') for f64 parity runs.",
            stacklevel=4,
        )


def _planar_route(engine: str | None, device, dtype, nfft: int) -> bool:
    """Whether a forward CWT of real rows in ``dtype`` on ``device`` takes
    the planar route (``ops/fused_cwt._planar_cwt_of_real``): ``engine``
    resolves to ``"planar"`` and ``nfft`` is a power of two.  The one place
    that warns of f64 sent there (:func:`warn_planar_downcast`)."""
    if (resolve_engine(engine, device, dtype) != "planar"
            or not mxu_dft.supported_n(nfft)):
        return False
    warn_planar_downcast(dtype)
    return True


def _warn_fallback(engine: str, n: int) -> None:
    """An explicitly requested non-xla engine meets a non-pow-2 length and
    runs ``torch.fft`` instead of its own path: say so."""
    warnings.warn(
        f"engine={engine!r} supports only power-of-two FFT lengths; length "
        f"{n} runs torch.fft instead. Pad to a power of two "
        "(CWTConfig(pad_pow2=True)) to stay on the fused-kernel path.",
        stacklevel=3,
    )


def _check_engine(x: torch.Tensor, n: int, engine: str | None) -> None:
    engine = resolve_engine(engine, x.device, x.real.dtype)
    if engine != "xla" and not mxu_dft.supported_n(n):
        _warn_fallback(engine, n)


def fft(x: torch.Tensor, n: int | None = None, *, engine: str | None = None):
    """Complex FFT along the last axis (matches ``numpy.fft.fft(x, n)``)."""
    _check_engine(x, x.shape[-1] if n is None else n, engine)
    return torch.fft.fft(x, n=n, dim=-1)


def ifft(x: torch.Tensor, n: int | None = None, *, engine: str | None = None):
    """Inverse complex FFT along the last axis (matches ``numpy.fft.ifft``)."""
    _check_engine(x, x.shape[-1] if n is None else n, engine)
    return torch.fft.ifft(x, n=n, dim=-1).resolve_conj()


def _mirrored(half: torch.Tensor, nfft: int) -> torch.Tensor:
    """The full spectrum from an rFFT's bins 0 .. nfft//2: bins nfft-1 ..
    nfft//2+1 mirror bins 1 .. (nfft-1)//2."""
    mirror = torch.conj(half[..., 1 : (nfft + 1) // 2].flip(-1))
    return torch.cat([half, mirror], dim=-1)


def fft_of_real_full(x: torch.Tensor, nfft: int, *, engine: str | None = None):
    """Full complex spectrum of a real signal zero-padded to ``nfft``: an
    rFFT plus its Hermitian mirror."""
    _check_engine(x, nfft, engine)
    return _mirrored(torch.fft.rfft(x, n=nfft, dim=-1), nfft)


@span("spectrum")
def _spectrum_f64(x: torch.Tensor, nfft: int, *,
                  dtype: torch.dtype = torch.complex64,
                  engine: str | None = None) -> torch.Tensor:
    """The forward spectrum that every f32 route into the kernels takes:
    real rows ``x`` ``(..., n)`` of any float dtype, upcast to f64 on their
    device (never downcast), rFFT zero-padded to ``nfft`` in f64, mirrored
    to the full ``(..., nfft)`` spectrum and rounded once to ``dtype``.

    An f32 FFT errs by ~1e-7 of the signal's norm in every bin; at the small
    scales of a record whose spectrum falls steeply (a trend, as Mauna Loa's
    CO2) that is most of the bins' own size.  In f64 each bin is rounded
    once.  ``engine``, when given, gets the engine policy's non-pow-2
    warning, as in :func:`fft_of_real_full`."""
    if engine is not None:
        _check_engine(x, nfft, engine)
    return _mirrored(torch.fft.rfft(x.to(torch.float64), n=nfft, dim=-1),
                     nfft).to(dtype)

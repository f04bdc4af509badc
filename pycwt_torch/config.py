"""Global numeric / padding policy for the PyTorch port.

Counterpart of ``pycwt_tpu/config.py``: the same immutable ``CWTConfig`` with
the same fields and validation.  ``dtype=None`` follows
``torch.get_default_dtype()`` (float32 unless the caller changed it); the
parity tests pass ``torch.float64``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["CWTConfig", "DEFAULT", "next_pow2", "round_half_even"]

_PRECISIONS = ("highest", "high", "fast")
_COMPLEX_OF = {torch.float64: torch.complex128, torch.float32: torch.complex64}


@dataclasses.dataclass(frozen=True)
class CWTConfig:
    """Immutable numeric policy.

    Attributes
    ----------
    pad_pow2:
        Pad FFT lengths to the next power of two (the reference's scipy
        path); ``False`` keeps the signal length (its pyfftw path).
    dtype:
        Real compute dtype (a ``torch.dtype``).  ``None`` follows
        ``torch.get_default_dtype()``.
    engine:
        ``"xla"`` | ``"mxu"`` | ``"pallas"`` | ``"planar"`` — the JAX
        package's names, resolved by :func:`pycwt_torch.ops.fft.resolve_engine`.
        ``None`` defers to ``PYCWT_TPU_ENGINE``, then to the tensor's device
        ("planar" on CUDA, "xla" on the CPU).
    precision:
        Tier of the fused CUDA kernels: ``"highest"`` | ``"high"`` |
        ``"fast"``.  ``highest`` and ``high`` keep the kernels'
        intermediate T in f32 and meet the strictest bound; ``fast`` stores
        T in bf16, as ``pycwt_tpu`` does, which halves its round trip
        through device memory (within the tier's 2e-2 of max|W|).  The
        butterflies are f32 at every tier.
    """

    pad_pow2: bool = True
    dtype: torch.dtype | None = None
    engine: str | None = None
    precision: str = "high"

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be 'highest' | 'high' | 'fast', "
                f"got {self.precision!r}")

    @classmethod
    def from_params(cls, params: dict) -> "CWTConfig":
        """Build a config from plain values; a dtype given as a string
        (``"float64"``, ``"torch.float32"``) maps to the torch dtype."""
        params = dict(params)
        dtype = params.get("dtype")
        if isinstance(dtype, str):
            name = dtype.rsplit(".", 1)[-1]
            resolved = getattr(torch, name, None)
            if not isinstance(resolved, torch.dtype):
                raise ValueError(f"unknown dtype {dtype!r}")
            params["dtype"] = resolved
        return cls(**params)

    @property
    def real_dtype(self) -> torch.dtype:
        return self.dtype if self.dtype is not None else torch.get_default_dtype()

    @property
    def complex_dtype(self) -> torch.dtype:
        return _COMPLEX_OF[self.real_dtype]

    def fft_length(self, n: int) -> int:
        """FFT length for a signal of ``n`` samples (``2 ** ceil(log2 n)``
        under pad_pow2)."""
        if not self.pad_pow2 or n <= 1:
            return n
        return 1 << (n - 1).bit_length()


#: Default policy — pow-2 padding, dtype follows torch's default dtype.
DEFAULT = CWTConfig()


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (host-side helper)."""
    if n <= 1:
        return max(n, 1)
    return 1 << (n - 1).bit_length()


def round_half_even(x: float) -> int:
    """numpy-style banker's rounding for host-side scalar grid math (the
    reference's ``int(np.round(...))``)."""
    f = math.floor(x)
    diff = x - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f if f % 2 == 0 else f + 1

"""Mother wavelets as frozen dataclasses with PyTorch spectra.

Counterpart of ``pycwt_tpu/mothers.py``.  Every mother factorizes its
spectrum as ``psi_ft(f) = psi_ft_const() * psi_ft_envelope(f)`` with a real
envelope and a complex constant: the fused CUDA kernel evaluates the
envelope per bin and applies the constant once.  Envelopes take and return
tensors on the caller's device and dtype; Paul's envelope uses the safe form
``exp(m·log f − f)`` and DOG's is exactly 0 wherever ``e^(−f²/2)``
underflows, so float32 gives 0 where the naive products give inf·0 = NaN;
the reference's overflow-induced NaN rows are
replicated host-side by :meth:`reference_nan_rows` (numpy float64).

Constants are the Torrence & Compo (1998) Table-2 values, with ``-1``
sentinels for parameterizations without tabulated factors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch

__all__ = ["Morlet", "Paul", "DOG", "MexicanHat", "Mother", "as_mother",
           "from_params"]


def _hermitenorm_coeffs(n: int) -> tuple[float, ...]:
    """Coefficients (highest power first) of the probabilists' Hermite
    polynomial He_n, via He_{n+1}(x) = x·He_n(x) − n·He_{n−1}(x)."""
    if n == 0:
        return (1.0,)
    prev = np.array([1.0])
    cur = np.array([1.0, 0.0])
    for k in range(1, n):
        nxt = np.concatenate([cur, [0.0]])
        nxt[2:] -= k * prev
        prev, cur = cur, nxt
    return tuple(float(c) for c in cur)


def _double_factorial_range(lo: int, hi: int) -> float:
    """``np.prod(range(lo, hi))`` with the empty product equal to 1."""
    out = 1.0
    for k in range(lo, hi):
        out *= k
    return out


def _int_pow(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x ** m`` for a non-negative integer ``m`` by repeated squaring."""
    result = torch.ones_like(x)
    base = x
    while m:
        if m & 1:
            result = result * base
        m >>= 1
        if m:
            base = base * base
    return result


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


@dataclasses.dataclass(frozen=True)
class Morlet:
    """Morlet mother wavelet; ``f0=6`` carries the TC98 Table-2 constants."""

    f0: float = 6.0
    name: str = dataclasses.field(default="Morlet", compare=False)

    def psi_ft(self, f):
        """ψ̂(f) = π^(−1/4)·exp(−(f−f0)²/2)."""
        return self.psi_ft_const() * self.psi_ft_envelope(f)

    def psi_ft_envelope(self, f):
        f = _as_tensor(f)
        return torch.exp(-0.5 * (f - self.f0) ** 2)

    def psi_ft_const(self) -> complex:
        return math.pi ** -0.25

    def analytic_negligible_negative(self) -> bool:
        """True when ψ̂(f≤0) is below f32 round-off (exp(−f0²/2) < 1e-7),
        so kernels may skip the negative-frequency half of the spectrum."""
        return math.exp(-0.5 * self.f0 ** 2) < 1e-7

    def psi(self, t):
        """ψ(t) = π^(−1/4)·exp(i f0 t − t²/2)."""
        t = _as_tensor(t)
        return (math.pi ** -0.25) * torch.exp(torch.complex(-(t ** 2) / 2,
                                                            self.f0 * t))

    def psi0(self) -> complex:
        return math.pi ** -0.25

    def flambda(self) -> float:
        return (4 * math.pi) / (self.f0 + math.sqrt(2 + self.f0 ** 2))

    def coi(self) -> float:
        return 1.0 / math.sqrt(2)

    def sup(self) -> float:
        return 1.0 / self.coi()

    @property
    def dofmin(self) -> float:
        return 2.0

    @property
    def cdelta(self) -> float:
        return 0.776 if self.f0 == 6 else -1.0

    @property
    def gamma(self) -> float:
        return 2.32 if self.f0 == 6 else -1.0

    @property
    def deltaj0(self) -> float:
        return 0.60 if self.f0 == 6 else -1.0

    def smooth(self, W, dt, dj, scales):
        """WCT smoothing (time Gaussian, scale boxcar); delegates to the op."""
        from .ops.smoothing import smooth as _smooth

        return _smooth(W, dt, dj, scales, self)

    def reference_nan_rows(self, scales: np.ndarray, ftfreqs: np.ndarray) -> np.ndarray:
        """Morlet's Gaussian underflows to 0; no row is ever non-finite."""
        return np.zeros(len(scales), dtype=bool)


@dataclasses.dataclass(frozen=True)
class Paul:
    """Paul mother wavelet of order ``m``."""

    m: int = 4
    name: str = dataclasses.field(default="Paul", compare=False)

    def psi_ft(self, f):
        """ψ̂(f) = 2^m/√(m·(2m−1)!)·f^m·e^(−f)·H(f)."""
        return self.psi_ft_const() * self.psi_ft_envelope(f)

    def psi_ft_envelope(self, f):
        # f^m·e^(−f) = exp(m·log f − f) for f > 0, exactly 0 otherwise.
        f = _as_tensor(f)
        pos = f > 0
        safe_f = torch.where(pos, f, torch.ones_like(f))
        return torch.where(pos, torch.exp(self.m * torch.log(safe_f) - safe_f),
                           torch.zeros_like(f))

    def psi_ft_const(self) -> complex:
        return 2.0 ** self.m / math.sqrt(self.m * _double_factorial_range(2, 2 * self.m))

    def analytic_negligible_negative(self) -> bool:
        """ψ̂ is exactly zero for f ≤ 0 (Heaviside factor)."""
        return True

    def _psi_const(self) -> complex:
        # Includes the reference's np.prod(range(2, m−1)) factor (1 for m ≤ 3).
        return (2 ** self.m * (1j ** self.m)
                * _double_factorial_range(2, self.m - 1)
                / math.sqrt(math.pi * _double_factorial_range(2, 2 * self.m + 1)))

    def psi(self, t):
        t = _as_tensor(t)
        z = torch.complex(torch.ones_like(t), -t)
        return self._psi_const() / _int_pow(z, self.m + 1)

    def psi0(self) -> complex:
        return complex(self._psi_const())

    def flambda(self) -> float:
        return 4 * math.pi / (2 * self.m + 1)

    def coi(self) -> float:
        return math.sqrt(2)

    def sup(self) -> float:
        return 1 / self.coi()

    @property
    def dofmin(self) -> float:
        return 2.0

    @property
    def cdelta(self) -> float:
        return 1.132 if self.m == 4 else -1.0

    @property
    def gamma(self) -> float:
        return 1.17 if self.m == 4 else -1.0

    @property
    def deltaj0(self) -> float:
        return 1.50 if self.m == 4 else -1.0

    def smooth(self, W, dt, dj, scales):
        """WCT smoothing (time Gaussian, scale boxcar); delegates to the op."""
        from .ops.smoothing import smooth as _smooth

        return _smooth(W, dt, dj, scales, self)

    def reference_nan_rows(self, scales: np.ndarray, ftfreqs: np.ndarray) -> np.ndarray:
        """Rows where the reference's naive ``c·f^m·e^(−f)·(f>0)`` gives
        inf·0 = NaN in float64 (large negative ``s·ω`` overflows ``e^(−f)``).
        The constant prefactor and the association order set the overflow
        threshold, so both are replicated."""
        with np.errstate(over="ignore", invalid="ignore"):
            f = scales[:, None] * ftfreqs[None, :]
            # ((c · f^m) · e^(−f)) · (f>0), as the reference associates it
            ref = float(self.psi_ft_const()) * f ** self.m * np.exp(-f) * (f > 0)
        return ~np.isfinite(ref).all(axis=1)


@dataclasses.dataclass(frozen=True)
class DOG:
    """Derivative-of-Gaussian mother wavelet of order ``m`` (m=2: Mexican hat)."""

    m: int = 2
    name: str = dataclasses.field(default="DOG", compare=False)

    def psi_ft(self, f):
        """ψ̂(f) = −(i^m)/√Γ(m+1/2)·f^m·e^(−f²/2) (TC98 errata sign)."""
        return self.psi_ft_const() * self.psi_ft_envelope(f)

    def psi_ft_envelope(self, f):
        # Exactly 0 wherever e^(−f²/2) underflows: f^m alone may overflow
        # there (f ≳ 2.6e6 at m = 6 in float32) and the product be inf·0 =
        # NaN.  Elsewhere the product, as the kernels compute it.
        f = _as_tensor(f)
        e = torch.exp(-0.5 * f ** 2)
        return _int_pow(torch.where(e > 0, f, torch.zeros_like(f)), self.m) * e

    def psi_ft_const(self) -> complex:
        return complex(-(1j ** self.m) / math.sqrt(math.gamma(self.m + 0.5)))

    def analytic_negligible_negative(self) -> bool:
        """The envelope is symmetric in f: the negative half is never
        negligible."""
        return False

    def psi(self, t):
        """ψ(t) via probabilists' Hermite polynomials (Horner's rule)."""
        t = _as_tensor(t)
        poly = torch.zeros_like(t)
        for c in _hermitenorm_coeffs(self.m):
            poly = poly * t + c
        return ((-1.0) ** (self.m + 1) * poly * torch.exp(-(t ** 2) / 2)
                / math.sqrt(math.gamma(self.m + 0.5)))

    def psi0(self) -> complex:
        he0 = float(np.polyval(np.asarray(_hermitenorm_coeffs(self.m)), 0.0))
        return (-1.0) ** (self.m + 1) * he0 / math.sqrt(math.gamma(self.m + 0.5))

    def flambda(self) -> float:
        return 2 * math.pi / math.sqrt(self.m + 0.5)

    def coi(self) -> float:
        return 1 / math.sqrt(2)

    def sup(self) -> float:
        return 1 / self.coi()

    @property
    def dofmin(self) -> float:
        return 1.0

    @property
    def cdelta(self) -> float:
        return {2: 3.541, 6: 1.966}.get(self.m, -1.0)

    @property
    def gamma(self) -> float:
        return {2: 1.43, 6: 1.37}.get(self.m, -1.0)

    @property
    def deltaj0(self) -> float:
        return {2: 1.40, 6: 0.97}.get(self.m, -1.0)

    def smooth(self, W, dt, dj, scales):
        """WCT smoothing (time Gaussian, scale boxcar); delegates to the op."""
        from .ops.smoothing import smooth as _smooth

        return _smooth(W, dt, dj, scales, self)

    def reference_nan_rows(self, scales: np.ndarray, ftfreqs: np.ndarray) -> np.ndarray:
        """The Gaussian underflows before f^m overflows: finite in float64."""
        return np.zeros(len(scales), dtype=bool)


@dataclasses.dataclass(frozen=True)
class MexicanHat(DOG):
    """Mexican hat = DOG(m=2)."""

    m: int = 2
    name: str = dataclasses.field(default="Mexican Hat", compare=False)


Mother = Union[Morlet, Paul, DOG, MexicanHat]

_REGISTRY = {
    "morlet": Morlet,
    "paul": Paul,
    "dog": DOG,
    "mexicanhat": MexicanHat,
}


def as_mother(wavelet: Union[str, Mother]) -> Mother:
    """Coerce a string or mother instance to a mother instance."""
    if isinstance(wavelet, str):
        try:
            return _REGISTRY[wavelet.lower()]()
        except KeyError:
            raise ValueError(
                f"Unknown mother wavelet {wavelet!r}; expected one of {sorted(_REGISTRY)}"
            ) from None
    return wavelet


def from_params(params: dict) -> Mother:
    """Build a mother from plain values, e.g. ``{"kind": "Paul", "m": 4}``.
    ``kind`` is the class name (case-insensitive); the other keys are the
    dataclass fields (as ``dataclasses.asdict`` gives them)."""
    params = dict(params)
    kind = params.pop("kind", None)
    if kind is None:
        raise ValueError("mother params need a 'kind' key")
    cls = _REGISTRY.get(str(kind).replace(" ", "").lower())
    if cls is None:
        raise ValueError(
            f"Unknown mother kind {kind!r}; expected one of {sorted(_REGISTRY)}")
    return cls(**params)

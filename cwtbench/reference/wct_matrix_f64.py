"""Plain reference of the all-pairs wavelet coherence of a network of
stations: for every pair (i, j), i < j, what pycwt's ``wct(y_i, y_j, dt,
dj, sig=False)`` returns (Grinsted, Moore & Jevrejeva 2004), with each
station's transform and self-smoothing computed once and shared by its
pairs.

* Each station is normalised on its own to zero mean and unit (population)
  variance, as pycwt's ``wct`` normalises each series of a pair.
* The grid, the COI, the transform (products with DFT matrices), the
  smoothing (one (n, n) circulant matrix per scale in time, the banded
  boxcar in scale) and the arithmetic are ``wct_f64.py``'s.
* W12 = W_i conj(W_j), WCT = |S(W12 / s)|^2 / (S(|W_i|^2 / s) S(|W_j|^2 / s)),
  the phase atan2(Im W12, Re W12).
* The pairs come in row-major order, (0, 1), (0, 2), ..., (B - 2, B - 1),
  and run in blocks of ``block`` pairs, so that 496 pairs of 110 scales at
  1024 samples fit on one card beside the time kernel, (110, 1024, 1024)
  float64 = 0.92 GB, which ``wct_f64`` caches.

``Arith("f64")`` is the reference proper and ``Arith("tf32")`` the
control, as in ``wct_f64.py``, which also sets both of torch's TF32 flags
to False.  The module imports nothing of the program and takes none of its
values.
"""
from __future__ import annotations

import numpy as np
import torch

from .wct_f64 import Arith, coi, cwt, grid, smooth

__all__ = ["Arith", "Network", "all_pairs"]


def all_pairs(B: int) -> np.ndarray:
    """The (B (B - 1) / 2, 2) pairs i < j in row-major order."""
    i, j = np.triu_indices(B, k=1)
    return np.stack([i, j], axis=1)


class Network:
    """The shared fields of the stations ``y`` (B, n0): each station's
    planar W and self-smoothing on ``device``, in ``ar``'s arithmetic, and
    the grid's COI and frequencies as that arithmetic would give them."""

    def __init__(self, y, dt: float, dj: float, f0: float, ar: Arith, device):
        y = np.asarray(y, np.float64)
        B, n0 = y.shape
        _, _, self.sj, freqs = grid(n0, dt, dj, f0)
        self.dt, self.dj, self.ar = float(dt), float(dj), ar
        self.pairs = all_pairs(B)
        yn = (y - y.mean(axis=1, keepdims=True)) / y.std(axis=1, keepdims=True)
        self.wr, self.wi = cwt(torch.as_tensor(yn, device=device).to(ar.dtype),
                               self.sj, dt, f0, ar)
        self.s = torch.as_tensor(self.sj, dtype=ar.dtype, device=device)[:, None]
        self.power = smooth((self.wr ** 2 + self.wi ** 2) / self.s, self.sj,
                            dt, dj, ar)
        self.coi = ar.host(coi(n0, dt, f0))
        self.freqs = ar.host(freqs)

    def maps(self, pi, pj):
        """(WCT, phase, |W12|), each (len(pi), S, n0), of the pairs
        (pi[p], pj[p])."""
        pi = torch.as_tensor(pi, device=self.wr.device)
        pj = torch.as_tensor(pj, device=self.wr.device)
        w1r, w1i = self.wr[pi], self.wi[pi]
        w2r, w2i = self.wr[pj], self.wi[pj]
        w12r = w1r * w2r + w1i * w2i
        w12i = w1i * w2r - w1r * w2i
        S12r = smooth(w12r / self.s, self.sj, self.dt, self.dj, self.ar)
        S12i = smooth(w12i / self.s, self.sj, self.dt, self.dj, self.ar)
        wct = (S12r ** 2 + S12i ** 2) / (self.power[pi] * self.power[pj])
        return wct, torch.atan2(w12i, w12r), torch.sqrt(w12r ** 2 + w12i ** 2)

    def blocks(self, block: int = 64):
        """``(lo, hi, WCT, phase, |W12|)`` of the pairs ``lo:hi`` of
        :func:`all_pairs`, block by block."""
        for lo in range(0, len(self.pairs), block):
            hi = min(lo + block, len(self.pairs))
            yield (lo, hi, *self.maps(self.pairs[lo:hi, 0], self.pairs[lo:hi, 1]))

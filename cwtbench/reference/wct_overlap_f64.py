"""Plain reference of the blocked wavelet coherence of two long records by
overlap-save, with the framing that ``ops.overlap.wct_overlap_planar``
documents (Grinsted, Moore & Jevrejeva 2004 for the coherence; Torrence &
Compo 1998 for the transform).

* Each record is normalised over its whole length to zero mean and unit
  (population) variance, as pycwt's ``wct`` normalises each series.
* Scales s_j = s0 2^(j dj), j = 0 .. S - 1, given by the configuration.
* The halo is H = 2 ceil(zeta s_max / dt) samples, zeta = sqrt(-2 ln eps):
  the wavelet's e-folding support at the largest scale, twice, once for
  the transform and once for the time smoothing.  The record is
  zero-padded by H at its start and to a whole number of chunks plus H at
  its end; chunk i is the slab of chunk + 2H samples from i chunk on,
  transformed at nfft_c = 2^ceil(log2(chunk + 2H)).
* Each chunk, at nfft_c and without trimming: the CWT of both slabs
  (pycwt's Morlet filter bank, as ``cwt_f64.py`` writes it), |W1|^2 / s,
  |W2|^2 / s and W12 / s with W12 = W1 conj(W2), each smoothed as pycwt's
  Morlet ``smooth`` (``wct_null_pairs_f64.smooth``: the spectrum times
  exp(-(s/dt)^2 k^2 / 2), k = 2 pi fftfreq(nfft_c), then the boxcar of
  round(2 * 0.6 / dj) taps with half end taps in scale), R^2 = |S12|^2 /
  (S1 S2), and the phase atan2(Im W12, Re W12) of the unsmoothed W12.  Its
  interior, samples H .. H + chunk of the slab, is the record's samples
  i chunk .. (i + 1) chunk; the last chunk's zero tail is dropped.

Departures from pycwt's global ``wct``: only the framing.  pycwt's
``wct`` transforms and smooths the whole record at one power of two; here
each chunk is, so the first and last 2H samples follow zero padding (inside
the cone of influence either way), and the interior's transform equals
the global one for s >~ 4 dt.  Below that the mother's spectrum is still
large at the Nyquist frequency, so the truncated filter rings and any
finite halo leaves a gap of ~1e-2 at the finest scales, which the scale
boxcar carries up to round(2 * 0.6 / dj) / 2 rows higher: the coherence
equals the global one to float64 round-off on the rows whose boxcar
reaches only scales of 4 dt and more.  The program has the same framing,
so the comparison with it holds every scale.

``mode="f64"`` is the reference proper; ``mode="tf32"`` computes in
float32 with every operand of a transform or of a product with a filter
or the boxcar rounded to TF32, as ``wct_null_pairs_f64.py`` does.  The
chunks run one at a time on the records' device, so 2^24 samples of 64
scales fit on one card.  The module imports nothing of the program and
takes none of its values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .wct_null_pairs_f64 import _check_mode, _cwt, smooth

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["framing", "scales", "chunks"]


def scales(S: int, dt: float, dj: float, s0_dt: float) -> np.ndarray:
    """s_j = s0 2^(j dj), j < S, s0 = s0_dt dt, float64."""
    return s0_dt * dt * 2.0 ** (np.arange(S, dtype=np.float64) * dj)


def framing(N: int, s_max: float, dt: float, chunk: int, eps: float) -> dict:
    """The blocking of N samples: halo ``H``, chunk length ``nfft_c`` and
    the number of chunks."""
    zeta = math.sqrt(-2.0 * math.log(eps))
    H = 2 * int(math.ceil(zeta * s_max / dt))
    return {"H": H, "nfft_c": 1 << (chunk + 2 * H - 1).bit_length(),
            "n_chunks": -(-N // chunk)}


def chunks(y1, y2, sj, dt: float, dj: float, f0: float, *,
           chunk: int, eps: float, device, mode: str = "f64"):
    """Yield ``(lo, hi, WCT, phase, |W12|)`` chunk after chunk: the maps
    of the record's samples lo .. hi, each (S, hi - lo), in ``mode``'s
    dtype on ``device``, of the records ``y1``, ``y2`` (N,)."""
    dtype = _check_mode(mode)
    y = torch.stack([torch.as_tensor(v, dtype=torch.float64) for v in (y1, y2)])
    y = y.to(device)
    y = (y - y.mean(dim=1, keepdim=True)) / y.std(dim=1, correction=0, keepdim=True)
    N = y.shape[1]
    sj = np.asarray(sj, np.float64)
    f = framing(N, float(sj.max()), dt, chunk, eps)
    H, nfft = f["H"], f["nfft_c"]
    padded = torch.zeros((2, f["n_chunks"] * chunk + 2 * H), dtype=torch.float64,
                         device=device)
    padded[:, H:H + N] = y
    s = torch.as_tensor(sj, dtype=dtype, device=device)[:, None]
    for i in range(f["n_chunks"]):
        slab = torch.zeros((2, nfft), dtype=torch.float64, device=device)
        slab[:, :chunk + 2 * H] = padded[:, i * chunk:(i + 1) * chunk + 2 * H]
        W = _cwt(slab, sj, dt, f0, nfft, mode)          # (2, S, nfft)
        W1, W2 = W[0], W[1]
        S1 = smooth(W1.abs() ** 2 / s, sj, dt, dj, mode)
        S2 = smooth(W2.abs() ** 2 / s, sj, dt, dj, mode)
        W12 = W1 * W2.conj()
        S12 = smooth(W12 / s, sj, dt, dj, mode)
        del W, W1, W2
        lo, hi = i * chunk, min((i + 1) * chunk, N)
        keep = slice(H, H + hi - lo)
        R2 = S12[:, keep].abs() ** 2 / (S1[:, keep] * S2[:, keep])
        W12 = W12[:, keep]
        yield lo, hi, R2, torch.atan2(W12.imag, W12.real), W12.abs()

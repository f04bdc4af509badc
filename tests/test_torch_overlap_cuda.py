"""The card twin of ``test_torch_overlap_reference.py``: ``wct_overlap_planar``
on the card (K1 and K2 twice a chunk, the smoothing's cuFFT and band
product) at the cell ``overlap_16m``'s grid and chunk (64 scales from
s = 2 dt at 4096 Hz, chunks of 2^18 at nfft 2^19) on a pair of 2^22
samples, against the benchmark's float64 reference computed on the card,
every scale and sample, within the cell's limits; the ``fast`` tier reads
above one of them.  They need an NVIDIA card, so they skip where there is
none; ``python -m pytest --noconftest tests/test_torch_overlap_cuda.py``
on the card runs them."""
import json
import os
import warnings

import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import wct_overlap_f64 as R
from pycwt_torch.ops import overlap as tov
from pycwt_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "cwtbench", "cells", "overlap_16m.json")) as f:
    LIMITS = json.load(f)["limits"]
DT, DJ, F0 = 1 / 4096, 1 / 8, 6.0
N, CHUNK = 1 << 22, 1 << 18
SEED = 2 ** 31 + 8191


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gaps(maps, y1, y2, sj, device):
    WCT, A = maps
    w_gap = turn = top = 0.0
    for lo, hi, rw, rph, mag in R.chunks(y1, y2, sj, DT, DJ, F0, chunk=CHUNK,
                                         eps=1e-7, device=device):
        w_gap = max(w_gap, float((WCT[:, lo:hi].double() - rw).abs().max()))
        t = 2 * torch.sin(0.5 * (A[:, lo:hi].double() - rph)).abs() * mag
        turn, top = max(turn, float(t.max())), max(top, float(mag.max()))
    return {"wct_gap": w_gap, "phase_gap": turn / top}


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_wct_overlap_planar_on_the_card_against_the_reference(cuda, precision):
    make = harness.load_module("inputs", "long_pairs").make
    y = make({"pairs": 1, "n0": N, "g": [0.4, 0.8], "burn_in": 256, "share": 0.5},
             SEED, "cuda")
    y1, y2 = y["y1"][0], y["y2"][0]
    sj = R.scales(64, DT, DJ, 2.0)
    profiling.enable_spans()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # the near-Nyquist caveat of s < 4 dt
            maps = tov.wct_overlap_planar(y1, y2, sj, DT, mother=pt.Morlet(F0), dj=DJ,
                                          precision=precision)
        torch.cuda.synchronize()
        assert profiling.OVERLAP_CHUNKS == N // CHUNK
        assert profiling.OVERLAP_INTERIOR_POINTS * 2 == profiling.OVERLAP_POINTS
    finally:
        profiling.disable_spans()
    assert all(m.shape == (64, N) and m.dtype == torch.float32 and m.is_cuda
               for m in maps)
    gaps = _gaps(maps, y1, y2, sj, cuda)
    print(precision, gaps)
    if precision == "high":
        assert all(gaps[k] <= lim for k, lim in LIMITS.items()), gaps
    else:
        assert any(gaps[k] > lim for k, lim in LIMITS.items()), gaps

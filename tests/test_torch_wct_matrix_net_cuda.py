"""The card twin of ``test_torch_wct_matrix_net.py``: ``wct_matrix`` on the
planar route (K1 and K2 once a call, the batched pair smoothing on planes)
against the benchmark's float64 reference computed on the card, at the CPU
test's 6 stations of 147 samples and at the cell ``wct_matrix_32st``'s 32
stations of 1024 samples (496 pairs, 110 scales).  They need an NVIDIA card,
so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_wct_matrix_net_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import wct_matrix_f64 as R
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.utils import profiling

NETWORK = harness.load_module("inputs", "station_network").make
ENTRY = harness.load_module("entries", "wct_matrix")
SEED = 2 ** 31 + 4099
DT, DJ = 0.25, 1 / 12
#: the f32 kernels and smoothing on the card, as the CPU test's float32
#: routes: the cell's own runs read up to ~1e-5 (WCT) and ~1e-6 (phase)
TOL = (5e-5, 1e-5)
GRID_TOL = 4 * np.finfo(np.float64).eps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("stations,n0,S", [(6, 147, 76), (32, 1024, 110)])
def test_wct_matrix_on_the_card_matches_the_reference(cuda, stations, n0, S):
    params = {"networks": 1, "stations": stations, "n0": n0, "g": [0.4, 0.8],
              "burn_in": 256, "period": 32, "amplitude": 1.0}
    y = NETWORK(params, SEED, "cpu")["y"][0]
    before = dict(fc.KERNEL_LAUNCHES)
    blocks = profiling.MATRIX_PAIR_BLOCKS
    WCT, aWCT, coi, freqs, pairs = pt.wct_matrix(y, DT, dj=DJ, wavelet=pt.Morlet(6))
    launched = {k: fc.KERNEL_LAUNCHES[k] - before[k] for k in before}
    assert launched["cwt_stage_a"] == launched["cwt_stage_b"] == 1
    assert profiling.MATRIX_PAIR_BLOCKS - blocks == 1
    P = stations * (stations - 1) // 2
    assert WCT.shape == aWCT.shape == (P, S, n0)
    assert WCT.dtype == aWCT.dtype == np.float32
    np.testing.assert_array_equal(pairs, R.all_pairs(stations))
    net = R.Network(y, DT, DJ, 6.0, R.Arith("f64"), cuda)
    w_gap, ph_gap = ENTRY.map_gaps(net, lambda lo, hi: (WCT[lo:hi], aWCT[lo:hi]), cuda)
    assert w_gap <= TOL[0] and ph_gap <= TOL[1], (w_gap, ph_gap)
    for got, want in ((coi, net.coi), (freqs, net.freqs)):
        assert np.max(np.abs(got / want - 1)) <= GRID_TOL
    WCTd, aWCTd, *_ = pt.wct_matrix(y, DT, dj=DJ, wavelet=pt.Morlet(6), as_numpy=False)
    assert WCTd.is_cuda
    np.testing.assert_array_equal(WCTd.cpu().numpy(), WCT)
    np.testing.assert_array_equal(aWCTd.cpu().numpy(), aWCT)

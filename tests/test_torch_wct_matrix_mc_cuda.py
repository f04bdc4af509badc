"""The card twin of ``test_torch_wct_matrix_mc.py``: ``wct_matrix_analysis``
cold on the card (K1+K2 on the planar route, the generator kernels, float32)
against the same call on the CPU in float64, at the CPU test's 6 stations
of 256 samples (15 pairs, 11 distinct nulls of 24 members).  It needs an
NVIDIA card, so it skips where there is none; ``python -m pytest
--noconftest tests/test_torch_wct_matrix_mc_cuda.py`` on the card runs it."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.utils import profiling

NETWORK = harness.load_module("inputs", "station_network").make
PARAMS = {"networks": 1, "stations": 6, "n0": 256, "g": [0.45, 0.6], "burn_in": 256,
          "period": 32, "amplitude": 1.0}
SEED = 2 ** 31 + 6007
#: float32 on the card against float64: the CPU's float32 route reads
#: 3.7e-5 at this size (a few of 24 members' counts move a bin), the
#: benchmark's reference in TF32 4.95e-4
SIG_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_the_cards_curves_are_the_cpus(cuda):
    y = NETWORK(PARAMS, SEED, "cpu")["y"][0]
    kw = dict(dj=1 / 12, mother=pt.Morlet(6), significance_level=0.95, mc_count=24,
              seed=SEED, cache=False)
    nulls = profiling.MC_NULLS
    card = wct_matrix_analysis(y, 0.25, **kw)
    assert profiling.MC_NULLS - nulls == 11
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        host = wct_matrix_analysis(y, 0.25, device="cpu", **kw)
    finally:
        torch.set_default_dtype(saved)
    got, want = card["sig95"], host["sig95"]
    assert got.shape == want.shape == (15, 86)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    m = np.isfinite(want)
    assert np.max(np.abs(got[m] - want[m])) <= SIG_TOL
    np.testing.assert_array_equal(card["alpha"], host["alpha"])

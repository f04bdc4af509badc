"""The Monte-Carlo counts kernel on the card (``csrc/mc_hist.cu``,
``ops/mc_hist.py``) against the torch path on the card, bit for bit: the
counts of ``mc_coherence_counts`` equal ``_histogram`` of the torch ratio on
fields with NaN, ±inf, negative and zero S1·S2, R² on bin edges and above 1,
with all-masked rows, a COI mask and fewer valid members than B, at both
cells' chunk shapes (S 76 × n 885 with P 1, S 110 × n 6302 with P > 1),
accumulated in place; the chunk functions on real surrogates, and
``wct_significance`` and ``wct_matrix_analysis``, through the kernel and
through the torch tail; the wrapper's refusals.  They need an NVIDIA card,
so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_mc_hist_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.ops import mc_hist
from pycwt_torch.utils import profiling

M6 = pt.Morlet(6)
#: JAO/JBaltic's Monte-Carlo grid (S = 76, n = 885) and the 32-station
#: network's (S = 110, n = 6302)
JAO = dict(dt=0.25, dj=1 / 12, s0=0.48400665459719555, J=75)
NET = dict(JAO, J=109)
NETWORK = harness.load_module("inputs", "station_network").make
PARAMS = {"networks": 1, "stations": 6, "n0": 256, "g": [0.45, 0.6], "burn_in": 256,
          "period": 32, "amplitude": 1.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _special_fields(P, B, S, n, seed, dev):
    """Random fields with R² up to ~1.5; then NaN, ±inf, negative and zero
    S1·S2, zero numerators; and R² within a few ulps of each bin edge k/1000,
    k < 1500 (|C|² = k/1000 · S1·S2 in float64, split at random between C's
    parts, rounded to float32), where the rounding order decides the bin."""
    g = torch.Generator().manual_seed(seed)
    Sm = torch.view_as_complex(torch.rand((P, B, S, n, 2), generator=g) + 0.05).clone()
    Cm = torch.view_as_complex(torch.randn((P, B, S, n, 2), generator=g) * 0.6).clone()
    fs, fc = Sm.view(-1), Cm.view(-1)
    N = fs.numel()
    at = torch.randperm(N, generator=g)[:60000]
    edges = at[:min(30000, N // 2)]
    k = torch.arange(len(edges)) % 1500
    mag = k / 1000.0 * fs[edges].real.double() * fs[edges].imag.double()
    u = torch.rand(len(edges), generator=g, dtype=torch.float64)
    fc[edges] = torch.complex(torch.sqrt(mag * u).float(), torch.sqrt(mag * (1 - u)).float())
    nan, inf = float("nan"), float("inf")
    cases = [(complex(nan, 1), 1), (complex(1, nan), 1), (1 + 1j, complex(nan, 0)),
             (1 + 1j, complex(inf, 0)), (1 + 1j, complex(0, -inf)), (1 - 1j, 0.5),
             (-1 - 1j, 0.5), (0 + 1j, 0.5), (0j, 0j), (complex(1, 0), 0j),
             (complex(inf, 1), 0.5), (complex(-inf, 1), 0.5)]
    for j, i in enumerate(at[len(edges):len(edges) + 1200].tolist()):
        fs[i], fc[i] = cases[j % len(cases)]
    return Sm.to(dev), Cm.to(dev)


def _coi_mask(grid, dev):
    _, _, oc, _, _ = tco._surrogate_grid(grid["dt"], grid["dj"], grid["s0"], grid["J"], M6)
    mask = torch.tensor(oc)
    mask[3] = False                        # an all-masked row
    return mask.to(dev)


def _torch_counts(Sm, Cm, mask, valid):
    B = Sm.shape[1]
    keep = None if valid == B else torch.arange(B, device=Sm.device) < valid
    return tco._histogram(tco._coherence_ratio(Sm, Cm), mask, valid=keep)


@pytest.mark.parametrize("shape, grid", [((1, 300, 76, 885), JAO), ((8, 5, 110, 6302), NET),
                                         ((1, 40, 76, 885), JAO), ((3, 100, 76, 885), JAO)],
                         ids=["wct_mc300", "matrix_mc", "cluster_2", "cluster_4"])
@pytest.mark.parametrize("valid", ["all", "fewer"])
def test_the_kernels_counts_are_the_torch_paths(cuda, shape, grid, valid):
    P, B, S, n = shape
    Sm, Cm = _special_fields(P, B, S, n, seed=n + B, dev=cuda)
    mask = _coi_mask(grid, cuda)
    v = B if valid == "all" else B - 2
    acc = torch.zeros((P, S, tco.NBINS), dtype=torch.int64, device=cuda)
    mc_hist.coherence_counts(Sm, Cm, mask, v, acc)
    want = _torch_counts(Sm, Cm, mask, v)
    assert torch.equal(acc, want)
    assert int(acc[:, 3].sum()) == 0 and int(acc.sum()) == P * v * int(mask.sum())


def test_the_counts_accumulate_in_place_across_chunks(cuda):
    mask = _coi_mask(JAO, cuda)
    acc = torch.zeros((2, 76, tco.NBINS), dtype=torch.int64, device=cuda)
    want = torch.zeros_like(acc)
    for i, valid in enumerate((7, 7, 3)):
        Sm, Cm = _special_fields(2, 7, 76, 885, seed=i, dev=cuda)
        assert mc_hist.coherence_counts(Sm, Cm, mask, valid, acc) is acc
        want += _torch_counts(Sm, Cm, mask, valid)
    assert torch.equal(acc, want)


def _torch_tail(monkeypatch):
    monkeypatch.setattr(mc_hist, "on_card", lambda fields: False)


def test_a_real_chunk_of_the_network_null_is_counted_alike(cuda, monkeypatch):
    """``_mc_histogram_run_pairs`` at the network's grid (three nulls, an
    overdrawn last chunk) through the kernel and through the torch tail."""
    n, sj, oc, _, _ = tco._surrogate_grid(NET["dt"], NET["dj"], NET["s0"], NET["J"], M6)
    args = (tst.PRNGKey(77, device=cuda), torch.tensor(sj, dtype=torch.float32, device=cuda),
            torch.tensor(oc, device=cuda), torch.tensor([4, 17, 9], device=cuda),
            torch.tensor([0.45, 0.6, 0.72], device=cuda),
            torch.tensor([0.5, 0.41, 0.66], device=cuda), 10, NET["dt"])
    kw = dict(mother=M6, nfft=8192, dj=NET["dj"], batch=4, nchunks=3, n=n, tau=64)
    launches = mc_hist.LAUNCHES["mc_coherence_counts"]
    kernel = tco._mc_histogram_run_pairs(*args, **kw)
    assert mc_hist.LAUNCHES["mc_coherence_counts"] == launches + 3
    _torch_tail(monkeypatch)
    plain = tco._mc_histogram_run_pairs(*args, **kw)
    assert torch.equal(kernel, plain)
    assert int(kernel.sum()) == 3 * 10 * int(oc.sum())


def test_wct_significance_reads_the_same_curve(cuda, monkeypatch):
    kw = dict(mc_count=300, cache=False, progress=False, seed=7, device=cuda, **JAO)
    cells = profiling.MC_HIST_KERNEL_CELLS
    kernel = tco.wct_significance(0.72, 0.55, **kw)
    assert profiling.MC_HIST_KERNEL_CELLS - cells == 300 * 76 * 885
    _torch_tail(monkeypatch)
    plain = tco.wct_significance(0.72, 0.55, **kw)
    np.testing.assert_array_equal(kernel, plain)


def test_wct_matrix_analysis_reads_the_same_curves(cuda, monkeypatch):
    y = NETWORK(PARAMS, 2 ** 31 + 6007, "cpu")["y"][0]
    kw = dict(dj=1 / 12, mother=M6, significance_level=0.95, mc_count=24, seed=5,
              cache=False)
    cells = profiling.MC_HIST_KERNEL_CELLS
    kernel = wct_matrix_analysis(y, 0.25, **kw)["sig95"]
    assert profiling.MC_HIST_KERNEL_CELLS > cells
    _torch_tail(monkeypatch)
    plain = wct_matrix_analysis(y, 0.25, **kw)["sig95"]
    assert kernel.shape == (15, 86)
    np.testing.assert_array_equal(kernel, plain)


@pytest.mark.parametrize("fault, error", [
    ("complex128 fields", TypeError), ("int32 counts", TypeError),
    ("fields on the CPU", ValueError), ("mask on the CPU", ValueError),
    ("strided fields", ValueError), ("3-D fields", ValueError)])
def test_the_wrapper_refuses_on_the_card(cuda, fault, error):
    Sm = torch.ones((1, 3, 4, 20), dtype=torch.complex64, device=cuda)
    Cm, mask = Sm.clone(), torch.ones((4, 20), dtype=torch.bool, device=cuda)
    acc = torch.zeros((1, 4, tco.NBINS), dtype=torch.int64, device=cuda)
    if fault == "complex128 fields":
        Sm = Sm.to(torch.complex128)
    elif fault == "int32 counts":
        acc = acc.int()
    elif fault == "fields on the CPU":
        Sm = Sm.cpu()
    elif fault == "mask on the CPU":
        mask = mask.cpu()
    elif fault == "strided fields":
        Sm = torch.ones((1, 3, 20, 4), dtype=torch.complex64, device=cuda).transpose(2, 3)
    else:
        Sm, Cm = Sm[0], Cm[0]
    launches = mc_hist.LAUNCHES["mc_coherence_counts"]
    with pytest.raises(error):
        mc_hist.coherence_counts(Sm, Cm, mask, 3, acc)
    assert mc_hist.LAUNCHES["mc_coherence_counts"] == launches

"""The Monte-Carlo significance and the f64 routing on the card: the
generator's words on CPU and CUDA, curves and histograms bit-identical
across ``mc_batch`` and ``pair_block`` on both kernel routes, the f64 curve
equal to the CPU's, and the NINO3 golden at 1e-10 with an f64 config and the
default engine.  They need an NVIDIA card, so they skip where there is none;
``python -m pytest --noconftest tests/test_torch_mc_cuda.py`` on the card
runs them."""
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
#: JAO/JBaltic's Monte-Carlo shape (S = 76, n = 885, nfft = 1024)
JAO = dict(dt=0.25, dj=1 / 12, s0=0.48400665459719555, J=75)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["0", "1"], ids=["K1K2", "K3"])
def route(request, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", request.param)
    return request.param


def _rel_err(a, b):
    mask = np.abs(b) > 1e-12 * np.abs(b).max()
    return float((np.abs(a - b)[mask] / np.abs(b)[mask]).max())


def test_generator_words_equal_on_cpu_and_cuda(cuda):
    idx = torch.arange(300)
    words = [tst.fold_in(tst.PRNGKey(7, device=d), idx.to(d)) for d in ("cpu", cuda)]
    for w_cpu, w_cuda in zip(*words):
        assert torch.equal(w_cpu, w_cuda.cpu())
    z = [tst._normal_f64(w, 885) for w in words]
    assert float((z[0] - z[1].cpu()).abs().max()) < 1e-13
    key = tst.PRNGKey(7, device=cuda)
    assert key[0].device.type == "cuda"


def test_mc_bit_identical_across_mc_batch(cuda, route):
    """Curves and summed histograms at mc_batch 60, 16 and 7 (on K1+K2, or
    on cwt_direct under PYCWT_TPU_SMALL_KERNEL=1) are bit-identical."""
    n, sj, oc, _, _ = tco._surrogate_grid(JAO["dt"], JAO["dj"], JAO["s0"], JAO["J"],
                                          pt.Morlet(6))
    scales = torch.tensor(sj, dtype=torch.float32, device=cuda)
    oc = torch.tensor(oc, device=cuda)
    key = tst.PRNGKey(7, device=cuda)
    kw = dict(mother=pt.Morlet(6), nfft=1024, dj=JAO["dj"], n=n, al1=0.018, al2=0.085)
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0
    hists = [sum(tco._mc_histogram_chunk(key, s, scales, oc, JAO["dt"],
                                         batch=min(b, 60 - s), **kw)
                 for s in range(0, 60, b)) for b in (60, 16, 7)]
    for h in hists[1:]:
        assert torch.equal(h, hists[0])
    assert int(hists[0].sum()) == 60 * int(oc.sum())
    small = route == "1"
    assert (fc.KERNEL_LAUNCHES["cwt_direct"] > 0) == small
    assert (fc.KERNEL_LAUNCHES["cwt_stage_a"] > 0) == (not small)
    curves = [tco.wct_significance(0.018, 0.085, mc_count=60, mc_batch=b, seed=7,
                                   cache=False, progress=False, **JAO)
              for b in (60, 16, 7)]
    for c in curves[1:]:
        np.testing.assert_array_equal(c, curves[0])


def test_mc_batch_bit_identical_across_pair_block(cuda):
    kw = dict(mc_count=24, seed=3, cache=False, progress=False, **JAO)
    al1, al2 = [0.1, 0.3, 0.5, 0.7, 0.2], [0.2, 0.0, 0.6, 0.1, 0.4]
    a = tco.wct_significance_batch(al1, al2, pair_block=5, mc_batch=24, **kw)
    b = tco.wct_significance_batch(al1, al2, pair_block=2, mc_batch=7, **kw)
    np.testing.assert_array_equal(a, b)


def test_mc_f64_on_the_card_equals_the_cpu(cuda):
    """An f64 config on the card runs cuFFT in f64 ("xla") from the same
    streams: its curve is the CPU's."""
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=40, seed=4, cache=False,
              progress=False, mc_batch=16, config=CWTConfig(dtype=torch.float64))
    on_card = tco.wct_significance(0.5, 0.6, **kw)
    on_cpu = tco.wct_significance(0.5, 0.6, device="cpu", **kw)
    assert np.array_equal(np.isnan(on_card), np.isnan(on_cpu))
    assert np.nanmax(np.abs(on_card - on_cpu)) < 1e-9


def test_f64_config_runs_f64_on_the_card(cuda):
    """NINO3's |W| at the golden's 1e-10 with an f64 config and the default
    engine: no silent f32 kernels."""
    g = np.load(os.path.join(GOLDEN, "cwt_nino3_morlet6.npz"))
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0
    W, *_ = pt.cwt(g["signal"], float(g["dt"]), config=CWTConfig(dtype=torch.float64))
    assert W.dtype == np.complex128
    assert _rel_err(W, g["W"]) < 1e-10
    power, *_ = pt.cwt_power(g["signal"], float(g["dt"]),
                             config=CWTConfig(dtype=torch.float64))
    assert _rel_err(power, np.abs(g["W"]) ** 2) < 1e-10
    assert sum(fc.KERNEL_LAUNCHES.values()) == 0

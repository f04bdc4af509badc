"""The many-pair and long-signal surfaces on the card: wct_matrix against the
CPU f64 port, blocking of pairs, the overlap-save planar surfaces against the
global transform at N = 2^16, and DOG's spectral envelope inside cwt_stage_a
and cwt_direct at scales where f^m overflows float32.  They need an NVIDIA
card, so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_pairs_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.coherence import _wct_core_planar
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import overlap as tov
from pycwt_torch.ops.mxu_dft import fft_of_real_planar

torch.set_num_threads(2)

M6 = pt.Morlet(6)


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


def _reset():
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0


def _rel_err(a, b):
    mask = np.abs(b) > 1e-12 * np.abs(b).max()
    return float((np.abs(a - b)[mask] / np.abs(b)[mask]).max())


def _stations(B=8, n0=512, seed=7):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.4, 0.8, B)
    y = np.zeros((B, n0 + 256))
    e = rng.standard_normal(y.shape)
    for t in range(1, y.shape[1]):
        y[:, t] = g * y[:, t - 1] + e[:, t]
    return y[:, 256:]


def test_wct_matrix_on_the_card_matches_cpu_f64(cuda, route):
    """The card's f32 maps on either kernel route against the CPU f64 port
    at rel_err 1e-3 (tests/test_engines.py:170), with the route's kernels
    launched."""
    y = _stations()
    _reset()
    W, A, coi, freq, pairs = pt.wct_matrix(y, 0.25, dj=1 / 8)
    torch.cuda.synchronize()
    small = route == "1"
    assert (fc.KERNEL_LAUNCHES["cwt_direct"] > 0) == small
    assert (fc.KERNEL_LAUNCHES["cwt_stage_a"] > 0) == (not small)
    Wc, *_ = pt.wct_matrix(y, 0.25, dj=1 / 8, device="cpu",
                           config=CWTConfig(dtype=torch.float64))
    assert W.dtype == np.float32 and W.shape == Wc.shape
    assert _rel_err(W, Wc) < 1e-3


def test_pair_blocking_on_the_card(cuda):
    """Blocks of 7 (a ragged last one) against the auto block: the maps
    agree within 1e-6 (the cuFFT and cuBLAS rows of one pair need not be
    bit-identical across batch sizes)."""
    y = _stations(B=6)
    Wa, Aa, *_ = pt.wct_matrix(y, 0.25, dj=1 / 8, as_numpy=False)
    Wb, Ab, *_ = pt.wct_matrix(y, 0.25, dj=1 / 8, pair_block=7, as_numpy=False)
    assert Wa.device.type == "cuda"
    assert float((Wa - Wb).abs().max()) <= 1e-6
    Pa, *_ = pt.wct_pairs(y[:5], y[1:], 0.25, dj=1 / 8)
    Pb, *_ = pt.wct_pairs(y[:5], y[1:], 0.25, dj=1 / 8, pair_block=2)
    assert np.abs(Pa - Pb).max() <= 1e-6
    Xa, *_ = pt.xwt_pairs_planar(y[:5], y[1:], 0.25, dj=1 / 8)
    Xb, *_ = pt.xwt_pairs_planar(y[:5], y[1:], 0.25, dj=1 / 8, pair_block=3)
    assert np.abs(Xa - Xb).max() <= 1e-6 * np.abs(Xa).max()


def test_overlap_planar_matches_global_on_the_card(cuda):
    """N = 2^16, chunk 2^13: the blocked planar CWT, XWT and WCT against the
    global transform on the card, interior, s ≥ 4dt; K1+K2 launched twice a
    chunk and signal."""
    N, chunk = 1 << 16, 1 << 13
    rng = np.random.default_rng(3)
    y1 = torch.tensor(rng.standard_normal(N), dtype=torch.float32, device=cuda)
    y2 = 0.5 * y1 + torch.tensor(rng.standard_normal(N), dtype=torch.float32,
                                 device=cuda)
    sc = torch.tensor([4.0, 8.0, 16.0, 32.0, 64.0], device=cuda)
    _reset()
    wr, wi = tov.cwt_overlap_save_planar(y1, sc, 1.0, mother=M6, chunk=chunk)
    assert fc.KERNEL_LAUNCHES["cwt_stage_a"] == N // chunk
    gr, gi = fc._planar_cwt_of_real(y1, sc, mother=M6, nfft=N, dt=1.0)
    H = tov.halo_samples(64.0, 1.0)
    sl = slice(H, N - H)
    scale = float(torch.sqrt(gr ** 2 + gi ** 2).max())
    err = max(float((wr - gr)[:, sl].abs().max()), float((wi - gi)[:, sl].abs().max()))
    assert err <= 2e-4 * scale
    pw = tov.streamed_global_power_planar(y1, sc, 1.0, mother=M6, chunk=chunk)
    torch.testing.assert_close(pw, (wr ** 2 + wi ** 2).sum(-1), rtol=3e-5, atol=0)
    W = tov.cwt_overlap_save(y1, sc, 1.0, mother=M6, chunk=chunk)
    assert float((W - torch.complex(wr, wi)).abs().max()) <= 2e-5 * scale
    n1 = (y1 - y1.mean()) / y1.std(correction=0)
    n2 = (y2 - y2.mean()) / y2.std(correction=0)
    R, A = tov.wct_overlap_planar(y1, y2, sc, 1.0, mother=M6, dj=0.5, chunk=chunk)
    Rg, Ag, _ = _wct_core_planar(n1[None], n2[None], sc, 1.0, mother=M6, nfft=N, dj=0.5)
    H2 = 2 * H
    assert float((R - Rg[0])[:, H2:N - H2].abs().max()) <= 2e-4
    M, _ = tov.xwt_overlap_planar(y1, y2, sc, 1.0, mother=M6, chunk=chunk)
    w1 = torch.complex(*fc._planar_cwt_of_real(n1, sc, mother=M6, nfft=N, dt=1.0))
    w2 = torch.complex(*fc._planar_cwt_of_real(n2, sc, mother=M6, nfft=N, dt=1.0))
    ref = (w1 * w2.conj()).abs()
    assert float((M - ref)[:, sl].abs().max()) <= 3e-5 * float(ref.max())


@pytest.mark.parametrize("nfft, small", [(1 << 20, False), (1 << 12, True)])
def test_dog_envelope_in_the_kernels(cuda, nfft, small):
    """DOG(6) with scales up to 2·nfft (f^6 overflows f32 there): K1+K2 at
    nfft 2^20 and K3 at 2^12 give finite planes that match the f64 plain
    version at the `high` bound."""
    x = torch.tensor(np.random.default_rng(5).standard_normal(nfft),
                     dtype=torch.float32, device=cuda)
    sr, si = fft_of_real_planar(x[None], nfft)
    sc = torch.tensor([2.0, float(nfft) ** 0.5, 2.0 * nfft], device=cuda)
    kw = dict(mother=pt.DOG(6), nfft=nfft, dt=1.0)
    _reset()
    wr, wi = fc.fused_cwt_planar(sr, si, sc, small_kernel=small, **kw)
    assert fc.KERNEL_LAUNCHES["cwt_direct" if small else "cwt_stage_a"] == 1
    assert bool(torch.isfinite(wr).all()) and bool(torch.isfinite(wi).all())
    rr, ri = fc._fused_cwt_planar_reference(sr.double(), si.double(), sc.double(), **kw)
    scale = float(torch.sqrt(rr ** 2 + ri ** 2).max())
    err = max(float((wr.double() - rr).abs().max()), float((wi.double() - ri).abs().max()))
    assert err <= 2e-4 * scale

"""Parity mode on the card: the f64 goldens through ``cwt_twofloat``,
``xwt_twofloat`` and ``wct_twofloat`` within 1e-6 (the bound of
tests/test_tpu_chip.py:63-65; native f64 lands near 1e-12), no hand kernel
launched, also under ``PYCWT_TPU_ENGINE=planar``, and the card's results
equal to the CPU's.  They need an NVIDIA card, so they skip where there is
none; ``python -m pytest --noconftest tests/test_torch_twofloat_cuda.py`` on
the card runs them."""
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import twofloat as tf

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: parity mode's default device")
    return torch.device("cuda")


@pytest.fixture(params=["unset", "planar"])
def engine_env(request, monkeypatch):
    if request.param == "unset":
        monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    else:
        monkeypatch.setenv("PYCWT_TPU_ENGINE", request.param)
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0
    yield request.param
    assert sum(fc.KERNEL_LAUNCHES.values()) == 0, fc.KERNEL_LAUNCHES


def _golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def _rel_err(a, b):
    mask = np.abs(b) > 1e-12 * np.abs(b).max()
    return float((np.abs(a - b)[mask] / np.abs(b)[mask]).max())


def test_cwt_twofloat_golden_on_the_card(cuda, engine_env):
    g = _golden("cwt_nino3_morlet6")
    W, sj, fr, coi = pt.cwt_twofloat(g["signal"], float(g["dt"]))
    assert W.dtype == np.complex128 and W.shape == g["W"].shape
    assert _rel_err(np.abs(W) ** 2, np.abs(g["W"]) ** 2) < 1e-6
    Wc, *_ = pt.cwt_twofloat(g["signal"], float(g["dt"]), device="cpu")
    assert np.abs(W - Wc).max() < 1e-12 * np.abs(Wc).max()


def test_xwt_wct_twofloat_goldens_on_the_card(cuda, engine_env):
    gx = _golden("xwt_jao_jbaltic_norm1")
    W12, coi, fr = pt.xwt_twofloat(gx["y1"], gx["y2"], float(gx["dt"]))
    assert _rel_err(np.abs(W12), np.abs(gx["W12"])) < 1e-6
    gw = _golden("wct_jao_jbaltic")
    WCT, aW, coi2, fr2 = pt.wct_twofloat(gw["y1"], gw["y2"], float(gw["dt"]))
    assert _rel_err(WCT, gw["WCT"]) < 1e-6
    m = gw["WCT"] > 0.5
    assert np.abs(((aW - gw["aWCT"]) + np.pi) % (2 * np.pi) - np.pi)[m].max() < 1e-6


def test_fft_df_and_smoothing_stay_on_the_card(cuda):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
    planes = [torch.tensor(p, device=cuda) for p in
              (*tf.df_from_f64(x.real), *tf.df_from_f64(x.imag))]
    out = tf.fft_df(*planes, 1024)
    assert all(o.device.type == "cuda" and o.dtype == torch.float32 for o in out)
    host_planes = [p.cpu().numpy() for p in planes]
    assert all(o.device.type == "cuda" for o in tf.fft_df(*host_planes, 1024))
    got = (tf.df_to_f64(out[0].cpu(), out[1].cpu())
           + 1j * tf.df_to_f64(out[2].cpu(), out[3].cpu()))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() < 1e-13 * np.abs(ref).max()
    g = _golden("smooth")
    T = np.abs(np.asarray(g["Wc"])) ** 2
    args = (g["scales"], float(g["dt"]), float(g["dj"]), pt.Morlet(6))
    card = tf.smooth_twofloat(T, *args)
    host = tf.smooth_twofloat(T, *args, device="cpu")
    assert np.abs(card - host).max() < 1e-13 * np.abs(host).max()


def test_batch_guard_raises_before_device_work(cuda):
    with pytest.raises(ValueError, match="Split the batch"):
        pt.cwt_twofloat(np.zeros((64, 2048)), 1.0, max_bytes=1e6)

"""The port's f32 matrix products on the card ignore the process's TF32 and
bf16 settings (``pycwt_torch/ops/_precision.full_f32_matmul``): under
``torch.set_float32_matmul_precision("high")`` or ``"medium"``,
``allow_tf32`` and the newer ``fp32_precision`` settings, the smoothing, the
WCT on both kernel routes, ``wct_matrix``, the global spectrum and a
coherence gradient give the bits they give under "highest", and the
caller's setting reads back unchanged.  They need an NVIDIA card, so they
skip where there is none; ``python -m pytest --noconftest
tests/test_torch_matmul_pin_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch.analysis import global_spectrum
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import smoothing as tsm
from test_torch_matmul_pin_support import CALLERS, restore, state

M6 = pt.Morlet(6)
#: the caller settings that reach cuBLAS
CARD_CALLERS = ("high", "medium", "allow_tf32", "fp32_precision_cuda_tf32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    saved = state()
    yield torch.device("cuda")
    restore(saved)


def _surfaces(dev, monkeypatch):
    """name -> result of each surface, on the card, on both kernel routes."""
    rng = np.random.default_rng(0)
    y1 = rng.standard_normal(885)
    y2 = 0.5 * y1 + rng.standard_normal(885)
    Y = rng.standard_normal((8, 512))
    Ta = torch.tensor(rng.standard_normal((3, 40, 300)), dtype=torch.float32, device=dev)
    Tb = torch.tensor(rng.standard_normal((3, 40, 300)), dtype=torch.float32, device=dev)
    sj = torch.tensor(2.0 * 2 ** (np.arange(40) / 8), dtype=torch.float32, device=dev)
    out = {"smooth": tsm.smooth(Ta, 1.0, 1 / 8, sj, M6),
           "smooth_planar_pair": torch.stack(
               tsm.smooth_planar_pair(Ta, Tb, 1.0, 1 / 8, sj, M6)),
           "global_spectrum": torch.tensor(global_spectrum(y1, 0.25, device=dev)[0])}
    for small in ("0", "1"):
        monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", small)
        for k in fc.KERNEL_LAUNCHES:
            fc.KERNEL_LAUNCHES[k] = 0
        out[f"wct_{small}"] = torch.tensor(pt.wct(y1, y2, 0.25, sig=False,
                                                  device=dev)[0])
        out[f"wct_matrix_{small}"] = pt.wct_matrix(Y, 1.0, device=dev, as_numpy=False)[0]
        a = torch.tensor(y1[:512], dtype=torch.float32, device=dev, requires_grad=True)
        R, _, _ = tco._wct_core(a[None], torch.tensor(y2[:512], dtype=torch.float32,
                                                      device=dev)[None],
                                sj[::8], 1.0, mother=M6, nfft=512, dj=0.5)
        out[f"gradient_{small}"] = torch.autograd.grad(R.mean(), a)[0]
        kernel = "cwt_direct" if small == "1" else "cwt_stage_a"
        assert fc.KERNEL_LAUNCHES[kernel] > 0, fc.KERNEL_LAUNCHES
    return {k: v.detach().cpu() for k, v in out.items()}


@pytest.mark.parametrize("caller", CARD_CALLERS)
def test_card_products_ignore_tf32_and_bf16(cuda, monkeypatch, caller):
    torch.set_float32_matmul_precision("highest")
    ref = _surfaces(cuda, monkeypatch)
    CALLERS[caller]()
    before = state()
    got = _surfaces(cuda, monkeypatch)
    assert state() == before
    for name, want in ref.items():
        assert torch.equal(got[name], want), name


def test_unpinned_product_does_move_under_tf32(cuda):
    """The setting does reach a product outside the pin on this card, so the
    check above has something to hold."""
    g = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn(98, 98, generator=g, device=cuda)
    B = torch.randn(8, 98, 2048, generator=g, device=cuda)
    torch.set_float32_matmul_precision("highest")
    full = torch.matmul(A, B)
    torch.set_float32_matmul_precision("high")
    assert not torch.equal(torch.matmul(A, B), full)
    assert torch.equal(tsm._band_product(A, B), full)


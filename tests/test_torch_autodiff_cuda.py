"""Gradients through the coherence stack on the card
(tests/test_autodiff.py's bounds): ``_wct_core`` on the planar route, whose
forward runs K1+K2 (or K3 under ``PYCWT_TPU_SMALL_KERNEL=1``) and whose
backward replays the plain version, against the same loss built from the
plain versions; the f64 xla route against finite differences; the
lag-fitting loop in f64.  They need an NVIDIA card, so they skip where
there is none; ``python -m pytest --noconftest
tests/test_torch_autodiff_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

from pycwt_torch import coherence as tco
from pycwt_torch.ops import fused_cwt as fc
from test_torch_autodiff_support import (M6, finite_difference_error, fit_lag,
                                         lag_problem, reference_loss,
                                         wct_sum_problem)

torch.set_num_threads(2)

#: PYCWT_TPU_SMALL_KERNEL -> (the kernel that must launch, nfft)
ROUTES = {"0": ("cwt_stage_a", 1 << 14), "1": ("cwt_direct", 1 << 12)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=list(ROUTES), ids=["K1K2", "K3"])
def route(request, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", request.param)
    return request.param


def _reset():
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0


def test_planar_wct_core_gradient_through_the_kernels(cuda, route):
    kernel, nfft = ROUTES[route]
    rng = np.random.default_rng(6)
    y1 = torch.tensor(rng.standard_normal(nfft), dtype=torch.float32, device=cuda)
    y2 = torch.tensor(rng.standard_normal(nfft), dtype=torch.float32, device=cuda)
    scales = torch.tensor([4.0, 16.0, 64.0], device=cuda)
    a = y1.clone().requires_grad_(True)
    _reset()
    WCT, _, _ = tco._wct_core(a[None], y2[None], scales, 1.0, mother=M6, nfft=nfft,
                              dj=0.5, engine="planar")
    (g,) = torch.autograd.grad(WCT.mean(), a)
    launches = dict(fc.KERNEL_LAUNCHES)
    assert launches[kernel] == 2, launches
    a = y1.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(reference_loss(y2, scales, nfft)(a), a)
    assert bool(torch.isfinite(g).all())
    torch.testing.assert_close(g, g_ref, rtol=0, atol=2e-4 * float(g_ref.abs().max()))


def test_wct_core_f64_gradient_matches_finite_difference(cuda):
    y1, _, _, loss = wct_sum_problem(cuda)
    _reset()
    (g,) = torch.autograd.grad(loss(y1), y1)
    assert sum(fc.KERNEL_LAUNCHES.values()) == 0
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert finite_difference_error(loss, y1, g) < 1e-4


def test_fit_lag_on_the_card(cuda):
    lag, losses = fit_lag(lag_problem(cuda), cuda)
    assert losses[-1] < losses[0]
    assert abs(lag - 3.7) < 0.2, f"recovered lag {lag}"

"""The problems that the coherence-stack gradient checks share
(tests/test_autodiff.py:114-231), on any device: the plain planar WCT loss,
the f64 WCT sum with its finite differences, and the lag-fitting loop.
``tests/test_torch_autodiff.py`` (CPU), ``tests/test_torch_autodiff_cuda.py``
and ``chip_smoke.py`` (the card) import them; this module imports no JAX.
Its own test checks the lag problem's loss on the CPU."""
import numpy as np
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops.mxu_dft import fft_of_real_planar
from pycwt_torch.ops.smoothing import smooth_planar_pair

M6 = pt.Morlet(6)
#: the lag that the lag problem's signals are shifted by
TRUE_LAG = 3.7


def reference_loss(y2, scales, nfft, mother=M6):
    """tests/test_autodiff.py:164-181: the planar WCT built on the plain
    transform, ``smooth_planar_pair`` and the coherence ratio."""
    def one(y):
        sr, si = fft_of_real_planar(y[None], nfft)
        return fc._fused_cwt_planar_reference(sr, si, scales, mother=mother,
                                              nfft=nfft, dt=1.0)

    def loss(a):
        w1r, w1i = one(a)
        w2r, w2i = one(y2)
        s_col = scales[:, None]
        S1, S2 = smooth_planar_pair((w1r ** 2 + w1i ** 2) / s_col,
                                    (w2r ** 2 + w2i ** 2) / s_col, 1.0, 0.5, scales,
                                    mother)
        S12r, S12i = smooth_planar_pair((w1r * w2r + w1i * w2i) / s_col,
                                        (w1i * w2r - w1r * w2i) / s_col, 1.0, 0.5,
                                        scales, mother)
        return ((S12r ** 2 + S12i ** 2) / (S1 * S2)).mean()
    return loss


def wct_sum_problem(device):
    """tests/test_autodiff.py:114-139's inputs and loss, f64 on ``device``:
    ``(y1, y2, scales, loss)`` with ``loss(v)`` the sum of the WCT of v and
    y2 on the xla route; ``y1`` requires grad."""
    rng = np.random.default_rng(5)
    N = 128
    y1 = torch.tensor(rng.standard_normal(N), device=device, requires_grad=True)
    y2 = torch.tensor(rng.standard_normal(N), device=device)
    scales = torch.tensor([2.0, 4.0, 8.0], dtype=torch.float64, device=device)

    def loss(v):
        WCT, _, _ = tco._wct_core(v[None], y2[None], scales, 1.0, mother=M6, nfft=N,
                                  dj=0.5, engine="xla")
        return torch.sum(WCT)

    return y1, y2, scales, loss


def finite_difference_error(loss, x, g, idxs=(3, 64, 100), eps=1e-6):
    """The largest ``|g[i] − fd_i| / max(1, |fd_i|)`` over ``idxs``, with
    ``fd_i`` the centered finite difference of ``loss`` at ``x``."""
    err = 0.0
    with torch.no_grad():
        for idx in idxs:
            e = torch.zeros_like(x)
            e[idx] = eps
            fd = float((loss(x + e) - loss(x - e)) / (2 * eps))
            err = max(err, abs(float(g[idx]) - fd) / max(1.0, abs(fd)))
    return err


def lag_problem(device):
    """tests/test_autodiff.py:191-231's data and loss, f64 on ``device``:
    the loss of a model lag, whose minimum is at the true lag 3.7."""
    N = 256
    rng = np.random.default_rng(8)
    base = np.cumsum(rng.standard_normal(N + 64))[32:32 + N]
    base = torch.tensor((base - base.mean()) / base.std(), device=device)
    scales = torch.tensor([2.0, 4.0, 8.0, 16.0], dtype=torch.float64, device=device)
    k = torch.fft.fftfreq(N, dtype=torch.float64, device=device)

    def shift(y, lag):
        # Differentiable fractional shift via a Fourier phase ramp.
        return torch.fft.ifft(torch.fft.fft(y) * torch.exp(-2j * torch.pi * k * lag)).real

    y2 = shift(base, torch.tensor(TRUE_LAG, dtype=torch.float64, device=device))

    def loss(lag):
        _, _, W12 = tco._wct_core(shift(y2, -lag)[None], base[None], scales, 1.0,
                                  mother=M6, nfft=N, dj=0.5, engine="xla")
        return -torch.mean(W12.real)

    return loss


def fit_lag(loss, device, steps=60, lr=2.0):
    """Gradient descent on ``loss`` from lag 0: (the lag, the losses)."""
    lag = torch.tensor(0.0, dtype=torch.float64, device=device)
    losses = []
    for _ in range(steps):
        lag.requires_grad_(True)
        v = loss(lag)
        (g,) = torch.autograd.grad(v, lag)
        losses.append(float(v.detach()))
        lag = (lag - lr * g).detach()
    return float(lag), losses


def test_lag_problem_loss_is_least_at_the_true_lag():
    """On a grid of whole lags the loss is least at the one nearest 3.7."""
    loss = lag_problem("cpu")
    with torch.no_grad():
        values = [float(loss(torch.tensor(float(lag), dtype=torch.float64)))
                  for lag in range(9)]
    assert int(np.argmin(values)) == round(TRUE_LAG)

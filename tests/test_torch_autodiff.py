"""Gradients through the port's coherence stack on the CPU: a mirror of
tests/test_autodiff.py at its bounds, against pycwt_tpu's gradients on the
same inputs.  The CWT's own finite-difference and reconstruction mirrors
(tests/test_autodiff.py:19-52) are in tests/test_torch_cwt.py, and the
small kernel's (:91-111) in tests/test_torch_direct.py; here are the fused
planar pipeline at JAX's nfft, the reconstruction through it, the WCT core
on the xla route (finite differences) and on the planar route (both kernel
routes' autograd Functions), and the lag-fitting loop.

On a CPU tensor ``fused_cwt_planar`` runs the plain version, so the kernel
routes' autograd Functions (``_FusedCWT``: forward stage A and B, backward
the plain replay; ``_FusedDirect``: K3) are called here directly; their
forward runs each kernel's plain version with the kernel's layout."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mxu_dft as tdft
from pycwt_torch.transform import build_scale_grid, icwt_planar
# the problems shared with the card's checks (that module imports no JAX)
from test_torch_autodiff_support import (finite_difference_error, fit_lag,
                                         lag_problem, reference_loss,
                                         wct_sum_problem)

torch.set_num_threads(2)

#: kernel route -> (autograd Function, the nfft tests/test_autodiff.py uses)
ROUTES = {"K1K2": (fc._FusedCWT, 1 << 14), "K3": (fc._FusedDirect, 1 << 12)}


def _via_function(route, sr, si, scales, mother, nfft, output):
    """The route's autograd Function on ``(..., n)`` planar spectra."""
    lead = sr.shape[:-1]
    out = route.apply(sr.reshape(-1, sr.shape[-1]), si.reshape(-1, si.shape[-1]),
                      scales, mother, nfft, 1.0, output)
    if output == "planes":
        return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)
    return out.reshape(*lead, *out.shape[1:])


def test_grad_through_fused_planar_pipeline():
    """The four-step route's autograd Function at nfft 2^14 (stage A and B
    forward, the plain replay backward) against the plain formulation, and
    against JAX's gradient of the same loss through its planar-XLA
    formulation (tests/test_autodiff.py:55-88): x at 1e-4 of the largest
    gradient, the scales path through the envelope at rtol 1e-4."""
    from pycwt_tpu.ops.mxu_dft import fft_of_real_planar as jfft_planar
    from pycwt_tpu.ops.pallas_fft import _small_planar_xla

    rng = np.random.default_rng(3)
    nfft = 1 << 14
    x0 = rng.standard_normal(nfft).astype(np.float32)
    sc0 = np.array([4.0, 16.0, 64.0], np.float32)
    m = pt.Morlet(6)

    def grads(fn):
        x = torch.tensor(x0, requires_grad=True)
        sc = torch.tensor(sc0, requires_grad=True)
        sr, si = tdft.fft_of_real_planar(x, nfft)
        return torch.autograd.grad(fn(sr, si, sc).sum() / nfft, (x, sc))

    gx, gs = grads(lambda sr, si, sc: _via_function(
        fc._FusedCWT, sr, si, sc, m, nfft, "power_sum"))
    rx, rs = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(
        sr, si, sc, mother=m, nfft=nfft, dt=1.0, output="power_sum"))
    assert torch.isfinite(gx).all()
    torch.testing.assert_close(gx, rx, rtol=0, atol=1e-4 * float(rx.abs().max()))
    torch.testing.assert_close(gs, rs, rtol=1e-4, atol=0)

    def jloss(x, scales):
        sr, si = jfft_planar(x, nfft)
        wr, wi = _small_planar_xla(sr, si, scales, mother=wt.Morlet(6), nfft=nfft,
                                   dt=1.0, precision=jax.lax.Precision.HIGHEST)
        return (wr * wr + wi * wi).sum() / nfft

    jx, js = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(sc0))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-4 * float(jnp.abs(jx).max()))
    np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_grad_through_reconstruction_on_kernel_routes(route):
    """cwt → icwt_planar reconstruction loss through each route's autograd
    Function: finite, non-zero and equal to the plain formulation's
    gradient (tests/test_autodiff.py:36-52 on the planar route)."""
    fn_route, _ = ROUTES[route]
    N = 256
    x0 = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    scales = torch.tensor(build_scale_grid(N, 1.0, dj=0.25, s0=2.0, J=8).sj,
                          dtype=torch.float32)
    m = pt.Morlet(6)

    def grad(cwt):
        x = torch.tensor(x0, requires_grad=True)
        sr, si = tdft.fft_of_real_planar(x, N)
        wr, _ = cwt(sr, si)
        xr = icwt_planar(wr, scales, 1.0, 0.25, mother=m)
        (g,) = torch.autograd.grad(torch.mean((xr - x) ** 2), x)
        return g

    g = grad(lambda sr, si: _via_function(fn_route, sr, si, scales, m, N, "planes"))
    g_ref = grad(lambda sr, si: fc._fused_cwt_planar_reference(
        sr, si, scales, mother=m, nfft=N, dt=1.0))
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    torch.testing.assert_close(g, g_ref, rtol=0, atol=1e-4 * float(g_ref.abs().max()))


def test_grad_through_wct_core_finite_difference():
    """The full coherence stack on the xla route in f64 (two CWTs, three
    smoothings, the ratio) against centered finite differences at 1e-4
    (tests/test_autodiff.py:114-139), and against JAX's gradient."""
    from pycwt_tpu.coherence import _wct_core as jwct_core

    y1, y2, scales, loss = wct_sum_problem("cpu")
    (g,) = torch.autograd.grad(loss(y1), y1)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    assert finite_difference_error(loss, y1, g) < 1e-4

    def jloss(a):
        WCT, _, _ = jwct_core(a[None], jnp.asarray(y2.numpy())[None],
                              jnp.asarray(scales.numpy()), 1.0, mother=wt.Morlet(6),
                              nfft=128, dj=0.5, engine="xla")
        return jnp.sum(WCT)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(y1.detach().numpy())))
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-10, atol=1e-10 * np.abs(gj).max())


@pytest.mark.parametrize("route", ROUTES)
def test_grad_through_planar_wct_core_matches_xla_formulation(route, monkeypatch):
    """``_wct_core(engine="planar")`` with its forward transforms through the
    route's autograd Function (as on the card) composed with the
    plane-packed smoothing and the ratio, against the same loss on the plain
    transform at 2e-4 of the largest gradient (tests/test_autodiff.py:
    142-188), the K1+K2 route at nfft 2^14 and K3's at 2^12."""
    fn_route, nfft = ROUTES[route]
    rng = np.random.default_rng(6)
    y1 = torch.tensor(rng.standard_normal(nfft), dtype=torch.float32)
    y2 = torch.tensor(rng.standard_normal(nfft), dtype=torch.float32)
    scales = torch.tensor([4.0, 16.0, 64.0])
    mother = pt.Morlet(6)
    calls = []

    def planar_w(y, sc, *, mother, nfft, dt, precision="highest"):
        calls.append(route)
        sr, si = tdft.fft_of_real_planar(y, nfft)
        return _via_function(fn_route, sr, si, sc, mother, nfft, "planes")

    monkeypatch.setattr(tco, "_planar_w", planar_w)

    def loss_planar(a):
        WCT, _, _ = tco._wct_core(a[None], y2[None], scales, 1.0, mother=mother,
                                  nfft=nfft, dj=0.5, engine="planar")
        return WCT.mean()

    a = y1.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_planar(a), a)
    assert calls == [route, route]
    a = y1.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(
        reference_loss(y2, scales, nfft, mother)(a), a)
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g, g_ref, rtol=0, atol=2e-4 * float(g_ref.abs().max()))


def test_planar_wct_core_gradient_matches_pycwt_tpu():
    """The port's planar WCT core (plain versions on the CPU) and pycwt_tpu's
    planar-XLA formulation of it give the same gradient at 2e-4 of the
    largest, at an nfft where JAX's planar route is XLA (2^12)."""
    from pycwt_tpu.ops.mxu_dft import fft_of_real_planar as jfft_planar
    from pycwt_tpu.ops.pallas_fft import _small_planar_xla
    from pycwt_tpu.ops.smoothing import smooth_planar_pair as jsmooth_pair

    nfft = 1 << 12
    rng = np.random.default_rng(6)
    y1 = rng.standard_normal(nfft).astype(np.float32)
    y2 = rng.standard_normal(nfft).astype(np.float32)
    sc = np.array([4.0, 16.0, 64.0], np.float32)
    a = torch.tensor(y1, requires_grad=True)
    WCT, _, _ = tco._wct_core(a[None], torch.tensor(y2)[None], torch.tensor(sc), 1.0,
                              mother=pt.Morlet(6), nfft=nfft, dj=0.5, engine="planar")
    (g,) = torch.autograd.grad(WCT.mean(), a)

    scales = jnp.asarray(sc)
    mother = wt.Morlet(6)

    def jloss(v):
        def one(y):
            sr, si = jfft_planar(y, nfft)
            return _small_planar_xla(sr, si, scales, mother=mother, nfft=nfft, dt=1.0,
                                     precision=jax.lax.Precision.HIGHEST)
        w1r, w1i = one(v)
        w2r, w2i = one(jnp.asarray(y2))
        s_col = scales[:, None]
        S1, S2 = jsmooth_pair((w1r ** 2 + w1i ** 2) / s_col,
                              (w2r ** 2 + w2i ** 2) / s_col, 1.0, 0.5, scales, mother)
        S12r, S12i = jsmooth_pair((w1r * w2r + w1i * w2i) / s_col,
                                  (w1i * w2r - w1r * w2i) / s_col, 1.0, 0.5, scales,
                                  mother)
        return ((S12r ** 2 + S12i ** 2) / (S1 * S2)).mean()

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(y1)))
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=2e-4 * np.abs(gj).max())


def test_fit_lag_by_descending_coherence_loss():
    """Recover a 3.7-sample lag by gradient descent on a smoothed
    cross-spectrum objective, 60 steps of lr 2 (tests/test_autodiff.py:
    191-231); the first step's gradient equals JAX's."""
    from pycwt_tpu.coherence import _wct_core as jwct_core

    loss = lag_problem("cpu")
    lag, losses = fit_lag(loss, "cpu")
    assert losses[-1] < losses[0]
    assert abs(lag - 3.7) < 0.2, f"recovered lag {lag}"

    N = 256
    rng = np.random.default_rng(8)
    base = jnp.asarray(np.cumsum(rng.standard_normal(N + 64)))[32:32 + N]
    base = (base - base.mean()) / base.std()
    k = jnp.fft.fftfreq(N)

    def jshift(y, lg):
        return jnp.real(jnp.fft.ifft(jnp.fft.fft(y) * jnp.exp(-2j * jnp.pi * k * lg)))

    y2 = jshift(base, 3.7)

    def jloss(lg):
        _, _, W12 = jwct_core(jshift(y2, -lg)[None], base[None],
                              jnp.asarray([2.0, 4.0, 8.0, 16.0]), 1.0,
                              mother=wt.Morlet(6), nfft=256, dj=0.5, engine="xla")
        return -jnp.mean(jnp.real(W12))

    v0 = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    (g0,) = torch.autograd.grad(loss(v0), v0)
    gj = float(jax.grad(jloss)(0.0))
    assert abs(float(g0) - gj) < 1e-10 * max(1.0, abs(gj))

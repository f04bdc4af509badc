"""The plain reference against independent float64 computations at a tiny
size: pycwt's formulas in numpy and scipy (FFT-based transform and
smoothing, ``convolve2d``), the program's own float64 surfaces on the CPU
for the Monte-Carlo null (the same threefry members), and TF32 rounding by
its definition."""
import math

import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from cwtbench.reference import cwt_f64, threefry, wct_f64

F0 = 6.0


def _np_cwt(x, sj, dt, nfft):
    """pycwt's cwt: the padded FFT times conj(psi_ft(s w)) sqrt(2 pi s/dt)."""
    n0 = len(x)
    X = np.fft.fft(x, nfft)
    w = 2 * np.pi * np.fft.fftfreq(nfft, dt)
    psi = np.pi ** -0.25 * np.exp(-0.5 * (sj[:, None] * w[None, :] - F0) ** 2)
    return np.fft.ifft(X[None, :] * np.sqrt(2 * np.pi * sj[:, None] / dt) * psi)[:, :n0]


def _np_smooth(W, sj, dt, dj):
    """pycwt's Morlet smooth: Gaussian in time by FFT, boxcar in scale."""
    m, n = W.shape
    nfft = 1 << (n - 1).bit_length()
    k = 2 * np.pi * np.fft.fftfreq(nfft)
    F = np.exp(-0.5 * (sj[:, None] / dt) ** 2 * k[None, :] ** 2)
    T = np.fft.ifft(F * np.fft.fft(W, nfft, axis=1), axis=1)[:, :n]
    T = T.real if np.isrealobj(W) else T
    L = int(round(0.6 / dj * 2))
    win = np.ones(L)
    win[0] = win[-1] = 0.5
    win /= win.sum()
    if np.iscomplexobj(T):
        return (convolve2d(T.real, win[:, None], "same")
                + 1j * convolve2d(T.imag, win[:, None], "same"))
    return convolve2d(T, win[:, None], "same")


def test_cwt_power_and_transform():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000)
    sc = cwt_f64.scale_grid(12, 1.0, 0.25, 2.0)
    want = _np_cwt(x, sc.numpy(), 1.0, 1024)
    xt = torch.as_tensor(x)
    got = np.concatenate([W.numpy() for _, _, W in cwt_f64.transform_blocks(
        xt, sc, dt=1.0, nfft=1024, f0=F0, block=5)])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    ps = cwt_f64.power_sum(xt, sc, dt=1.0, nfft=1024, f0=F0, block=5).numpy()
    np.testing.assert_allclose(ps, (np.abs(want) ** 2).sum(-1), rtol=1e-12)


def test_wct_against_pycwt_formulas():
    rng = np.random.default_rng(4)
    n0, dt, dj = 147, 0.25, 1 / 12
    y1 = np.cumsum(rng.standard_normal(n0)) * 0.2 + rng.standard_normal(n0)
    y2 = 0.6 * y1 + rng.standard_normal(n0)
    w, ph, coi, freqs, mag = wct_f64.wct(y1, y2, dt, dj, F0, wct_f64.Arith("f64"), "cpu")
    lam = 4 * np.pi / (F0 + np.sqrt(2 + F0 ** 2))
    s0 = 2 * dt / lam
    J = int(np.round(np.log2(n0 * dt / s0) / dj))
    sj = s0 * 2 ** (np.arange(J + 1) * dj)
    assert w.shape == (J + 1, n0) == (76, 147)
    n1, n2 = ((y - y.mean()) / y.std() for y in (y1, y2))
    W1, W2 = _np_cwt(n1, sj, dt, 256), _np_cwt(n2, sj, dt, 256)
    s = sj[:, None]
    S1 = _np_smooth(np.abs(W1) ** 2 / s, sj, dt, dj)
    S2 = _np_smooth(np.abs(W2) ** 2 / s, sj, dt, dj)
    W12 = W1 * W2.conj()
    S12 = _np_smooth(W12 / s, sj, dt, dj)
    np.testing.assert_allclose(w, np.abs(S12) ** 2 / (S1 * S2), atol=1e-12)
    assert np.max(np.abs(np.exp(1j * ph) - np.exp(1j * np.angle(W12))) * np.abs(W12)) \
        <= 1e-12 * np.abs(W12).max()
    np.testing.assert_allclose(mag, np.abs(W12), rtol=1e-12)
    tri = n0 / 2 - np.abs(np.arange(n0) - (n0 - 1) / 2)
    np.testing.assert_allclose(coi, lam / np.sqrt(2) * dt * tri, rtol=1e-15)
    np.testing.assert_allclose(freqs, 1 / (lam * sj), rtol=1e-15)


def test_ar1_and_normals_match_the_program():
    from pycwt_torch import stats

    rng = np.random.default_rng(5)
    y = rng.standard_normal(300).cumsum() * 0.1 + rng.standard_normal(300)
    assert wct_f64.ar1(y) == pytest.approx(stats.ar1(y)[0], rel=1e-14)
    key = threefry.prng_key(2 ** 33 + 17)
    k1, _ = threefry.split2(key)
    idx = torch.arange(5, 9)
    got = threefry.normal_f64(threefry.fold_in(k1, idx), 40)
    pk1, _ = stats.split(stats.PRNGKey(2 ** 33 + 17))
    want = stats._normal_f64(stats.fold_in(pk1, idx), 40)
    assert torch.equal(got, want)
    assert threefry.burn_in(0.7) == stats._burn_in(0.7)


def test_mc_curve_matches_the_programs_f64_curve():
    """The same members, float64 on both sides: the curves agree."""
    from pycwt_torch import coherence
    from pycwt_torch.config import CWTConfig

    dt, dj, n0 = 0.25, 1 / 12, 147
    s0, J, _, _ = wct_f64.grid(n0, dt, dj, F0)
    got = wct_f64.mc_significance(0.62, 0.45, dt, dj, s0, J, F0, 24, 2 ** 31 + 5,
                                  0.95, wct_f64.Arith("f64"), "cpu", block=10)
    want = coherence.wct_significance(0.62, 0.45, dt, dj, s0, J, 0.95, mc_count=24,
                                      seed=2 ** 31 + 5, cache=False, progress=False,
                                      config=CWTConfig(dtype=torch.float64),
                                      device="cpu")
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    assert np.abs(got[m] - want[m]).max() <= 1e-9


def test_tf32_rounding():
    one = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10, 1 + 3 * 2 ** -11, -(1 + 3 * 2 ** -11)])
    got = wct_f64.tf32_round(one.to(torch.float32))
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -9)])
    assert torch.equal(got, want)
    x = torch.randn(10000)
    rel = ((wct_f64.tf32_round(x) - x) / x).abs().max()
    assert 2 ** -12 < rel <= 2 ** -11


def test_arith_modes():
    with pytest.raises(ValueError):
        wct_f64.Arith("bf16")
    assert wct_f64.Arith("tf32").dtype == torch.float32
    v = np.array([math.pi])
    assert wct_f64.Arith("f64").host(v)[0] == math.pi
    assert abs(wct_f64.Arith("tf32").host(v)[0] / math.pi - 1) < 2 ** -11

"""The PyTorch port's forward/inverse CWT on the CPU at float64: the NINO3
goldens at the JAX package's bounds, parity with pycwt_tpu on identical
inputs, the engine and device rules, and gradients."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import transform as jtr
from pycwt_tpu.ops.spectra import global_power_parseval as j_parseval
from pycwt_torch import transform as ttr
from pycwt_torch.config import CWTConfig, next_pow2
from pycwt_torch.ops import fft as tfft
from pycwt_torch.ops.spectra import global_power_parseval as t_parseval
from tests.conftest import rel_err

torch.set_num_threads(2)

F64 = CWTConfig(dtype=torch.float64)
MOTHERS = {
    "morlet6": (wt.Morlet(6), pt.Morlet(6)),
    "paul4": (wt.Paul(4), pt.Paul(4)),
    "dog2": (wt.DOG(2), pt.DOG(2)),
    "dog6": (wt.DOG(6), pt.DOG(6)),
    "mexicanhat": (wt.MexicanHat(), pt.MexicanHat()),
}


@pytest.mark.parametrize("key", sorted(MOTHERS))
def test_cwt_golden_parity(golden, key):
    g = golden(f"cwt_nino3_{key}")
    W, sj, freqs, coi, sfft, fftfreqs = pt.cwt(
        g["signal"], float(g["dt"]), wavelet=MOTHERS[key][1], config=F64,
        device="cpu")
    assert W.shape == g["W"].shape
    assert rel_err(sj, g["sj"]) < 1e-12
    assert rel_err(freqs, g["freqs"]) < 1e-12
    assert rel_err(coi, g["coi"]) < 1e-12
    assert rel_err(fftfreqs, g["fftfreqs"]) < 1e-12
    assert rel_err(sfft, g["sfft"]) < 1e-10
    assert rel_err(W, g["W"]) < 1e-10


def test_cwt_custom_freqs(golden):
    g = golden("cwt_nino3_customfreqs")
    W, sj, *_ = pt.cwt(g["signal"], float(g["dt"]), freqs=g["cfreqs"],
                       config=F64, device="cpu")
    assert rel_err(sj, g["sj"]) < 1e-12
    assert rel_err(W, g["W"]) < 1e-10


def test_cwt_nopad_matches_reference_pyfftw_path(golden):
    g = golden("cwt_nino3_nopad")
    cfg = CWTConfig(pad_pow2=False, dtype=torch.float64)
    W, sj, freqs, coi, fft, fftfreqs = pt.cwt(
        g["signal"], float(g["dt"]), dj=float(g["dj"]), config=cfg, device="cpu")
    assert W.shape == g["W"].shape
    assert fft.shape == g["fft"].shape
    assert rel_err(W, g["W"]) < 1e-10
    assert rel_err(sj, g["sj"]) < 1e-12
    assert rel_err(fft, g["fft"]) < 1e-10
    assert rel_err(fftfreqs, g["fftfreqs"]) < 1e-12
    assert rel_err(coi, g["coi"]) < 1e-12


@pytest.mark.parametrize("key", sorted(MOTHERS))
def test_icwt_golden_parity(golden, key):
    g = golden(f"cwt_nino3_{key}")
    iw = pt.icwt(g["W"], g["sj"], float(g["dt"]), wavelet=MOTHERS[key][1])
    assert rel_err(iw, g["icwt"]) < 1e-10


def test_icwt_transposed_orientation(golden):
    g = golden("icwt_transposed")
    iw = pt.icwt(g["W"].T, g["sj"], float(g["dt"]))
    assert rel_err(iw, g["icwt_t"]) < 1e-10


def test_icwt_shape_mismatch_raises(golden):
    g = golden("cwt_nino3_morlet6")
    with pytest.raises(Warning):
        pt.icwt(g["W"], g["sj"][:-5], float(g["dt"]))


@pytest.mark.parametrize("key", ["morlet6", "paul4", "dog6"])
def test_icwt_batch_and_planar_match_jax(key):
    j, t = MOTHERS[key]
    rng = np.random.default_rng(11)
    W = rng.standard_normal((2, 9, 128)) + 1j * rng.standard_normal((2, 9, 128))
    sj = 0.5 * 2.0 ** (np.arange(9) / 4)
    ref = np.asarray(jtr.icwt_batch(jnp.asarray(W), jnp.asarray(sj), 0.25, 0.25,
                                    mother=j))
    got = ttr.icwt_batch(torch.tensor(W), torch.tensor(sj), 0.25, 0.25, mother=t)
    assert rel_err(got.numpy(), ref) < 1e-12
    planar = ttr.icwt_planar(torch.tensor(W.real), sj, 0.25, 0.25, mother=t)
    np.testing.assert_array_equal(planar.numpy(), got.numpy())


@pytest.mark.parametrize("key", sorted(MOTHERS))
def test_cwt_batch_matches_jax(key):
    j, t = MOTHERS[key]
    rng = np.random.default_rng(3)
    X = rng.standard_normal((3, 300))
    grid = jtr.build_scale_grid(300, 0.5, mother=j)
    nfft = next_pow2(300)
    Wj, ftj = jtr.cwt_batch(jnp.asarray(X), jnp.asarray(grid.sj), 0.5,
                            mother=j, nfft=nfft)
    Wt, ftt = ttr.cwt_batch(torch.tensor(X), grid.sj, 0.5, mother=t, nfft=nfft,
                            config=F64)
    assert Wt.shape == (3, len(grid.sj), 300) and Wt.dtype == torch.complex128
    # Two FFT libraries round differently, so the bound is relative to
    # max|W|: DOG's real-valued W has entries near zero whose elementwise
    # relative error reaches ~2e-10.
    Wt, Wj = Wt.numpy(), np.asarray(Wj)
    assert np.abs(Wt - Wj).max() <= 1e-12 * np.abs(Wj).max()
    assert rel_err(ftt.numpy(), np.asarray(ftj)) < 1e-12


def test_batched_matches_single():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((4, 300))
    grid = ttr.build_scale_grid(300, 0.5)
    Wb, _ = ttr.cwt_batch(torch.tensor(X), grid.sj, 0.5, mother=pt.Morlet(6),
                          nfft=512, config=F64)
    for i in range(4):
        Wi, *_ = pt.cwt(X[i], 0.5, config=F64, device="cpu")
        assert rel_err(Wb[i].numpy(), Wi) < 1e-12


def test_cwt_power_matches_cwt_abs2():
    rng = np.random.default_rng(21)
    x = rng.standard_normal(400)
    W, sj, freqs, coi, _, _ = pt.cwt(x, 0.25, dj=1 / 8, config=F64, device="cpu")
    ref = np.abs(W) ** 2
    p, sj2, freqs2, coi2 = pt.cwt_power(
        x, 0.25, dj=1 / 8, config=CWTConfig(engine="planar"), device="cpu")
    np.testing.assert_allclose(sj2, sj)
    np.testing.assert_allclose(coi2, coi)
    np.testing.assert_allclose(p, ref, atol=2e-5 * ref.max(), rtol=0)
    p2, *_ = pt.cwt_power(x, 0.25, dj=1 / 8,
                          config=CWTConfig(engine="xla", dtype=torch.float64),
                          device="cpu")
    np.testing.assert_allclose(p2, ref, rtol=1e-12)


def test_planar_parts_take_the_spectrum_in_f64(monkeypatch):
    """The planar path (cwt_analysis, xwt_planar, cwt_power on the card)
    rounds the host signal's f64 spectrum to f32 once: on Mauna Loa's CO2,
    whose trend leaves the small scales' power 3e-11 of the largest, |W|²
    then stays within 5e-4 rel_err of f64 on the CPU, where an f32 spectrum
    gives 1.2e-3 here and 5e-3 through cuFFT on an H100."""
    from pycwt_torch import api
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.sample import load

    ds = load("mauna")
    x = (ds.values - ds.values.mean()) / ds.values.std()
    W, *_ = pt.cwt(x, ds.dt, config=F64, device="cpu")
    wr, wi, *_ = api._cwt_planar_parts(x, ds.dt, device="cpu")
    assert rel_err(wr ** 2 + wi ** 2, np.abs(W) ** 2) < 5e-4
    seen = {}
    real = fc.fused_cwt_planar

    def spy(sr, si, *args, **kw):
        seen["spectrum"] = (sr, si)
        return real(sr, si, *args, **kw)

    monkeypatch.setattr(fc, "fused_cwt_planar", spy)
    api._cwt_planar_parts(x, ds.dt, device="cpu")
    spec = torch.fft.fft(torch.tensor(x), n=next_pow2(len(x)))
    assert torch.equal(seen["spectrum"][0], spec.real.float())
    assert torch.equal(seen["spectrum"][1], spec.imag.float())


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("nfft", [256, 300])
def test_global_power_parseval_matches_jax(engine, nfft):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2, 256))
    sj = 1.0 * 2.0 ** (np.arange(10) / 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(j_parseval(jnp.asarray(X), jnp.asarray(sj), dt=0.5,
                                    mother=wt.Morlet(6), nfft=nfft, engine=engine))
        got = t_parseval(torch.tensor(X), sj, dt=0.5, mother=pt.Morlet(6),
                         nfft=nfft, engine=engine)
    assert rel_err(got.numpy(), ref) < 1e-10


def test_reconstruction_snr():
    t = np.arange(512) * 0.25
    x = np.sin(2 * np.pi * t / 16) + 0.5 * np.sin(2 * np.pi * t / 4)
    x = (x - x.mean()) / x.std()
    W, sj, *_ = pt.cwt(x, 0.25, dj=1 / 24, config=F64, device="cpu")
    xr = pt.icwt(W, sj, 0.25, dj=1 / 24)
    snr = 10 * np.log10(np.mean(x ** 2) / np.mean((x - np.real(xr)) ** 2))
    assert snr > 20, snr


# -- engine and device rules ------------------------------------------------

def test_resolve_engine_order(monkeypatch):
    monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    assert tfft.resolve_engine(None, "cuda") == "planar"
    assert tfft.resolve_engine(None, torch.device("cuda", 0)) == "planar"
    assert tfft.resolve_engine(None, "cpu") == "xla"
    assert tfft.resolve_engine(None) == "xla"
    assert tfft.resolve_engine("mxu", "cuda") == "mxu"
    monkeypatch.setenv("PYCWT_TPU_ENGINE", "pallas")
    assert tfft.resolve_engine(None, "cpu") == "pallas"
    assert tfft.resolve_engine("xla", "cpu") == "xla"
    with pytest.raises(ValueError):
        tfft.resolve_engine("cufft")


def test_non_pow2_engine_warns_like_jax():
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, 504)))
    for engine in ("mxu", "pallas", "planar"):
        with pytest.warns(UserWarning, match="power-of-two"):
            tfft.fft_of_real_full(x, 504, engine=engine)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        full = tfft.fft_of_real_full(x, 504, engine="xla")
        tfft.fft_of_real_full(x, 512, engine="planar")
    np.testing.assert_allclose(full.numpy(), np.fft.fft(x.numpy(), 504), atol=1e-12)
    with pytest.warns(UserWarning):
        pt.cwt(x[0].numpy(), 0.25, config=CWTConfig(pad_pow2=False,
                                                     engine="planar"),
               device="cpu")


def test_fft_engine_functions_match_numpy():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))
    for engine in ("xla", "mxu", "planar"):
        np.testing.assert_allclose(tfft.fft(torch.tensor(z), engine=engine).numpy(),
                                   np.fft.fft(z), atol=1e-12)
        np.testing.assert_allclose(tfft.ifft(torch.tensor(z), engine=engine).numpy(),
                                   np.fft.ifft(z), atol=1e-12)
        np.testing.assert_allclose(
            tfft.fft_of_real_full(torch.tensor(z.real), 128, engine=engine).numpy(),
            np.fft.fft(z.real, 128), atol=1e-12)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x = np.random.default_rng(0).standard_normal(64)
    for fn in (pt.cwt, pt.cwt_power):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(x, 1.0)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(x, 1.0, device="cuda")


# -- gradients (mirrors of tests/test_autodiff.py) ---------------------------

def _power_loss(x, scales, nfft):
    W, _ = ttr.cwt_batch(x[None], scales, 1.0, mother=pt.Morlet(6), nfft=nfft,
                         config=F64)
    return torch.sum(W.abs() ** 2)


def test_grad_matches_finite_difference():
    rng = np.random.default_rng(0)
    N = 256
    x = torch.tensor(rng.standard_normal(N), requires_grad=True)
    scales = torch.tensor(ttr.build_scale_grid(N, 1.0, dj=0.5, s0=2.0, J=5).sj)
    (g,) = torch.autograd.grad(_power_loss(x, scales, N), x)
    eps = 1e-6
    with torch.no_grad():
        for idx in [0, 57, 200]:
            e = torch.zeros(N, dtype=torch.float64)
            e[idx] = eps
            fd = (_power_loss(x + e, scales, N) - _power_loss(x - e, scales, N)) / (2 * eps)
            assert abs(float(g[idx]) - float(fd)) < 1e-4 * max(1.0, abs(float(fd)))
    xj = jnp.asarray(x.detach().numpy())
    gj = jax.grad(lambda v: jnp.sum(jnp.abs(jtr.cwt_batch(
        v[None], jnp.asarray(scales.numpy()), 1.0, mother=wt.Morlet(6),
        nfft=N)[0]) ** 2))(xj)
    assert rel_err(g.numpy(), np.asarray(gj)) < 1e-10


def test_grad_through_reconstruction():
    rng = np.random.default_rng(1)
    N = 128
    x = torch.tensor(rng.standard_normal(N), requires_grad=True)
    scales = torch.tensor(ttr.build_scale_grid(N, 1.0, dj=0.25, s0=2.0, J=8).sj)
    W, _ = ttr.cwt_batch(x[None], scales, 1.0, mother=pt.Morlet(6), nfft=N,
                         config=F64)
    xr = ttr.icwt_batch(W, scales, 1.0, 0.25, mother=pt.Morlet(6))[0]
    (g,) = torch.autograd.grad(torch.mean((xr - x) ** 2), x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0

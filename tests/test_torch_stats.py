"""The port's statistics (pycwt_torch/stats.py, ops/special.py) on the CPU in
float64 against pycwt_tpu, the goldens and scipy: AR(1) fits, the chi-square
PPF, red-noise surrogates by distribution, and the TC98 significance modes."""
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.ops import special as jsp
from pycwt_torch import stats as tst
from pycwt_torch.ops import special as tsp
from pycwt_torch.sample import load
from tests.conftest import rel_err

torch.set_num_threads(2)


@pytest.fixture
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.mark.parametrize("i", range(4))
def test_ar1_golden_and_jax(golden, i):
    """ar1 golden at 1e-10 (host f64 math, the JAX package's own bound)."""
    g = golden("ar1")
    x = load(str(g["names"][i])).values
    got = pt.ar1(x)
    assert rel_err(got, g["gam"][i]) < 1e-10
    np.testing.assert_array_equal(got, wt.ar1(x))


def test_ar1_spectrum_golden(golden):
    g = golden("ar1")
    assert rel_err(pt.ar1_spectrum(g["fgrid"], 0.5), g["spec_g05"]) < 1e-12
    assert rel_err(pt.ar1_spectrum(g["fgrid"], 0.72), g["spec_g072"]) < 1e-12


def test_ar1_raises_and_batch_nan_row():
    trend = np.linspace(0.0, 50.0, 200)
    with pytest.raises(Warning):
        pt.ar1(trend)
    with pytest.raises(Warning):
        pt.ar1(np.arange(100.0))
    good = np.sin(np.linspace(0, 20, 200)) + 0.1 * np.arange(200) % 3
    g, a, mu2 = pt.ar1_batch(np.stack([trend, good]))
    assert np.isnan(g[0]) and np.isnan(a[0]) and np.isfinite(g[1])
    with pytest.raises(ValueError):
        pt.ar1_batch(good)


def test_ar1_batch_matches_per_series():
    """Same f64 formula batched: 1e-9 relative, the JAX test's bound."""
    rng = np.random.default_rng(0)
    rows = [np.asarray(tst._ar1_recurrence(torch.tensor(rng.standard_normal(400)), g))
            for g in (0.0, 0.3, 0.7, 0.9)]
    x = np.stack(rows)
    got = pt.ar1_batch(x)
    ref = wt.ar1_batch(x)
    for i, row in enumerate(rows):
        for b, one, j in zip(got, pt.ar1(row), ref):
            np.testing.assert_allclose(b[i], one, rtol=1e-9)
            np.testing.assert_allclose(b[i], j[i], rtol=1e-12)


def test_ar1_recurrence_equals_sequential_filter():
    """The log-depth scan against scipy's lfilter, f64 round-off (1e-12)."""
    import scipy.signal

    z = np.random.default_rng(0).standard_normal((3, 500))
    got = tst._ar1_recurrence(torch.tensor(z), 0.8).numpy()
    assert rel_err(got, scipy.signal.lfilter([1, 0], [1, -0.8], z, axis=1)) < 1e-12
    # per-row coefficients: the scan sums in another order, so near zero
    # crossings the bound is relative to the row's max
    gs = np.array([[0.1], [0.5], [0.95]])
    got = tst._ar1_recurrence(torch.tensor(z), torch.tensor(gs)).numpy()
    for r in range(3):
        ref = scipy.signal.lfilter([1, 0], [1, -gs[r, 0]], z[r])
        assert np.abs(got[r] - ref).max() <= 1e-12 * np.abs(ref).max()


def test_rednoise_statistics():
    """Distributional, as tests/test_stats.py:57-69: lag-1 within 0.02 of g,
    variance within 10 % of 1/(1−g²) (torch.Generator bits differ from
    jax.random, so only the distribution is comparable)."""
    g = 0.72
    gen = torch.Generator().manual_seed(0)
    y = tst.rednoise_batch(gen, 4000, g, 1.0, batch=64, dtype=torch.float64).numpy()
    assert y.shape == (64, 4000)
    yc = y - y.mean(axis=1, keepdims=True)
    lag1 = (yc[:, :-1] * yc[:, 1:]).sum(1) / (yc ** 2).sum(1)
    assert abs(lag1.mean() - g) < 0.02
    assert abs(y.var() / (1 / (1 - g ** 2)) - 1) < 0.1


def test_rednoise_g0_white_and_seeding(f64):
    y = pt.rednoise(1000, 0.0, 2.0, seed=3, device="cpu")
    assert y.shape == (1000,) and y.dtype == np.float64
    assert abs(y.std() - 2.0) < 0.2
    yc = y - y.mean()
    assert abs((yc[:-1] * yc[1:]).sum() / (yc ** 2).sum()) < 0.1
    a = pt.rednoise(64, 0.5, device="cpu")
    b = pt.rednoise(64, 0.5, device="cpu")
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(pt.rednoise(64, 0.5, seed=42, device="cpu"),
                                  pt.rednoise(64, 0.5, seed=42, device="cpu"))


def _tensor_bound(a):
    """Bound of the tensor PPF against scipy in f64: 1e-11 (tests/test_stats.py:
    38-44), but 1e-9 for shapes a >= 20, where torch.special.gammainc itself
    is up to ~2e-9 relative off scipy's (see test_gammainc_np_vs_scipy)."""
    return 1e-9 if a >= 20 else 1e-11


@pytest.mark.parametrize("df", [0.5, 1.0, 2.0, 2.7, 10.0, 64.3, 500.0])
def test_chi2_ppf_vs_scipy_and_jax(df):
    """The host twin (the significance path) at 1e-11 against scipy and
    1e-12 against the JAX package's f64 PPF; chi2_ppf_host is that twin;
    the tensor PPF at :func:`_tensor_bound`."""
    ps = np.array([0.05, 0.5, 0.8646, 0.90, 0.95, 0.99, 0.999])
    ref = scipy.stats.chi2.ppf(ps, df)
    host = tsp.chi2_ppf_np(ps, df)
    assert rel_err(host, ref) < 1e-11
    np.testing.assert_allclose(
        np.asarray(jsp.chi2_ppf(jnp.asarray(ps, jnp.float64), df)), host, rtol=1e-12)
    np.testing.assert_allclose(jsp.chi2_ppf_np(ps, df), host, rtol=1e-12)
    np.testing.assert_array_equal(tsp.chi2_ppf_host(ps, df), host)
    ours = tsp.chi2_ppf(torch.tensor(ps), df).numpy()
    assert rel_err(ours, ref) < _tensor_bound(df / 2)


@pytest.mark.parametrize("a", [0.5, 1.0, 3.3, 48.0])
def test_gammaincinv_vs_scipy(a):
    ps = np.linspace(0.01, 0.99, 23)
    ours = tsp.gammaincinv(a, torch.tensor(ps)).numpy()
    assert rel_err(ours, scipy.special.gammaincinv(a, ps)) < _tensor_bound(a)


@pytest.mark.parametrize("a", [0.5, 3.3, 24.0, 48.0])
def test_gammainc_np_vs_scipy(a):
    """The host twin's incomplete gamma at 1e-13 absolute against scipy, and
    torch.special.gammainc's own f64 error (which sets _tensor_bound)."""
    x = np.linspace(0.01, 3 * a, 40)
    ref = scipy.special.gammainc(a, x)
    got = np.array([tsp._gammainc_np_scalar(a, v) for v in x])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    lib = torch.special.gammainc(torch.full((x.size,), a, dtype=torch.float64),
                                 torch.tensor(x)).numpy()
    assert np.abs(lib - ref).max() < 1e-9


def test_chi2_ppf_float32_and_z_table():
    """TC98 Table 3 mirror (tests/test_stats.py:167-190): the 86.46 % level
    at 2 DOF gives Grinsted's Z2 = 3.999; f32 tensors stay f32."""
    z = float(tsp.chi2_ppf(torch.tensor(0.8646, dtype=torch.float64), 2))
    assert abs(z - 3.999) < 2e-3
    table = {0.10: (1.595, 3.214), 0.05: (2.182, 3.999), 0.01: (3.604, 5.767)}
    for alpha, (z1, z2) in table.items():
        assert abs(z2 * scipy.special.k1(z2) - alpha) < 2e-4
    p32 = tsp.chi2_ppf(torch.tensor([0.5, 0.95], dtype=torch.float32),
                       torch.tensor(2.0, dtype=torch.float32))
    assert p32.dtype == torch.float32
    np.testing.assert_allclose(p32.numpy(), scipy.stats.chi2.ppf([0.5, 0.95], 2),
                               rtol=1e-5)


def test_significance_mode0_goldens(golden):
    g = golden("significance_nino3")
    sig0, th0 = pt.significance(1.0, float(g["dt"]), g["sj"], 0,
                                alpha=float(g["alpha"]))
    assert rel_err(sig0, g["sig0"]) < 1e-10
    assert rel_err(th0, g["th0"]) < 1e-10
    nino = load("nino3").values
    sig0b, th0b = pt.significance((nino - nino.mean()) / nino.std(),
                                  float(g["dt"]), g["sj"], 0)
    assert rel_err(sig0b, g["sig0b"]) < 1e-10
    assert rel_err(th0b, g["th0b"]) < 1e-10
    gd = golden("significance_dog2")
    sig, _ = pt.significance(1.0, float(gd["dt"]), gd["sj"], 0,
                             alpha=float(gd["alpha"]), wavelet=pt.DOG(2))
    assert rel_err(sig, gd["sig0"]) < 1e-10


def test_significance_mode1_golden_and_scalar_dof(golden):
    """Deviations 3 and 4 of docs/parity.md: the true fft_theor in mode 1,
    and a scalar dof broadcast."""
    g = golden("significance_nino3")
    kw = dict(alpha=float(g["alpha"]))
    sig1, th1 = pt.significance(1.0, float(g["dt"]), g["sj"], 1, dof=g["dof1"], **kw)
    assert rel_err(sig1, g["sig1"]) < 1e-10
    th0, _ = pt.significance(1.0, float(g["dt"]), g["sj"], 0, **kw)
    assert rel_err(th1, g["th0"]) < 1e-10
    s_scalar, _ = pt.significance(1.0, float(g["dt"]), g["sj"], 1, dof=300.0, **kw)
    ref, _ = wt.significance(1.0, float(g["dt"]), g["sj"], 1, dof=300.0, **kw)
    assert s_scalar.shape == g["sj"].shape
    np.testing.assert_allclose(s_scalar, ref, rtol=1e-12)


def test_significance_mode2_golden_and_errors(golden):
    g = golden("significance_nino3")
    sig2, th2 = pt.significance(1.0, float(g["dt"]), g["sj"], 2,
                                alpha=float(g["alpha"]), dof=[2, 8])
    assert rel_err(np.atleast_1d(sig2), g["sig2"]) < 1e-10
    assert rel_err(np.atleast_1d(th2), g["th2"]) < 1e-10
    with pytest.raises(ValueError):
        pt.significance(1.0, 0.25, g["sj"], 7, alpha=0.5)
    with pytest.raises(ValueError):
        pt.significance(1.0, 0.25, g["sj"], 2, alpha=0.5, dof=[2, 8],
                        wavelet=pt.Morlet(5))
    with pytest.raises(ValueError, match="No valid scales"):
        pt.significance(1.0, 0.25, g["sj"], 2, alpha=0.5, dof=[1e6, 2e6])

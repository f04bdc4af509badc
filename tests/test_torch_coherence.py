"""The port's smoothing, XWT, WCT and analysis flows (pycwt_torch/
ops/smoothing.py, coherence.py, analysis.py) on the CPU against the goldens
and pycwt_tpu on the same inputs.  float64 runs hold the JAX package's own
1e-10 golden bounds; the planar (f32) route holds its f32 bounds."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import coherence as jco
from pycwt_torch import analysis as tan
from pycwt_torch import coherence as tco
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import smoothing as tsm
from pycwt_torch.sample import load
from pycwt_torch.transform import build_scale_grid
from tests.conftest import rel_err

torch.set_num_threads(2)

PLANAR = CWTConfig(engine="planar")


@pytest.fixture
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _smooth_golden(g, W):
    return tsm.smooth(torch.tensor(W), float(g["dt"]), float(g["dj"]),
                      torch.tensor(g["scales"]), pt.Morlet(6)).numpy()


def test_smooth_golden_real_complex_batched(golden):
    g = golden("smooth")
    assert rel_err(_smooth_golden(g, g["Wr"]), g["sm_r"]) < 1e-10
    assert rel_err(_smooth_golden(g, g["Wc"]), g["sm_c"]) < 1e-10
    both = _smooth_golden(g, np.stack([g["Wr"], 2 * g["Wr"]]))
    assert rel_err(both[0], g["sm_r"]) < 1e-10
    assert rel_err(both[1], 2 * g["sm_r"]) < 1e-10
    via_mother = pt.Morlet(6).smooth(torch.tensor(g["Wc"]), float(g["dt"]),
                                     float(g["dj"]), torch.tensor(g["scales"]))
    assert rel_err(via_mother.numpy(), g["sm_c"]) < 1e-10
    with pytest.raises(ValueError, match="deltaj0"):
        tsm.smooth(torch.tensor(g["Wr"]), 0.25, 1 / 8, torch.tensor(g["scales"]),
                   pt.Morlet(5))


@pytest.mark.parametrize("mother", ["paul", "dog", "mexicanhat"])
def test_smooth_matches_jax_other_mothers(mother):
    rng = np.random.default_rng(7)
    W = rng.standard_normal((2, 20, 150)) + 1j * rng.standard_normal((2, 20, 150))
    sc = 0.5 * 2 ** (np.arange(20) / 6)
    ref = np.asarray(getattr(wt, {"paul": "Paul", "dog": "DOG",
                                  "mexicanhat": "MexicanHat"}[mother])().smooth(
        jnp.asarray(W), 0.25, 1 / 6, jnp.asarray(sc)))
    got = pt.mothers.as_mother(mother).smooth(torch.tensor(W), 0.25, 1 / 6,
                                              torch.tensor(sc)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["real", "complex", "conj"])
def test_scale_boxcar_matches_convolve2d(kind):
    """The band product (on the real view of a complex field) is scipy's
    'same' convolution along the scale axis, for a conjugate view too."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(4)
    T = torch.tensor(rng.standard_normal((2, 12, 30)))
    if kind != "real":
        T = torch.complex(T, torch.tensor(rng.standard_normal((2, 12, 30))))
    if kind == "conj":
        T = T.conj()
    win = tsm.rect_window(5)
    got = tsm.scale_boxcar_same(T, win)
    dense = T.resolve_conj().numpy()
    ref = np.stack([convolve2d(t, win[:, None], "same") for t in dense])
    assert got.dtype == T.dtype
    assert np.abs(got.numpy() - ref).max() < 1e-14


def test_smooth_planar_pair_matches_single_planes():
    """Two real planes in one complex FFT pair equal two single-plane calls
    at f32 round-off: 1e-5 of max (tests/test_coherence.py:114-133)."""
    rng = np.random.default_rng(3)
    S, N = 12, 300
    sc = torch.tensor(2.0 * 2 ** (np.arange(S) * 0.25), dtype=torch.float32)
    Ta = torch.tensor(rng.standard_normal((S, N)), dtype=torch.float32)
    Tb = torch.tensor(rng.standard_normal((S, N)), dtype=torch.float32)
    m = pt.Morlet(6)
    sa_ref = tsm.smooth_planar_real(Ta, 0.25, 1 / 8, sc, m)
    sb_ref = tsm.smooth_planar_real(Tb, 0.25, 1 / 8, sc, m)
    sa, sb = tsm.smooth_planar_pair(Ta, Tb, 0.25, 1 / 8, sc, m)
    assert sa.dtype == torch.float32
    scale = float(max(sa_ref.abs().max(), sb_ref.abs().max()))
    torch.testing.assert_close(sa, sa_ref, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(sb, sb_ref, rtol=0, atol=1e-5 * scale)
    ref = tsm.smooth(Ta.double(), 0.25, 1 / 8, sc.double(), m)
    torch.testing.assert_close(sa.double(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("norm", [0, 1])
def test_xwt_golden(golden, f64, norm):
    g = golden(f"xwt_jao_jbaltic_norm{norm}")
    W12, coi, freq, signif = pt.xwt(g["y1"], g["y2"], float(g["dt"]),
                                    significance_level=0.8646,
                                    normalize=bool(norm), device="cpu")
    assert rel_err(W12, g["W12"]) < 1e-10
    assert rel_err(coi, g["coi"]) < 1e-12
    assert rel_err(freq, g["freq"]) < 1e-12
    assert rel_err(signif, g["signif"]) < 1e-10


def test_wct_golden(golden, f64):
    g = golden("wct_jao_jbaltic")
    WCT, aWCT, coi, freq, sig = pt.wct(g["y1"], g["y2"], float(g["dt"]),
                                       sig=False, device="cpu")
    assert rel_err(WCT, g["WCT"]) < 1e-10
    assert np.abs(np.angle(np.exp(1j * (aWCT - g["aWCT"])))).max() < 1e-10
    assert rel_err(coi, g["coi"]) < 1e-12
    assert rel_err(freq, g["freq"]) < 1e-12
    np.testing.assert_array_equal(sig, [0])


def test_wct_core_matches_jax_f64():
    """The complex pipeline on identical f64 inputs (1e-10)."""
    rng = np.random.default_rng(8)
    y1 = rng.standard_normal((2, 200))
    y2 = 0.5 * y1 + rng.standard_normal((2, 200))
    grid = build_scale_grid(200, 0.5, dj=1 / 8)
    kw = dict(mother=pt.Morlet(6), nfft=256, dj=1 / 8)
    R, a, W12 = tco._wct_core(torch.tensor(y1), torch.tensor(y2),
                              torch.tensor(grid.sj), 0.5, engine="xla", **kw)
    Rj, aj, W12j = jco._wct_core(jnp.asarray(y1), jnp.asarray(y2),
                                 jnp.asarray(grid.sj), 0.5, mother=wt.Morlet(6),
                                 nfft=256, dj=1 / 8, engine="xla")
    assert R.dtype == torch.float64
    assert rel_err(R.numpy(), np.asarray(Rj)) < 1e-10
    assert np.abs(np.angle(np.exp(1j * (a.numpy() - np.asarray(aj))))).max() < 1e-10
    assert rel_err(W12.numpy(), np.asarray(W12j)) < 1e-10


@pytest.mark.parametrize("small_kernel", ["0", "1"], ids=["K1K2_plain", "K3_plain"])
def test_wct_core_planar_matches_complex(monkeypatch, small_kernel):
    """The planar f32 route against the complex route in f32 (1e-3,
    tests/test_engines.py:112-127), through the plain version of either
    kernel route (PYCWT_TPU_SMALL_KERNEL)."""
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", small_kernel)
    rng = np.random.default_rng(9)
    y1 = torch.tensor(rng.standard_normal((1, 240)), dtype=torch.float32)
    y2 = 0.4 * y1 + torch.tensor(rng.standard_normal((1, 240)), dtype=torch.float32)
    sj = torch.tensor(build_scale_grid(240, 0.5, dj=1 / 8).sj, dtype=torch.float32)
    kw = dict(mother=pt.Morlet(6), nfft=256, dj=1 / 8)
    Rc, ac, W12c = tco._wct_core(y1, y2, sj, 0.5, engine="mxu", **kw)
    Rp, ap, (w12r, w12i) = tco._wct_core(y1, y2, sj, 0.5, engine="planar", **kw)
    assert Rp.dtype == torch.float32
    assert rel_err(Rp.numpy(), Rc.numpy()) < 1e-3
    assert np.abs(ap.numpy() - ac.numpy()).max() < 1e-3
    assert rel_err(np.hypot(w12r.numpy(), w12i.numpy()), W12c.abs().numpy()) < 1e-3


def test_wct_planar_f64_warns_and_f32_golden(golden):
    """The planar route is f32: f64 inputs warn about the downcast; its WCT
    holds the f32 bound 1e-3 (tests/test_engines.py:170)."""
    g = golden("wct_jao_jbaltic")
    with pytest.warns(UserWarning, match="float32"):
        pt.wct(g["y1"], g["y2"], float(g["dt"]), sig=False, device="cpu",
               config=CWTConfig(engine="planar", dtype=torch.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        WCT, *_ = pt.wct(g["y1"], g["y2"], float(g["dt"]), sig=False,
                         device="cpu", config=PLANAR)
    assert rel_err(WCT, g["WCT"]) < 1e-3


def test_xwt_planar_golden_f32(golden):
    """xwt_planar's |W12| at the f32 bound 1.9e-3 (tests/test_tpu_chip.py:43),
    its signif exact in f64."""
    g = golden("xwt_jao_jbaltic_norm1")
    mag, phase, coi, freq, signif = pt.xwt_planar(
        g["y1"], g["y2"], float(g["dt"]), significance_level=0.8646,
        config=PLANAR, device="cpu")
    assert rel_err(mag, np.abs(g["W12"])) < 1.9e-3
    assert rel_err(signif, g["signif"]) < 1e-10
    m = np.abs(g["W12"]) > 1e-3 * np.abs(g["W12"]).max()
    assert np.abs(np.angle(np.exp(1j * (phase - np.angle(g["W12"]))))[m]).max() < 1e-3
    with pytest.raises(ValueError, match="power-of-two"):
        pt.xwt_planar(g["y1"][:100], g["y2"][:100], 1.0, device="cpu",
                      config=CWTConfig(pad_pow2=False))


@pytest.mark.parametrize("mother", ["paul", "dog", "mexicanhat"])
def test_wct_works_for_other_mothers(f64, mother):
    """Deviation 5 of docs/parity.md: smoothing for every tabulated mother;
    the same coherence as pycwt_tpu (1e-10), finite."""
    rng = np.random.default_rng(2)
    y1 = rng.standard_normal(256)
    y2 = rng.standard_normal(256)
    jm = {"paul": wt.Paul(4), "dog": wt.DOG(2), "mexicanhat": wt.MexicanHat()}[mother]
    WCT, *_ = pt.wct(y1, y2, 1.0, sig=False, wavelet=mother, device="cpu")
    ref, *_ = wt.wct(y1, y2, 1.0, sig=False, wavelet=jm)
    assert np.isfinite(WCT).all()
    assert np.abs(WCT - ref).max() < 1e-10


def test_wct_nan_row_drop_and_sig_raises(f64):
    """The NaN-row drop, and sig=True (the default) on the same call: the
    Monte-Carlo curve has J + 1 entries, one per scale of the undropped
    grid, as pycwt_tpu's (the name is kept from when sig=True raised)."""
    rng = np.random.default_rng(61)
    y1 = rng.standard_normal(300)
    y2 = rng.standard_normal(300)
    # Paul at scales above ~56 overflows the reference's naive filter: those
    # rows are dropped, as cwt drops them
    kw = dict(dj=1 / 8, wavelet="paul", s0=0.5, J=60)
    _, sj, freq_cwt, *_ = pt.cwt(y1, 0.25, device="cpu", **kw)
    WCT, _, _, freq, _ = pt.wct(y1, y2, 0.25, sig=False, device="cpu", **kw)
    ref, *_ = wt.wct(y1, y2, 0.25, sig=False, **kw)
    assert WCT.shape == ref.shape and WCT.shape[0] == len(sj) < 61
    np.testing.assert_allclose(freq, freq_cwt)
    mc = dict(mc_count=3, seed=1, cache=False, progress=False)
    *_, sig = pt.wct(y1, y2, 0.25, device="cpu", **kw, **mc)
    assert sig.shape == (61,) and np.isfinite(sig[:5]).all()
    res = tan.wct_analysis(y1, y2, 0.25, dj=1 / 8, mother="paul", s0=0.5, J=60,
                           significance_level=0.95, device="cpu", **mc)
    np.testing.assert_array_equal(res["sig95"], sig)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    y = np.random.default_rng(0).standard_normal(64)
    for call in (lambda: pt.xwt(y, y, 1.0), lambda: pt.xwt_planar(y, y, 1.0),
                 lambda: pt.wct(y, y, 1.0, sig=False),
                 lambda: tan.cwt_analysis(y, 1.0),
                 lambda: tan.xwt_analysis(y, y, 1.0),
                 lambda: tan.wct_analysis(y, y, 1.0, sig=False),
                 lambda: tan.global_spectrum(y, 1.0),
                 lambda: pt.rednoise(10, 0.5),
                 lambda: pt.wct_significance(0.3, 0.4, 1.0, 0.25, 2.0, 7,
                                             mc_count=2, cache=False),
                 lambda: pt.wct_significance_batch([0.3], [0.4], 1.0, 0.25, 2.0, 7,
                                                   mc_count=2, cache=False)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_figure_nino3_golden(golden, f64):
    """tests/test_analysis.py:68-88 on the port, at its bounds."""
    g = golden("figure_nino3")
    ds = load("nino3")
    res = tan.cwt_analysis(ds.values, ds.dt, t0=ds.t0, mother=pt.Morlet(6),
                           avg_band=(2, 8), device="cpu")
    for name in ("t", "signal", "iwave", "period", "power", "sig95", "coi",
                 "global_power", "global_signif", "scale_avg"):
        np.testing.assert_allclose(getattr(res, name), g[name], rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(res.scale_avg_signif, g["scale_avg_signif"],
                               rtol=1e-10)
    np.testing.assert_allclose(res.alpha, g["alpha"], rtol=1e-10)
    assert 0.01 < (res.sig95 > 1).mean() < 0.5


def test_figure_jao_jbaltic_golden(golden, f64):
    """tests/test_analysis.py:91-106 on the port, at its bounds."""
    g = golden("figure_jao_jbaltic")
    jao, jba = load("jao"), load("jbaltic")
    n = min(jao.values.size, jba.values.size)
    x = tan.xwt_analysis(jao.values[:n], jba.values[:n], jao.dt,
                         significance_level=0.8646, device="cpu")
    w = tan.wct_analysis(jao.values[:n], jba.values[:n], jao.dt, sig=False,
                         device="cpu")
    np.testing.assert_allclose(x["cross_power"], g["cross_power"], rtol=1e-10)
    np.testing.assert_allclose(x["cross_sig"], g["cross_sig"], rtol=1e-10)
    np.testing.assert_allclose(x["coi"], g["xwt_coi"], rtol=1e-10)
    np.testing.assert_allclose(w["WCT"], g["wct"], rtol=1e-10)
    np.testing.assert_allclose(w["phase"], g["wct_phase"], rtol=1e-10)
    u, v = tan.phase_arrows(w["phase"])
    np.testing.assert_allclose(u ** 2 + v ** 2, 1.0)


def test_analysis_planar_route_matches_complex(monkeypatch, f64):
    """The flows under the planar engine (the CUDA default, here on the
    plain versions in f32) against the complex route, 5e-5 of max
    (tests/test_analysis.py:109-151)."""
    ds = load("nino3")
    ref = tan.cwt_analysis(ds.values, ds.dt, device="cpu")
    rng = np.random.default_rng(23)
    y1 = rng.standard_normal(250)
    y2 = 0.5 * y1 + rng.standard_normal(250)
    xref = tan.xwt_analysis(y1, y2, 0.25, device="cpu")
    monkeypatch.setenv("PYCWT_TPU_ENGINE", "planar")
    with pytest.warns(UserWarning, match="float32"):
        got = tan.cwt_analysis(ds.values, ds.dt, device="cpu")
    for field in ("power", "sig95", "global_power", "scale_avg", "iwave"):
        a, b = getattr(got, field), getattr(ref, field)
        np.testing.assert_allclose(a, b, atol=5e-5 * np.abs(b).max(), rtol=0,
                                   err_msg=field)
    assert np.iscomplexobj(got.W)
    with pytest.warns(UserWarning, match="float32"):
        xgot = tan.xwt_analysis(y1, y2, 0.25, device="cpu")
    scale = xref["cross_power"].max()
    np.testing.assert_allclose(xgot["cross_power"], xref["cross_power"],
                               atol=5e-5 * scale, rtol=0)
    np.testing.assert_allclose(xgot["signif"], xref["signif"], rtol=1e-10)


@pytest.mark.parametrize("exact_trim", [False, True])
def test_global_spectrum_matches_jax(f64, exact_trim):
    from pycwt_tpu.analysis import global_spectrum as jgs

    x = load("nino3").values
    got = tan.global_spectrum(x, 0.25, exact_trim=exact_trim, device="cpu")
    ref = jgs(x, 0.25, exact_trim=exact_trim)
    assert rel_err(got[0], np.asarray(ref[0])) < 1e-10
    np.testing.assert_array_equal(got[1], ref[1])

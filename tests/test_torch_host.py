"""Host-side parity of the PyTorch port with pycwt_tpu: config helpers,
mother-wavelet constants and spectra, scale grids, NaN-row masks, COI, the
sample loader, the helpers, and ``from_params`` round trips."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import config as jcfg
from pycwt_tpu import transform as jtr
from pycwt_tpu.sample import dataset as jds
from pycwt_tpu.utils import helpers as jhelp
from pycwt_torch import config as tcfg
from pycwt_torch import transform as ttr
from pycwt_torch.mothers import from_params
from pycwt_torch.sample import dataset as tds
from pycwt_torch.utils import helpers as thelp

torch.set_num_threads(2)

PAIRS = [
    (wt.Morlet(6), pt.Morlet(6)),
    (wt.Morlet(5.0), pt.Morlet(5.0)),
    (wt.Paul(4), pt.Paul(4)),
    (wt.Paul(3), pt.Paul(3)),
    (wt.DOG(2), pt.DOG(2)),
    (wt.DOG(3), pt.DOG(3)),
    (wt.DOG(6), pt.DOG(6)),
    (wt.MexicanHat(), pt.MexicanHat()),
]
IDS = [f"{j.name}-{dataclasses.astuple(j)[0]}" for j, _ in PAIRS]


# -- config ---------------------------------------------------------------

def test_fft_length_and_next_pow2_match():
    for n in [1, 2, 3, 255, 256, 257, 504, 512, 513, 1000, 4097]:
        for pad in (True, False):
            assert (tcfg.CWTConfig(pad_pow2=pad).fft_length(n)
                    == jcfg.CWTConfig(pad_pow2=pad).fft_length(n))
    for n in range(-2, 2100):
        assert tcfg.next_pow2(n) == jcfg.next_pow2(n)


def test_round_half_even_matches():
    for x in [0.5, 1.5, 2.5, 3.49999, 101.5, 96.5, 7.5000001, -0.0, -1.5,
              -2.5, 1e6 + 0.5]:
        assert tcfg.round_half_even(x) == jcfg.round_half_even(x) == int(np.round(x))


def test_precision_validation_and_default():
    assert tcfg.DEFAULT.precision == jcfg.DEFAULT.precision == "high"
    for tier in ("highest", "high", "fast"):
        assert tcfg.CWTConfig(precision=tier).precision == tier
    with pytest.raises(ValueError):
        tcfg.CWTConfig(precision="exact")


def test_dtype_follows_torch_default():
    assert tcfg.DEFAULT.real_dtype == torch.get_default_dtype()
    cfg = tcfg.CWTConfig(dtype=torch.float64)
    assert cfg.real_dtype == torch.float64
    assert cfg.complex_dtype == torch.complex128
    assert tcfg.CWTConfig(dtype=torch.float32).complex_dtype == torch.complex64


@pytest.mark.parametrize("jax_cfg", [
    jcfg.CWTConfig(),
    jcfg.CWTConfig(pad_pow2=False, dtype=jnp.float64, engine="xla",
                   precision="highest"),
    jcfg.CWTConfig(dtype=jnp.float32, engine="planar", precision="fast"),
], ids=["default", "f64-xla", "f32-planar"])
def test_config_from_params_round_trip(jax_cfg):
    params = dataclasses.asdict(jax_cfg)
    if params["dtype"] is not None:
        params["dtype"] = str(jnp.dtype(params["dtype"]))
    cfg = tcfg.CWTConfig.from_params(params)
    assert cfg.pad_pow2 == jax_cfg.pad_pow2
    assert cfg.engine == jax_cfg.engine
    assert cfg.precision == jax_cfg.precision
    if jax_cfg.dtype is not None:
        assert cfg.dtype == getattr(torch, str(jnp.dtype(jax_cfg.dtype)))
    assert tcfg.CWTConfig.from_params(dataclasses.asdict(cfg)) == cfg
    assert tcfg.CWTConfig.from_params({"dtype": "torch.float64"}).dtype == torch.float64
    with pytest.raises(ValueError):
        tcfg.CWTConfig.from_params({"dtype": "float7"})


# -- mothers --------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_mother_constants_match(pair):
    j, t = pair
    assert t.name == j.name
    for attr in ("dofmin", "cdelta", "gamma", "deltaj0"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.analytic_negligible_negative() is j.analytic_negligible_negative()
    for meth in ("flambda", "coi", "sup", "psi0", "psi_ft_const"):
        assert getattr(t, meth)() == pytest.approx(getattr(j, meth)(),
                                                   rel=1e-15, abs=0), meth


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_mother_spectra_match(pair):
    j, t = pair
    f = np.concatenate([np.linspace(-60.0, 60.0, 2401), [0.0, -0.0, 1e-300,
                                                          -1e-300, 7.25]])
    env_j = np.asarray(j.psi_ft_envelope(jnp.asarray(f)))
    env_t = t.psi_ft_envelope(torch.tensor(f, dtype=torch.float64)).numpy()
    assert np.isfinite(env_t).all()
    assert np.abs(env_t - env_j).max() <= 1e-15 * np.abs(env_j).max()
    ft_j = np.asarray(j.psi_ft(jnp.asarray(f)))
    ft_t = np.asarray(t.psi_ft(torch.tensor(f, dtype=torch.float64)))
    assert np.abs(ft_t - ft_j).max() <= 1e-15 * np.abs(ft_j).max()
    tt = np.linspace(-8.0, 8.0, 401)
    psi_j = np.asarray(j.psi(jnp.asarray(tt)))
    psi_t = t.psi(torch.tensor(tt, dtype=torch.float64)).numpy()
    assert np.abs(psi_t - psi_j).max() <= 1e-13 * np.abs(psi_j).max()


@pytest.mark.parametrize("m", [2, 4, 8])
def test_paul_reference_nan_rows_match(m):
    scales = 2.0 ** np.arange(0.0, 14.0, 0.25)
    ftfreqs = 2 * np.pi * np.fft.fftfreq(1024, 0.25)
    mask_j = wt.Paul(m).reference_nan_rows(scales, ftfreqs)
    mask_t = pt.Paul(m).reference_nan_rows(scales, ftfreqs)
    np.testing.assert_array_equal(mask_t, mask_j)
    assert mask_t.any() and not mask_t.all()
    for pair in PAIRS:
        np.testing.assert_array_equal(pair[1].reference_nan_rows(scales, ftfreqs),
                                      pair[0].reference_nan_rows(scales, ftfreqs))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_mother_from_params_round_trip(pair):
    j, t = pair
    params = {"kind": type(j).__name__, **dataclasses.asdict(j)}
    got = from_params(params)
    assert type(got) is type(t)
    assert got == t and got.name == t.name
    assert dataclasses.asdict(got) == dataclasses.asdict(j)
    assert from_params({"kind": type(j).__name__.lower()}) == type(t)()


def test_as_mother_and_from_params_errors():
    for name in ("morlet", "paul", "dog", "mexicanhat", "Morlet"):
        assert dataclasses.asdict(pt.mothers.as_mother(name)) == \
            dataclasses.asdict(wt.mothers.as_mother(name))
    with pytest.raises(ValueError):
        pt.mothers.as_mother("haar")
    with pytest.raises(ValueError):
        from_params({"kind": "Haar"})
    with pytest.raises(ValueError):
        from_params({"m": 4})


# -- scale grids, NaN rows, COI ------------------------------------------

GRID_CASES = [
    dict(n0=504, dt=0.25),
    dict(n0=504, dt=0.25, dj=1 / 4, s0=0.5, J=7),
    dict(n0=2 ** 20, dt=1.0, dj=0.25, s0=2.0, J=63),
    dict(n0=300, dt=0.5, freqs=np.array([0.1, 0.2, 0.35, 1.0])),
]


@pytest.mark.parametrize("case", range(len(GRID_CASES)))
@pytest.mark.parametrize("pair", PAIRS[::2], ids=IDS[::2])
def test_scale_grid_nan_rows_and_coi_equal(case, pair):
    j, t = pair
    kw = GRID_CASES[case]
    gj = jtr.build_scale_grid(mother=j, **kw)
    gt = ttr.build_scale_grid(mother=t, **kw)
    np.testing.assert_array_equal(gt.sj, gj.sj)
    np.testing.assert_array_equal(gt.freqs, gj.freqs)
    assert (gt.dj, gt.s0, gt.J) == (gj.dj, gj.s0, gj.J)
    n0, dt = kw["n0"], kw["dt"]
    nfft = tcfg.DEFAULT.fft_length(min(n0, 4096))
    for a, b in zip(ttr.drop_reference_nan_rows(t, gt.sj * 64, gt.freqs, nfft, dt),
                    jtr.drop_reference_nan_rows(j, gj.sj * 64, gj.freqs, nfft, dt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.coi_bartlett(min(n0, 4096), dt, t),
                                  jtr.coi_bartlett(min(n0, 4096), dt, j))


def test_paul_nan_row_drop_equal_at_large_scales():
    sj = 2.0 ** np.arange(0.0, 16.0, 0.5)
    freqs = 1.0 / (wt.Paul(4).flambda() * sj)
    dj_ = jtr.drop_reference_nan_rows(wt.Paul(4), sj, freqs, 1024, 0.25)
    dt_ = ttr.drop_reference_nan_rows(pt.Paul(4), sj, freqs, 1024, 0.25)
    assert len(dt_[0]) < len(sj)
    for a, b in zip(dt_, dj_):
        np.testing.assert_array_equal(a, b)


# -- sample data and helpers ---------------------------------------------

def test_sample_loader_equal():
    assert tds.list_datasets() == jds.list_datasets()
    for name in jds.list_datasets():
        a, b = tds.load(name), jds.load(name)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.time, b.time)
        np.testing.assert_array_equal(a.standardized(), b.standardized())
        assert (a.t0, a.dt, a.label, a.units, a.title) == (b.t0, b.dt, b.label,
                                                          b.units, b.title)
        assert a.labels(True) == b.labels(True) and a.labels() == b.labels()
        with open(os.path.join(tds._DATA_DIR, f"{name}.npz"), "rb") as f1, \
                open(os.path.join(jds._DATA_DIR, f"{name}.npz"), "rb") as f2:
            assert f1.read() == f2.read()
    with pytest.raises(KeyError):
        tds.load("nope")


def test_helpers_equal():
    rng = np.random.default_rng(4)
    x = np.round(rng.standard_normal(200), 1)
    np.testing.assert_array_equal(thelp.find(x > 0.3), jhelp.find(x > 0.3))
    for arg in (7, 5.0, [3, 4], np.zeros((6, 2))):
        for norm in (False, True):
            np.testing.assert_array_equal(thelp.rect(arg, norm),
                                          jhelp.rect(arg, norm))
    with pytest.raises(TypeError):
        thelp.rect("x")
    for a, b in zip(thelp.boxpdf(x), jhelp.boxpdf(x)):
        np.testing.assert_array_equal(a, b)
    assert thelp.get_cache_dir() == jhelp.get_cache_dir()
    assert os.path.isdir(thelp.get_cache_dir())

"""The host grid as every surface builds it (``transform._host_grid``): the
COI built in place in one array, bit for bit the expression it replaces and
the JAX package's ``coi_bartlett``; the angular frequencies built only
where a NaN-row check (Paul's) or ``api.cwt`` reads them, counted by
``profiling.GRID_FTFREQ_ARRAYS`` beside ``profiling.HOST_GRIDS``; the
grid's scales as the NaN-row drop on the full frequency array gives them;
``api.cwt``'s frequencies and the Paul golden bit for bit; and the span
``coi`` of ``cwt_power``, opened after the kernels' enqueue and before the
``fetch``.  The card twin is ``test_torch_host_spans_cuda.py``."""
import os

import numpy as np
import pytest
import torch

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import transform as jtr
from pycwt_torch import transform as ttr
from pycwt_torch.config import CWTConfig
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MOTHERS = {"morlet6": (wt.Morlet(6), pt.Morlet(6)),
           "paul4": (wt.Paul(4), pt.Paul(4)),
           "dog2": (wt.DOG(2), pt.DOG(2))}
F64 = CWTConfig(dtype=torch.float64)
FFT_LENGTH = CWTConfig().fft_length


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and the counters 0."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _old_coi(n0, dt, mother):
    """The COI as one expression, each step a new array."""
    tri = n0 / 2 - np.abs(np.arange(0, n0, dtype=np.float64) - (n0 - 1) / 2)
    return mother.flambda() * mother.coi() * dt * tri


def _old_grid(n0, dt, mother):
    """The grid's scales, frequencies and COI as they were built with the
    full angular-frequency array for every mother."""
    grid = ttr.build_scale_grid(n0, dt, mother=mother)
    nfft = FFT_LENGTH(n0)
    sj, freqs = ttr._finite_rows(mother, grid.sj, grid.freqs,
                                 2 * np.pi * np.fft.fftfreq(nfft, dt))
    return sj, freqs, _old_coi(n0, dt, mother)


@pytest.mark.parametrize("key", sorted(MOTHERS))
@pytest.mark.parametrize("n0", [1, 2, 147, 1000, 4097, 10 ** 6])
def test_the_coi_is_the_old_expression_and_the_jax_one(n0, key):
    j, t = MOTHERS[key]
    dt = 0.25
    coi = ttr.coi_bartlett(n0, dt, t)
    assert coi.shape == (n0,) and coi.dtype == np.float64
    np.testing.assert_array_equal(coi, _old_coi(n0, dt, t))
    np.testing.assert_array_equal(coi, jtr.coi_bartlett(n0, dt, j))
    g = ttr._host_grid(n0, dt, 1 / 12, -1, -1, t, FFT_LENGTH)
    np.testing.assert_array_equal(g.coi, coi)
    assert g.coi is g.coi                   # built once, on the first read


@pytest.mark.parametrize("key", sorted(MOTHERS))
@pytest.mark.parametrize("n0", [147, 1000, 4097])
def test_the_grid_is_the_old_grid(n0, key):
    """Morlet and DOG skip the NaN-row check, which keeps every row of
    theirs; Paul's drops rows from n0 ~ 230 on, as it did."""
    t = MOTHERS[key][1]
    g = ttr._host_grid(n0, 0.25, 1 / 12, -1, -1, t, FFT_LENGTH)
    sj, freqs, coi = _old_grid(n0, 0.25, t)
    for got, want in ((g.sj, sj), (g.freqs, freqs), (g.coi, coi)):
        np.testing.assert_array_equal(got, want)
    full = ttr.build_scale_grid(n0, 0.25, mother=t)
    assert (len(g.sj) < len(full.sj)) == (key == "paul4" and n0 > 147)
    assert profiling.HOST_GRIDS == 1
    assert profiling.GRID_FTFREQ_ARRAYS == (key == "paul4")


def _x(n0=3000, seed=7):
    return np.random.default_rng(seed).standard_normal(n0)


def _pair():
    return np.random.default_rng(5).standard_normal((2, 147))


#: (call, grids it builds, frequency arrays it builds)
CALLS = {
    "cwt_power_morlet_planar": (lambda: pt.cwt_power(
        _x(), 1.0, config=CWTConfig(engine="planar"), device="cpu"), 1, 0),
    "cwt_power_morlet_xla": (lambda: pt.cwt_power(
        _x(), 1.0, config=CWTConfig(engine="xla"), device="cpu"), 1, 0),
    "cwt_power_dog": (lambda: pt.cwt_power(_x(), 1.0, wavelet=pt.DOG(2),
                                           device="cpu"), 1, 0),
    "wct_morlet": (lambda: pt.wct(*_pair(), 0.25, sig=False, device="cpu"), 1, 0),
    "wct_dog": (lambda: pt.wct(*_pair(), 0.25, sig=False, wavelet=pt.DOG(2),
                               device="cpu"), 1, 0),
    "wct_matrix_morlet": (lambda: pt.wct_matrix(
        np.random.default_rng(11).standard_normal((4, 128)), 0.25, device="cpu"),
        1, 0),
    "cwt_morlet": (lambda: pt.cwt(_x(), 1.0, device="cpu"), 1, 1),
    "cwt_dog": (lambda: pt.cwt(_x(), 1.0, wavelet=pt.DOG(2), device="cpu"), 1, 1),
    "cwt_paul": (lambda: pt.cwt(_x(), 1.0, wavelet=pt.Paul(4), device="cpu"), 1, 1),
    "cwt_power_paul": (lambda: pt.cwt_power(_x(), 1.0, wavelet=pt.Paul(4),
                                            device="cpu"), 1, 1),
    "grid_paul": (lambda: ttr._host_grid(3000, 1.0, 1 / 12, -1, -1, pt.Paul(4),
                                         FFT_LENGTH), 1, 1),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_the_frequency_arrays_built(name):
    """``GRID_FTFREQ_ARRAYS`` rises by 0 a Morlet or DOG ``cwt_power``,
    ``wct`` or ``wct_matrix`` call and by 1 an ``api.cwt`` call or a Paul
    grid, with the recorder off as on; ``HOST_GRIDS`` by 1 a call."""
    fn, grids, arrays = CALLS[name]
    profiling.enable_spans()
    fn()
    assert (profiling.HOST_GRIDS, profiling.GRID_FTFREQ_ARRAYS) == (grids, arrays)
    profiling.disable_spans()
    fn()
    assert (profiling.HOST_GRIDS, profiling.GRID_FTFREQ_ARRAYS) == \
        (2 * grids, 2 * arrays)


@pytest.mark.parametrize("key", sorted(MOTHERS))
def test_cwt_returns_the_old_frequencies(key):
    t = MOTHERS[key][1]
    x = _x(1000)
    out = pt.cwt(x, 0.5, wavelet=t, config=F64, device="cpu")
    nfft = FFT_LENGTH(1000)
    np.testing.assert_array_equal(
        out[5], (2 * np.pi * np.fft.fftfreq(nfft, 0.5))[1:nfft // 2] / (2 * np.pi))
    for got, want in zip(out[1:4], _old_grid(1000, 0.5, t)):
        np.testing.assert_array_equal(got, want)


def test_the_paul_golden_grid_is_bit_for_bit():
    g = np.load(os.path.join(GOLDEN, "cwt_nino3_paul4.npz"))
    _, sj, freqs, coi, _, fftfreqs = pt.cwt(g["signal"], float(g["dt"]),
                                            wavelet=pt.Paul(4), config=F64,
                                            device="cpu")
    for got, key in ((sj, "sj"), (freqs, "freqs"), (coi, "coi"),
                     (fftfreqs, "fftfreqs")):
        np.testing.assert_array_equal(got, g[key])


@pytest.mark.parametrize("route", ["planar", "xla"])
def test_cwt_power_builds_the_coi_between_enqueue_and_fetch(route):
    """Under ``torch.profiler`` the span ``coi`` opens inside ``cwt_power``
    after the transform's span (``fused_cwt`` on the planar route,
    ``cwt_batch`` on the others) has closed and before the first ``fetch``
    opens, and its answers are the parent's formulas bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    x = _x()
    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        power, sj, freqs, coi = pt.cwt_power(x, 1.0, config=CWTConfig(engine=route),
                                             device="cpu")
    events = {}
    for e in prof.events():
        if e.is_user_annotation:
            events.setdefault(e.name, []).append(e)
    (c,) = events["coi"]
    assert c.cpu_parent.name == "cwt_power"
    work = events["fused_cwt" if route == "planar" else "cwt_batch"]
    assert max(e.time_range.end for e in work) <= c.time_range.start
    assert c.time_range.end <= min(e.time_range.start for e in events["fetch"])
    for got, want in zip((sj, freqs, coi), _old_grid(len(x), 1.0, pt.Morlet(6))):
        np.testing.assert_array_equal(got, want)
    assert power.shape == (len(sj), len(x))

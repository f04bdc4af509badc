"""The all-pairs coherence matrix (``wct_matrix``) of a small station network
against the benchmark's float64 reference
(``cwtbench/reference/wct_matrix_f64.py``), its spans and counters, and the
readers of the six per-layer metrics of the cell ``wct_matrix_32st``.

The network is the cell's (``cwtbench/inputs/station_network.py``) cut to 6
stations of 147 samples at the cell's settings (dt 0.25, dj 1/12,
Morlet-6: 76 scales at nfft 256), so all 15 pairs.  The CPU routes are the
complex one in float64 and in float32 (``torch.fft``) and
``engine="planar"``, which runs the kernels' plain version on the card's
route.  Its card twin is ``test_torch_wct_matrix_net_cuda.py``."""
import math
import types

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import wct_matrix_f64 as R
from pycwt_torch.config import CWTConfig
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

NETWORK = harness.load_module("inputs", "station_network").make
ENTRY = harness.load_module("entries", "wct_matrix")
PARAMS = {"networks": 1, "stations": 6, "n0": 147, "g": [0.4, 0.8],
          "burn_in": 256, "period": 32, "amplitude": 1.0}
SEED = 2 ** 31 + 4099
DT, DJ = 0.25, 1 / 12
ROUTES = {"f64": CWTConfig(dtype=torch.float64), "f32": CWTConfig(),
          "planar": CWTConfig(engine="planar")}
#: (WCT, weighted phase) tolerances.  float64: the FFTs against the
#: reference's DFT products read up to 3.2e-15 over eight seeds; the ratio
#: of two smoothed fields can amplify a rounding where they are small, so
#: 1e-12 leaves ~300 times room.  float32, either route: the transform's
#: and the smoothing's rounding read up to 1.8e-6 (WCT) and 5.4e-7 (phase)
#: over eight seeds, and the cell's runs up to 7.5e-6; the reference in
#: TF32 reads 2.3e-3 and 5.7e-4, so a fault of that size fails.
TOL = {"f64": (1e-12, 1e-12), "f32": (5e-5, 1e-5), "planar": (5e-5, 1e-5)}
#: the host float64 grid is built by the same formulas on both sides
GRID_TOL = 4 * np.finfo(np.float64).eps


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the span recorder off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _stations(seed=SEED):
    return NETWORK(PARAMS, seed, "cpu")["y"][0]


def gaps(out, y, device="cpu"):
    """wct_gap, phase_gap and grid_gap of ``wct_matrix``'s answer against
    the reference, as the cell's entry reads them (``map_gaps``)."""
    WCT, aWCT, coi, freqs, _ = out
    net = R.Network(y, DT, DJ, 6.0, R.Arith("f64"), device)
    w_gap, ph_gap = ENTRY.map_gaps(net, lambda lo, hi: (WCT[lo:hi], aWCT[lo:hi]), device)
    grid = max(float(np.max(np.abs(np.asarray(a) / b - 1)))
               for a, b in ((coi, net.coi), (freqs, net.freqs)))
    return w_gap, ph_gap, grid


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wct_matrix_matches_the_reference(route):
    y = _stations()
    out = pt.wct_matrix(y, DT, dj=DJ, wavelet=pt.Morlet(6), config=ROUTES[route],
                        device="cpu")
    WCT, aWCT, coi, freqs, pairs = out
    dtype = np.float64 if route == "f64" else np.float32
    assert WCT.shape == aWCT.shape == (15, 76, 147)
    assert WCT.dtype == aWCT.dtype == dtype
    assert coi.shape == (147,) and freqs.shape == (76,)
    np.testing.assert_array_equal(pairs, R.all_pairs(6))
    w_gap, ph_gap, grid = gaps(out, y)
    assert w_gap <= TOL[route][0] and ph_gap <= TOL[route][1], (w_gap, ph_gap)
    assert grid <= GRID_TOL


def test_the_reference_pairs_are_row_major():
    assert R.all_pairs(4).tolist() == [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]


def test_the_network_is_seeded_and_coherent_in_its_first_half():
    y = _stations()
    assert y.shape == (6, 147) and y.dtype == np.float64 and y.flags.c_contiguous
    np.testing.assert_array_equal(y, _stations())
    assert not np.array_equal(y, _stations(SEED + 1))
    big = NETWORK(dict(PARAMS, stations=4, n0=4096), SEED, "cpu")["y"][0]
    spec = np.abs(np.fft.rfft(big - big.mean(1, keepdims=True), axis=1)) ** 2
    k = 4096 // 32                       # the period-32 bin
    near = spec[:, k - 40:k + 40].mean(1)
    # a unit sine over 4096 samples: (4096 / 2)^2 in its bin, ~70 times an
    # AR(1) bin's mean at g = 0.8; a noise bin passes 20 times its mean
    # with a chance of e^-20
    assert np.all(spec[:2, k] > 20 * near[:2]) and np.all(spec[2:, k] < 20 * near[2:])


#: spans directly under ``wct_matrix`` a call
UNDER = {"grid": 1, "upload": 1, "wct_matrix.fields": 1, "wct_matrix.pairs": 1,
         "fetch": 2, "coi": 1}


@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_the_spans_hold_the_call(engine):
    """``wct_matrix`` once a call, its fields, its pair loop, the COI and
    the two fetches once each under it (the layers below them, ``spectrum``,
    ``fused_cwt``, ``smooth``, nest inside): its self time is its total less
    theirs; ``MATRIX_PAIRS`` rises by the 15 pairs a call."""
    y = _stations()
    profiling.enable_spans()
    for _ in range(3):
        pt.wct_matrix(y, DT, dj=DJ, config=CWTConfig(engine=engine), device="cpu")
    got = profiling.span_summary()
    assert got["wct_matrix"]["count"] == 3
    for name, n in UNDER.items():
        assert got[name]["count"] == 3 * n, name
    row = got["wct_matrix"]
    assert row["self_ns"] == row["total_ns"] - sum(got[k]["total_ns"] for k in UNDER)
    assert 0 < row["self_ns"] < row["total_ns"]
    assert profiling.MATRIX_PAIRS == 45 and profiling.MATRIX_PAIR_BLOCKS == 3
    assert profiling._stack == []


@pytest.mark.parametrize("pair_block", [4, 15])
def test_the_blocks_are_counted(pair_block):
    """``MATRIX_PAIR_BLOCKS`` rises by ceil(15 / pair_block) a call, whether
    the recorder is on or off; switching it on sets both counters to 0."""
    y = _stations()
    profiling.enable_spans()
    assert profiling.MATRIX_PAIRS == profiling.MATRIX_PAIR_BLOCKS == 0
    kw = dict(dj=DJ, pair_block=pair_block, config=CWTConfig(engine="planar"),
              device="cpu")
    for _ in range(2):
        pt.wct_matrix(y, DT, **kw)
    blocks = math.ceil(15 / pair_block)
    assert (profiling.MATRIX_PAIRS, profiling.MATRIX_PAIR_BLOCKS) == (30, 2 * blocks)
    profiling.disable_spans()
    pt.wct_matrix(y, DT, **kw)
    assert (profiling.MATRIX_PAIRS, profiling.MATRIX_PAIR_BLOCKS) == (45, 3 * blocks)
    profiling.enable_spans()
    assert profiling.MATRIX_PAIRS == profiling.MATRIX_PAIR_BLOCKS == 0


# --------------------------------------------------------------------------
# The cell's per-layer metrics
# --------------------------------------------------------------------------

#: the cell's shape: 32 stations of 1024 samples, 496 pairs, 110 scales,
#: Morlet's 14-tap boxcar at dj 1/12
CELL_SHAPE = {"kind": "wct_matrix", "B": 32, "P": 496, "S": 110, "n0": 1024,
              "nfft": 1024, "taps": 14}
SPAN_METRICS = ("api_host_ms.matrix", "pairs_host_ms.matrix", "fetch_wait_ms.matrix")
DEVICE_METRICS = ("matrix_roofline_pct", "device_idle_pct.matrix")


def _metric(name):
    return harness.load_module("metrics", name)


class _View:
    """What the device metrics read of a traced slice."""

    def __init__(self, shape, calls=0, ops=(), idle=None):
        self.entry = types.SimpleNamespace(shape=shape)
        self.calls, self.device_ops, self._idle = calls, list(ops), idle

    def idle_pct(self):
        return self._idle


def test_the_roofline_counts_the_calls_own_work():
    """Bytes: the stations in, the two f32 maps out; operations from the
    shape, about 1e10 at the cell's; the bound is the operations' at the
    f32 peak, a little above the bytes' at HBM's bandwidth."""
    roof = _metric("matrix_roofline_pct")
    assert roof.call_bytes(CELL_SHAPE) == 4 * 32 * 1024 + 8 * 496 * 110 * 1024
    ops = roof.call_ops(CELL_SHAPE)
    # per cross point: two FFTs at 5 log2 N each, 8 + 2 + 56 + 5 + 1 besides
    assert ops == pytest.approx(496 * 110 * 1024 * 172, rel=0.06)
    assert roof.bound_s(CELL_SHAPE) == pytest.approx(ops / 67e12)
    assert 0.13e-3 < roof.call_bytes(CELL_SHAPE) / 3.35e12 < roof.bound_s(CELL_SHAPE) < 0.16e-3


def test_the_roofline_reads_the_device_time_but_the_copies_home():
    """Every device op counts but those named DtoH, over the slice's calls;
    nothing is read without calls, ops or the matrix's shape."""
    roof = _metric("matrix_roofline_pct")
    bound_us = roof.bound_s(CELL_SHAPE) * 1e6
    ops = [(0.0, 30 * bound_us, "cwt_stage_a_kernel"),
           (0.0, 10 * bound_us, "Memcpy DtoH (Device -> Pinned)"),
           (0.0, 10 * bound_us, "Memcpy HtoD (Pageable -> Device)")]
    assert roof.read(_View(CELL_SHAPE, 4, ops)) == pytest.approx(10.0)
    assert roof.read(_View(CELL_SHAPE, 0, ops)) is None
    assert roof.read(_View(CELL_SHAPE, 4)) is None
    assert roof.read(_View(dict(CELL_SHAPE, kind="wct"), 4, ops)) is None
    assert roof.read(_View(CELL_SHAPE, 4, ops[1:2])) is None
    idle = _metric("device_idle_pct.matrix")
    assert idle.read(_View(CELL_SHAPE, idle=12.5)) == 12.5
    assert idle.read(_View(CELL_SHAPE)) is None


def test_the_span_metrics_read_a_call_of_the_recorder():
    """Loading a span metric switches the recorder on; each reads its span
    a ``wct_matrix`` call over the calls outside a profiler, and the block
    count over every call."""
    mods = {n: _metric(n) for n in SPAN_METRICS + ("pair_blocks.matrix",)}
    assert profiling._on
    assert all(m.read(None) is None for m in mods.values())
    y = _stations()
    for _ in range(2):
        pt.wct_matrix(y, DT, dj=DJ, pair_block=4, config=CWTConfig(engine="planar"),
                      device="cpu")
    got = profiling.span_summary()
    ms = {k: got[k]["total_ns"] * 1e-6 / 2 for k in got}
    assert mods["api_host_ms.matrix"].read(None) == pytest.approx(
        got["wct_matrix"]["self_ns"] * 1e-6 / 2)
    assert mods["pairs_host_ms.matrix"].read(None) == pytest.approx(ms["wct_matrix.pairs"])
    assert mods["fetch_wait_ms.matrix"].read(None) == pytest.approx(ms["fetch"])
    assert mods["pair_blocks.matrix"].read(None) == 4
    for name in SPAN_METRICS:
        assert 0 < mods[name].read(None) < ms["wct_matrix"]


@pytest.mark.parametrize("name", SPAN_METRICS + ("pair_blocks.matrix",))
def test_a_program_without_the_spans_or_counters_reads_nothing(name, monkeypatch):
    """Over the parent's program (the recorder, no span ``wct_matrix``, no
    block counter) and over one without the recorder, loading the metric
    and reading it give nothing and raise nothing."""
    monkeypatch.delattr(profiling, "MATRIX_PAIR_BLOCKS")
    mod = _metric(name)
    with profiling.span("fetch"):
        pass
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert _metric(name).read(None) is None

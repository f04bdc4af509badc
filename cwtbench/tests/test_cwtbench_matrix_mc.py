"""The cell ``wct_matrix_mc_32st`` on the CPU, cut to networks of 6 stations
of 256 samples (15 pairs, 86 scales; surrogates of 1576 samples at nfft
2048) and 24 members a null: whole runs come out correct; the TF32 control
and each fault the cell can have come out not correct; a traced run lists
the cell's per-layer metrics and reads those that the CPU gives something
to read; the roofline counts the work from the shape."""
import math
import os
import time
import types

import numpy as np
import pytest

from conftest import edit_json
from cwtbench import harness
from pycwt_torch.utils import profiling

CELL = "wct_matrix_mc_32st"
SEED = 2 ** 31 + 1597
SPAN_METRICS = ("mc_batch_ms.matrix_mc", "readout_host_ms.matrix_mc",
                "api_host_ms.matrix_mc", "mc_histogram_ms.matrix_mc")
COUNTER_METRICS = ("nulls_per_call.matrix_mc",)
DEVICE_METRICS = ("mc_roofline_pct.matrix_mc",)
#: metrics of ``wct_matrix_32st`` and ``wct_mc300`` that the cell also
#: reports: the maps' pair loop and blocks, which the CPU reads, and the
#: card's idle share and generator rows, which it does not
SHARED_CPU = ("pairs_host_ms.matrix", "pair_blocks.matrix")
SHARED_CARD = ("device_idle_pct.matrix", "mc_kernel_rows_pct")
#: the cut's own sig_gap limit, set by the cell's rule at the cut's size:
#: 24 members of 1576 samples give each scale's CDF ~50 times fewer counts
#: than 300 of 6302, so a float32 rounding that moves a count moves the
#: curve more; over six seeds the program reads 1.4e-5-6.0e-5 there,
#: over three the TF32 reference 3.1e-4-4.5e-4
CUT_SIG_LIMIT = 1e-4


@pytest.fixture(autouse=True)
def recorder_off():
    """Loading a span metric switches the recorder on: each test starts and
    ends with it off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


@pytest.fixture
def mc_root(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "traffic", "network32_mc300.json"),
              {"inputs": {"networks": 2, "stations": 6, "n0": 256, "g": [0.45, 0.6]}})
    edit_json(os.path.join(here, "configs", "grinsted04_network32_mc300.json"),
              {"mc_count": 24})
    edit_json(os.path.join(here, "cells", f"{CELL}.json"),
              {"limits": {"sig_gap": CUT_SIG_LIMIT}})
    return root, here


def _run(root, here, seconds=0.5, trace=False):
    return harness.run(CELL, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_the_cell_is_correct_on_the_cpu(mc_root):
    root, here = mc_root
    res, checks = _run(root, here)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == {"sig_gap", "alpha_gap", "wct_gap", "phase_gap",
                           "grid_gap", "pairs_gap"}
    assert checks["pairs_gap"][0] == 0 and checks["grid_gap"][0] == 0
    assert 0 < checks["sig_gap"][0] and checks["alpha_gap"][0] < 1e-14
    assert set(res["metrics"]) == {"setup_s", "analyses_per_s", "analysis_p95_ms"}


def test_the_control_fails(mc_root):
    """The references in TF32 in the program's place read above the
    significance, coefficient, WCT, phase and grid limits."""
    from cwtbench.control import readings

    root, here = mc_root
    c = harness.load_cell(CELL, root, here)
    row = readings(c, SEED, 0.1, True, "cpu")
    for k in ("sig_gap", "alpha_gap", "wct_gap", "phase_gap", "grid_gap"):
        assert row[k] > c.spec["limits"][k], (k, row)
    assert row["pairs_gap"] == 0


def _swap_curves_across_nulls(out):
    """Two pairs of different nulls trade curves."""
    sig = out["sig95"].copy()
    a, b = 0, next(p for p in range(1, len(sig)) if not np.array_equal(sig[p], sig[0]))
    sig[[a, b]] = sig[[b, a]]
    return dict(out, sig95=sig)


def _scale_a_curve(out):
    sig = out["sig95"].copy()
    sig[3] *= 1 + 1e-3
    return dict(out, sig95=sig)


def _zero_a_nan_row(out):
    sig = out["sig95"].copy()
    sig[np.isnan(sig)] = 0.0
    return dict(out, sig95=sig)


def _fault_call(monkeypatch, fault):
    from pycwt_torch import analysis

    inner = analysis.wct_matrix_analysis
    monkeypatch.setattr(analysis, "wct_matrix_analysis",
                        lambda *a, **kw: fault(inner(*a, **kw)))


def _half_the_members(monkeypatch):
    """The nulls simulated with half the members the call asks for."""
    from pycwt_torch import coherence

    inner = coherence.wct_significance_batch

    def half(*a, mc_count=300, **kw):
        return inner(*a, mc_count=mc_count // 2, **kw)

    monkeypatch.setattr(coherence, "wct_significance_batch", half)


@pytest.mark.parametrize("fault", ["swap_curves_across_nulls", "half_the_members",
                                   "scale_a_curve", "zero_a_nan_row"])
def test_a_fault_fails(mc_root, monkeypatch, fault):
    root, here = mc_root
    if fault == "half_the_members":
        _half_the_members(monkeypatch)
    else:
        _fault_call(monkeypatch, globals()[f"_{fault}"])
    c = harness.load_cell(CELL, root, here)
    entry = harness.make_entry(c, SEED, "cpu")
    entry.warm()
    window = harness.Window(setup_s=0.0)
    harness.measure(entry, 0.1, lambda: None, window)
    assert window.calls > 0 and window.failed == 0
    gaps = entry.compare()
    assert gaps["sig_gap"] > c.spec["limits"]["sig_gap"], gaps


def test_the_traced_run_reads_the_new_metrics(mc_root):
    root, here = mc_root
    listed = {m["name"] for m in harness.load_cell(CELL, root, here).per_layer}
    assert listed == set(SPAN_METRICS + COUNTER_METRICS + DEVICE_METRICS
                         + SHARED_CPU + SHARED_CARD)
    res, checks = _run(root, here, seconds=1.0, trace=True)
    assert res["correct"], checks
    # the CPU has no device timeline and draws no row on a card
    assert set(res["metrics"]) == set(SPAN_METRICS + COUNTER_METRICS + SHARED_CPU)
    for name in SPAN_METRICS:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and 0 < value < 2 * res["call_ms"]["max"], (name, value)
    # call i takes network i mod 2, each with its own count of nulls
    nulls = harness.make_entry(harness.load_cell(CELL, root, here), SEED, "cpu").shape["nulls"]
    summary = profiling.span_summary()
    calls = summary["wct_matrix_analysis"]["count"] + summary["wct_matrix_analysis"]["profiled"]
    want = sum(nulls[i % 2] for i in range(calls))
    assert calls == res["attempted"] and profiling.MC_NULLS == want
    assert res["metrics"]["nulls_per_call.matrix_mc"]["value"] == pytest.approx(want / calls)
    assert res["metrics"]["pair_blocks.matrix"]["value"] == 1


def test_the_shape_counts_the_references_nulls(mc_root):
    root, here = mc_root
    c = harness.load_cell(CELL, root, here)
    entry = harness.make_entry(c, SEED, "cpu")
    from cwtbench.reference import wct_null_pairs_f64 as NP

    pairs = NP.all_pairs(6)
    want = [len(NP.null_keys(NP.station_alphas(y), pairs, 24)[0]) for y in entry.y]
    # the seed's two networks differ: 5 and 11 nulls
    assert entry.shape["nulls"] == want == [5, 11]
    assert (entry.shape["n_mc"], entry.shape["nfft_mc"], entry.shape["S"]) == (1576, 2048, 86)


#: the cell's shape: 32 stations of 1024 samples, 496 pairs, 110 scales,
#: surrogates of 6302 samples at nfft 8192, every network here of 45 nulls
CELL_SHAPE = {"kind": "wct_matrix_mc", "B": 32, "P": 496, "S": 110, "n0": 1024,
              "nfft": 1024, "taps": 14, "n_mc": 6302, "nfft_mc": 8192,
              "mc_count": 300, "nulls": [45, 45, 45, 45]}


def _view(shape, first=0, last=0, ops=()):
    return types.SimpleNamespace(entry=types.SimpleNamespace(shape=shape), first=first,
                                 last=last, calls=last - first, device_ops=list(ops))


def test_the_roofline_counts_the_work_of_the_shape():
    """A member pair is ~0.49 GFLOP (two CWTs, two self-smoothings, the
    cross smoothing and the ratio); a call of 45 nulls ~6.6 TFLOP beside
    the maps' ~1e10, bound by the f32 peak at ~0.1 s; nothing in the shape
    says how the program chunks, so any chunking reads the same bound."""
    roof = harness.load_module("metrics", "mc_roofline_pct.matrix_mc")
    maps = harness.load_module("metrics", "matrix_roofline_pct")
    assert roof.member_ops(CELL_SHAPE) == pytest.approx(0.49e9, rel=0.01)
    ops = roof.call_ops(CELL_SHAPE, 45)
    assert ops == pytest.approx(maps.call_ops(CELL_SHAPE) + 45 * 300 * roof.member_ops(CELL_SHAPE))
    assert 6.5e12 < ops < 6.7e12
    assert roof.bound_s(CELL_SHAPE, 45) == pytest.approx(ops / 67e12)
    bound_us = roof.bound_s(CELL_SHAPE, 45) * 1e6
    ops_ = [(0.0, 20 * bound_us, "cwt_stage_a_kernel"),
            (0.0, 5 * bound_us, "Memcpy DtoH (Device -> Pinned)")]
    assert roof.read(_view(CELL_SHAPE, 4, 6, ops_)) == pytest.approx(10.0)
    assert roof.read(_view(CELL_SHAPE, 4, 4, ops_)) is None
    assert roof.read(_view(dict(CELL_SHAPE, kind="wct_matrix"), 4, 6, ops_)) is None
    chunked = dict(CELL_SHAPE, mc_batch=9, chunks=34)
    assert roof.read(_view(chunked, 4, 6, ops_)) == roof.read(_view(CELL_SHAPE, 4, 6, ops_))


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_a_program_without_the_spans_or_counters_reads_nothing(name, monkeypatch):
    """Over the parent's program (the recorder, no span
    ``wct_matrix_analysis``, no null counter) and over one without the
    recorder, loading the metric and reading it give nothing."""
    monkeypatch.delattr(profiling, "MC_NULLS")
    mod = harness.load_module("metrics", name)
    with profiling.span("fetch"):
        pass
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert harness.load_module("metrics", name).read(None) is None

"""The cell ``wct_matrix_32st`` on the CPU, cut to networks of 6 stations of
147 samples (15 pairs, 76 scales): whole runs come out correct; the TF32
control and each fault the cell can have come out not correct; a traced
run lists the cell's six per-layer metrics and reads those that the CPU
gives something to read; the kept calls are drawn from the seed."""
import math
import os
import time

import numpy as np
import pytest

from conftest import edit_json
from cwtbench import harness
from pycwt_torch.utils import profiling

CELL = "wct_matrix_32st"
SEED = 2 ** 31 + 977
SPAN_METRICS = ("api_host_ms.matrix", "pairs_host_ms.matrix",
                "fetch_wait_ms.matrix", "pair_blocks.matrix")
DEVICE_METRICS = ("matrix_roofline_pct", "device_idle_pct.matrix")


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
def matrix_root(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "traffic", "network32_maps.json"),
              {"inputs": {"stations": 6, "n0": 147}})
    return root, here


def _run(root, here, seconds=0.6, trace=False):
    return harness.run(CELL, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_the_cell_is_correct_on_the_cpu(matrix_root):
    root, here = matrix_root
    # a window long enough for some calls on a loaded CPU (pytest -n 4)
    res, checks = _run(root, here, seconds=1.5)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == {"wct_gap", "phase_gap", "grid_gap", "pairs_gap"}
    assert checks["pairs_gap"][0] == 0 and checks["grid_gap"][0] == 0
    assert set(res["metrics"]) == {"setup_s", "analyses_per_s", "analysis_p95_ms"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_the_control_fails(matrix_root):
    """The reference in TF32 in the program's place reads above the WCT,
    phase and grid limits."""
    from cwtbench.control import readings

    root, here = matrix_root
    c = harness.load_cell(CELL, root, here)
    row = readings(c, SEED, 0.3, True, "cpu")
    for k in ("wct_gap", "phase_gap", "grid_gap"):
        assert row[k] > c.spec["limits"][k], row
    assert row["pairs_gap"] == 0


def _scale_a_value(out):
    WCT, *rest = out
    WCT = WCT.copy()
    WCT.flat[np.argmax(WCT)] *= 1 + 1e-3
    return (WCT, *rest)


def _swap_two_pairs(out):
    WCT, aWCT, *rest = out
    return (WCT[[1, 0, *range(2, len(WCT))]], aWCT[[1, 0, *range(2, len(aWCT))]], *rest)


def _drop_a_scale_row(out):
    WCT, aWCT, coi, freqs, pairs = out
    return WCT[:, 1:], aWCT[:, 1:], coi, freqs[1:], pairs


@pytest.mark.parametrize("fault", [_scale_a_value, _swap_two_pairs, _drop_a_scale_row],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_fails(matrix_root, monkeypatch, fault):
    from pycwt_torch import coherence

    root, here = matrix_root
    c = harness.load_cell(CELL, root, here)
    entry = harness.make_entry(c, SEED, "cpu")
    inner = coherence.wct_matrix
    monkeypatch.setattr(coherence, "wct_matrix", lambda *a, **kw: fault(inner(*a, **kw)))
    entry.warm()
    window = harness.Window(setup_s=0.0)
    harness.measure(entry, 0.4, lambda: None, window)
    assert window.calls > 0 and window.failed == 0
    gaps = entry.compare()
    assert any(gaps[k] > lim for k, lim in c.spec["limits"].items()), gaps


def test_the_traced_run_reads_the_new_metrics(matrix_root):
    root, here = matrix_root
    listed = {m["name"] for m in harness.load_cell(CELL, root, here).per_layer}
    assert listed == set(SPAN_METRICS) | set(DEVICE_METRICS)
    res, checks = _run(root, here, seconds=3.0, trace=True)
    assert res["correct"], checks
    for name in SPAN_METRICS:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert res["metrics"]["pair_blocks.matrix"]["value"] == 1
    # the CPU has no device timeline: nothing to read there
    assert set(res["metrics"]) == set(SPAN_METRICS)
    summary = profiling.span_summary()
    calls = summary["wct_matrix"]["count"] + summary["wct_matrix"]["profiled"]
    assert calls == res["attempted"] and profiling.MATRIX_PAIRS == 15 * calls
    assert profiling.HOST_BYTES == calls * 2 * 15 * 76 * 147 * 4
    for name in ("api_host_ms.matrix", "pairs_host_ms.matrix", "fetch_wait_ms.matrix"):
        assert res["metrics"][name]["value"] < 2 * res["call_ms"]["p50"]


def test_the_kept_calls_are_drawn_from_the_seed(matrix_root):
    """The first call, one drawn from the seed among calls 1-15, and the
    last one."""
    root, here = matrix_root
    c = harness.load_cell(CELL, root, here)
    kept = []
    for seed in (SEED, SEED, SEED + 1, SEED + 2):
        entry = harness.make_entry(c, seed, "cpu")
        for i in range(40):
            entry.keep(i, None)
        kept.append(sorted(entry.kept))
    assert kept[0] == kept[1] and len({tuple(k) for k in kept}) > 1
    for k in kept:
        assert len(k) == 3 and k[0] == 0 and 0 < k[1] < 16 and k[2] == 39


def test_the_reference_is_each_pairs_reference():
    """The network's shared fields give each pair the maps that the pair
    reference of the coherence cells (``reference/wct_f64.py``, held
    against pycwt's formulas in numpy and scipy) gives it alone."""
    from cwtbench.reference import wct_f64, wct_matrix_f64

    make = harness.load_module("inputs", "station_network").make
    y = make({"networks": 1, "stations": 4, "n0": 147, "g": [0.4, 0.8],
              "burn_in": 256, "period": 32, "amplitude": 1.0}, SEED, "cpu")["y"][0]
    ar = wct_f64.Arith("f64")
    net = wct_matrix_f64.Network(y, 0.25, 1 / 12, 6.0, ar, "cpu")
    (lo, hi, W, A, M), = net.blocks()
    assert (lo, hi) == (0, 6)
    for p, (i, j) in enumerate(net.pairs):
        w, a, coi, freqs, mag = wct_f64.wct(y[i], y[j], 0.25, 1 / 12, 6.0, ar, "cpu")
        np.testing.assert_allclose(W[p].numpy(), w, rtol=0, atol=1e-12)
        np.testing.assert_allclose(A[p].numpy(), a, rtol=0, atol=1e-12)
        np.testing.assert_allclose(M[p].numpy(), mag, rtol=1e-12)
        np.testing.assert_array_equal(net.coi, coi)
        np.testing.assert_array_equal(net.freqs, freqs)

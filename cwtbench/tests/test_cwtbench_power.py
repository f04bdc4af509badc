"""The cell ``cwt_power_host_1m`` on the CPU, cut to 3,000-sample records:
whole runs come out correct; the ``fast`` control and each fault the cell
can have come out not correct; a traced run reads its per-layer metrics
where the CPU gives them something to read; and a program without the
span ``cwt_power`` or the byte counter reads nothing and raises nothing."""
import math
import os
import time
import types

import numpy as np
import pytest

from conftest import edit_json
from cwtbench import harness, kernel_bounds
from pycwt_torch.utils import profiling

CELL = "cwt_power_host_1m"
SEED = 2 ** 31 + 977
SPAN_METRICS = ("api_host_ms.power", "fetch_wait_ms.power", "fetch_gb_s.power")
DEVICE_METRICS = ("power_kernels_roofline_pct", "device_idle_pct.power")


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
def power_root(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "traffic", "power_host_1m.json"),
              {"inputs": {"n0": 3000, "records": 2}})
    return root, here


def _run(root, here, seconds=0.6, trace=False):
    return harness.run(CELL, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_the_cell_is_correct_on_the_cpu(power_root):
    root, here = power_root
    res, checks = _run(root, here)
    assert res["correct"], checks
    assert res["attempted"] > 2 and res["failed"] == 0
    assert set(checks) == {"p_gap", "grid_gap"}
    assert set(res["metrics"]) == {"setup_s", "analyses_per_s", "analysis_p95_ms"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_the_control_fails(power_root):
    """The program at the ``fast`` tier (bf16 T) reads above ``p_gap``'s
    limit; its grid is the same host f64 grid."""
    from cwtbench.control import readings

    root, here = power_root
    c = harness.load_cell(CELL, root, here)
    row = readings(c, SEED, 0.3, True, "cpu")
    assert row["p_gap"] > c.spec["limits"]["p_gap"], row
    assert row["grid_gap"] <= c.spec["limits"]["grid_gap"], row


def _scale_a_row(inner, records):
    def call(x, dt, **kw):
        P, *rest = inner(x, dt, **kw)
        P = P.copy()
        P[7] *= 1 + 1e-3
        return (P, *rest)
    return call


def _drop_a_row(inner, records):
    def call(x, dt, **kw):
        P, sj, freqs, coi = inner(x, dt, **kw)
        return P[1:], sj[1:], freqs[1:], coi
    return call


def _wrong_record(inner, records):
    """Each call answers with the power of the record it was not given."""
    def call(x, dt, **kw):
        other = next(r for r in records if not np.shares_memory(r, x))
        return inner(other, dt, **kw)
    return call


@pytest.mark.parametrize("fault", [_scale_a_row, _drop_a_row, _wrong_record],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_fails(power_root, monkeypatch, fault):
    import pycwt_torch as pt

    root, here = power_root
    c = harness.load_cell(CELL, root, here)
    entry = harness.make_entry(c, SEED, "cpu")
    records = list(entry.x)
    monkeypatch.setattr(pt, "cwt_power", fault(pt.cwt_power, records))
    entry.warm()
    window = harness.Window(setup_s=0.0)
    harness.measure(entry, 0.4, lambda: None, window)
    assert window.calls > 0 and window.failed == 0
    gaps = entry.compare()
    assert any(gaps[k] > lim for k, lim in c.spec["limits"].items()), gaps


def test_the_traced_run_reads_the_new_metrics(power_root):
    root, here = power_root
    listed = {m["name"] for m in harness.load_cell(CELL, root, here).per_layer}
    assert listed == set(SPAN_METRICS) | set(DEVICE_METRICS)
    res, checks = _run(root, here, seconds=3.0, trace=True)
    assert res["correct"], checks
    for name in SPAN_METRICS:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    # the CPU has no device timeline: nothing to read there
    assert not set(res["metrics"]) & set(DEVICE_METRICS)
    summary = profiling.span_summary()
    calls = summary["cwt_power"]["count"] + summary["cwt_power"]["profiled"]
    assert calls == res["attempted"]
    S = harness.make_entry(harness.load_cell(CELL, root, here), SEED, "cpu").shape["S"]
    assert profiling.HOST_BYTES == calls * S * 3000 * 4
    assert res["metrics"]["fetch_wait_ms.power"]["value"] < 2 * res["call_ms"]["p50"]


class _Trace:
    """What the device metrics read of a traced slice."""

    def __init__(self, entry, per_call=None, idle=None):
        self.entry = entry
        self._per_call, self._idle = per_call or {}, idle

    def per_call_s(self, match=None):
        return self._per_call.get(match)

    def idle_pct(self):
        return self._idle


def test_the_device_metrics_read_the_timeline(power_root):
    """The kernels' roofline share is their bound at the call's shape over
    the device time of the ops named ``cwt_stage_`` a call; the idle share
    is the slice's."""
    root, here = power_root
    entry = harness.make_entry(harness.load_cell(CELL, root, here), SEED, "cpu")
    bound = sum(kernel_bounds.k1_k2(entry.shape, 4096).values())
    assert bound == sum(entry.kernel_bounds().values())
    roof = harness.load_module("metrics", "power_kernels_roofline_pct", here)
    idle = harness.load_module("metrics", "device_idle_pct.power", here)
    assert roof.read(_Trace(entry, {"cwt_stage_": 4 * bound})) == pytest.approx(25.0)
    assert roof.read(_Trace(entry)) is None
    assert roof.read(_Trace(types.SimpleNamespace(shape={"kernel_output": "planes"}),
                            {"cwt_stage_": 1.0})) is None
    assert idle.read(_Trace(entry, idle=12.5)) == 12.5


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_span_or_counter_reads_nothing(name, monkeypatch):
    """Over the parent's program (the recorder, no span ``cwt_power``, no
    counter) and over one without the recorder, loading the metric and
    reading it give nothing and raise nothing."""
    monkeypatch.delattr(profiling, "HOST_BYTES")
    mod = harness.load_module("metrics", name)
    with profiling.span("fetch"):
        pass
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert harness.load_module("metrics", name).read(None) is None


def test_the_kept_calls_are_drawn_from_the_seed(power_root):
    """Two calls drawn from the seed among the first 16, and the last one."""
    root, here = power_root
    c = harness.load_cell(CELL, root, here)
    kept = []
    for seed in (SEED, SEED, SEED + 1):
        entry = harness.make_entry(c, seed, "cpu")
        for i in range(40):
            entry.keep(i, None)
        kept.append(sorted(entry.kept))
    assert kept[0] == kept[1] != kept[2]
    assert len(kept[0]) == 3 and kept[0][-1] == 39 and kept[0][1] < 16


def test_the_records_are_host_ar1(power_root):
    root, here = power_root
    c = harness.load_cell(CELL, root, here)
    make = harness.load_module("inputs", "host_ar1_records", here).make
    params = dict(c.traffic["inputs"], n0=200_000)
    x = make(params, SEED, "cpu")["x"]
    assert x.dtype == np.float64 and x.flags.c_contiguous and x.shape == (2, 200_000)
    np.testing.assert_array_equal(x, make(params, SEED, "cpu")["x"])
    assert not np.array_equal(x, make(params, SEED + 1, "cpu")["x"])
    for r in x:
        assert abs(r.var() - 1) < 0.05
        assert abs(np.corrcoef(r[1:], r[:-1])[0, 1] - 0.72) < 0.01

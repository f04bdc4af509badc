"""The per-layer metrics that read the program's host spans ``grid``,
``upload``, ``ar1``, ``mc.setup``, ``mc.chunks``, ``mc.quantile`` and
``mc``, and the counter ``UPLOAD_BYTES``: a traced run of ``wct_mc300``,
``wct_nosig`` and ``cwt_power_host_1m`` lists and reads each of them; an
untraced run reports none; and a program without the spans or the counter
reads nothing and raises nothing."""
import math
import os
import time

import pytest

from conftest import edit_json
from cwtbench import harness
from pycwt_torch.utils import profiling

SEED = 2 ** 31 + 2707
#: the new metrics each cell lists
NEW = {
    "wct_mc300": ("grid_host_ms.wct", "upload_ms.wct", "ar1_host_ms.wct",
                  "mc_setup_ms.wct", "mc_enqueue_ms.wct", "quantile_host_ms.wct",
                  "mc_span_ms.wct"),
    "wct_nosig": ("grid_host_ms.wct", "upload_ms.wct"),
    "cwt_power_host_1m": ("grid_host_ms.power", "upload_ms.power",
                          "upload_gb_s.power"),
}
ALL = sorted({n for names in NEW.values() for n in names})
#: each metric's (span, the call span it is taken a call of)
SPAN_OF = {
    "grid_host_ms.power": ("grid", "cwt_power"),
    "upload_ms.power": ("upload", "cwt_power"),
    "grid_host_ms.wct": ("grid", "wct"),
    "upload_ms.wct": ("upload", "wct"),
    "ar1_host_ms.wct": ("ar1", "wct"),
    "mc_setup_ms.wct": ("mc.setup", "wct"),
    "mc_enqueue_ms.wct": ("mc.chunks", "wct"),
    "quantile_host_ms.wct": ("mc.quantile", "wct"),
    "mc_span_ms.wct": ("mc", "wct"),
}


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
def root(tiny_root):
    """The tiny root, with ``cwt_power_host_1m``'s records cut to 3,000
    samples."""
    root, here = tiny_root
    edit_json(os.path.join(here, "traffic", "power_host_1m.json"),
              {"inputs": {"n0": 3000, "records": 2}})
    return root, here


def _run(root, here, cell, seconds, trace):
    return harness.run(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def _metric(name):
    return harness.load_module("metrics", name)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_traced_run_reads_the_host_spans(root, cell):
    root, here = root
    listed = {m["name"] for m in harness.load_cell(cell, root, here).per_layer}
    assert listed & set(ALL) == set(NEW[cell])
    # correctness is test_cwtbench_run's (the 20-member cut's sig_gap can
    # pass its 300-member limit on the calls that the window samples)
    res, _ = _run(root, here, cell, 3.0, True)
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    for name in NEW[cell]:
        value = got[name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    summary = profiling.span_summary()
    top = "cwt_power" if cell == "cwt_power_host_1m" else "wct"
    calls = summary[top]["count"]
    assert calls + summary[top]["profiled"] == res["attempted"]
    for name in NEW[cell]:
        if name in SPAN_OF:
            span, call = SPAN_OF[name]
            assert call == top
            assert got[name]["value"] == pytest.approx(
                summary[span]["total_ns"] * 1e-6 / calls)
            assert got[name]["value"] < 2 * res["call_ms"]["p50"]
    if cell == "cwt_power_host_1m":
        entry = harness.make_entry(harness.load_cell(cell, root, here), SEED, "cpu")
        # the float64 record and the float32 scales, every call of the window
        assert profiling.UPLOAD_BYTES == res["attempted"] * (3000 * 8 + entry.shape["S"] * 4)
        want = (profiling.UPLOAD_BYTES / res["attempted"]) / (
            summary["upload"]["total_ns"] * 1e-9 / calls) * 1e-9
        assert got["upload_gb_s.power"]["value"] == pytest.approx(want)
    if cell == "wct_mc300":
        # the MC span holds its set-up, chunk loop and readout
        parts = sum(got[n]["value"] for n in ("mc_setup_ms.wct", "mc_enqueue_ms.wct",
                                              "quantile_host_ms.wct"))
        assert parts < got["mc_span_ms.wct"]["value"]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_an_untraced_run_reports_none_of_them(root, cell):
    root, here = root
    res, _ = _run(root, here, cell, 0.4, False)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not profiling._on and profiling.span_summary() == {}
    assert not set(res["metrics"]) & set(ALL)


@pytest.mark.parametrize("name", ALL)
def test_a_program_without_the_spans_reads_nothing(name, monkeypatch):
    """Over the parent's program (the recorder and the call spans, none of
    the new spans, no counter ``UPLOAD_BYTES``) and over one without the
    recorder, loading the metric and reading it give nothing and raise
    nothing."""
    monkeypatch.delattr(profiling, "UPLOAD_BYTES")
    mod = _metric(name)
    assert profiling._on
    assert mod.read(None) is None
    for call in ("wct", "cwt_power"):
        with profiling.span(call):
            with profiling.span("fetch"):
                pass
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert _metric(name).read(None) is None


def test_the_counter_alone_reads_no_rate(monkeypatch):
    """``upload_gb_s.power`` needs both the bytes and the span's time."""
    mod = _metric("upload_gb_s.power")
    with profiling.span("cwt_power"):
        with profiling.span("upload"):
            pass
    assert mod.read(None) is None           # no bytes counted
    profiling.UPLOAD_BYTES = 8000
    assert mod.read(None) > 0
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.UPLOAD_BYTES = 8000
    assert mod.read(None) is None           # no span timed

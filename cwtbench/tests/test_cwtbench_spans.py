"""The per-layer metrics that read the program's span recorder
(``pycwt_torch.utils.profiling``): a traced run of each coherence cell
reports every one of them that the cell lists, finite and above zero; an
untraced run never switches the recorder on; and a program without the
recorder reads nothing and raises nothing."""
import math
import time

import pytest

from conftest import REPO
from cwtbench import harness
from pycwt_torch.utils import profiling

SEED = 2 ** 31 + 977
SPAN_METRICS = ("api_host_ms.wct", "fetch_wait_ms.wct", "smooth_host_ms.wct",
                "mc_generate_ms", "mc_histogram_ms")


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


def _run(root, here, cell, seconds, trace):
    return harness.run(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


@pytest.mark.parametrize("cell", ["wct_mc300", "wct_nosig"])
def test_the_traced_run_reads_the_program_spans(tiny_root, cell):
    root, here = tiny_root
    listed = {m["name"] for m in harness.load_cell(cell, root, here).per_layer}
    ours = listed & set(SPAN_METRICS)
    assert ours == (set(SPAN_METRICS) if cell == "wct_mc300"
                    else {"api_host_ms.wct", "fetch_wait_ms.wct", "smooth_host_ms.wct"})
    # correctness is test_cwtbench_run's: at this cut (20 members) the
    # significance gap of the calls that the window happens to sample can
    # pass its limit, which is set for 300
    res, _ = _run(root, here, cell, 3.0, True)
    assert res["attempted"] > 0 and res["failed"] == 0
    for name in ours:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
        assert res["metrics"][name]["unit"] == "ms"
    # the spans split the call: no layer's host time exceeds a whole call
    p50 = res["call_ms"]["p50"]
    assert all(res["metrics"][n]["value"] < 2 * p50 for n in ours)
    summary = profiling.span_summary()
    assert summary["wct"]["count"] > 0
    assert summary["wct"]["count"] + summary["wct"]["profiled"] == res["attempted"]


@pytest.mark.parametrize("cell", ["wct_mc300", "wct_nosig"])
def test_an_untraced_run_leaves_the_recorder_off(tiny_root, cell):
    root, here = tiny_root
    res, _ = _run(root, here, cell, 0.4, False)
    assert res["correct"]
    assert not profiling._on and profiling.span_summary() == {}
    assert not set(res["metrics"]) & set(SPAN_METRICS)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    """Over a parent tree whose profiling module has no recorder, loading
    the metric and reading it give nothing and raise nothing."""
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    mod = harness.load_module("metrics", name)
    assert mod.read(None) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_run_without_wct_spans_reads_nothing(name):
    mod = harness.load_module("metrics", name)
    assert profiling._on
    assert mod.read(None) is None
    with profiling.span("smooth"):
        pass
    assert mod.read(None) is None


def test_the_span_metrics_are_named_in_the_benchmark():
    import json
    import os

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "host_clock" and m["unit"] == "ms"
        assert m["better"] == "lower" and m["workloads"]

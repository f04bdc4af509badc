"""The per-layer metric ``wct_head_kernel_pct`` in the two Monte-Carlo
cells on the CPU: both cells list it; a traced run reports it, and there it
reads 0, since the CPU makes every coherence field by the torch head (the
head kernel runs on the card only); an untraced run leaves it out; and a
program without the point counters reads nothing and raises nothing."""
import os
import time

import pytest

from conftest import edit_json
from cwtbench import harness
from pycwt_torch.utils import profiling

SEED = 2 ** 31 + 2207
METRIC = "wct_head_kernel_pct"
CELLS = ("wct_mc300", "wct_matrix_mc_32st")
COUNTERS = ("WCT_HEAD_KERNEL_POINTS", "WCT_HEAD_PLAIN_POINTS")


@pytest.fixture(autouse=True)
def recorder_off():
    """Loading a counter metric switches the recorder on: each test starts
    and ends with it off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


@pytest.fixture
def mc_root(tiny_root):
    """The matrix cell cut as in ``test_cwtbench_matrix_mc``: networks of 6
    stations of 256 samples, 24 members a null."""
    root, here = tiny_root
    edit_json(os.path.join(here, "traffic", "network32_mc300.json"),
              {"inputs": {"networks": 2, "stations": 6, "n0": 256, "g": [0.45, 0.6]}})
    edit_json(os.path.join(here, "configs", "grinsted04_network32_mc300.json"),
              {"mc_count": 24})
    return root, here


def _run(root, here, cell, seconds, trace):
    return harness.run(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_both_mc_cells_list_the_metric(mc_root):
    root, here = mc_root
    for cell in CELLS:
        metric = {m["name"]: m for m in harness.load_cell(cell, root, here).per_layer}[METRIC]
        assert (metric["unit"], metric["better"], metric["moves"], metric["layer"]) == (
            "%", "higher", "analyses_per_s", "WCT core, routing")


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reads_no_kernel_points(mc_root, cell):
    root, here = mc_root
    res, _ = _run(root, here, cell, 1.0, True)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"][METRIC]["value"] == 0
    assert res["metrics"][METRIC]["unit"] == "%"
    assert profiling.WCT_HEAD_PLAIN_POINTS > 0 == profiling.WCT_HEAD_KERNEL_POINTS


def test_an_untraced_run_leaves_the_metric_out(mc_root):
    root, here = mc_root
    res, _ = _run(root, here, "wct_mc300", 0.4, False)
    assert res["correct"] and METRIC not in res["metrics"]


def test_the_reader_reads_the_counters(monkeypatch):
    """Nothing before a point is counted, 100 with kernel points only, then
    100·kernel / (kernel + plain); over a program without the counters, or
    without the recorder, nothing, and no error."""
    mod = harness.load_module("metrics", METRIC)
    assert profiling._on and mod.read(None) is None
    profiling.WCT_HEAD_KERNEL_POINTS = 300
    assert mod.read(None) == 100.0
    profiling.WCT_HEAD_PLAIN_POINTS = 100
    assert mod.read(None) == 75.0
    for attr in COUNTERS:
        monkeypatch.delattr(profiling, attr)
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert harness.load_module("metrics", METRIC).read(None) is None

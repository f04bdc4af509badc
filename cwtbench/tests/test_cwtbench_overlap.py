"""The cell ``overlap_16m`` on the CPU, cut to pairs of 2^16 samples of 16
scales in chunks of 2^13: whole runs come out correct; the controls and
each fault the cell can have come out not correct; a traced run reads the
program's counter and span metrics; the kept calls are drawn from the
seed; the inputs are seeded and their recursion is the AR(1) loop's."""
import math
import os
import time

import numpy as np
import pytest
import torch

from conftest import edit_json
from cwtbench import harness
from pycwt_torch.utils import profiling

CELL = "overlap_16m"
SEED = 2 ** 31 + 1613
CHUNK = 1 << 13
SPAN_METRICS = ("overlap_interior_pct", "chunk_enqueue_ms.overlap")
DEVICE_METRICS = ("device_idle_pct.overlap", "overlap_roofline_pct")


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
def overlap_root(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "configs", "gwosc_4096s_wct_overlap.json"),
              {"J": 15, "chunk": CHUNK})
    edit_json(os.path.join(here, "traffic", "pair_16m.json"),
              {"inputs": {"n0": 1 << 16}})
    return root, here


def _run(root, here, seconds=1.0, trace=False):
    return harness.run(CELL, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_the_cell_is_correct_on_the_cpu(overlap_root):
    root, here = overlap_root
    res, checks = _run(root, here)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == {"wct_gap", "phase_gap"}
    assert set(res["metrics"]) == {"setup_s", "analyses_per_s", "analysis_p95_ms"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("control", ["fast", "tf32"])
def test_the_controls_fail(overlap_root, control):
    """The program at its bf16-T tier (the cell's control) and the reference
    computed in TF32 in the program's place each read above a limit."""
    from cwtbench.control import readings

    root, here = overlap_root
    c = harness.load_cell(CELL, root, here)
    if control == "fast":
        row = readings(c, SEED, 0.3, True, "cpu")
    else:
        entry = harness.make_entry(c, SEED, "cpu")
        entry.keep(0, entry.call(0))
        row = entry.compare(control="tf32")
    assert any(row[k] > lim for k, lim in c.spec["limits"].items()), row


def _scale_a_row(out):
    WCT, A = out
    WCT = WCT.clone()
    WCT[int(WCT.amax(dim=1).argmax())] *= 1 + 1e-3
    return WCT, A


def _shift_a_chunk(out):
    """The second chunk's interior one sample late."""
    return tuple(torch.cat([m[:, :CHUNK], m[:, CHUNK - 1:2 * CHUNK - 1], m[:, 2 * CHUNK:]],
                           dim=1) for m in out)


def _negate_the_phase(out):
    WCT, A = out
    return WCT, -A


def _drop_a_sample(out):
    return tuple(m[:, :-1] for m in out)


@pytest.mark.parametrize("fault", [_scale_a_row, _shift_a_chunk, _negate_the_phase,
                                   _drop_a_sample], ids=lambda f: f.__name__.strip("_"))
def test_a_fault_fails(overlap_root, monkeypatch, fault):
    from pycwt_torch.ops import overlap

    root, here = overlap_root
    c = harness.load_cell(CELL, root, here)
    entry = harness.make_entry(c, SEED, "cpu")
    inner = overlap.wct_overlap_planar
    monkeypatch.setattr(overlap, "wct_overlap_planar",
                        lambda *a, **kw: fault(inner(*a, **kw)))
    for i in range(3):
        entry.keep(i, entry.call(i))
    gaps = entry.compare()
    assert any(gaps[k] > lim for k, lim in c.spec["limits"].items()), gaps


def test_the_traced_run_reads_the_new_metrics(overlap_root):
    root, here = overlap_root
    listed = {m["name"] for m in harness.load_cell(CELL, root, here).per_layer}
    assert listed == set(SPAN_METRICS) | set(DEVICE_METRICS)
    res, checks = _run(root, here, seconds=2.0, trace=True)
    assert res["correct"], checks
    # chunk 2^13 + 2 halos of 84 samples is transformed at 2^14
    assert res["metrics"]["overlap_interior_pct"]["value"] == 50.0
    enqueue = res["metrics"]["chunk_enqueue_ms.overlap"]["value"]
    assert math.isfinite(enqueue) and 0 < enqueue < 2 * res["call_ms"]["p50"]
    # the CPU has no device timeline: nothing to read there
    assert set(res["metrics"]) == set(SPAN_METRICS)
    summary = profiling.span_summary()
    calls = summary["wct_overlap"]["count"] + summary["wct_overlap"]["profiled"]
    assert calls == res["attempted"] and profiling.OVERLAP_CHUNKS == 8 * calls


def test_the_kept_calls_are_drawn_from_the_seed(overlap_root):
    """The first call, one drawn from the seed among calls 1-7, and the
    last one."""
    root, here = overlap_root
    c = harness.load_cell(CELL, root, here)
    kept = []
    for seed in (SEED, SEED, SEED + 1, SEED + 2, SEED + 3):
        entry = harness.make_entry(c, seed, "cpu")
        for i in range(20):
            entry.keep(i, None)
        kept.append(sorted(entry.kept))
    assert kept[0] == kept[1] and len({tuple(k) for k in kept}) > 1
    for k in kept:
        assert len(k) == 3 and k[0] == 0 and 0 < k[1] < 8 and k[2] == 19


def test_long_pairs_are_seeded_and_their_recursion_is_the_loops():
    make = harness.load_module("inputs", "long_pairs").make
    params = {"pairs": 2, "n0": 3000, "g": [0.4, 0.8], "burn_in": 256, "share": 0.5}
    a, b, other = (make(params, s, "cpu") for s in (SEED, SEED, SEED + 1))
    for k in ("y1", "y2"):
        assert a[k].dtype == np.float64 and a[k].shape == (2, 3000)
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], other[k])
    # the same draws, the recursion as a loop: y2 - 0.5 y1 = e2 - 0.5 e1
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    kw = dict(generator=gen, dtype=torch.float64)
    g = (0.4 + 0.4 * torch.rand(2, **kw)).numpy()
    z = torch.randn((2, 3256), **kw).numpy()
    e = torch.randn((2, 2, 3000), **kw).numpy()
    c = np.empty_like(z)
    c[:, 0] = z[:, 0]
    for t in range(1, z.shape[1]):
        c[:, t] = g * c[:, t - 1] + z[:, t]
    # lfilter sums in another order than the loop: float64 round-off
    np.testing.assert_allclose(a["y1"], c[:, 256:] + e[:, 0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(a["y2"], 0.5 * c[:, 256:] + e[:, 1], rtol=0, atol=1e-12)

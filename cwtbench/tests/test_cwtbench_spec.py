"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""
import json
import os
import re

import pytest

from conftest import REPO, edit_json
from cwtbench import harness

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cwtbench"]
    assert BENCH["command"] == ["python3", "cwtbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_texts():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.match(entry["why"]), entry["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"])


def test_cells_one_chip_and_metrics_cover_them():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert TEXT.match(m["layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in cells:
        reports = [n for n, m in e2e.items() if cell in m.get("workloads", [cell])]
        assert "setup_s" in reports and len(reports) >= 2, cell
        layers = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers, cell
        for m in layers:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_name_is_found(cell):
    c = harness.load_cell(cell, REPO)
    assert c.chips == 1
    harness.load_module("inputs", c.traffic["inputs"]["kind"])
    harness.load_module("entries", c.traffic["entry"])
    for m in c.end_to_end:
        assert callable(harness.load_module("e2e", m["name"]).value)
    for m in c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(c.spec["limits"]) and all(v > 0 for v in c.spec["limits"].values())
    assert c.spec["precision"] == c.config["precision"]


def test_config_files_state_their_settings():
    for c in BENCH["configs"]:
        path = os.path.join(REPO, c["file"])
        assert c["file"].startswith("cwtbench/configs/")
        with open(path) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert os.path.isfile(os.path.join(REPO, "cwtbench", data["reference"]))


def test_new_files_are_picked_up_without_edits(tiny_root):
    """A cell, a configuration, a traffic mix and a per-layer metric added as
    files (and named in BENCHMARK.json) run with no other file changed."""
    root, here = tiny_root
    before = {}
    for d, _, files in os.walk(here):
        for fn in files:
            with open(os.path.join(d, fn), "rb") as f:
                before[os.path.join(d, fn)] = f.read()
    with open(os.path.join(here, "configs", "tc98_morlet6_long.json")) as f:
        conf = json.load(f)
    conf.update(name="tc98_morlet6_short", J=3)
    with open(os.path.join(here, "configs", "tc98_morlet6_short.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(here, "traffic", "gws_2k.json"), "w") as f:
        json.dump({"entry": "power_sum",
                   "inputs": {"kind": "normal_records", "records": 2, "n0": 2048}}, f)
    with open(os.path.join(here, "cells", "cwt_gws_2k.json"), "w") as f:
        json.dump({"config": "tc98_morlet6_short", "traffic": "gws_2k",
                   "precision": "high", "control": {"precision": "fast"},
                   "limits": {"power_gap": 1e-4}}, f)
    with open(os.path.join(here, "metrics", "calls_traced.py"), "w") as f:
        f.write("def read(trace):\n    return trace.calls or None\n")
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tc98_morlet6_short", "source": "test",
                             "file": "cwtbench/configs/tc98_morlet6_short.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "cwt_gws_2k", "config": "tc98_morlet6_short",
                               "traffic": "gws_2k", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "cwt_rate":
            m["workloads"].append("cwt_gws_2k")
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "Device", "moves": "cwt_rate",
                               "workloads": ["cwt_gws_2k"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    import time

    res, checks = harness.run("cwt_gws_2k", 7, 0.3, False, t_start=time.perf_counter(),
                              device="cpu", root=root, here=here)
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "cwt_rate"}
    assert set(checks) == {"power_gap"}
    res, _ = harness.run("cwt_gws_2k", 7, 0.5, True, t_start=time.perf_counter(),
                         device="cpu", root=root, here=here)
    assert res["correct"] and res["metrics"]["calls_traced"]["value"] >= 1
    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path


def test_cell_must_agree_with_benchmark(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "cells", "cwt_gws_1m.json"), {"traffic": "w_4m"})
    with pytest.raises(harness.BenchError):
        harness.load_cell("cwt_gws_1m", root, here)
    with pytest.raises(harness.BenchError):
        harness.load_cell("no_such_cell", root, here)

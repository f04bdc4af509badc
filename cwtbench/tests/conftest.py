"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
folder and ``BENCHMARK.json`` in a temporary root, cut to a size that a
test run holds (few scales, short records, a small Monte-Carlo null), for
driving whole runs of each cell on the CPU.

Run them with ``python -m pytest cwtbench/tests -q`` from the repo root."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: file -> {key: value} of the cut; a dict value updates a nested dict
TINY = {
    "configs/tc98_morlet6_long.json": {"J": 7},
    "configs/grinsted04_wct_ar1.json": {"mc_count": 20},
    "traffic/gws_1m.json": {"inputs": {"n0": 4096, "records": 3}},
    "traffic/w_4m.json": {"inputs": {"n0": 4096, "records": 2}},
    "traffic/pairs_mc300.json": {"inputs": {"pairs": 3}},
    "traffic/pairs_nosig.json": {"inputs": {"pairs": 3}},
}


def edit_json(path: str, changes: dict) -> None:
    with open(path) as f:
        data = json.load(f)
    for k, v in changes.items():
        if isinstance(v, dict) and isinstance(data.get(k), dict):
            data[k].update(v)
        else:
            data[k] = v
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """(root, here): a temporary checkout root holding BENCHMARK.json and a
    copy of the benchmark folder cut to ``TINY``.  The program's engine is
    set to the card's default, ``planar``, so that the CPU runs the kernels'
    plain versions on the card's route, tiers and all."""
    monkeypatch.setenv("PYCWT_TPU_ENGINE", "planar")
    root = str(tmp_path)
    here = os.path.join(root, "cwtbench")
    shutil.copytree(os.path.join(REPO, "cwtbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for rel, changes in TINY.items():
        edit_json(os.path.join(here, rel), changes)
    return root, here

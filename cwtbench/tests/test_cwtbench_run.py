"""Whole runs of each cell on the CPU at a size a test run holds: without a
card the command refuses; with the program on the CPU each cell comes out
correct; its control, and each fault the cell can have, come out not
correct; and no module of JAX or of the JAX package may be loaded."""
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import REPO
from cwtbench import harness

CELLS = ("cwt_gws_1m", "wct_mc300", "cwt_w_4m", "wct_nosig")
SEED = 2 ** 31 + 977


def _run(root, here, cell, seconds=0.4, trace=False):
    return harness.run(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


def test_without_a_card_it_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "cwtbench/run.py", "--workload", "cwt_gws_1m",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


def test_without_the_program_it_refuses(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(os.path.join(REPO, "cwtbench"), tmp_path / "cwtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "cwtbench/run.py", "--workload", "wct_nosig",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_on_the_cpu(tiny_root, cell):
    root, here = tiny_root
    res, checks = _run(root, here, cell)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == set(harness.load_cell(cell, root, here).spec["limits"])
    e2e = {m["name"] for m in harness.load_cell(cell, root, here).end_to_end}
    assert set(res["metrics"]) == e2e
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny_root, cell):
    """The control in the program's place (the lower tier, or the reference
    in TF32) reads above at least one limit."""
    from cwtbench.control import readings

    root, here = tiny_root
    c = harness.load_cell(cell, root, here)
    row = readings(c, SEED, 0.3, True, "cpu")
    assert any(row[k] > lim for k, lim in c.spec["limits"].items()), row


def _alter(module, attr, how):
    inner = getattr(module, attr)

    def wrapped(*a, **kw):
        return how(inner(*a, **kw))

    return inner, wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_produced_fails(tiny_root, cell, monkeypatch):
    """One value of each call's answer off by 1e-3 of the largest."""
    root, here = tiny_root
    if cell.startswith("cwt"):
        from pycwt_torch.ops import fused_cwt

        def bump(out):
            out = tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()
            first = out[0] if isinstance(out, tuple) else out
            first.view(-1)[3] += 1e-3 * first.abs().max()
            return out

        # cwt_batch imports fused_cwt, which calls fused_cwt_planar
        inner, wrapped = _alter(fused_cwt, "fused_cwt_planar", bump)
        monkeypatch.setattr(fused_cwt, "fused_cwt_planar", wrapped)
    else:
        from pycwt_torch import coherence

        def bump(out):
            w, *rest = out
            w = w.copy()
            w.flat[5] += 1e-3
            return (w, *rest)

        inner, wrapped = _alter(coherence, "wct", bump)
        monkeypatch.setattr(coherence, "wct", wrapped)
    res, checks = _run(root, here, cell)
    assert not res["correct"], checks


def test_half_the_members_left_out_fails(tiny_root, monkeypatch):
    """The Monte-Carlo histogram over half of each chunk's members, doubled:
    the mean taken over the rest."""
    from pycwt_torch import coherence

    inner = coherence._histogram

    def half(R2, outsidecoi, valid=None, nbins=coherence.NBINS):
        keep = R2[..., : R2.shape[-3] // 2, :, :]
        return 2 * inner(keep, outsidecoi, None if valid is None
                         else valid[: R2.shape[-3] // 2], nbins)

    monkeypatch.setattr(coherence, "_histogram", half)
    root, here = tiny_root
    res, checks = _run(root, here, "wct_mc300")
    assert not res["correct"] and checks["sig_gap"][0] > checks["sig_gap"][1], checks


def test_a_failing_call_fails(tiny_root, monkeypatch):
    """A call that raises inside the window (after the two warm-up calls)."""
    from pycwt_torch.ops import fused_cwt

    inner, calls = fused_cwt.fused_cwt_planar, []

    def broken(*a, **kw):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("broken")
        return inner(*a, **kw)

    monkeypatch.setattr(fused_cwt, "fused_cwt_planar", broken)
    root, here = tiny_root
    res, _ = _run(root, here, "cwt_gws_1m")
    assert not res["correct"] and res["failed"] == 1


def test_the_traced_run_reads_spans(tiny_root):
    root, here = tiny_root
    res, _ = _run(root, here, "wct_mc300", seconds=3.0, trace=True)
    assert res["correct"]
    assert res["metrics"]["mc_ms_per_call"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", ["wct_mc300", "wct_nosig"])
def test_the_kept_sample_is_drawn_from_the_seed(tiny_root, cell):
    """The coherence cells keep the first call's answer and about one in
    ``kept_every`` of the others, the same calls for the same seed."""
    root, here = tiny_root
    c = harness.load_cell(cell, root, here)
    every = c.spec["check"]["kept_every"]
    kept = []
    for seed in (SEED, SEED, SEED + 1):
        entry = harness.make_entry(c, seed, "cpu")
        for i in range(70000):
            entry.keep(i, (None,) * 5)
        kept.append([k[0] for k in entry.kept])
    assert kept[0] == kept[1] != kept[2]
    assert kept[0][0] == 0 and 0.9 < len(kept[0]) * every / 70000 < 1.1


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    monkeypatch.setitem(sys.modules, "pycwt_tpux", types.ModuleType("pycwt_tpux"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pycwt_tpu.ops", types.ModuleType("pycwt_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "pycwt_tpu"]

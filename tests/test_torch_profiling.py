"""The port's profiling and build-cache utilities on the CPU
(pycwt_torch/utils/profiling.py, utils.enable_compilation_cache): the trace
context, the phase timer's report against pycwt_tpu's on the same phases,
and the build directory the nvcc cache moves (no nvcc needed)."""
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.ops import _build
from pycwt_torch.utils import enable_compilation_cache, get_cache_dir
from pycwt_torch.utils import profiling as tprof
from pycwt_tpu.utils import profiling as jprof

torch.set_num_threads(2)


def _small_cwt():
    y = np.random.default_rng(0).standard_normal(256)
    return pt.cwt(y, 1.0, dj=0.5, device="cpu")


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tprof.trace(None):
        W, *_ = _small_cwt()
    assert W.shape[1] == 256
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with tprof.trace(str(log_dir)):
        _small_cwt()
    files = glob.glob(str(log_dir / "pycwt_torch.*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("fft" in n for n in names), sorted(names)[:20]


def test_trace_records_the_card_before_cuda_is_initialized(tmp_path, monkeypatch):
    """With a card present but no CUDA call made yet (the first transform
    of a fresh process), the trace still asks the profiler for the card's
    activity."""
    import torch.profiler as tp

    asked = []

    class Profile:
        def __init__(self, activities):
            asked.extend(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            open(path, "w").close()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(tp, "profile", Profile)
    with tprof.trace(str(tmp_path)):
        pass
    assert tp.ProfilerActivity.CUDA in asked and tp.ProfilerActivity.CPU in asked
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1


def test_trace_exports_nothing_when_the_region_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with tprof.trace(str(tmp_path)):
            1 / 0
    assert glob.glob(str(tmp_path / "*.json")) == []


def test_phase_timer_reports_pycwt_tpu_shape():
    """The same phases through both timers give the same keys per phase;
    seconds and sample-scales accumulate across entries of one phase."""
    reports = []
    for timer in (tprof.PhaseTimer(), jprof.PhaseTimer()):
        for _ in range(2):
            with timer.phase("cwt", samples=256, scales=9):
                _small_cwt()
        with timer.phase("host"):
            np.ones(10).sum()
        reports.append(timer.report())
    ours, theirs = reports
    assert {k: set(v) for k, v in ours.items()} == {k: set(v) for k, v in theirs.items()}
    assert set(ours["cwt"]) == {"seconds", "sample_scales_per_s"}
    assert set(ours["host"]) == {"seconds"}
    assert ours["cwt"]["sample_scales_per_s"] == pytest.approx(
        2 * 256 * 9 / ours["cwt"]["seconds"])


def test_phase_timer_counts_a_phase_that_raises():
    timer = tprof.PhaseTimer()
    with pytest.raises(RuntimeError):
        with timer.phase("bad", samples=4, scales=2):
            raise RuntimeError("boom")
    assert timer.phases["bad"]["sample_scales"] == 8
    assert timer.report()["bad"]["seconds"] >= 0


def test_phase_timer_log_and_log_sharding(caplog):
    timer = tprof.PhaseTimer()
    with timer.phase("cwt", samples=256, scales=9):
        _small_cwt()
    with caplog.at_level(logging.INFO, logger="pycwt_torch"):
        timer.log()
        tprof.log_sharding("W", torch.zeros(3, 4, dtype=torch.float64))
        tprof.log_sharding("host", np.zeros((2, 2)))
    text = caplog.text
    assert "sample-scales/s" in text
    assert "W: shape=(3, 4) dtype=torch.float64 device=cpu" in text
    assert "host: shape=(2, 2)" in text
    assert tprof.logger.name == "pycwt_torch"


@pytest.fixture
def build_dir(monkeypatch):
    """Restore the build directory after a test moves it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


def test_enable_compilation_cache_moves_the_build_target(tmp_path, build_dir):
    default = _build.BUILD_DIR
    assert os.path.dirname(_build._target("fused_cwt")) == default
    path = str(tmp_path / "cuda" / "cache")
    assert enable_compilation_cache(path) == path
    assert os.path.isdir(path)
    for name in _build.SOURCES:
        target = _build._target(name)
        assert os.path.dirname(target) == path
        assert os.path.basename(target).startswith(name + "-")
    # idempotent: a second call keeps the directory and the targets
    before = {name: _build._target(name) for name in _build.SOURCES}
    assert enable_compilation_cache(path) == path
    assert {name: _build._target(name) for name in _build.SOURCES} == before


def test_enable_compilation_cache_default_under_cache_dir(tmp_path, monkeypatch,
                                                          build_dir):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    path = enable_compilation_cache()
    assert path == os.path.join(get_cache_dir(), "cuda_build")
    assert os.path.isdir(path)
    assert os.path.dirname(_build._target("direct_cwt")) == os.path.abspath(path)


def test_build_all_finds_a_library_in_the_cache_without_nvcc(tmp_path, monkeypatch,
                                                            build_dir):
    """A library already in the cache directory is used as it is: build_all
    starts no compiler for it."""
    enable_compilation_cache(str(tmp_path))
    for name in _build.SOURCES:
        open(_build._target(name), "wb").close()

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc started for a cached library")

    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    paths = _build.build_all()
    assert set(paths) == set(_build.SOURCES)
    assert all(os.path.dirname(p) == str(tmp_path) for p in paths.values())

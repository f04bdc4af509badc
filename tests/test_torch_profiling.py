"""The port's profiling and build-cache utilities on the CPU
(pycwt_torch/utils/profiling.py, utils.enable_compilation_cache): the trace
context, the phase timer's report against pycwt_tpu's on the same phases,
the build directory the nvcc cache moves (no nvcc needed), and the span
recorder: off, on, under ``torch.profiler``, through an exception, in a
``wct(sig=True)`` call on both CPU routes."""
import contextlib
import glob
import json
import logging
import os
import sys

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


# --------------------------------------------------------------------------
# The span recorder
# --------------------------------------------------------------------------

#: mc_count 6 in chunks of 4: two chunks, each two generator calls, one
#: histogram and one WCT core, beside the pair's own core; one grid, the
#: pair's upload and the MC grid's, one span around both AR(1) fits, and
#: the MC call's set-up, chunk loop and quantile readout once each
MC = dict(mc_count=6, mc_batch=4, cache=False, progress=False, seed=3)
#: spans a wct(sig=True) call takes on each CPU route: the default ("xla")
#: runs cwt_batch and three smoothings a core; "planar" the f64 spectrum,
#: the kernels' wrapper (their plain version here) and two smoothings
ROUTES = {
    "xla": {"cwt_batch": 6, "smooth": 9},
    "planar": {"spectrum": 6, "fused_cwt": 6, "smooth": 6},
}
COMMON = {"wct": 1, "fetch": 3, "wct.core": 3, "mc": 1, "mc.generate": 4,
          "mc.histogram": 2, "grid": 1, "upload": 2, "ar1": 1, "mc.setup": 1,
          "mc.chunks": 1, "mc.quantile": 1, "coi": 1}
#: (span, the span directly around it), on both routes and on each alone
PARENTS = [("wct.core", "wct"), ("mc", "wct"), ("fetch", "wct"),
           ("grid", "wct"), ("upload", "wct"), ("ar1", "wct"), ("coi", "wct"),
           ("mc.setup", "mc"), ("upload", "mc.setup"), ("mc.chunks", "mc"),
           ("mc.generate", "mc.chunks"), ("mc.histogram", "mc.chunks"),
           ("wct.core", "mc.chunks"), ("fetch", "mc"), ("mc.quantile", "mc"),
           ("smooth", "wct.core")]
ROUTE_PARENTS = {"xla": [("cwt_batch", "wct.core")],
                 "planar": [("spectrum", "wct.core"), ("fused_cwt", "wct.core")]}


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    tprof.disable_spans()
    tprof.enable_spans()
    tprof.disable_spans()
    yield
    tprof.disable_spans()
    tprof.enable_spans()
    tprof.disable_spans()


def _wct(route):
    from pycwt_torch.config import CWTConfig

    rng = np.random.default_rng(5)
    y1, y2 = rng.standard_normal((2, 147))
    return pt.wct(y1, y2, 0.25, config=CWTConfig(engine=route), device="cpu", **MC)


def _no_record_function(monkeypatch):
    import torch.autograd.profiler as ap
    import torch.profiler as tp

    def refuse(*a, **k):
        raise AssertionError("record_function called")

    for mod in (tprof, ap, tp):
        monkeypatch.setattr(mod, "record_function", refuse)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_off_record_nothing(route, monkeypatch):
    """Off, a wct call leaves no aggregate and opens no record_function,
    and gives the same answer as with the recorder on."""
    _no_record_function(monkeypatch)
    off = _wct(route)
    assert tprof.span_summary() == {} and not tprof._on and tprof._stack == []
    monkeypatch.undo()
    tprof.enable_spans()
    on = _wct(route)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["decorator", "context"])
def test_a_span_off_calls_no_generator(form):
    """Off, a span runs its wrapper, or its __enter__ and __exit__, and no
    other function of the module, and no generator."""
    body = tprof.span("x")(lambda: None) if form == "decorator" else None
    seen = []

    def watch(frame, event, arg):
        if event == "call":
            seen.append(frame.f_code)

    sys.setprofile(watch)
    try:
        if body is not None:
            body()
        else:
            with tprof.span("x"):
                pass
    finally:
        sys.setprofile(None)
    ours = {c.co_name for c in seen if c.co_filename == tprof.__file__}
    assert ours == ({"spanned"} if form == "decorator" else
                    {"__init__", "__enter__", "__exit__"})
    assert not any(c.co_flags & 0x20 for c in seen)     # CO_GENERATOR


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_on_count_every_layer(route):
    """On, each span of the call is counted as often as it runs; each
    name's self time is its total less its children's, so the self times of
    every name add up to the outermost span's total."""
    tprof.enable_spans()
    _wct(route)
    got = tprof.span_summary()
    assert {k: v["count"] for k, v in got.items()} == {**COMMON, **ROUTES[route]}
    assert all(v["profiled"] == 0 for v in got.values())
    assert all(0 <= v["self_ns"] <= v["total_ns"] for v in got.values())
    assert sum(v["self_ns"] for v in got.values()) == got["wct"]["total_ns"]
    assert got["mc"]["total_ns"] < got["wct"]["total_ns"]
    assert tprof._stack == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_under_the_profiler(route):
    """Under torch.profiler each span is a user annotation nested in the
    span around it (``cpu_parent``), counted apart from the host
    aggregates, which it leaves empty."""
    from torch.profiler import ProfilerActivity, profile

    tprof.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _wct(route)
    got = tprof.span_summary()
    assert {k: v["profiled"] for k, v in got.items()} == {**COMMON, **ROUTES[route]}
    assert all(v["count"] == v["total_ns"] == v["self_ns"] == 0 for v in got.values())
    names = set(COMMON) | set(ROUTES[route])
    pairs = set()
    for e in prof.events():
        if e.name in names:
            assert e.is_user_annotation, e.name
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            pairs.add((e.name, parent))
    assert set(PARENTS + ROUTE_PARENTS[route]) <= pairs
    assert ("wct", None) in pairs


@pytest.mark.parametrize("form", ["decorator", "context"])
@pytest.mark.parametrize("profiled", [False, True])
def test_a_raising_span_closes(form, profiled):
    """A span that raises still closes: the stack is empty afterwards and
    the span and its parent are counted."""
    from torch.profiler import ProfilerActivity, profile

    def fail():
        raise KeyError("inner")

    inner = tprof.span("inner")(fail)
    tprof.enable_spans()
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()):
        with pytest.raises(KeyError):
            with tprof.span("outer"):
                if form == "decorator":
                    inner()
                else:
                    with tprof.span("inner"):
                        fail()
    assert tprof._stack == []
    key = "profiled" if profiled else "count"
    got = tprof.span_summary()
    assert got["outer"][key] == got["inner"][key] == 1


def test_enable_spans_is_idempotent():
    """A second enable_spans while on keeps the aggregates; after
    disable_spans they stay readable, and the next enable_spans clears
    them."""
    tprof.enable_spans()
    with tprof.span("a"):
        pass
    tprof.enable_spans()
    with tprof.span("a"):
        pass
    assert tprof.span_summary()["a"]["count"] == 2
    tprof.disable_spans()
    with tprof.span("a"):
        pass
    assert tprof.span_summary()["a"]["count"] == 2
    tprof.enable_spans()
    assert tprof.span_summary() == {}


def test_switching_inside_an_open_span():
    """A span opened before enable_spans and closed after it records
    nothing and disturbs nothing; one open across disable_spans is dropped
    at the next enable_spans."""
    with tprof.span("before"):
        tprof.enable_spans()
        with tprof.span("inside"):
            pass
    assert set(tprof.span_summary()) == {"inside"} and tprof._stack == []
    with tprof.span("across"):
        tprof.disable_spans()
    tprof.enable_spans()
    assert tprof._stack == [] and tprof.span_summary() == {}


def test_trace_shows_the_spans(tmp_path):
    """profiling.trace writes the spans into its Chrome trace with the
    recorder off, and leaves the recorder off."""
    with tprof.trace(str(tmp_path)):
        _wct("planar")
    assert not tprof._on
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert set(COMMON) | set(ROUTES["planar"]) <= names


@pytest.mark.parametrize("on", [False, True])
def test_the_planar_warning_names_the_caller(on):
    """The planar route's f64 warning points at the caller of _wct_core,
    recorder on or off: its span is a block, which adds no frame."""
    import warnings

    from pycwt_torch.coherence import _wct_core

    if on:
        tprof.enable_spans()
    y = torch.as_tensor(np.random.default_rng(1).standard_normal((1, 64)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _wct_core(y, y, torch.tensor([1.0, 2.0], dtype=torch.float64), 1.0,
                  mother=pt.Morlet(6), nfft=256, dj=0.25, engine="planar")
    (w,) = [w for w in caught if "computes in float32" in str(w.message)]
    assert w.filename == __file__

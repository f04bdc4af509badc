"""The spans that name the host work inside the API and Monte-Carlo spans
(``grid``, ``upload``, ``ar1``, ``mc.setup``, ``mc.chunks``,
``mc.quantile``) and the counter ``profiling.UPLOAD_BYTES``: each span's
count a call and the span directly around it, on ``wct`` (both CPU routes,
with and without the Monte-Carlo null), ``cwt_power`` (both routes),
``wct_matrix_analysis`` and ``wct_significance(checkpoint=...)``; the API
spans' self time as their total less their children's; the bytes the
uploads copy; and the answers, bit for bit the same with the recorder off,
on and under ``torch.profiler``.  The card twin is
``test_torch_host_spans_cuda.py``."""
import collections

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.config import CWTConfig
from pycwt_torch.transform import _host_grid
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

ROUTES = ("planar", "xla")
NEW = ("grid", "upload", "ar1", "mc.setup", "mc.chunks", "mc.quantile")
#: the spans whose parents are checked: the new ones and those around them
NAMED = NEW + ("wct", "cwt_power", "wct_matrix", "wct_matrix_analysis", "mc",
               "mc.batch", "mc.readout", "mc.generate", "mc.histogram",
               "wct.core", "fetch")
#: mc_count 6 in chunks of 4: two chunks of the single-pair null
MC = dict(mc_count=6, mc_batch=4, cache=False, progress=False, seed=3)
#: the single-pair null's grid (dt 1, dj 1/4, s0 2, J 7)
SMALL = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, progress=False, device="cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _pair(n=147, seed=5):
    return np.random.default_rng(seed).standard_normal((2, n))


def _stations(b=5, n=128, seed=11):
    """``b`` AR(1) rows of ``n`` samples with g between 0.3 and 0.7."""
    rng = np.random.default_rng(seed)
    g = np.linspace(0.3, 0.7, b)
    e = rng.standard_normal((b, n + 64))
    y = np.zeros_like(e)
    for t in range(1, e.shape[1]):
        y[:, t] = g * y[:, t - 1] + e[:, t]
    return y[:, 64:]


def _wct(route, sig):
    y1, y2 = _pair()
    return pt.wct(y1, y2, 0.25, sig=sig, config=CWTConfig(engine=route),
                  device="cpu", **MC)


def _power(route):
    x = np.random.default_rng(7).standard_normal(3000)
    return pt.cwt_power(x, 1.0, config=CWTConfig(engine=route), device="cpu")


def _matrix():
    return wct_matrix_analysis(_stations(), 0.25, dj=1 / 12, mc_count=6, seed=9,
                               cache=False, device="cpu")


def _tree(fn):
    """(result, Counter of (span, the span directly around it)) of one call
    under ``torch.profiler``, where every span is a user annotation."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    profiling.disable_spans()
    pairs = collections.Counter()
    for e in prof.events():
        if e.name in NAMED:
            assert e.is_user_annotation, e.name
            parent = e.cpu_parent.name if e.cpu_parent is not None else None
            pairs[(e.name, parent)] += 1
    return out, pairs


def _under(pairs, parent):
    return {name: n for (name, p), n in pairs.items() if p == parent}


def _direct_self(got, name, children):
    return got[name]["total_ns"] - sum(got[c]["total_ns"] for c in children)


@pytest.mark.parametrize("route", ROUTES)
def test_wct_without_the_null_spans_its_grid_and_upload(route):
    _, pairs = _tree(lambda: _wct(route, sig=False))
    assert _under(pairs, "wct") == {"grid": 1, "upload": 1, "wct.core": 1, "fetch": 2}
    assert not {name for name, _ in pairs} & {"ar1", "mc", "mc.setup", "mc.chunks",
                                              "mc.quantile"}
    profiling.enable_spans()
    for _ in range(2):
        _wct(route, sig=False)
    got = profiling.span_summary()
    assert {k: got[k]["count"] for k in ("wct", "grid", "upload")} == \
        {"wct": 2, "grid": 2, "upload": 2}
    row = got["wct"]
    assert row["self_ns"] == _direct_self(got, "wct", ("grid", "upload", "wct.core",
                                                       "fetch", "coi"))
    assert 0 < row["self_ns"] < row["total_ns"]


@pytest.mark.parametrize("route", ROUTES)
def test_wct_with_the_null_spans_each_part(route):
    _, pairs = _tree(lambda: _wct(route, sig=True))
    assert _under(pairs, "wct") == {"grid": 1, "upload": 1, "wct.core": 1, "ar1": 1,
                                    "mc": 1, "fetch": 2}
    assert _under(pairs, "mc") == {"mc.setup": 1, "mc.chunks": 1, "fetch": 1,
                                   "mc.quantile": 1}
    assert _under(pairs, "mc.setup") == {"upload": 1}
    under = _under(pairs, "mc.chunks")
    assert under["mc.generate"] == 4 and under["mc.histogram"] == 2
    assert under["wct.core"] == 2
    assert _under(pairs, "mc.quantile") == {}


@pytest.mark.parametrize("route", ROUTES)
def test_cwt_power_spans_its_grid_and_upload(route):
    _, pairs = _tree(lambda: _power(route))
    under = _under(pairs, "cwt_power")
    assert under["grid"] == 1 and under["upload"] == 1
    assert sum(n for (name, _), n in pairs.items() if name in ("grid", "upload")) == 2


def test_wct_matrix_analysis_spans_each_part():
    _, pairs = _tree(_matrix)
    nulls = profiling.MC_NULLS
    assert nulls > 1
    assert _under(pairs, "wct_matrix_analysis") == {"wct_matrix": 1, "ar1": 1,
                                                    "mc.batch": 1}
    under = _under(pairs, "wct_matrix")
    assert under["grid"] == 1 and under["upload"] == 1
    assert _under(pairs, "mc.batch") == {"mc.setup": 1, "mc.chunks": 1, "fetch": 1,
                                         "mc.readout": 1}
    assert _under(pairs, "mc.setup") == {"upload": 1}
    under = _under(pairs, "mc.chunks")
    # one block of nulls: its coefficients' upload, one chunk of 6 members
    assert under["upload"] == 1 and under["mc.generate"] == 2
    assert under["mc.histogram"] == 1
    assert _under(pairs, "mc.readout") == {"mc.quantile": nulls}
    profiling.enable_spans()
    _matrix()
    got = profiling.span_summary()
    row = got["wct_matrix_analysis"]
    assert row["self_ns"] == _direct_self(got, "wct_matrix_analysis",
                                          ("wct_matrix", "ar1", "mc.batch"))
    assert 0 < row["self_ns"] < row["total_ns"]


def test_the_checkpointed_null_spans_each_chunk(tmp_path):
    ck = str(tmp_path / "mc.ckpt")
    kw = dict(SMALL, mc_count=10, mc_batch=4, cache=False, seed=4, checkpoint=ck)
    _, pairs = _tree(lambda: coherence.wct_significance(0.5, 0.6, **kw))
    # three chunks (4, 4, 2), each enqueued, fetched and written apart
    assert _under(pairs, None) == {"mc": 1}
    assert _under(pairs, "mc") == {"mc.setup": 1, "mc.chunks": 3, "fetch": 3,
                                   "mc.quantile": 1}
    assert _under(pairs, "mc.setup") == {"upload": 1}
    for name, n in (("mc.generate", 6), ("mc.histogram", 3)):
        assert _under(pairs, "mc.chunks")[name] == n
    # a second call resumes from the finished checkpoint: no chunk is left
    profiling.enable_spans()
    coherence.wct_significance(0.5, 0.6, **kw)
    got = profiling.span_summary()
    assert "mc.chunks" not in got and got["mc.setup"]["count"] == 1
    row = got["mc"]
    assert row["self_ns"] == _direct_self(got, "mc", ("mc.setup", "mc.quantile"))


def test_the_null_alone_is_its_parts():
    """``mc``'s self time is its total less its set-up, chunks, fetch and
    readout."""
    profiling.enable_spans()
    coherence.wct_significance(0.5, 0.6, **SMALL, **{k: v for k, v in MC.items()
                                                     if k != "progress"})
    got = profiling.span_summary()
    assert {k: got[k]["count"] for k in ("mc", "mc.setup", "mc.chunks", "mc.quantile",
                                         "fetch", "upload")} == \
        {"mc": 1, "mc.setup": 1, "mc.chunks": 1, "mc.quantile": 1, "fetch": 1,
         "upload": 1}
    row = got["mc"]
    assert row["self_ns"] == _direct_self(got, "mc", ("mc.setup", "mc.chunks", "fetch",
                                                      "mc.quantile"))
    assert 0 < row["self_ns"] < row["total_ns"]
    assert got["mc.setup"]["self_ns"] == _direct_self(got, "mc.setup", ("upload",))


@pytest.mark.parametrize("route", ROUTES)
def test_the_upload_bytes_are_the_copies(route):
    """``UPLOAD_BYTES`` adds each copied array's bytes as the device holds
    them, with the recorder on or off; ``enable_spans`` sets it to 0."""
    x = np.random.default_rng(7).standard_normal(3000)
    g = _host_grid(3000, 1.0, 1 / 12, -1, -1, pt.Morlet(6), CWTConfig().fft_length)
    S = len(g.sj)
    # the f64 record, and the scales in f32 (planar) or f64 (api.cwt)
    per_call = 3000 * 8 + S * (4 if route == "planar" else 8)
    profiling.enable_spans()
    assert profiling.UPLOAD_BYTES == 0
    _power(route)
    assert profiling.UPLOAD_BYTES == per_call
    profiling.disable_spans()
    pt.cwt_power(x, 1.0, config=CWTConfig(engine=route), device="cpu")
    assert profiling.UPLOAD_BYTES == 2 * per_call
    profiling.enable_spans()
    assert profiling.UPLOAD_BYTES == 0

    y1, y2 = _pair()
    gw = _host_grid(147, 0.25, 1 / 12, -1, -1, pt.Morlet(6), CWTConfig().fft_length)
    n, sj, outsidecoi, _, _ = coherence._surrogate_grid(0.25, 1 / 12, gw.s0, gw.J,
                                                        pt.Morlet(6))
    pair = 2 * 147 * 4 + len(gw.sj) * 4          # f32 rows and scales
    _wct(route, sig=False)
    assert profiling.UPLOAD_BYTES == pair
    _wct(route, sig=True)
    # the MC grid in f32 and its bool COI mask; the key is no host array
    assert profiling.UPLOAD_BYTES == 2 * pair + len(sj) * 4 + outsidecoi.size


def test_the_matrix_upload_bytes_are_the_copies():
    y = _stations()
    B, n0 = y.shape
    g = _host_grid(n0, 0.25, 1 / 12, -1, -1, pt.Morlet(6), CWTConfig().fft_length)
    P = B * (B - 1) // 2
    profiling.enable_spans()
    pt.wct_matrix(y, 0.25, dj=1 / 12, device="cpu")
    # f32 rows, two int64 index columns, f32 scales
    assert profiling.UPLOAD_BYTES == B * n0 * 4 + 2 * P * 8 + len(g.sj) * 4


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


SURFACES = {
    "wct_planar": lambda: _wct("planar", sig=True),
    "wct_xla": lambda: _wct("xla", sig=True),
    "wct_nosig": lambda: _wct("planar", sig=False),
    "cwt_power_planar": lambda: _power("planar"),
    "cwt_power_xla": lambda: _power("xla"),
    "wct_matrix_analysis": _matrix,
}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_the_answers_are_bit_for_bit_on_and_off(surface):
    fn = SURFACES[surface]
    off = fn()
    profiling.enable_spans()
    on = fn()
    _same(off, on)
    profiled, _ = _tree(fn)
    _same(off, profiled)


def test_the_checkpointed_answer_is_bit_for_bit_on_and_off(tmp_path):
    kw = dict(SMALL, mc_count=10, mc_batch=4, cache=False, seed=4)
    off = coherence.wct_significance(0.5, 0.6, checkpoint=str(tmp_path / "a"), **kw)
    profiling.enable_spans()
    on = coherence.wct_significance(0.5, 0.6, checkpoint=str(tmp_path / "b"), **kw)
    np.testing.assert_array_equal(off, on)

"""The card twin of ``test_torch_host_spans.py``: on the card's default
route (the planar route, the CUDA kernels, the generator and counts
kernels), the spans ``grid``, ``upload``, ``ar1``, ``mc.setup``,
``mc.chunks`` and ``mc.quantile`` a call of ``cwt_power``, ``wct`` with its
Monte-Carlo null and ``wct_matrix_analysis``; the bytes that
``profiling.UPLOAD_BYTES`` counts; and the answers, bit for bit the same
with the recorder off and on.  It needs an NVIDIA card, so it skips where
there is none; ``python -m pytest --noconftest
tests/test_torch_host_spans_cuda.py`` on the card runs it."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.config import CWTConfig
from pycwt_torch.transform import _host_grid
from pycwt_torch.utils import profiling

MC = dict(mc_count=24, cache=False, progress=False, seed=3)


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _record(n0=100_000):
    return np.random.default_rng(7).standard_normal(n0)


def _pair():
    return np.random.default_rng(5).standard_normal((2, 147))


def _stations():
    rng = np.random.default_rng(11)
    g = np.linspace(0.3, 0.7, 6)[:, None]
    y = rng.standard_normal((6, 320))
    for t in range(1, y.shape[1]):
        y[:, t] += g[:, 0] * y[:, t - 1]
    return y[:, 64:]


def _counts(names):
    got = profiling.span_summary()
    return {k: got.get(k, {}).get("count", 0) for k in names}


def test_cwt_power_spans_and_bytes(cuda):
    x = _record()
    g = _host_grid(len(x), 1.0, 1 / 12, -1, -1, pt.Morlet(6), CWTConfig().fft_length)
    off = pt.cwt_power(x, 1.0)
    profiling.enable_spans()
    on = pt.cwt_power(x, 1.0)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert _counts(("cwt_power", "grid", "upload")) == {"cwt_power": 1, "grid": 1,
                                                        "upload": 1}
    # the f64 record and the f32 scales, on the planar route
    assert profiling.UPLOAD_BYTES == len(x) * 8 + len(g.sj) * 4
    got = profiling.span_summary()
    row = got["cwt_power"]
    children = ("grid", "upload", "spectrum", "fused_cwt", "fetch")
    assert row["self_ns"] == row["total_ns"] - sum(got[k]["total_ns"] for k in children)


def test_wct_with_the_null_spans_and_bytes(cuda):
    y1, y2 = _pair()
    off = pt.wct(y1, y2, 0.25, **MC)
    profiling.enable_spans()
    on = pt.wct(y1, y2, 0.25, **MC)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert _counts(("wct", "grid", "upload", "ar1", "mc", "mc.setup", "mc.chunks",
                    "mc.quantile", "fetch")) == \
        {"wct": 1, "grid": 1, "upload": 2, "ar1": 1, "mc": 1, "mc.setup": 1,
         "mc.chunks": 1, "mc.quantile": 1, "fetch": 3}
    gw = _host_grid(147, 0.25, 1 / 12, -1, -1, pt.Morlet(6), CWTConfig().fft_length)
    _, sj, outsidecoi, _, _ = coherence._surrogate_grid(0.25, 1 / 12, gw.s0, gw.J,
                                                        pt.Morlet(6))
    assert profiling.UPLOAD_BYTES == 2 * 147 * 4 + len(gw.sj) * 4 + len(sj) * 4 \
        + outsidecoi.size
    got = profiling.span_summary()
    row = got["mc"]
    parts = ("mc.setup", "mc.chunks", "mc.quantile")
    assert sum(got[k]["total_ns"] for k in parts) < row["total_ns"]


def test_wct_matrix_analysis_spans(cuda):
    y = _stations()
    kw = dict(dj=1 / 12, mc_count=24, seed=9, cache=False)
    off = wct_matrix_analysis(y, 0.25, **kw)
    profiling.enable_spans()
    on = wct_matrix_analysis(y, 0.25, **kw)
    for k in off:
        np.testing.assert_array_equal(np.asarray(off[k]), np.asarray(on[k]))
    blocks = -(-profiling.MC_NULLS // 64)
    assert _counts(("wct_matrix_analysis", "grid", "ar1", "mc.setup", "mc.chunks",
                    "mc.readout")) == \
        {"wct_matrix_analysis": 1, "grid": 1, "ar1": 1, "mc.setup": 1,
         "mc.chunks": 1, "mc.readout": 1}
    # the maps' upload, the MC grid's and each block's coefficients
    assert _counts(("upload",)) == {"upload": 2 + blocks}
    assert _counts(("mc.quantile",)) == {"mc.quantile": profiling.MC_NULLS}

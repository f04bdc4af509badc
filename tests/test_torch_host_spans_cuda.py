"""The card twin of ``test_torch_host_spans.py``: on the card's default route
(the planar route, the CUDA kernels, the generator and counts kernels), the
spans ``grid``, ``upload``, ``ar1``, ``mc.setup``, ``mc.chunks`` and
``mc.quantile`` a call of ``cwt_power``, ``wct`` with its Monte-Carlo null
and ``wct_matrix_analysis``; the bytes that ``profiling.UPLOAD_BYTES``
counts; the answers, bit for bit the same with the recorder off and on; and
``cwt_power``'s COI at 10^6 samples, built between the kernels' enqueue and
the fetch. It needs an NVIDIA card, so it skips where there is none;
``python -m pytest --noconftest tests/test_torch_host_spans_cuda.py`` on
the card runs it."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops.fused_cwt import _planar_cwt_of_real
from pycwt_torch.transform import _finite_rows, _host_grid, build_scale_grid
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
    children = ("grid", "upload", "spectrum", "fused_cwt", "coi", "fetch")
    assert row["self_ns"] == row["total_ns"] - sum(got[k]["total_ns"] for k in children)


def _old_grid(n0, dt, mother):
    """The grid's scales, frequencies and COI as they were built with the
    full angular-frequency array and the COI as one expression."""
    grid = build_scale_grid(n0, dt, mother=mother)
    sj, freqs = _finite_rows(mother, grid.sj, grid.freqs,
                             2 * np.pi * np.fft.fftfreq(CWTConfig().fft_length(n0), dt))
    tri = n0 / 2 - np.abs(np.arange(0, n0, dtype=np.float64) - (n0 - 1) / 2)
    return sj, freqs, mother.flambda() * mother.coi() * dt * tri


def test_cwt_power_builds_the_coi_while_the_kernels_run(cuda):
    """At 10^6 samples the span ``coi`` opens after ``fused_cwt`` has
    queued the kernels and closes before ``fetch`` opens; no angular-
    frequency array is built; ``(power, sj, freqs, coi)`` equal the old
    grid's formulas and the kernels' power on that grid bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    x = _record(1_000_000)
    pt.cwt_power(x, 1.0)                    # the build and the pool, warm
    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        power, sj, freqs, coi = pt.cwt_power(x, 1.0)
    assert (profiling.HOST_GRIDS, profiling.GRID_FTFREQ_ARRAYS) == (1, 0)
    spans = {}
    for e in prof.events():
        if e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU:
            spans.setdefault(e.name, []).append(e.time_range)
    (c,) = spans["coi"]
    (k,) = spans["fused_cwt"]
    (f,) = spans["fetch"]
    assert k.end <= c.start and c.end <= f.start
    want = _old_grid(len(x), 1.0, pt.Morlet(6))
    for got, ref in zip((sj, freqs, coi), want):
        np.testing.assert_array_equal(got, ref)
    xs = torch.as_tensor(x, dtype=torch.float64, device=cuda)
    ref = _planar_cwt_of_real(xs, torch.as_tensor(want[0], dtype=torch.float32,
                                                  device=cuda),
                              mother=pt.Morlet(6), nfft=2 ** 20, dt=1.0,
                              precision=CWTConfig().precision, output="power")
    np.testing.assert_array_equal(power, ref[:, :len(x)].cpu().numpy())


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

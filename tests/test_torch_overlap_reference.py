"""The blocked wavelet coherence of a long pair (``wct_overlap_planar``)
against the benchmark's float64 reference of it
(``cwtbench/reference/wct_overlap_f64.py``) on the CPU, and the reference
against a global float64 coherence written here with ``torch.fft``, which
ties it to pycwt's maths; the overlap-save surfaces' spans and counters,
the bits they leave alone, and the cell ``overlap_16m``'s four per-layer
metric readers over a stand-in trace."""
import json
import math
import os
import types
import warnings

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import wct_overlap_f64 as R
from pycwt_torch.ops import overlap as tov
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "cwtbench", "cells", "overlap_16m.json")) as f:
    LIMITS = json.load(f)["limits"]
#: the cell's grid: 4096 Hz, Morlet-6, s0 = 2 dt, dj = 1/8
DT, DJ, F0 = 1 / 4096, 1 / 8, 6.0
M6 = pt.Morlet(F0)
N, CHUNK = 1 << 14, 1 << 12


@pytest.fixture(autouse=True)
def quiet_and_recorder_off():
    """The grids reach s = 2 dt, where the near-Nyquist caveat warns; each
    test starts and ends with the recorder off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _pair(n, seed=0):
    """Two records sharing an AR(1) part, as the cell's inputs."""
    make = harness.load_module("inputs", "long_pairs").make
    y = make({"pairs": 1, "n0": n, "g": [0.4, 0.8], "burn_in": 256, "share": 0.5},
             2 ** 31 + seed, "cpu")
    return y["y1"][0], y["y2"][0]


def _gaps(maps, y1, y2, sj, chunk):
    """(wct_gap, phase_gap) of ``maps`` against the reference, weighted as
    the cell weighs them."""
    WCT, A = maps
    w_gap = turn = top = 0.0
    for lo, hi, rw, rph, mag in R.chunks(y1, y2, sj, DT, DJ, F0, chunk=chunk,
                                         eps=1e-7, device="cpu"):
        w_gap = max(w_gap, float((WCT[:, lo:hi].double() - rw).abs().max()))
        t = 2 * torch.sin(0.5 * (A[:, lo:hi].double() - rph)).abs() * mag
        turn, top = max(turn, float(t.max())), max(top, float(mag.max()))
    return w_gap, turn / top


@pytest.mark.parametrize("n", [N, N - 1500], ids=["whole_chunks", "zero_tail"])
def test_wct_overlap_planar_matches_the_reference(n):
    """Every sample and scale of both maps, 16 scales from s = 2 dt (so the
    near-Nyquist rows too: both compute the same framing)."""
    y1, y2 = _pair(n)
    sj = R.scales(16, DT, DJ, 2.0)
    maps = tov.wct_overlap_planar(y1, y2, sj, DT, mother=M6, dj=DJ, chunk=CHUNK,
                                  device="cpu")
    assert all(m.shape == (16, n) and m.dtype == torch.float32 for m in maps)
    w_gap, ph_gap = _gaps(maps, y1, y2, sj, CHUNK)
    # float32 transforms and smoothings at nfft 8192 and the f32 ratio:
    # ~2e-6 of a WCT in [0, 1]; the cell's limit is 3e-4
    assert w_gap < 2e-5
    # the phase of the unsmoothed cross spectrum, weighted by |W12_ref|:
    # the f32 kernels' ~3e-7 of max|W|; the cell's limit is 2e-5
    assert ph_gap < 2e-6


@pytest.mark.parametrize("lower", ["fast", "tf32"])
def test_lower_precision_fails_the_cell_limits(lower):
    """The program at its bf16-T tier, the cell's control, and the
    reference computed in TF32 each read above a limit of the cell."""
    y1, y2 = _pair(N, seed=1)
    sj = R.scales(16, DT, DJ, 2.0)
    if lower == "fast":
        maps = tov.wct_overlap_planar(y1, y2, sj, DT, mother=M6, dj=DJ, chunk=CHUNK,
                                      precision="fast", device="cpu")
    else:
        WCT = torch.empty(16, N, dtype=torch.float32)
        A = torch.empty_like(WCT)
        for lo, hi, w, ph, _ in R.chunks(y1, y2, sj, DT, DJ, F0, chunk=CHUNK,
                                         eps=1e-7, device="cpu", mode="tf32"):
            WCT[:, lo:hi], A[:, lo:hi] = w, ph
        maps = WCT, A
    gaps = dict(zip(("wct_gap", "phase_gap"), _gaps(maps, y1, y2, sj, CHUNK)))
    assert any(gaps[k] > 3 * lim for k, lim in LIMITS.items()), gaps


def _global_wct(y1, y2, sj):
    """pycwt's ``wct`` maps in float64 over the whole record: both series
    normalised, the Morlet CWT at the next power of two, the time Gaussian
    by FFT, the boxcar of round(2 * 0.6 / dj) taps with half end taps as
    scipy's 'same' convolution, R^2."""
    y = torch.tensor(np.stack([y1, y2]))
    y = (y - y.mean(1, keepdim=True)) / y.std(1, correction=0, keepdim=True)
    n = y.shape[1]
    nfft = 1 << (n - 1).bit_length()
    s = torch.tensor(sj)[:, None]
    w = 2 * math.pi * torch.fft.fftfreq(nfft, d=DT, dtype=torch.float64)
    bank = (torch.sqrt(2 * math.pi * s / DT) * math.pi ** -0.25
            * torch.exp(-0.5 * (s * w - F0) ** 2))
    W = torch.fft.ifft(torch.fft.fft(y, n=nfft)[:, None, :] * bank)[..., :n]
    k = 2 * math.pi * torch.fft.fftfreq(nfft, dtype=torch.float64)
    gauss = torch.exp(-0.5 * (s / DT) ** 2 * k ** 2)
    L = int(round(2 * 0.6 / DJ))
    win = np.ones(L)
    win[0] = win[-1] = 0.5
    win /= win.sum()
    S, start = len(sj), (L - 1) // 2
    box = torch.zeros(S, S, dtype=torch.float64)
    for i in range(S):
        for c in range(S):
            if 0 <= i + start - c < L:
                box[i, c] = win[i + start - c]

    def smooth(T):
        timed = torch.fft.ifft(torch.fft.fft(T, n=nfft) * gauss)[..., :n]
        return box.to(timed.dtype) @ timed

    S1, S2 = (smooth(W[i].abs() ** 2 / s).real for i in (0, 1))
    S12 = smooth(W[0] * W[1].conj() / s)
    return S12.abs() ** 2 / (S1 * S2), L


def test_the_reference_matches_a_global_wct():
    """Away from the record's ends (2 halos) the blocked reference is the
    global coherence, on every row whose boxcar reaches only scales of
    4 dt and more: below 4 dt the filter rings at the Nyquist frequency
    and the chunk edges show (the reference's docstring)."""
    y1, y2 = _pair(N, seed=2)
    sj = R.scales(32, DT, DJ, 2.0)
    glob, L = _global_wct(y1, y2, sj)
    blocked = torch.empty_like(glob)
    for lo, hi, w, _, _ in R.chunks(y1, y2, sj, DT, DJ, F0, chunk=CHUNK, eps=1e-7,
                                    device="cpu"):
        blocked[:, lo:hi] = w
    H = R.framing(N, sj.max(), DT, CHUNK, 1e-7)["H"]
    first = int(np.argmax(sj >= 4 * DT - 1e-15)) + L // 2
    assert 0 < first < 20
    gap = (blocked - glob)[first:, 2 * H:N - 2 * H].abs().max()
    # float64 round-off of two FFT lengths (~2e-15 measured)
    assert float(gap) < 1e-10
    # and the rows below do show the chunk edges
    assert float((blocked - glob)[0, 2 * H:N - 2 * H].abs().max()) > 1e-3


def _surfaces(n, S, chunk):
    """Each single-device overlap-save surface on a host pair: (name of its
    top span, signals it transforms, the call)."""
    y1, y2 = _pair(n, seed=3)
    sj = R.scales(S, DT, DJ, 4.0)
    kw = dict(mother=M6, chunk=chunk, device="cpu")
    return {
        "wct_overlap": (2, lambda: tov.wct_overlap_planar(y1, y2, sj, DT, dj=DJ, **kw)),
        "xwt_overlap_planar": (2, lambda: tov.xwt_overlap_planar(y1, y2, sj, DT, **kw)),
        "cwt_overlap_save": (1, lambda: tov.cwt_overlap_save(y1, sj, DT, **kw)),
        "cwt_overlap_save_planar": (
            1, lambda: tov.cwt_overlap_save_planar(y1, sj, DT, **kw)),
        "streamed_global_power": (
            1, lambda: tov.streamed_global_power(y1, sj, DT, **kw)),
        "streamed_global_power_planar": (
            1, lambda: tov.streamed_global_power_planar(y1, sj, DT, **kw)),
    }, sj


SURFACES = ["wct_overlap", "xwt_overlap_planar", "cwt_overlap_save",
            "cwt_overlap_save_planar", "streamed_global_power",
            "streamed_global_power_planar"]


@pytest.mark.parametrize("n", [1 << 12, (1 << 12) - 300], ids=["whole_chunks", "zero_tail"])
@pytest.mark.parametrize("name", SURFACES)
def test_one_calls_spans_and_counters(name, n):
    S, chunk = 8, 1 << 10
    surfaces, sj = _surfaces(n, S, chunk)
    signals, call = surfaces[name]
    profiling.enable_spans()
    call()
    summary = profiling.span_summary()
    H = (2 if name == "wct_overlap" else 1) * tov.halo_samples(sj.max(), DT)
    nfft = 1 << (chunk + 2 * H - 1).bit_length()
    n_chunks = -(-n // chunk)
    for span in (name, "upload", "overlap.chunks"):
        assert summary[span]["count"] == 1, (span, summary)
    assert profiling.OVERLAP_CHUNKS == n_chunks
    assert profiling.OVERLAP_POINTS == signals * n_chunks * S * nfft
    # the last chunk's zero tail stays out of the interior
    assert profiling.OVERLAP_INTERIOR_POINTS == signals * S * n
    # the host float64 records and scales, as float32 on the device
    assert profiling.UPLOAD_BYTES == 4 * (signals * n + S)


def test_tensors_already_on_the_device_are_not_counted_as_uploads():
    y1, y2 = (torch.as_tensor(y, dtype=torch.float32) for y in _pair(1 << 12))
    sj = torch.as_tensor(R.scales(8, DT, DJ, 4.0), dtype=torch.float32)
    profiling.enable_spans()
    tov.wct_overlap_planar(y1, y2, sj, DT, mother=M6, dj=DJ, chunk=1 << 10)
    assert profiling.UPLOAD_BYTES == 0
    assert profiling.span_summary()["upload"]["count"] == 1


@pytest.mark.parametrize("name", SURFACES)
def test_the_recorder_leaves_the_bits_alone(name):
    surfaces, _ = _surfaces(1 << 12, 8, 1 << 10)
    _, call = surfaces[name]
    off = call()
    profiling.enable_spans()
    on = call()
    off, on = (x if isinstance(x, tuple) else (x,) for x in (off, on))
    assert all(torch.equal(a, b) for a, b in zip(off, on))


#: the cell's shape, as its entry gives it
SHAPE = {"kind": "wct_overlap", "B": 2, "P": 1, "N": 1 << 24, "S": 64,
         "chunk": 1 << 18, "nfft_c": 1 << 19, "H": 5332, "taps": 10}


def _stand_in(calls=4, busy_s=1.8, window_s=2.0, shape=SHAPE):
    """What a traced run hands the readers: ``calls`` calls of 0.45 s of
    kernels each, and the upload's copies, which the roofline leaves out."""
    ops = [(0.0, 0.45e6, "cwt_stage_a_kernel")] * calls
    ops += [(0.0, 0.02e6, "Memcpy HtoD (Pageable -> Device)")] * calls
    return types.SimpleNamespace(
        entry=types.SimpleNamespace(shape=shape), calls=calls, device_ops=ops,
        window_s=window_s, busy_s=busy_s,
        idle_pct=lambda: 100.0 * (1 - busy_s / window_s))


def test_the_metric_readers():
    read = {name: harness.load_module("metrics", name).read
            for name in ("device_idle_pct.overlap", "overlap_roofline_pct",
                         "overlap_interior_pct", "chunk_enqueue_ms.overlap")}
    trace = _stand_in()
    assert read["device_idle_pct.overlap"](trace) == pytest.approx(10.0)
    roof = harness.load_module("metrics", "overlap_roofline_pct")
    # ~0.74 TFLOP and 8.7 GB: float32-bound at ~11.1 ms a call
    assert roof.call_ops(SHAPE) == pytest.approx(7.42e11, rel=1e-3)
    assert roof.call_bytes(SHAPE) == pytest.approx(8.72e9, rel=1e-3)
    assert roof.bound_s(SHAPE) == pytest.approx(0.01108, rel=1e-3)
    assert read["overlap_roofline_pct"](trace) == pytest.approx(
        100 * roof.bound_s(SHAPE) / 0.45)
    assert read["overlap_roofline_pct"](_stand_in(shape={"kind": "cwt"})) is None
    assert read["overlap_roofline_pct"](_stand_in(calls=0)) is None
    # loading the counter and span readers switched the recorder on and
    # cleared it: nothing to read until a call
    assert profiling._on
    assert read["overlap_interior_pct"](trace) is None
    assert read["chunk_enqueue_ms.overlap"](trace) is None
    surfaces, _ = _surfaces(1 << 12, 8, 1 << 10)
    surfaces["wct_overlap"][1]()
    # 2^10 + 2 halos of 84 samples transformed at 2^11
    assert read["overlap_interior_pct"](trace) == 50.0
    assert read["chunk_enqueue_ms.overlap"](trace) > 0


def test_the_counter_readers_read_nothing_without_the_program_s_names(monkeypatch):
    """As on a program without the recorder's overlap names: None, and no
    error."""
    read = {name: harness.load_module("metrics", name).read
            for name in ("overlap_interior_pct", "chunk_enqueue_ms.overlap")}
    for attr in ("OVERLAP_POINTS", "OVERLAP_INTERIOR_POINTS"):
        monkeypatch.delattr(profiling, attr)
    monkeypatch.setattr(profiling, "span_summary", lambda: {"wct": {"count": 3}})
    assert read["overlap_interior_pct"](_stand_in()) is None
    assert read["chunk_enqueue_ms.overlap"](_stand_in()) is None

"""The public ``cwt_power`` of long records at pycwt's defaults (dj 1/12,
s0 -1, J -1, Morlet) against the benchmark's float64 reference
(``cwtbench/reference/cwt_power_f64.py``), which works out the automatic
grid and the COI itself; the span ``cwt_power`` and the counter of the
bytes that ``api._host`` copies to the host.

The CPU cases run the default CPU route (``xla``: ``torch.fft`` in f32) and
``engine="planar"``, which runs the kernels' plain version on the card's
route (the f64 spectrum rounded once, the ``power`` epilogue, the slice to
n0).  The card case needs an NVIDIA card and nvcc and skips where there is
none; ``python -m pytest --noconftest tests/test_torch_cwt_power_long.py``
on the card runs it."""
import math

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import cwt_power_f64 as R
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.transform import build_scale_grid, coi_bartlett
from pycwt_torch.utils import profiling

#: the records the benchmark's cell draws: stationary AR(1), g = 0.72
AR1 = harness.load_module("inputs", "host_ar1_records").make
SEED = 2 ** 31 + 4099
#: f32 arithmetic on either route: the transform's rounding reads
#: 1.3-1.6e-6 of a row's peak power over six seeds at these lengths (the
#: f32 FFTs of 4096 points, or the f64 spectrum rounded once and the plain
#: version's f32 inverse FFT); the limit is a tenth of the benchmark's
P_TOL = 1e-5
#: the host f64 grid: the reference's COI takes lambda / sqrt(2) where the
#: program multiplies by lambda and 1/sqrt(2), a rounding apart
GRID_TOL = 4 * np.finfo(np.float64).eps


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the span recorder off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _record(n0, seed=SEED):
    return AR1({"records": 1, "n0": n0, "g": 0.72}, seed, "cpu")["x"][0]


def _p_gap(P, x, sj, device="cpu"):
    """max over scales of max_t |P - P_ref| / max_t P_ref."""
    gap = 0.0
    xt = torch.as_tensor(x, device=device)
    for lo, hi, ref in R.power_blocks(xt, sj, dt=1.0, f0=6.0):
        got = torch.as_tensor(P[lo:hi]).to(device=device, dtype=torch.float64)
        gap = max(gap, float(((got - ref).abs().amax(1) / ref.amax(1)).max()))
    return gap


def _grid_gap(out, ref):
    return max(float(np.max(np.abs(np.asarray(a) / b.numpy() - 1)))
               for a, b in zip(out, ref))


@pytest.mark.parametrize("engine", ["xla", "planar"])
@pytest.mark.parametrize("n0", [3000, 4096])
def test_power_matches_the_reference(n0, engine):
    x = _record(n0)
    P, sj, freqs, coi = pt.cwt_power(x, 1.0, config=CWTConfig(engine=engine),
                                     device="cpu")
    ref = R.grid(n0, 1.0, 1 / 12, 6.0)
    assert P.shape == (len(ref[0]), n0) and P.dtype == np.float32
    assert _p_gap(P, x, ref[0]) <= P_TOL
    assert _grid_gap((sj, freqs, coi), ref) <= GRID_TOL


@pytest.mark.parametrize("n0", [3000, 4096, 100_000, 1_000_000])
def test_the_automatic_grid_is_the_references(n0):
    """The program's grid at the defaults (``build_scale_grid`` and
    ``coi_bartlett``, host f64) against the reference's own, up to the
    benchmark's 10^6 samples: 229 scales there, at nfft 2^20."""
    mother = pt.Morlet(6.0)
    grid = build_scale_grid(n0, 1.0, mother=mother)
    ours = (grid.sj, grid.freqs, coi_bartlett(n0, 1.0, mother))
    ref = R.grid(n0, 1.0, 1 / 12, 6.0)
    assert len(grid.sj) == len(ref[0])
    assert _grid_gap(ours, ref) <= GRID_TOL
    if n0 == 1_000_000:
        assert len(grid.sj) == 229


def test_the_byte_counter_counts_the_power():
    """On the card's route each call copies S n0 float32 values to the host,
    and switching the recorder on sets the counter back to 0."""
    n0 = 3000
    x = _record(n0)
    cfg = CWTConfig(engine="planar")
    profiling.enable_spans()
    assert profiling.HOST_BYTES == 0
    for _ in range(2):
        P, *_ = pt.cwt_power(x, 1.0, config=cfg, device="cpu")
    assert profiling.HOST_BYTES == 2 * P.shape[0] * n0 * 4
    profiling.disable_spans()
    pt.cwt_power(x, 1.0, config=cfg, device="cpu")
    assert profiling.HOST_BYTES == 3 * P.shape[0] * n0 * 4
    profiling.enable_spans()
    assert profiling.HOST_BYTES == 0


#: the spans directly under ``cwt_power``, a call, on each CPU route: the
#: host grid and the upload of the record and its scales besides the layers
UNDER = {"planar": {"grid": 1, "upload": 1, "spectrum": 1, "fused_cwt": 1,
                    "coi": 1, "fetch": 1},
         "xla": {"grid": 1, "upload": 1, "cwt_batch": 1, "coi": 1, "fetch": 2}}


@pytest.mark.parametrize("engine", sorted(UNDER))
def test_the_span_holds_the_call(engine):
    """``cwt_power`` is recorded once a call, the spans of its layers once
    each under it: its self time is its total less theirs."""
    x = _record(3000)
    profiling.enable_spans()
    for _ in range(3):
        pt.cwt_power(x, 1.0, config=CWTConfig(engine=engine), device="cpu")
    got = profiling.span_summary()
    assert {k: v["count"] for k, v in got.items()} == {
        "cwt_power": 3, **{k: 3 * n for k, n in UNDER[engine].items()}}
    row = got["cwt_power"]
    assert row["self_ns"] == row["total_ns"] - sum(
        got[k]["total_ns"] for k in UNDER[engine])
    assert 0 < row["self_ns"] < row["total_ns"]
    assert profiling._stack == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_cwt_power_on_the_card(cuda):
    """10^5 samples at the defaults (189 scales, nfft 2^17) through K1 and
    K2's ``power`` epilogue, one launch of each a call, against the
    reference on the card.  The kernels' f32 error is 2.6-4.5e-7 of a row's
    max|W| at every shape (PERF.md's kernel table), about twice that of its
    peak power."""
    n0 = 100_000
    x = _record(n0)
    before = dict(fc.KERNEL_LAUNCHES)
    for _ in range(2):
        P, sj, freqs, coi = pt.cwt_power(x, 1.0)
    launched = {k: fc.KERNEL_LAUNCHES[k] - before[k] for k in before}
    assert launched == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 0,
                        "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
    ref = R.grid(n0, 1.0, 1 / 12, 6.0)
    assert P.shape == (189, n0) and P.dtype == np.float32
    assert math.isfinite(_p_gap(P, x, ref[0], cuda))
    assert _p_gap(P, x, ref[0], cuda) <= P_TOL
    assert _grid_gap((sj, freqs, coi), ref) <= GRID_TOL

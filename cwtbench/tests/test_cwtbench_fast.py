"""The cells of the ``fast`` tier, ``cwt_fast_1m`` and ``cwt_fast_w_4m``, on
the CPU, cut to records of 2^14 samples and 40 scales (the largest then
spans ~1.5 bins of the spectrum, as the 64th does at 2^20): whole runs come
out correct; the control (the reference with its filtered spectrum rounded
to 4 significant bits) and each fault the cells can have come out not
correct; the readers of the cells' three new metrics; the rounding; and no
import of JAX in the new files."""
import os
import time

import pytest
import torch

from conftest import REPO, edit_json
from cwtbench import harness, kernel_bounds, kernel_bounds_t16, peaks
from pycwt_torch.utils import profiling

CELLS = ("cwt_fast_1m", "cwt_fast_w_4m")
SEED = 2 ** 31 + 4099
NFFT = 1 << 14
NEW_FILES = ("entries/power_sum_fast.py", "entries/cwt_batch_fast.py",
             "reference/cwt_rounded_f64.py", "kernel_bounds_t16.py",
             "metrics/t_bf16_pct.py", "metrics/k1_bf16_roofline_pct.py",
             "metrics/k2_bf16_roofline_pct.py")
METRICS = ("t_bf16_pct", "k1_bf16_roofline_pct", "k2_bf16_roofline_pct")


@pytest.fixture(autouse=True)
def recorder_off():
    """Loading a counter metric switches the recorder on: each test starts
    and ends with it off and its counters at 0."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


@pytest.fixture
def fast_root(tiny_root):
    root, here = tiny_root
    edit_json(os.path.join(here, "configs", "tc98_morlet6_long_fast.json"), {"J": 39})
    edit_json(os.path.join(here, "traffic", "gws_1m_fast.json"),
              {"inputs": {"n0": NFFT, "records": 3}})
    edit_json(os.path.join(here, "traffic", "w_4m_fast.json"),
              {"inputs": {"n0": NFFT, "records": 2}})
    return root, here


def _run(root, here, cell, seconds=0.4, trace=False):
    return harness.run(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", root=root, here=here)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_on_the_cpu(fast_root, cell):
    root, here = fast_root
    c = harness.load_cell(cell, root, here)
    assert c.precision == c.config["precision"] == "fast"
    res, checks = _run(root, here, cell)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == set(c.spec["limits"])
    assert set(res["metrics"]) == {"setup_s", "cwt_rate"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(fast_root, cell):
    """The reference one precision below bf16 in the program's place reads
    above the limit, by more than 3 times."""
    from cwtbench.control import readings

    root, here = fast_root
    c = harness.load_cell(cell, root, here)
    assert c.spec["control"] == {"reference": "sig4"}
    row = readings(c, SEED, 0.3, True, "cpu")
    (k, lim), = c.spec["limits"].items()
    assert row[k] > 3 * lim, row


def _scale_a_row(out):
    """The row that holds the largest value scaled by 1 + 1e-2."""
    out = out.clone()
    row = int(out.abs().reshape(out.shape[0], out.shape[1], -1).amax(dim=(0, 2)).argmax())
    out[:, row] *= 1 + 1e-2
    return out


def _swap_two_scales(out):
    out = out.clone()
    out[:, [0, -1]] = out[:, [-1, 0]]
    return out


def _drop_the_records_output(out):
    return out[:0]


@pytest.mark.parametrize("fault", [_scale_a_row, _swap_two_scales, _drop_the_records_output],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_fails(fast_root, monkeypatch, cell, fault):
    from pycwt_torch.ops import fused_cwt

    root, here = fast_root
    inner = fused_cwt.fused_cwt_planar
    # cwt_batch calls fused_cwt, which calls fused_cwt_planar
    monkeypatch.setattr(fused_cwt, "fused_cwt_planar",
                        lambda *a, **kw: fault(inner(*a, **kw)))
    res, checks = _run(root, here, cell)
    assert not res["correct"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_a_failing_call_fails(fast_root, monkeypatch, cell):
    """A call that raises inside the window (after the two warm-up calls)."""
    from pycwt_torch.ops import fused_cwt

    inner, calls = fused_cwt.fused_cwt_planar, []

    def broken(*a, **kw):
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("broken")
        return inner(*a, **kw)

    monkeypatch.setattr(fused_cwt, "fused_cwt_planar", broken)
    root, here = fast_root
    res, _ = _run(root, here, cell)
    assert not res["correct"] and res["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reads_the_counter(fast_root, cell):
    """On the CPU the plain version's T is bf16 alone; the rooflines find no
    device op to read."""
    root, here = fast_root
    listed = {m["name"] for m in harness.load_cell(cell, root, here).per_layer}
    assert listed == {"cwt_roofline_pct", "device_idle_pct.cwt", *METRICS}
    res, checks = _run(root, here, cell, seconds=1.0, trace=True)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"t_bf16_pct"}
    assert res["metrics"]["t_bf16_pct"]["value"] == 100.0
    # every call of the window made 40 rows of NFFT points of T
    assert profiling.T_BF16_POINTS == res["attempted"] * 40 * NFFT
    assert profiling.T_F32_POINTS == 0


def test_t_bf16_pct_reads_nothing_without_the_counters(monkeypatch):
    read = harness.load_module("metrics", "t_bf16_pct").read
    profiling.T_BF16_POINTS, profiling.T_F32_POINTS = 3, 1
    assert read(None) == 75.0
    profiling.T_BF16_POINTS = profiling.T_F32_POINTS = 0
    assert read(None) is None
    monkeypatch.delattr(profiling, "T_BF16_POINTS")
    monkeypatch.delattr(profiling, "T_F32_POINTS")
    assert read(None) is None


class _Trace:
    """A traced slice of ``calls`` calls holding the ops ``(name, seconds)``."""

    def __init__(self, shape, precision, ops, calls=2):
        self.entry = type("E", (), {"shape": shape, "precision": precision})()
        self.ops = ops
        self.calls = calls

    def per_call_s(self, match=None):
        t = sum(s for n, s in self.ops if match is None or match in n)
        return t / self.calls if self.ops else None


GWS = {"kind": "cwt", "B": 1, "n0": 2 ** 20, "nfft": 2 ** 20, "S": 64,
       "output": "power_sum", "kernel_output": "power_sum"}
W4M = {"kind": "cwt", "B": 1, "n0": 2 ** 22, "nfft": 2 ** 22, "S": 64,
       "output": "W", "kernel_output": "planes"}
OPS = [("cwt_stage_a_kernel<10, __nv_bfloat16>", 2 * 0.3891e-3),
       ("cwt_stage_b_kernel<10, 0, __nv_bfloat16, false>", 2 * 0.2800e-3),
       ("cwt_stage_b_reduce_kernel", 2 * 0.0068e-3),
       ("regular_fft_factor", 2 * 0.02e-3)]


def test_the_rooflines_read_the_bf16_bounds():
    k1 = harness.load_module("metrics", "k1_bf16_roofline_pct").read
    k2 = harness.load_module("metrics", "k2_bf16_roofline_pct").read
    b = kernel_bounds_t16.k1_k2(GWS, 2 ** 19, t_bytes=2)
    assert k1(_Trace(GWS, "fast", OPS)) == pytest.approx(100 * b["cwt_stage_a"] / 0.3891e-3)
    # K2's time holds its reduce pass
    assert k2(_Trace(GWS, "fast", OPS)) == pytest.approx(100 * b["cwt_stage_b"] / 0.2868e-3)
    assert k1(_Trace(GWS, "fast", OPS)) == pytest.approx(20.9, abs=0.05)
    assert k2(_Trace(GWS, "fast", OPS)) == pytest.approx(27.9, abs=0.05)
    for read in (k1, k2):
        assert read(_Trace(GWS, "high", OPS)) is None
        assert read(_Trace(GWS, "fast", [])) is None
        assert read(_Trace({"kind": "wct"}, "fast", OPS)) is None
        assert read(_Trace(GWS, "fast", OPS[3:])) is None


def test_the_bf16_bounds_by_hand():
    # K1 at 2^20 x 64: the half spectrum's two f32 planes, 64 scales, T's
    # two bf16 planes: bytes-bound
    b = kernel_bounds_t16.k1_k2(GWS, 2 ** 19, t_bytes=2)
    assert b["cwt_stage_a"] == pytest.approx(
        (2 * 2 ** 19 * 4 + 64 * 4 + 2 * 64 * 2 ** 20 * 2) / peaks.HBM_BYTES_S)
    assert b["cwt_stage_a"] * 1e3 == pytest.approx(0.0814, rel=1e-2)
    assert b["cwt_stage_b"] == pytest.approx((2 * 64 * 2 ** 20 * 2 + 64 * 4) / peaks.HBM_BYTES_S)
    # K2 at 2^22 x 64 writing complex64 W: T at 1.07 GB, W at 2.15 GB
    w = kernel_bounds_t16.k1_k2(W4M, 2 ** 21, t_bytes=2)
    assert w["cwt_stage_b"] == pytest.approx(
        (2 * 64 * 2 ** 22 * 2 + 8 * 64 * 2 ** 22) / peaks.HBM_BYTES_S)
    assert w == kernel_bounds_t16.k1_k2(dict(W4M, kernel_output="complex"), 2 ** 21, 2)
    # at 4 bytes it is kernel_bounds.k1_k2, the f32 T's
    for shape in (GWS, W4M, dict(GWS, kernel_output="power")):
        assert kernel_bounds_t16.k1_k2(shape, shape["nfft"] // 2, 4) == pytest.approx(
            kernel_bounds.k1_k2(shape, shape["nfft"] // 2))


def test_the_rounding_is_bf16s_at_8_bits_and_coarser_at_4():
    from cwtbench.reference import cwt_rounded_f64 as R

    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randn(20000, generator=gen)
         * torch.exp(40 * torch.randn(20000, generator=gen))).to(torch.float32)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1e-40, -3e-42, 2 ** -126, 1.0 + 2 ** -8,
                                    1.0 + 3 * 2 ** -8])])
    assert torch.equal(R.round_significant(x.double(), 8), x.to(torch.bfloat16).double())
    # 4 bits: 1 + 2^-4 is a tie, rounded to even (1); 1 + 3 2^-4 rounds up
    y = torch.tensor([1.0 + 2 ** -4, 1.0 + 3 * 2 ** -4, 0.75, -5.5], dtype=torch.float64)
    assert R.round_significant(y, 4).tolist() == [1.0, 1.25, 0.75, -5.5]
    assert R.BITS == {"sig4": 4}


def test_the_control_rounds_the_reference_it_reads_against():
    """At 52 bits the rounded reference is the reference itself."""
    from cwtbench.reference import cwt_f64
    from cwtbench.reference import cwt_rounded_f64 as R

    x = torch.randn(NFFT, generator=torch.Generator().manual_seed(SEED), dtype=torch.float64)
    sc = cwt_f64.scale_grid(8, 1.0, 0.25, 2.0)
    kw = dict(dt=1.0, nfft=NFFT, f0=6.0)
    ref = cwt_f64.power_sum(x, sc, **kw)
    assert torch.allclose(R.power_sum(x, sc, bits=52, **kw), ref, rtol=1e-14, atol=0)
    gap = float(((R.power_sum(x, sc, bits=4, **kw) - ref).abs() / ref).max())
    assert 1e-4 < gap < 1e-1


@pytest.mark.parametrize("rel", NEW_FILES)
def test_the_new_files_import_no_jax(rel):
    from test_cwtbench_imports import _imports

    path = os.path.join(REPO, "cwtbench", rel)
    assert not _imports(path) & set(harness.FORBIDDEN)
    if rel.startswith("reference/"):
        assert _imports(path) <= {"__future__", "math", "torch"}
        with open(path) as f:
            assert "pycwt" not in f.read()


def test_the_traffic_is_the_f32_cells():
    """The cells' records and loops are those of the f32 cells, through
    entries that widen theirs."""
    import json

    for new, old in (("gws_1m_fast", "gws_1m"), ("w_4m_fast", "w_4m")):
        with open(os.path.join(REPO, "cwtbench", "traffic", f"{new}.json")) as f:
            a = json.load(f)
        with open(os.path.join(REPO, "cwtbench", "traffic", f"{old}.json")) as f:
            b = json.load(f)
        assert a["inputs"] == b["inputs"] and a["loop"] == b["loop"]
        assert a["entry"] == b["entry"] + "_fast"

"""The ``fast`` tier against the benchmark's float64 reference
(``cwtbench/reference/cwt_f64.py``) at nfft 2^14, the smallest nfft where
pycwt_tpu keeps a bf16 T, on T&C's grid cut to 40 scales (the largest
spans ~1.5 bins of the spectrum, as the 64th does at 2^20): the global
spectrum and complex W of the plain version within the limits of the cells
``cwt_fast_1m`` and ``cwt_fast_w_4m``, and the control one precision
below (the filtered spectrum rounded to 4 significant bits) outside them;
the counters of T's points by element type; and the bound of K1 and K2
with T at 2 bytes."""
import json
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import kernel_bounds, kernel_bounds_t16, peaks
from cwtbench.reference import cwt_f64
from cwtbench.reference import cwt_rounded_f64 as rounded
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops.mxu_dft import fft_of_real_planar
from pycwt_torch.transform import build_scale_grid, cwt_batch
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFFT = 1 << 14
S = 40
KW = dict(dt=1.0, nfft=NFFT, f0=6.0)


def _limit(cell: str) -> float:
    with open(os.path.join(ROOT, "cwtbench", "cells", f"{cell}.json")) as f:
        (lim,) = json.load(f)["limits"].values()
    return lim


@pytest.fixture(autouse=True)
def counters_off():
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


@pytest.fixture(scope="module")
def record():
    x = torch.randn(NFFT, generator=torch.Generator().manual_seed(31),
                    dtype=torch.float32)
    grid = build_scale_grid(NFFT, 1.0, dj=0.25, s0=2.0, J=S - 1, mother=pt.Morlet(6))
    scales = torch.as_tensor(grid.sj, dtype=torch.float32)
    ref_scales = cwt_f64.scale_grid(S, 1.0, 0.25, 2.0)
    np.testing.assert_allclose(scales.numpy(), ref_scales.numpy(), rtol=1e-7)
    return x, scales, ref_scales


def _power_gap(got, ref):
    return float(((got.double() - ref).abs() / ref).max())


def _w_gap(blocks_of_got, x, ref_scales):
    num = den = 0.0
    for (lo, hi, ref), got in zip(cwt_f64.transform_blocks(x, ref_scales, block=8, **KW),
                                  blocks_of_got):
        num = max(num, float((got.to(torch.complex128) - ref).abs().max()))
        den = max(den, float(ref.abs().max()))
    return num / den


def test_fast_power_sum_within_the_cells_limit_and_the_control_outside(record):
    x, scales, ref_scales = record
    lim = _limit("cwt_fast_1m")
    sr, si = fft_of_real_planar(x[None], NFFT, half=True)
    got = fc.fused_cwt_planar(sr, si, scales, mother=pt.Morlet(6), nfft=NFFT, dt=1.0,
                              output="power_sum", precision="fast")[0]
    ref = cwt_f64.power_sum(x, ref_scales, **KW)
    program = _power_gap(got, ref)
    control = _power_gap(rounded.power_sum(x, ref_scales, bits=4, **KW), ref)
    high = _power_gap(fc.fused_cwt_planar(sr, si, scales, mother=pt.Morlet(6), nfft=NFFT,
                                          dt=1.0, output="power_sum", precision="high")[0],
                      ref)
    print(f"power_gap: high {high:.3e}, fast {program:.3e}, control {control:.3e}")
    assert high < program < lim / 2
    assert control > 3 * lim


def test_fast_complex_w_within_the_cells_limit_and_the_control_outside(record):
    x, scales, ref_scales = record
    lim = _limit("cwt_fast_w_4m")
    W, _ = cwt_batch(x[None], scales, 1.0, mother=pt.Morlet(6), nfft=NFFT,
                     config=CWTConfig(precision="fast", engine="planar"))
    assert W.dtype == torch.complex64 and W.shape == (1, S, NFFT)
    program = _w_gap((W[0, lo:lo + 8] for lo in range(0, S, 8)), x, ref_scales)
    control = _w_gap((b for _, _, b in rounded.transform_blocks(x, ref_scales, bits=4,
                                                                block=8, **KW)),
                     x, ref_scales)
    print(f"w_gap: fast {program:.3e}, control {control:.3e}")
    assert program < lim / 2
    assert control > 3 * lim
    assert profiling.T_BF16_POINTS == S * NFFT and profiling.T_F32_POINTS == 0


@pytest.mark.parametrize("tier", ["highest", "high", "fast"])
def test_t_points_are_counted_by_element_type(record, tier):
    """rows × R1 × R2 a launch of stage_a: bf16 alone at ``fast``, f32
    alone at the other tiers; ``enable_spans`` sets both to 0."""
    x, scales, _ = record
    sr, si = fft_of_real_planar(torch.stack([x, x.flip(0)]), NFFT, half=True)
    for _ in range(2):
        fc._FusedCWT.apply(sr, si, scales[:5], pt.Morlet(6), NFFT, 1.0, "power_sum", tier)
    points = 2 * 2 * 5 * NFFT
    fast = tier == "fast"
    assert (profiling.T_BF16_POINTS, profiling.T_F32_POINTS) == (
        points if fast else 0, 0 if fast else points)
    R1, R2 = fc._nfft_factors(NFFT)
    tr, _ = fc.stage_a(sr, si, scales[:3], mother=pt.Morlet(6), nfft=NFFT, dt=1.0,
                       t_dtype=fc._t_dtype(tier))
    assert tr.shape == (2 * 3, R1, R2)
    assert profiling.T_BF16_POINTS + profiling.T_F32_POINTS == points + 2 * 3 * R1 * R2
    profiling.enable_spans()
    assert profiling.T_BF16_POINTS == profiling.T_F32_POINTS == 0
    profiling.disable_spans()


def test_the_plain_high_path_makes_no_t(record):
    """On the CPU, ``high`` runs the one-pass plain version: no T to count."""
    x, scales, _ = record
    sr, si = fft_of_real_planar(x[None], NFFT, half=True)
    fc.fused_cwt_planar(sr, si, scales, mother=pt.Morlet(6), nfft=NFFT, dt=1.0,
                        output="power_sum", precision="high")
    assert profiling.T_BF16_POINTS == profiling.T_F32_POINTS == 0


BENCH = {"kind": "cwt", "B": 1, "n0": 2 ** 20, "nfft": 2 ** 20, "S": 64,
         "output": "power_sum", "kernel_output": "power_sum"}


def test_the_bound_with_t_at_2_bytes_by_hand():
    """K1-bf16 at the bench shape: 0.0814 ms (PERF.md's kernel table), its
    bytes the half spectrum's two f32 planes, 64 scales and T's two bf16
    planes; T's bytes half those of ``kernel_bounds.k1_k2``."""
    b16 = kernel_bounds_t16.k1_k2(BENCH, 2 ** 19, t_bytes=2)
    assert b16["cwt_stage_a"] * 1e3 == pytest.approx(0.0814, rel=1e-2)
    assert b16["cwt_stage_b"] * 1e3 == pytest.approx(0.0801, rel=1e-2)
    b32 = kernel_bounds.k1_k2(BENCH, 2 ** 19)
    t32 = 2 * 64 * 2 ** 20 * 4
    for k in ("cwt_stage_a", "cwt_stage_b"):
        # both bytes-bound: the difference is half of T's f32 bytes
        assert (b32[k] - b16[k]) * peaks.HBM_BYTES_S == pytest.approx(t32 / 2)
    assert kernel_bounds_t16.k1_k2(BENCH, 2 ** 19, t_bytes=4) == pytest.approx(b32)

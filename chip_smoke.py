"""Smoke run of the PyTorch port on one NVIDIA card: build, check, time.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``pycwt_torch/csrc/``, holds each
one against its plain PyTorch version on the card, drives the forward-CWT
main path through the entry points a user calls (``cwt``, ``cwt_power``,
and the 2^20-point, 64-scale ``fft_of_real_planar`` → ``fused_cwt_planar``
pipeline), checks the results against the NINO3 golden and the plain
version, times the kernels with CUDA events, and prints one JSON line of
kernel numbers and, last, one JSON ``ok`` line.  Any failure raises: the
exit code is then non-zero and no ``ok`` line is printed.  Without a CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
#: precision tier -> bound relative to max|W| (tests/test_pallas.py:33, :198, :276)
TIER_BOUND = {"highest": 1e-5, "high": 2e-4, "fast": 2e-2}
SIZES = [1 << p for p in (8, 10, 13, 14, 16, 20)]
OUTPUTS = ("planes", "power", "power_sum")
KERNEL_SOURCE = "pycwt_torch/csrc/fused_cwt.cu"


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    """Max relative error with an absolute floor (as tests/conftest.py)."""
    a = np.asarray(a)
    b = np.asarray(b)
    denom = np.maximum(np.abs(b), 1e-300)
    mask = np.abs(b) > 1e-12 * np.nanmax(np.abs(b))
    err = np.abs(a - b) / denom
    return float(err[mask].max()) if mask.any() else float(np.abs(a - b).max())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, runs=11, warmup=2):
    """Median of ``runs`` CUDA-event timings of ``fn()`` after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def phase_build():
    from pycwt_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        usage = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  nvcc {name}: {secs:.2f} s; " + " | ".join(usage))


def _inputs(nfft, half, B, S, seed):
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    x = torch.tensor(np.random.default_rng(seed).standard_normal((B, nfft)),
                     dtype=torch.float32, device="cuda")
    sr, si = fft_of_real_planar(x, nfft, half=half)
    # scales 2 .. 2·nfft^(3/4): DOG's f^m stays finite in f32
    sc = 2.0 * 2 ** (np.arange(S) * (0.75 * math.log2(nfft) / (S - 1)))
    return sr, si, torch.tensor(sc, dtype=torch.float32, device="cuda")


def phase_kernels_vs_plain():
    """Every size, mother, spectrum, output and tier against the plain
    version; B = 2 against two single-signal calls, bit for bit."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    worst = {tier: 0.0 for tier in TIER_BOUND}
    mothers = [pt.Morlet(6), pt.Paul(4), pt.DOG(2), pt.DOG(6)]
    for nfft in SIZES:
        for m in mothers:
            for half in ((False, True) if m.analytic_negligible_negative() else (False,)):
                sr, si, sc = _inputs(nfft, half, 2, 4, seed=nfft)
                kw = dict(mother=m, nfft=nfft, dt=1.0)
                rr, ri = fc._fused_cwt_planar_reference(sr, si, sc, **kw)
                scale_w = float(torch.sqrt(rr * rr + ri * ri).max())
                for output in OUTPUTS:
                    ref = fc._epilogue(rr, ri, output)
                    for tier in TIER_BOUND:
                        got = fc.fused_cwt_planar(sr, si, sc, output=output,
                                                  precision=tier, **kw)
                        if output == "planes":
                            err = max(float((got[0] - rr).abs().max()),
                                      float((got[1] - ri).abs().max())) / scale_w
                        else:
                            err = float((got - ref).abs().max() / ref.abs().max())
                        check(math.isfinite(err) and err < TIER_BOUND[tier],
                              f"{nfft} {m} half={half} {output} {tier}: {err}")
                        worst[tier] = max(worst[tier], err)
                    singles = [fc.fused_cwt_planar(sr[b], si[b], sc, output=output, **kw)
                               for b in range(2)]
                    if output == "planes":
                        same = all(torch.equal(got[i][b], singles[b][i])
                                   for b in range(2) for i in range(2))
                    else:
                        same = all(torch.equal(got[b], singles[b]) for b in range(2))
                    check(same, f"batch != singles at {nfft} {m} {output}")
        log(f"kernels vs plain, nfft={nfft}: ok (worst so far {worst})")
    check(all(v > 0 for v in fc.KERNEL_LAUNCHES.values()),
          f"kernel counters did not advance: {fc.KERNEL_LAUNCHES}")
    return worst


def phase_public_path():
    """cwt and cwt_power on NINO3 under the default engine (the kernels),
    against the f64 golden; an icwt_planar round trip."""
    import pycwt_torch as pt
    from pycwt_torch.api import _cwt_planar_parts
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.transform import icwt_planar

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                             "golden", "cwt_nino3_morlet6.npz"))
    dt = float(g["dt"])
    fc.KERNEL_LAUNCHES.update(cwt_stage_a=0, cwt_stage_b=0)
    W, sj, *_ = pt.cwt(g["signal"], dt)
    power, sj2, *_ = pt.cwt_power(g["signal"], dt)
    launches = dict(fc.KERNEL_LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"cwt/cwt_power did not launch both kernels: {launches}")
    ref = np.abs(g["W"]) ** 2
    e_cwt = rel_err(np.abs(W) ** 2, ref)
    e_pow = rel_err(power, ref)
    check(W.shape == g["W"].shape and np.isfinite(W).all(), "cwt shape/finite")
    check(e_cwt < 5e-3 and e_pow < 5e-3, f"NINO3 golden: {e_cwt}, {e_pow}")

    t = np.arange(512) * 0.25
    x = np.sin(2 * np.pi * t / 16) + 0.5 * np.sin(2 * np.pi * t / 4)
    x = (x - x.mean()) / x.std()
    wr, _, sjr, _, _ = _cwt_planar_parts(x, 0.25, dj=1 / 24)
    xr = icwt_planar(torch.tensor(wr, device="cuda"), sjr, 0.25, 1 / 24,
                     mother=pt.Morlet(6)).cpu().numpy()
    snr = 10 * np.log10(np.mean(x ** 2) / np.mean((x - xr) ** 2))
    check(snr > 20, f"icwt_planar round trip SNR {snr}")
    log(f"public path: cwt |W|^2 rel_err {e_cwt:.3e}, cwt_power {e_pow:.3e} "
        f"(bound 5e-3), icwt_planar SNR {snr:.1f} dB, launches {launches}")


def _bounds(nfft, S, n_in, R1, R2):
    """(bytes, ops) of each kernel at this shape: inputs read once, outputs
    written once; radix-2 FFT at 5·R·log2 R flops, complex multiplies at 6."""
    rows_a = n_in // R1
    a_bytes = 2 * n_in * 4 + S * 4 + 2 * S * nfft * 4
    a_ops = S * (rows_a * R1 * 6 + R1 * 5 * R2 * math.log2(R2) + nfft * 6)
    b_bytes = 2 * S * nfft * 4 + S * 4
    b_ops = S * (R2 * 5 * R1 * math.log2(R1) + nfft * 5)
    return (a_bytes, a_ops), (b_bytes, b_ops)


def _bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bench_shape():
    """The main path at its real size: 2^20 f32 points, 64 scales, Morlet-6,
    fft_of_real_planar(half=True) → fused_cwt_planar(output="power_sum")."""
    import pycwt_torch as pt
    from pycwt_torch.config import DEFAULT
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar
    from pycwt_torch.transform import build_scale_grid

    N0, S, dt = 1 << 20, 64, 1.0
    mother = pt.Morlet(6)
    grid = build_scale_grid(N0, dt, dj=0.25, s0=2.0, J=S - 1)
    check(len(grid.sj) == S, "scale grid size")
    x = torch.tensor(np.random.default_rng(0).standard_normal(N0),
                     dtype=torch.float32, device="cuda")
    scales = torch.tensor(grid.sj, dtype=torch.float32, device="cuda")
    kw = dict(mother=mother, nfft=N0, dt=dt)

    def pipeline():
        sr, si = fft_of_real_planar(x, N0, half=True)
        return fc.fused_cwt_planar(sr, si, scales, precision=DEFAULT.precision,
                                   output="power_sum", **kw)

    fc.KERNEL_LAUNCHES.update(cwt_stage_a=0, cwt_stage_b=0)
    pw = pipeline()
    torch.cuda.synchronize()
    launches = dict(fc.KERNEL_LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"main path did not launch both kernels: {launches}")

    sr, si = fft_of_real_planar(x, N0, half=True)
    ref = fc._fused_cwt_planar_reference(sr, si, scales, output="power_sum", **kw)
    check(pw.shape == (S,) and bool(torch.isfinite(pw).all()), "power_sum shape/finite")
    e_pipe = float((pw - ref).abs().max() / ref.abs().max())
    check(e_pipe < TIER_BOUND["highest"], f"bench pipeline vs plain: {e_pipe}")

    R1, R2 = fc._nfft_factors(N0)
    X2 = (sr[None], si[None])
    T = fc.stage_a(*X2, scales, **kw)
    T_ref = fc._stage_a_reference(*X2, scales, **kw)
    err_a = max(float((T[0] - T_ref[0]).abs().max()), float((T[1] - T_ref[1]).abs().max()))
    scale_a = float(torch.sqrt(T_ref[0] ** 2 + T_ref[1] ** 2).max())
    del T_ref
    out_b = fc.stage_b(*T, nfft=N0, output="power_sum")
    ref_b = fc._stage_b_reference(*T, nfft=N0, output="power_sum")
    err_b = float((out_b - ref_b).abs().max())
    # absolute tolerances: 1e-5 (the `highest` tier) of the plain version's max
    tol_a = 1e-5 * scale_a
    tol_b = 1e-5 * float(ref_b.abs().max())
    check(err_a <= tol_a, f"stage A vs plain: {err_a} > {tol_a}")
    check(err_b <= tol_b, f"stage B vs plain: {err_b} > {tol_b}")
    del ref_b

    ms_a = time_ms(lambda: fc.stage_a(*X2, scales, **kw))
    ms_b = time_ms(lambda: fc.stage_b(*T, nfft=N0, output="power_sum"))
    ms_pipe = time_ms(pipeline)
    plain_a = time_ms(lambda: fc._stage_a_reference(*X2, scales, **kw), runs=10, warmup=1)
    plain_b = time_ms(lambda: fc._stage_b_reference(*T, nfft=N0, output="power_sum"),
                      runs=10, warmup=1)
    plain_pipe = time_ms(lambda: fc._fused_cwt_planar_reference(
        *fft_of_real_planar(x, N0, half=True), scales, output="power_sum", **kw),
        runs=10, warmup=1)
    del T
    # library_ms: one cuFFT call over the pre-filtered (S, N) product, the
    # work both kernels together do apart from the filter and epilogue.
    from pycwt_torch.ops.filterbank import angular_frequencies, filter_bank
    spec = torch.complex(*fft_of_real_planar(x, N0))
    prod = spec[None] * filter_bank(mother, scales, angular_frequencies(
        N0, dt, torch.float32, "cuda"), dt).to(torch.complex64)
    lib_ms = time_ms(lambda: torch.fft.ifft(prod, dim=-1), runs=10, warmup=1)
    del prod, spec

    (a_bytes, a_ops), (b_bytes, b_ops) = _bounds(N0, S, sr.shape[-1], R1, R2)
    bound_a, by_a = _bound_ms(a_bytes, a_ops)
    bound_b, by_b = _bound_ms(b_bytes, b_ops)
    rate = N0 * S / (ms_pipe * 1e-3)
    log(f"bench shape N=2^20 S=64 Morlet-6 power_sum tier={DEFAULT.precision}: "
        f"pipeline {ms_pipe:.4f} ms ({rate:.4e} sample-scales/s), "
        f"cwt_stage_a {ms_a:.4f} ms (bound {bound_a:.4f}), "
        f"cwt_stage_b {ms_b:.4f} ms (bound {bound_b:.4f}), "
        f"plain pipeline {plain_pipe:.4f} ms, cuFFT ifft of the product {lib_ms:.4f} ms, "
        f"pipeline vs plain {e_pipe:.3e}")
    return dict(
        launches=launches, ms_a=ms_a, ms_b=ms_b, plain_a=plain_a, plain_b=plain_b,
        bound_a=bound_a, by_a=by_a, bound_b=bound_b, by_b=by_b, err_a=err_a,
        err_b=err_b, tol_a=tol_a, tol_b=tol_b, lib_ms=lib_ms, ms_pipe=ms_pipe,
        plain_pipe=plain_pipe, rate=rate, bytes_a=a_bytes, bytes_b=b_bytes)


def phase_gradient():
    """Gradients through the kernels' autograd Function equal those through
    the plain version (tests/test_autodiff.py:85-88)."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    nfft = 1 << 14
    x0 = np.random.default_rng(3).standard_normal(nfft)

    def grads(fn):
        x = torch.tensor(x0, dtype=torch.float32, device="cuda", requires_grad=True)
        sc = torch.tensor([4.0, 16.0, 64.0], device="cuda", requires_grad=True)
        sr, si = fft_of_real_planar(x, nfft)
        return torch.autograd.grad(fn(sr, si, sc).sum() / nfft, (x, sc))

    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output="power_sum")
    gx, gs = grads(lambda sr, si, sc: fc.fused_cwt_planar(sr, si, sc, **kw))
    rx, rs = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    ex = float((gx - rx).abs().max() / rx.abs().max())
    es = float(((gs - rs).abs() / rs.abs()).max())
    check(ex <= 1e-4 and es <= 1e-4, f"gradients: x {ex}, scales {es}")
    log(f"gradient through kernels vs plain: x {ex:.3e}, scales {es:.3e} (bound 1e-4)")


def main():
    card = phase_device()
    t0 = time.perf_counter()
    phase_build()
    worst = phase_kernels_vs_plain()
    phase_public_path()
    bench = phase_bench_shape()
    phase_gradient()
    common = dict(route="cuda", source=KERNEL_SOURCE, library_ms=bench["lib_ms"],
                  library_call="torch.fft.ifft of the filtered (64, 2^20) complex64 product",
                  max_rel_err_by_tier=worst, shape="N=2^20, S=64, Morlet-6, power_sum",
                  card=card)
    kernels = [
        dict(name="cwt_stage_a", replaces="pycwt_tpu/ops/pallas_fft.py:252",
             tpu_kernel="_make_kernel_a (K1)", launches=bench["launches"]["cwt_stage_a"],
             max_abs_err=bench["err_a"], tolerance=bench["tol_a"],
             ms=bench["ms_a"], plain_ms=bench["plain_a"],
             bound_ms=bench["bound_a"], bound_by=bench["by_a"],
             bound_bytes=bench["bytes_a"], **common),
        dict(name="cwt_stage_b", replaces="pycwt_tpu/ops/pallas_fft.py:289",
             tpu_kernel="_make_kernel_b (K2)", launches=bench["launches"]["cwt_stage_b"],
             max_abs_err=bench["err_b"], tolerance=bench["tol_b"],
             ms=bench["ms_b"], plain_ms=bench["plain_b"],
             bound_ms=bench["bound_b"], bound_by=bench["by_b"],
             bound_bytes=bench["bytes_b"], **common),
    ]
    log(json.dumps({"pipeline_ms": bench["ms_pipe"], "plain_pipeline_ms": bench["plain_pipe"],
                    "sample_scales_per_s": bench["rate"],
                    "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()

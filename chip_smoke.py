"""Smoke run of the PyTorch port on one NVIDIA card: build, check, time.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``pycwt_torch/csrc/`` (one ``nvcc``
per source, started together) and holds each one against its plain PyTorch
version on the card.  It then drives two paths through the entry points a
user calls, each with the launch counters set to 0 just before and read
just after:

* the forward-CWT main path (``cwt``, ``cwt_power``, and the 2^20-point,
  64-scale ``fft_of_real_planar`` → ``fused_cwt_planar`` pipeline) on
  ``cwt_stage_a`` + ``cwt_stage_b``;
* the ``fast`` tier's bf16 T (``phase_public_fast``, the bench shape):
  ``cwt`` with ``CWTConfig(precision="fast")`` on a seeded 2^20-point
  signal and the bench pipeline at ``fast``, each on ``cwt_stage_a_bf16`` +
  ``cwt_stage_b_bf16`` alone, against the bf16 and the f32 plain versions;
  the bf16 K1's T against the plain T rounded and the f32 K1's T rounded,
  the bf16 K2 against its plain version and the f32 K2 on the widened T;
  both bf16 kernels timed beside the f32 ones at the bench shape and at
  every nfft of the column plans, and every tier of every size of
  ``phase_kernels_vs_plain`` (``fast`` also against the bf16 plain version);
* K2's epilogues (``phase_stage_b_complex``) at 2^20 × 64, 2^22 × 16 and
  2^22 × 64 on an f32 and a bf16 T: ``complex`` against ``torch.complex`` of
  ``planes`` bit for bit, and the device time of ``complex``, ``planes``
  and ``planes`` plus that assembly;
* the statistics / XWT / WCT path (``xwt``, ``xwt_planar``,
  ``wct(sig=False)``, ``cwt_analysis``, ``xwt_analysis``, ``wct_analysis``)
  on the default route and on the ``PYCWT_TPU_SMALL_KERNEL=1`` route through
  ``cwt_direct``, against the goldens, and a 4,000-point WCT pair on both;
* the Monte-Carlo significance (``wct_significance`` on both routes,
  ``wct_significance_batch``, ``wct_analysis(sig=True)``) on the golden
  JAO/JBaltic null at 300 members, against the golden's bands, bit for bit
  across ``mc_batch`` and ``pair_block``, timed, with its peak memory;
* the all-pairs path on a 32-station AR(1) network (``wct_matrix`` on both
  kernel routes, ``wct_pairs``, ``xwt_pairs``, ``xwt_pairs_planar``, and
  ``wct_matrix_analysis`` with 300-member nulls, cold and warm) against the
  CPU f64 port, with peak bytes a pair against the blocking model;
* the overlap-save long-signal surfaces (``ops/overlap.py``) at N = 2^22
  against the global transform and timed at N = 2^24, 64 scales, chunk
  2^18, with their launches and peak memory;
* DOG(6) at scales where f^6 overflows f32, through K1+K2 and K3;
* parity mode (``cwt_twofloat``, ``xwt_twofloat``, ``wct_twofloat``) in
  native f64 against the goldens and, at 2^20 samples × 64 scales, against
  the CPU f64 port, timed beside the f32 K1+K2 planes path, with no kernel
  launched;
* gradients through the coherence stack (``_wct_core`` on the planar route
  through K1+K2 and through ``cwt_direct``, the f64 route against finite
  differences, the lag-fitting loop);
* ``utils/profiling`` (a trace naming both kernels, ``PhaseTimer``) and
  ``enable_compilation_cache`` in two child processes;
* ``pycwt_torch.parallel`` (``phase_parallel``) in child processes of this
  script (``--parallel-rank RANK WORLD BACKEND DIR``): every sharded surface
  on one NCCL rank against the unsharded port, then on four ranks sharing
  the card over gloo, each rank's block against the one-rank result
  (the rank-side scenarios are ``tests/test_torch_parallel_support.py``'s);
* the three example workflows (``pycwt_torch/examples/``: ``sample_cwt``
  on the five datasets, ``sample_xwt`` with its 300-member null,
  ``sample_network`` on 8 stations) at their defaults, each ``run(...)`` on
  both kernel routes against the CPU f64 port and the goldens, timed cold
  and warm, ``sample_xwt.run`` traced, then each script once as a child
  process;
* the forward-spectrum rule and the matmul pin (``phase_repairs``): the
  five records' |W|² through ``cwt`` (and Mauna Loa's through
  ``cwt_batch`` and one-rank ``sharded_cwt``) and the 8-station network's
  maps against the CPU f64 port, the MC curve bit for bit across
  ``mc_batch`` 1/7/64/300 and ``pair_block``, the WCT, the MC curve, the
  32-station maps and a coherence gradient bit for bit under TF32 and
  bf16 process settings, and the f64 spectrum's device cost;
* ``cwt_stage_b``'s ablation variants (``phase_relayout``, the counterpart
  of ``tools/tpu_relayout_experiment.py``): the entry point
  ``pycwt_torch.tools.relayout_experiment.run`` at 2^20 × 64 and 2^22 × 16,
  ``full`` bit for bit with ``cwt_stage_b``'s planes, ``memcopy`` exact and
  the others within 1e-5 of their plain versions, each variant's and each
  bf16-T instantiation's registers and spills, the library's f32 kernels'
  registers and spills against ``PTXAS_BEFORE``, and cuFFT's column
  ``ifft`` over T beside them.

K1 and K2 are checked at every column radix plan from 16 to 2048 points
(nfft 2^8 to 2^22), and lightly at 4096 and 8192 (2^24, 2^26).  It times K1
and K2 at the 2^20-point bench shape with CUDA events and by
``torch.profiler`` device time per call, each nfft's column plans beside
K1's and K2's device time, and ``cwt_direct``, the K1+K2 pair and the
``torch.fft.ifft`` yardstick at the K3 sizes by device time (CUDA-event
times of one call stand beside them as ``wall_ms``).  It prints one JSON
line of kernel numbers and, last, one JSON ``ok`` line.  ``--trace`` profiles
the 4,000-point WCT and a 300-member Monte-Carlo run on both routes, the
32-station ``wct_matrix`` and ``wct_matrix_analysis``, two overlap-save
surfaces at N = 2^24, parity mode's 2^20 × 64 f64 transform and one cold
and one warm ``sample_xwt.run`` on each route instead;
``--ab PARENT`` times the 4,000-point WCT and its smoothing, the
300-member MC run, the 2^24 overlap-save CWT and the bench-shape pipeline
for an unpacked parent tree and this one in turns, and holds the two
trees' ``highest`` and ``high`` outputs bit for bit (``_tier_digests``);
``--stage-b-complex`` builds, runs ``phase_stage_b_complex`` and holds the
f32 kernels' registers and spills against ``PTXAS_BEFORE``, alone;
``--mc-generator`` builds and runs ``phase_mc_generator`` (the MC
generator's kernels against its torch code on the card, timed), alone;
``--mc-histogram`` builds and runs ``phase_mc_histogram`` (the MC counts
kernel against the torch tail at both MC cells' chunk shapes, timed),
alone.
Any failure raises: the exit code is then non-zero and no ``ok`` line is
printed.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
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
#: nfft of the K1/K2 checks: every column plan from R = 16 to 2048 in both
#: kernels (cwt_stage_a's length-R2 columns, cwt_stage_b's length-R1 ones)
SIZES = [1 << p for p in (8, 9, 10, 11, 13, 14, 16, 18, 20, 22)]
#: nfft whose columns are 4096 and 8192 points long: checked lightly
LARGE_SIZES = [1 << 24, 1 << 26]
DIRECT_SIZES = [1 << p for p in range(8, 13)]
OUTPUTS = ("planes", "power", "power_sum")
KERNEL_SOURCE = "pycwt_torch/csrc/fused_cwt.cu"
DIRECT_SOURCE = "pycwt_torch/csrc/direct_cwt.cu"
MC_SOURCE = "pycwt_torch/csrc/mc_noise.cu"
MC_HIST_SOURCE = "pycwt_torch/csrc/mc_hist.cu"
WCT_HEAD_SOURCE = "pycwt_torch/csrc/wct_head.cu"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
#: f32 bounds of the slice's path against the f64 goldens (rel_err):
#: tests/test_tpu_chip.py:43, tests/test_engines.py:170, :156
XWT_BOUND, WCT_BOUND, CWT_BOUND = 1.9e-3, 1e-3, 5e-3


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


def _events_ms(fn):
    """(CUDA-event ms of one call of ``fn()``, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def time_ms(fn, runs=11, warmup=2):
    """Median of ``runs`` CUDA-event timings of ``fn()`` after a warm-up."""
    for _ in range(warmup):
        fn()
    return float(np.median([_events_ms(fn)[0] for _ in range(runs)]))


def _device_rows(prof, calls, required=True):
    """(ms per call, launches per call, name) of every device kernel in a
    torch.profiler run of ``calls`` calls; operators' rows, which repeat
    their kernels' time, are left out."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and dev > 0:
            rows.append((dev / calls / 1e3, e.count / calls, e.key))
    rows.sort(reverse=True)
    check(rows or not required, "the profiler saw no device time")
    return rows


def device_ms(fn, calls=50, warmup=3, tries=3, floor=0.0):
    """Device time of one call of ``fn()``: the kernel times that
    torch.profiler (CUPTI) records over ``calls`` calls, summed, per call.
    At these sizes a CUDA-event time around a call is mostly host time.  A
    profile that recorded no device activity at all (seen once in a few
    hundred on the H100), or less than ``floor`` ms a call (the work's
    bound: the profile lost kernels), is taken again, up to ``tries``
    times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        last = attempt == tries - 1
        rows = _device_rows(prof, calls, required=last)
        ms = sum(r[0] for r in rows)
        check(ms >= floor or not last,
              f"the profiler recorded {ms} ms a call, below the bound {floor} ms")
        if rows and ms >= floor:
            return ms


def _reset_counts():
    from pycwt_torch.ops import fused_cwt as fc

    for name in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[name] = 0


def _four_step_only(launches, bf16=False):
    """Both four-step kernels launched (their bf16-T forms if ``bf16``, and
    then the f32 ones not) and the direct one not."""
    a, b = ("cwt_stage_a_bf16", "cwt_stage_b_bf16") if bf16 else ("cwt_stage_a",
                                                                  "cwt_stage_b")
    return (launches[a] > 0 and launches[b] > 0 and launches["cwt_direct"] == 0
            and (not bf16 or launches["cwt_stage_a"] == launches["cwt_stage_b"] == 0))


def _bf16_plain(sr, si, sc, *, output, **kw):
    """The ``fast`` tier's plain version: stage A's with T rounded to bf16,
    then stage B's, in fused_cwt_planar's shapes ((B, S, ...) for (B, n)
    spectra)."""
    from pycwt_torch.ops import fused_cwt as fc

    T = fc._stage_a_reference(sr, si, sc, t_dtype=torch.bfloat16, **kw)
    out = fc._stage_b_reference(*T, nfft=kw["nfft"], output=output)
    shape = (sr.shape[0], sc.shape[0]) + ((kw["nfft"],) if output != "power_sum" else ())
    return tuple(o.reshape(shape) for o in out) if output == "planes" else out.reshape(shape)


def _ulps(a, b):
    """bf16 units in the last place between ``a`` and ``b``, elementwise
    (the distance of their bit patterns in the order of the values)."""
    def key(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (key(a) - key(b)).abs()


def _spacing(x):
    """The bf16 spacing at |x| (x bf16): 2^(e - 8) for |x| in [2^(e-1),
    2^e), 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                                e - 8))


def _t16_vs_plain(t16, plain32, scale):
    """cwt_stage_a_bf16's T plane ``t16`` against the plain f32 T plane
    rounded to bf16: (elements that differ, elements more than one bf16 ulp
    apart, max |difference| less one ulp and the f32 T's own 1e-5 of
    ``scale`` = max|T|; at most 0 when every element is within one ulp, or,
    far below max|T|, within the f32 T's error beyond it)."""
    pp = plain32.to(torch.bfloat16)
    gap = (t16.float() - pp.float()).abs()
    room = torch.maximum(_spacing(t16), _spacing(pp)) + 1e-5 * scale
    return (int((t16 != pp).sum()), int((_ulps(t16, pp) > 1).sum()),
            float((gap - room).max()))


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


def _ptxas_usage(out):
    """(kernel, registers and spills) of each entry function in ``nvcc
    -Xptxas -v`` output, the kernel named with its template arguments:
    ``cwt_stage_b<10>`` for the f32 kernel every caller but ``fast`` runs,
    ``cwt_stage_b<10, bf16>`` for its bf16-T instantiation,
    ``cwt_stage_b<10, memcopy>`` for an ablation variant,
    ``cwt_stage_b<10, complex>`` for the complex epilogue's."""
    from pycwt_torch.ops import fused_cwt as fc

    # a parent tree given to --ab may predate the ablation variants
    variant = {str(i): name for name, i in getattr(fc, "ABLATIONS", {}).items()}
    rows, name = [], None
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d(cwt_[a-z_]+?)_kernel(?:ILi(\d+)E(?:Li(\d+)E)?)?",
                          m.group(1))
            args = [k.group(2)] if k and k.group(2) else []
            if k and k.group(3) not in (None, "0"):
                args.append(variant[k.group(3)])
            if k and "__nv_bfloat16" in m.group(1):
                args.append("bf16")
            if k and "Lb1E" in m.group(1):
                args.append("complex")
            name = (k.group(1) + (f"<{', '.join(args)}>" if args else "")
                    if k else m.group(1))
            rows.append([name, ""])
        elif name and ("spill" in ln or "registers" in ln):
            rows[-1][1] += ln.replace("ptxas info    :", "").strip() + "; "
    return rows


def phase_build():
    """Build every library; returns kernel -> its ``-Xptxas -v`` line (empty
    where the libraries were already built)."""
    from pycwt_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {time.perf_counter() - t0:.2f} s")
    usage = {}
    for name, (secs, out) in _build.BUILD_LOG.items():
        log(f"  nvcc {name}: done after {secs:.2f} s")
        for kernel, line in _ptxas_usage(out):
            log(f"    {kernel}: {line}")
            usage[kernel] = line
    return usage


#: (registers, spill-store bytes, spill-load bytes) of every kernel
#: instantiation before cwt_stage_b's ablation variants and the bf16-T
#: instantiations were added, and of the f32 cwt_stage_b's complex epilogue
#: as first built, as
#: ``nvcc -Xptxas -v`` of release PTXAS_RELEASE printed them for the
#: unchanged sources on an NVIDIA H100 80GB HBM3; the kernels the library
#: runs must keep them.
PTXAS_RELEASE = "12.9, V12.9.86"
PTXAS_BEFORE = {
    "cwt_direct<8>": (62, 0, 0), "cwt_direct<9>": (80, 0, 0),
    "cwt_direct<10>": (64, 0, 0), "cwt_direct<11>": (62, 0, 0),
    "cwt_direct<12>": (64, 4, 4),
    "cwt_stage_a<4>": (64, 76, 76), "cwt_stage_a<5>": (64, 0, 0),
    "cwt_stage_a<6>": (64, 32, 36), "cwt_stage_a<7>": (64, 32, 36),
    "cwt_stage_a<8>": (64, 84, 88), "cwt_stage_a<9>": (64, 20, 20),
    "cwt_stage_a<10>": (64, 48, 48), "cwt_stage_a<11>": (64, 52, 56),
    "cwt_stage_a<12>": (64, 84, 84), "cwt_stage_a<13>": (64, 20, 24),
    "cwt_stage_b<4>": (64, 0, 0), "cwt_stage_b<5>": (64, 0, 0),
    "cwt_stage_b<6>": (64, 0, 0), "cwt_stage_b<7>": (64, 0, 0),
    "cwt_stage_b<8>": (64, 0, 0), "cwt_stage_b<9>": (64, 16, 24),
    "cwt_stage_b<10>": (64, 8, 8), "cwt_stage_b<11>": (64, 0, 0),
    "cwt_stage_b<12>": (64, 0, 0), "cwt_stage_b<13>": (64, 8, 8),
    **{f"cwt_stage_b<{r}, complex>": (64, 0, 0) for r in range(4, 14)},
    "cwt_stage_b_reduce": (31, 0, 0),
}


def _ptxas_figures(line):
    """(registers, spill-store bytes, spill-load bytes) of a ptxas line."""
    def num(pattern):
        m = re.search(pattern, line)
        return int(m.group(1)) if m else 0

    return (num(r"Used (\d+) registers"), num(r"(\d+) bytes spill stores"),
            num(r"(\d+) bytes spill loads"))


def _nvcc_release():
    from pycwt_torch.ops import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    m = re.search(r"release (\S+ V\S+)", out)
    return m.group(1) if m else out.strip().splitlines()[-1]


def _inputs(nfft, half, B, S, seed):
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    x = torch.tensor(np.random.default_rng(seed).standard_normal((B, nfft)),
                     dtype=torch.float32, device="cuda")
    sr, si = fft_of_real_planar(x, nfft, half=half)
    # scales 2 .. 2·nfft^(3/4): DOG's f^m stays finite in f32
    sc = 2.0 * 2 ** (np.arange(S) * (0.75 * math.log2(nfft) / max(S - 1, 1)))
    return sr, si, torch.tensor(sc, dtype=torch.float32, device="cuda")


def phase_kernels_vs_plain():
    """Every size, mother, spectrum, output and tier against the f32 plain
    version, and ``fast`` (its bf16 T) also against the bf16 plain version;
    B = 2 against two single-signal calls of the same tier, bit for bit;
    the `highest` planes of the kernels and of the f32 plain version against
    the plain version in f64."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    worst = {tier: 0.0 for tier in TIER_BOUND}
    worst["fast_vs_bf16_plain"] = 0.0
    worst_at = ""
    vs_f64 = {"kernels": 0.0, "plain": 0.0}
    mothers = [pt.Morlet(6), pt.Paul(4), pt.DOG(2), pt.DOG(6)]
    for nfft in SIZES:
        for m in mothers:
            for half in ((False, True) if m.analytic_negligible_negative() else (False,)):
                sr, si, sc = _inputs(nfft, half, 2, 4, seed=nfft)
                kw = dict(mother=m, nfft=nfft, dt=1.0)
                rr, ri = fc._fused_cwt_planar_reference(sr, si, sc, **kw)
                scale_w = float(torch.sqrt(rr * rr + ri * ri).max())
                t64 = torch.complex(*fc._fused_cwt_planar_reference(
                    sr.double(), si.double(), sc.double(), **kw))
                for output in OUTPUTS:
                    ref = fc._epilogue(rr, ri, output)
                    plain16 = _bf16_plain(sr, si, sc, output=output, **kw)
                    for tier in TIER_BOUND:
                        got = fc.fused_cwt_planar(sr, si, sc, output=output,
                                                  precision=tier, **kw)
                        refs = [(tier, (rr, ri) if output == "planes" else ref)]
                        if tier == "fast":
                            refs.append(("fast_vs_bf16_plain", plain16))
                        for key, want in refs:
                            if output == "planes":
                                err = max(float((got[0] - want[0]).abs().max()),
                                          float((got[1] - want[1]).abs().max())) / scale_w
                            else:
                                err = float((got - want).abs().max() / want.abs().max())
                            check(math.isfinite(err) and err < TIER_BOUND[tier],
                                  f"{nfft} {m} half={half} {output} {key}: {err}")
                            if err > worst[key]:
                                worst[key] = err
                                worst_at = f"nfft {nfft} {m} half={half} {output}"
                        if output == "planes" and tier == "highest":
                            for key, w in (("kernels", got), ("plain", (rr, ri))):
                                e = float((torch.complex(*w).to(t64.dtype) - t64).abs().max()
                                          / t64.abs().max())
                                vs_f64[key] = max(vs_f64[key], e)
                        singles = [fc.fused_cwt_planar(sr[b], si[b], sc, output=output,
                                                       precision=tier, **kw)
                                   for b in range(2)]
                        if output == "planes":
                            same = all(torch.equal(got[i][b], singles[b][i])
                                       for b in range(2) for i in range(2))
                        else:
                            same = all(torch.equal(got[b], singles[b]) for b in range(2))
                        check(same, f"batch != singles at {nfft} {m} {output} {tier}")
                    del plain16
        log(f"kernels vs plain, nfft={nfft}: ok (worst so far {worst}, at {worst_at}; "
            f"planes vs the f64 plain version: {vs_f64})")
    check(_four_step_only(fc.KERNEL_LAUNCHES) and fc.KERNEL_LAUNCHES["cwt_stage_a_bf16"] > 0
          and fc.KERNEL_LAUNCHES["cwt_stage_b_bf16"] > 0,
          f"kernel counters did not advance: {fc.KERNEL_LAUNCHES}")
    return worst, vs_f64


def phase_large_columns():
    """cwt_stage_a/cwt_stage_b on 4096- and 8192-point columns (nfft 2^24 and
    2^26): one signal, one scale, Morlet-6, planes, against the plain
    version at the `highest` bound; their bf16-T forms (`fast`) against the
    bf16 plain version at the `fast` bound."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    errs = {}
    for nfft in LARGE_SIZES:
        sr, si, sc = _inputs(nfft, True, 1, 1, seed=nfft)
        kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
        for tier in ("highest", "fast"):
            if tier == "fast":
                rr, ri = _bf16_plain(sr, si, sc, output="planes", **kw)
            else:
                rr, ri = fc._fused_cwt_planar_reference(sr, si, sc, **kw)
            scale_w = float(torch.sqrt(rr * rr + ri * ri).max())
            _reset_counts()
            wr, wi = fc.fused_cwt_planar(sr, si, sc, precision=tier, **kw)
            check(_four_step_only(fc.KERNEL_LAUNCHES, bf16=tier == "fast"),
                  f"2^{nfft.bit_length() - 1} {tier}: {fc.KERNEL_LAUNCHES}")
            err = max(float((wr - rr).abs().max()), float((wi - ri).abs().max())) / scale_w
            check(math.isfinite(err) and err < TIER_BOUND[tier],
                  f"nfft {nfft} {tier}: {err}")
            errs[f"2^{nfft.bit_length() - 1} {tier}"] = err
            del rr, ri, wr, wi
    log("large columns, planes vs plain (of max|W|; fast against the bf16 plain "
        "version): " + ", ".join(f"nfft {k} {e:.3e}" for k, e in errs.items()))
    return errs


def phase_public_path():
    """cwt and cwt_power on NINO3 under the default engine (the kernels),
    against the f64 golden; an icwt_planar round trip."""
    import pycwt_torch as pt
    from pycwt_torch.api import _cwt_planar_parts
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.transform import icwt_planar

    g = np.load(os.path.join(GOLDEN, "cwt_nino3_morlet6.npz"))
    dt = float(g["dt"])
    _reset_counts()
    W, sj, *_ = pt.cwt(g["signal"], dt)
    power, sj2, *_ = pt.cwt_power(g["signal"], dt)
    launches = dict(fc.KERNEL_LAUNCHES)
    check(_four_step_only(launches),
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


def _bounds(nfft, S, n_in, R1, R2, t_bytes=4, output="power_sum"):
    """(bytes, ops) of each kernel at this shape: inputs read once, outputs
    written once, T's two planes at ``t_bytes`` an element (2 for the bf16 T
    of ``fast``), stage B's ``output``; radix-2 FFT at 5·R·log2 R flops,
    complex multiplies at 6."""
    rows_a = n_in // R1
    t_total = 2 * S * nfft * t_bytes
    a_bytes = 2 * n_in * 4 + S * 4 + t_total
    a_ops = S * (rows_a * R1 * 6 + R1 * 5 * R2 * math.log2(R2) + nfft * 6)
    b_bytes = t_total + {"power_sum": S, "power": S * nfft, "planes": 2 * S * nfft,
                         "complex": 2 * S * nfft}[output] * 4
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

    _reset_counts()
    pw = pipeline()
    torch.cuda.synchronize()
    launches = dict(fc.KERNEL_LAUNCHES)
    check(_four_step_only(launches),
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
    dev_a = device_ms(lambda: fc.stage_a(*X2, scales, **kw), calls=20)
    # cwt_stage_b's row: the kernel and its fixed-order reduce pass
    dev_b = device_ms(lambda: fc.stage_b(*T, nfft=N0, output="power_sum"), calls=20)
    ms_pipe = time_ms(pipeline)
    # the card's busy time per pipeline call (every kernel it launches)
    dev_pipe = device_ms(pipeline, calls=20)
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
    fast = _bench_fast_tier(x, scales, kw, (sr, si), ms_pipe, dev_pipe)
    log(f"bench shape N=2^20 S=64 Morlet-6 power_sum tier={DEFAULT.precision}: "
        f"pipeline {ms_pipe:.4f} ms ({rate:.4e} sample-scales/s; device busy "
        f"{dev_pipe:.4f} ms per call, {100 * dev_pipe / ms_pipe:.1f} %), "
        f"cwt_stage_a {ms_a:.4f} ms (device {dev_a:.4f}, bound {bound_a:.4f}), "
        f"cwt_stage_b {ms_b:.4f} ms (device {dev_b:.4f}, bound {bound_b:.4f}), "
        f"plain pipeline {plain_pipe:.4f} ms, cuFFT ifft of the product {lib_ms:.4f} ms, "
        f"pipeline vs plain {e_pipe:.3e}")
    return dict(
        launches=launches, ms_a=ms_a, ms_b=ms_b, dev_a=dev_a, dev_b=dev_b, dev_pipe=dev_pipe,
        plain_a=plain_a, plain_b=plain_b,
        bound_a=bound_a, by_a=by_a, bound_b=bound_b, by_b=by_b, err_a=err_a,
        err_b=err_b, tol_a=tol_a, tol_b=tol_b, lib_ms=lib_ms, ms_pipe=ms_pipe,
        plain_pipe=plain_pipe, rate=rate, bytes_a=a_bytes, bytes_b=b_bytes, fast=fast)


#: (nfft, scales) at which phase_stage_b_complex times K2's epilogues
STAGE_B_COMPLEX_SHAPES = ((1 << 20, 64), (1 << 22, 16), (1 << 22, 64))


def phase_stage_b_complex(card, rounds=2):
    """K2's ``complex`` epilogue (``stage_b(output="complex")``) at each
    STAGE_B_COMPLEX_SHAPES, on the T of K1 (one half spectrum, Morlet-6),
    f32 and bf16: its W against ``torch.complex`` of the ``planes`` epilogue
    bit for bit, each launch counted in ``STAGE_B_COMPLEX_LAUNCHES``, then
    the device time (``device_ms``, 10 calls, median of ``rounds`` rounds in
    turns) of ``complex``, of ``planes`` and of ``planes`` followed by the
    assembly that ``fused_cwt`` ran before, with the byte bound of T read
    and W written once."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    shapes = {}
    for nfft, S in STAGE_B_COMPLEX_SHAPES:
        R1, R2 = fc._nfft_factors(nfft)
        sr, si, sc = _inputs(nfft, True, 1, S, seed=nfft.bit_length())
        for t_dtype, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            T = fc.stage_a(sr, si, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0,
                           t_dtype=t_dtype)
            fns = {
                "complex": lambda: fc.stage_b(*T, nfft=nfft, output="complex"),
                "planes": lambda: fc.stage_b(*T, nfft=nfft, output="planes"),
                "planes+assembly": lambda: torch.complex(
                    *fc.stage_b(*T, nfft=nfft, output="planes")),
            }
            n = fc.STAGE_B_COMPLEX_LAUNCHES
            got = fns["complex"]()
            check(fc.STAGE_B_COMPLEX_LAUNCHES == n + 1,
                  "stage_b(output='complex') was not counted")
            check(got.dtype == torch.complex64 and got.shape == (S, nfft)
                  and torch.equal(got, fns["planes+assembly"]()),
                  f"K2 complex at 2^{nfft.bit_length() - 1} x {S} ({tname} T) is not "
                  "torch.complex of its planes bit for bit")
            del got
            (_, _), (b_bytes, b_ops) = _bounds(nfft, S, nfft // 2, R1, R2,
                                               t_bytes=T[0].element_size(),
                                               output="complex")
            bound, by = _bound_ms(b_bytes, b_ops)
            ms = {k: [] for k in fns}
            for _ in range(rounds):
                for k, fn in fns.items():
                    ms[k].append(device_ms(fn, calls=10, floor=bound))
            ms = {k: float(np.median(v)) for k, v in ms.items()}
            del T
            torch.cuda.empty_cache()
            key = f"2^{nfft.bit_length() - 1}x{S} {tname}"
            shapes[key] = dict(R1=R1, bound_ms=bound, bound_by=by, device_ms=ms,
                               bound_share={k: bound / v for k, v in ms.items()})
            log(f"[{card}] K2 epilogues {key} (R1 {R1}; device ms, share of the "
                f"{bound:.4f} ms bound): " + "; ".join(
                    f"{k} {v:.4f} ({100 * bound / v:.1f} %)" for k, v in ms.items()) +
                "; complex == torch.complex(planes) bit for bit")
    return shapes


def _bench_fast_tier(x, scales, kw, spec, ms_pipe_high, dev_pipe_high):
    """The ``fast`` tier at the bench shape: the pipeline
    ``fft_of_real_planar(half=True)`` → ``fused_cwt_planar(precision="fast",
    output="power_sum")`` driven with the counters set to 0 just before and
    read just after (the bf16 instantiations only), against the bf16 and
    the f32 plain versions; then cwt_stage_a_bf16's T element by element
    against the plain T rounded (one bf16 ulp, or the f32 T's own error
    beyond it) and against the f32 kernel's T rounded (bit for bit),
    cwt_stage_b_bf16 on it against its plain version (1e-5 of max|out|) and
    against cwt_stage_b on the widened T (planes and |W|² bit for bit, the
    power sums within 1e-6); each bf16 kernel timed beside its f32 form, in
    turns, with its 2-byte-T bound."""
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    N0, S, bf16 = kw["nfft"], scales.shape[0], torch.bfloat16

    def pipeline():
        sr, si = fft_of_real_planar(x, N0, half=True)
        return fc.fused_cwt_planar(sr, si, scales, precision="fast",
                                   output="power_sum", **kw)

    _reset_counts()
    pw = pipeline()
    torch.cuda.synchronize()
    launches = dict(fc.KERNEL_LAUNCHES)
    check(_four_step_only(launches, bf16=True),
          f"the fast pipeline did not launch the bf16 kernels alone: {launches}")
    sr, si = spec
    check(pw.shape == (S,) and bool(torch.isfinite(pw).all()), "fast power_sum shape/finite")
    ref32 = fc._fused_cwt_planar_reference(sr, si, scales, output="power_sum", **kw)
    ref16 = _bf16_plain(sr[None], si[None], scales, output="power_sum", **kw)[0]
    e_pipe32 = float((pw - ref32).abs().max() / ref32.abs().max())
    e_pipe16 = float((pw - ref16).abs().max() / ref16.abs().max())
    check(e_pipe32 < TIER_BOUND["fast"] and e_pipe16 < TIER_BOUND["fast"],
          f"fast pipeline vs the f32 / bf16 plain versions: {e_pipe32}, {e_pipe16}")
    del ref32, ref16

    X2 = (sr[None], si[None])
    T16 = fc.stage_a(*X2, scales, t_dtype=bf16, **kw)
    T32 = fc.stage_a(*X2, scales, **kw)
    differ, beyond, over, err_a = 0, 0, -math.inf, 0.0
    plain = fc._stage_a_reference(*X2, scales, **kw)
    scale_a = float(torch.sqrt(plain[0] ** 2 + plain[1] ** 2).max())
    for i in range(2):
        d, b, o = _t16_vs_plain(T16[i], plain[i], scale_a)
        differ, beyond, over = differ + d, beyond + b, max(over, o)
        err_a = max(err_a, float((T16[i].float() - plain[i].to(bf16).float()).abs().max()))
        check(torch.equal(T16[i], T32[i].to(bf16)),
              "cwt_stage_a_bf16's T is not cwt_stage_a's T rounded")
    del plain
    share, beyond = differ / (2 * T16[0].numel()), beyond / (2 * T16[0].numel())
    check(over <= 0, f"cwt_stage_a_bf16's T is {over} beyond one bf16 ulp and the f32 "
          "T's 1e-5 of max|T| from the plain T rounded")
    out_b = fc.stage_b(*T16, nfft=N0, output="power_sum")
    ref_b = fc._stage_b_reference(*T16, nfft=N0, output="power_sum")
    err_b = float((out_b - ref_b).abs().max())
    tol_b = 1e-5 * float(ref_b.abs().max())
    check(err_b <= tol_b, f"cwt_stage_b_bf16 vs plain: {err_b} > {tol_b}")
    # per column the same arithmetic as cwt_stage_b on the widened T; the
    # power sums group the columns by the wide blocks' 16, not by 8
    for output in OUTPUTS:
        got = fc.stage_b(*T16, nfft=N0, output=output)
        wide = fc.stage_b(*(p.float() for p in T16), nfft=N0, output=output)
        if output == "power_sum":
            same = float((got - wide).abs().max()) <= 1e-6 * float(wide.abs().max())
        else:
            same = (all(torch.equal(g, w) for g, w in zip(got, wide)) if output == "planes"
                    else torch.equal(got, wide))
        check(same, f"cwt_stage_b_bf16 != cwt_stage_b on the widened T ({output})")
        del got, wide
    del ref_b

    # in turns: f32, bf16, bf16, f32 (CUDA events, then profiler device time)
    calls = {"a": lambda: fc.stage_a(*X2, scales, **kw),
             "a16": lambda: fc.stage_a(*X2, scales, t_dtype=bf16, **kw),
             "b": lambda: fc.stage_b(*T32, nfft=N0, output="power_sum"),
             "b16": lambda: fc.stage_b(*T16, nfft=N0, output="power_sum")}
    ms = {k: [] for k in calls}
    dev = {k: [] for k in calls}
    for order in (("a", "a16", "b", "b16"), ("a16", "a", "b16", "b")):
        for k in order:
            ms[k].append(time_ms(calls[k]))
            dev[k].append(device_ms(calls[k], calls=20))
    ms = {k: float(np.median(v)) for k, v in ms.items()}
    dev = {k: float(np.median(v)) for k, v in dev.items()}
    ms_pipe = time_ms(pipeline)
    dev_pipe = device_ms(pipeline, calls=20)
    plain_a = time_ms(lambda: fc._stage_a_reference(*X2, scales, t_dtype=bf16, **kw),
                      runs=10, warmup=1)
    plain_b = time_ms(lambda: fc._stage_b_reference(*T16, nfft=N0, output="power_sum"),
                      runs=10, warmup=1)
    del T16, T32
    R1, R2 = fc._nfft_factors(N0)
    (a_bytes, a_ops), (b_bytes, b_ops) = _bounds(N0, S, sr.shape[-1], R1, R2, t_bytes=2)
    bound_a, by_a = _bound_ms(a_bytes, a_ops)
    bound_b, by_b = _bound_ms(b_bytes, b_ops)
    log(f"bench shape, fast tier (bf16 T): pipeline {ms_pipe:.4f} ms (device busy "
        f"{dev_pipe:.4f}; high: {ms_pipe_high:.4f} / {dev_pipe_high:.4f}), launches "
        f"{launches}; vs the f32 / bf16 plain versions {e_pipe32:.3e} / {e_pipe16:.3e}; "
        f"cwt_stage_a_bf16 device {dev['a16']:.4f} ms (f32 {dev['a']:.4f}; bound "
        f"{bound_a:.4f}, {100 * bound_a / dev['a16']:.1f} %), cwt_stage_b_bf16 device "
        f"{dev['b16']:.4f} ms (f32 {dev['b']:.4f}; bound {bound_b:.4f}, "
        f"{100 * bound_b / dev['b16']:.1f} %); T: {share:.3e} of elements differ from "
        f"the plain rounding, {beyond:.3e} by more than one ulp; K2 vs plain {err_b:.3e} "
        f"(tolerance {tol_b:.3e})")
    return dict(launches=launches, e_pipe32=e_pipe32, e_pipe16=e_pipe16, ms=ms, dev=dev,
                ms_pipe=ms_pipe, dev_pipe=dev_pipe, plain_a=plain_a, plain_b=plain_b,
                bound_a=bound_a, by_a=by_a, bound_b=bound_b, by_b=by_b, bytes_a=a_bytes,
                bytes_b=b_bytes, err_a=err_a, share=share, beyond=beyond, err_b=err_b,
                tol_b=tol_b, rate=N0 * S / (ms_pipe * 1e-3))


def phase_public_fast(card):
    """``pt.cwt`` with ``CWTConfig(precision="fast")`` on a seeded 2^20-point
    signal (the bench grid: dj 1/4, s0 2, 64 scales), driven with the
    counters set to 0 just before and read just after: the bf16
    instantiations alone, once each.  W against the bf16 plain version and
    the f32 plain version on the same f64-rounded spectrum, within the
    tier's 2e-2 of max|W|."""
    import pycwt_torch as pt
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.fft import _spectrum_f64

    n0 = 1 << 20
    x = np.random.default_rng(20).standard_normal(n0)
    _reset_counts()
    W, sj, *_ = pt.cwt(x, 1.0, dj=0.25, s0=2.0, J=63, config=CWTConfig(precision="fast"))
    launches = dict(fc.KERNEL_LAUNCHES)
    check(_four_step_only(launches, bf16=True) and launches["cwt_stage_a_bf16"] == 1,
          f"cwt at fast did not launch the bf16 kernels once each: {launches}")
    check(W.shape == (64, n0) and np.isfinite(W).all(), "fast cwt shape/finite")
    spec = _spectrum_f64(torch.tensor(x, device="cuda"), n0)
    sr, si = spec.real.contiguous()[None], spec.imag.contiguous()[None]
    sc = torch.tensor(sj, dtype=torch.float32, device="cuda")
    kw = dict(mother=pt.Morlet(6), nfft=n0, dt=1.0)
    Wd = torch.tensor(W, device="cuda")
    errs = {}
    for key, (wr, wi) in (("bf16_plain", _bf16_plain(sr, si, sc, output="planes", **kw)),
                          ("f32_plain", fc._fused_cwt_planar_reference(sr, si, sc, **kw))):
        ref = torch.complex(wr[0], wi[0])
        errs[key] = float((Wd - ref).abs().max() / ref.abs().max())
        del ref, wr, wi
    check(all(e < TIER_BOUND["fast"] for e in errs.values()), f"fast cwt: {errs}")
    log(f"[{card}] public cwt at fast, 2^20 x 64: launches {launches}; W vs the bf16 / "
        f"f32 plain versions {errs['bf16_plain']:.3e} / {errs['f32_plain']:.3e} of max|W|")
    return dict(launches=launches, errs=errs)


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


def phase_direct_vs_plain():
    """cwt_direct (K3) at every nfft from 2^8 to 2^12, every mother, full and
    half spectrum, three outputs (from the kernel's own epilogue) and three
    tiers against its plain version; B = 2 against two single calls, bit for
    bit in every output; at 2^13 small_kernel runs K1+K2."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    worst = {tier: 0.0 for tier in TIER_BOUND}
    worst_at = ""
    # kernel and plain version, each against the plain version in f64
    vs_f64 = {"kernel": 0.0, "plain": 0.0}
    mothers = [pt.Morlet(6), pt.Paul(4), pt.DOG(2), pt.DOG(6)]
    _reset_counts()
    for nfft in DIRECT_SIZES:
        for m in mothers:
            for half in ((False, True) if m.analytic_negligible_negative() else (False,)):
                # 37 scales: a ragged last block where rows share one (< 2^10)
                sr, si, sc = _inputs(nfft, half, 2, 37, seed=nfft)
                kw = dict(mother=m, nfft=nfft, dt=1.0)
                rr, ri = fc._direct_reference(sr, si, sc, **kw)
                scale_w = float(torch.sqrt(rr * rr + ri * ri).max())
                t64 = torch.complex(*fc._direct_reference(sr.double(), si.double(),
                                                          sc.double(), **kw))
                for output in OUTPUTS:
                    ref = fc._epilogue(rr, ri, output)
                    for tier in TIER_BOUND:
                        got = fc.fused_cwt_planar(sr, si, sc, output=output, precision=tier,
                                                  small_kernel=True, **kw)
                        if output == "planes":
                            err = max(float((got[0] - rr).abs().max()),
                                      float((got[1] - ri).abs().max())) / scale_w
                        else:
                            err = float((got - ref).abs().max() / ref.abs().max())
                        check(math.isfinite(err) and err < TIER_BOUND[tier],
                              f"cwt_direct {nfft} {m} half={half} {output} {tier}: {err}")
                        if err > worst[tier]:
                            worst[tier] = err
                            worst_at = f"nfft {nfft} {m} half={half} {output}"
                    if output == "planes":
                        for key, w in (("kernel", got), ("plain", (rr, ri))):
                            e = float((torch.complex(*w).to(t64.dtype) - t64).abs().max()
                                      / t64.abs().max())
                            vs_f64[key] = max(vs_f64[key], e)
                    singles = [fc.fused_cwt_planar(sr[b], si[b], sc, output=output,
                                                   small_kernel=True, **kw)
                               for b in range(2)]
                    if output == "planes":
                        same = all(torch.equal(got[i][b], singles[b][i])
                                   for b in range(2) for i in range(2))
                    else:
                        same = all(torch.equal(got[b], singles[b]) for b in range(2))
                    check(same, f"cwt_direct batch != singles at {nfft} {m} {output}")
        log(f"cwt_direct vs plain, nfft={nfft}: ok (worst so far {worst}, at "
            f"{worst_at}; planes vs the f64 plain version: {vs_f64})")
    launches = dict(fc.KERNEL_LAUNCHES)
    check(launches["cwt_direct"] > 0 and launches["cwt_stage_a"] == 0,
          f"small_kernel did not route to cwt_direct: {launches}")
    _reset_counts()
    sr, si, sc = _inputs(1 << 13, False, 1, 4, seed=13)
    fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), nfft=1 << 13, dt=1.0,
                        small_kernel=True)
    check(_four_step_only(fc.KERNEL_LAUNCHES),
          f"small_kernel at 2^13 must run K1+K2: {fc.KERNEL_LAUNCHES}")
    log(f"small_kernel at 2^13 launches {dict(fc.KERNEL_LAUNCHES)}")
    return worst, vs_f64


@contextlib.contextmanager
def _env(name, value):
    """The environment variable ``name`` set to ``value`` (unset for None)
    inside the block; its old state after it."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def _route(small: bool):
    """PYCWT_TPU_SMALL_KERNEL=1 (the cwt_direct route) or unset (K1+K2)
    inside the block."""
    return _env("PYCWT_TPU_SMALL_KERNEL", "1" if small else None)


def phase_slice_path(small: bool):
    """The statistics / XWT / WCT path through the public entry points on
    the card, on one route, against the f64 goldens at the f32 bounds."""
    import pycwt_torch as pt
    from pycwt_torch.analysis import cwt_analysis, wct_analysis, xwt_analysis
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.sample import load

    name = "cwt_direct (PYCWT_TPU_SMALL_KERNEL=1)" if small else "default (K1+K2)"
    with _route(small):
        errs = {}
        _reset_counts()
        for norm in (0, 1):
            g = np.load(os.path.join(GOLDEN, f"xwt_jao_jbaltic_norm{norm}.npz"))
            W12, coi, freq, signif = pt.xwt(g["y1"], g["y2"], float(g["dt"]),
                                            significance_level=0.8646,
                                            normalize=bool(norm))
            errs[f"xwt_norm{norm}"] = rel_err(np.abs(W12), np.abs(g["W12"]))
            check(rel_err(signif, g["signif"]) < 1e-10, "xwt signif")
        mag, *_ = pt.xwt_planar(g["y1"], g["y2"], float(g["dt"]),
                                significance_level=0.8646)
        errs["xwt_planar"] = rel_err(mag, np.abs(g["W12"]))
        g = np.load(os.path.join(GOLDEN, "wct_jao_jbaltic.npz"))
        WCT, aWCT, coi, freq, sig = pt.wct(g["y1"], g["y2"], float(g["dt"]), sig=False)
        check(WCT.shape == g["WCT"].shape and np.isfinite(WCT).all(), "wct shape/finite")
        errs["wct"] = rel_err(WCT, g["WCT"])
        gn = np.load(os.path.join(GOLDEN, "figure_nino3.npz"))
        ds = load("nino3")
        res = cwt_analysis(ds.values, ds.dt, t0=ds.t0, mother=pt.Morlet(6),
                           avg_band=(2, 8))
        errs["cwt_analysis_power"] = rel_err(res.power, gn["power"])
        check(np.isfinite(res.sig95).all() and np.isfinite(res.global_signif).all(),
              "cwt_analysis significance finite")
        gf = np.load(os.path.join(GOLDEN, "figure_jao_jbaltic.npz"))
        jao, jba = load("jao"), load("jbaltic")
        n = min(jao.values.size, jba.values.size)
        x = xwt_analysis(jao.values[:n], jba.values[:n], jao.dt, significance_level=0.8646)
        w = wct_analysis(jao.values[:n], jba.values[:n], jao.dt, sig=False)
        errs["xwt_analysis"] = rel_err(x["cross_power"], gf["cross_power"])
        errs["wct_analysis"] = rel_err(w["WCT"], gf["wct"])
        torch.cuda.synchronize()
        launches = dict(fc.KERNEL_LAUNCHES)
    bounds = dict(xwt_norm0=XWT_BOUND, xwt_norm1=XWT_BOUND, xwt_planar=XWT_BOUND,
                  wct=WCT_BOUND, cwt_analysis_power=CWT_BOUND,
                  xwt_analysis=XWT_BOUND, wct_analysis=WCT_BOUND)
    for key, err in errs.items():
        check(err < bounds[key], f"{name}: {key} rel_err {err} >= {bounds[key]}")
    if small:
        ok = (launches["cwt_direct"] > 0 and launches["cwt_stage_a"] == 0
              and launches["cwt_stage_b"] == 0)
    else:
        ok = _four_step_only(launches)
    check(ok, f"{name}: wrong kernels launched: {launches}")
    log(f"slice path, route {name}: launches {launches}; rel_err " +
        ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return launches, errs


def _wct_pair(n0=4000, period=64.0, g=0.7, seed=0):
    """Two seeded AR(1) red-noise series sharing a 64-step oscillation."""
    from pycwt_torch.stats import rednoise_batch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    red = rednoise_batch(gen, n0, g, batch=2, dtype=torch.float64).cpu().numpy()
    wave = np.sin(2 * np.pi * np.arange(n0) / period)
    return red[0] + wave, red[1] + wave


def _wct_core_inputs(y1, y2):
    """Normalized f32 rows and the dj = 1/12 scales of a WCT pair on the
    card, and a call of ``_wct_core`` on them (nfft 4096, Morlet-6)."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch.transform import build_scale_grid

    sj = torch.tensor(build_scale_grid(y1.size, 1.0).sj, dtype=torch.float32,
                      device="cuda")
    ys = [torch.tensor((y - y.mean()) / y.std(), dtype=torch.float32,
                       device="cuda")[None] for y in (y1, y2)]
    return ys, sj, lambda: tco._wct_core(ys[0], ys[1], sj, 1.0, mother=pt.Morlet(6),
                                         nfft=4096, dj=1 / 12)


def phase_wct_timing():
    """``--time-wct TREE``: the 4,000-point ``_wct_core`` on both routes and
    its smoothing (``smooth_planar_pair`` on two (1, 133, 4000) planes, and
    the scale boxcar alone on the complex field), by CUDA events and device
    time, then the 300-member MC run (default route, median of 5),
    ``cwt_overlap_save_planar`` at 2^24 × 64 scales (median of 3) and the
    bench-shape pipeline (median of 21, and its device time), for the
    ``pycwt_torch`` of the tree on ``sys.path``, with the digests of
    :func:`_tier_digests`; one JSON line."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch.ops import overlap as tov
    from pycwt_torch.ops import smoothing as sm

    _, sj, core_call = _wct_core_inputs(*_wct_pair())
    out = {"tree": os.path.dirname(os.path.abspath(pt.__path__[0]))}
    for small in (False, True):
        with _route(small):
            out["wct_core_ms_" + ("cwt_direct" if small else "default")] = time_ms(
                core_call, runs=21, warmup=3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    Ta, Tb = (torch.randn((1, sj.shape[0], 4000), generator=gen, device="cuda")
              for _ in range(2))
    T = sm.time_gaussian_smooth(torch.complex(Ta, Tb), sj, 1.0, 4096)
    win = sm._scale_window(pt.Morlet(6), 1 / 12)
    for name, fn in (
            ("smooth_pair", lambda: sm.smooth_planar_pair(Ta, Tb, 1.0, 1 / 12, sj,
                                                          pt.Morlet(6))),
            ("boxcar", lambda: sm.scale_boxcar_same(T, win))):
        out[name + "_ms"] = time_ms(fn, runs=21, warmup=3)
        out[name + "_device_ms"] = device_ms(fn, calls=20)
    del T, Ta, Tb
    _, al1, al2, kw = _mc_args()
    mc = dict(mc_count=MC_COUNT, seed=MC_SEED, cache=False, progress=False, **kw)
    out["mc_300_members_ms"] = time_ms(lambda: tco.wct_significance(al1, al2, **mc),
                                       runs=5, warmup=1)
    x = torch.randn(LONG_TIME_N, generator=gen, device="cuda")
    lsj = torch.tensor(2.0 * 2.0 ** (np.arange(LONG_S) / 8.0), dtype=torch.float32,
                       device="cuda")
    out["overlap_2p24_ms"] = time_ms(lambda: tov.cwt_overlap_save_planar(
        x, lsj, 1.0, mother=pt.Morlet(6), chunk=LONG_CHUNK), runs=3, warmup=1)
    pipeline = _bench_pipeline()
    out["bench_pipeline_ms"] = time_ms(pipeline, runs=21, warmup=3)
    out["bench_pipeline_device_ms"] = device_ms(pipeline, calls=20)
    out["digests"] = _tier_digests()
    log("WCT timing " + json.dumps(out))
    return out


def _tier_digests():
    """sha256 (16 hex digits) of ``fused_cwt_planar``'s every output at the
    ``highest`` and ``high`` tiers, on seeded inputs at nfft 2^14, 2^20 and
    2^22 (Morlet-6 half spectrum, DOG(2) full; B = 2, 4 scales): what
    ``--ab`` holds bit for bit against a parent tree."""
    import hashlib

    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    out = {}
    for nfft in (1 << 14, 1 << 20, 1 << 22):
        for m, half in ((pt.Morlet(6), True), (pt.DOG(2), False)):
            sr, si, sc = _inputs(nfft, half, 2, 4, seed=nfft)
            for tier in ("highest", "high"):
                for output in OUTPUTS:
                    got = fc.fused_cwt_planar(sr, si, sc, mother=m, nfft=nfft, dt=1.0,
                                              precision=tier, output=output)
                    h = hashlib.sha256()
                    for t in got if isinstance(got, tuple) else (got,):
                        h.update(t.cpu().numpy().tobytes())
                    key = f"2^{nfft.bit_length() - 1} {type(m).__name__} {tier} {output}"
                    out[key] = h.hexdigest()[:16]
    return out


def phase_ab(parent: str):
    """``--ab PARENT``: :func:`phase_wct_timing` for the tree at PARENT (an
    unpacked parent commit) and for this one, in turns (parent, this, this,
    parent), each in a process of its own that builds its tree's kernels;
    then the `highest` and `high` outputs' digests of every turn, which
    must agree bit for bit."""
    here = os.path.dirname(os.path.abspath(__file__))
    digests = []
    for tree in (parent, here, here, parent):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-wct",
                              os.path.abspath(tree)], check=True, timeout=600,
                             capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr)
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("WCT timing ")][-1]
        digests.append(json.loads(line[len("WCT timing "):])["digests"])
    check(all(d == digests[0] for d in digests),
          "the highest/high outputs differ between the turns: " +
          json.dumps([{k: d[k] for k in d if d[k] != digests[0].get(k)} for d in digests]))
    log(f"--ab: {len(digests[0])} highest/high outputs bit for bit in all four turns")


def phase_wct_trace(calls=5):
    """``python3 chip_smoke.py --trace``: torch.profiler over ``calls`` calls
    of ``_wct_core`` at the 4,000-point shape on each route — device time by
    kernel, the device's busy time per call (sum of kernel times, one
    stream) and its share of the wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    ys, sj, core_call = _wct_core_inputs(*_wct_pair())
    for small in (False, True):
        with _route(small):
            for _ in range(3):
                core_call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    core_call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / calls
        rows = _device_rows(prof, calls)
        busy = sum(r[0] for r in rows)
        log(f"trace, route {'cwt_direct' if small else 'default (K1+K2)'}: "
            f"{wall:.4f} ms wall per _wct_core call under the profiler, device busy "
            f"{busy:.4f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
        for ms, n, key in rows[:10]:
            log(f"  {ms:.4f} ms  x{n:g}  {key[:90]}")


def _direct_bound(B, S, K, nfft):
    """(bytes, ops) of the function cwt_direct computes with the planes
    output: X and scales in, two W planes out; the least operations are the
    FFT route's, a complex filter multiply (6 flops) per (signal, scale,
    bin) and a radix-2 inverse FFT (5·N·log2 N) per (signal, scale)."""
    nbytes = 2 * B * K * 4 + S * 4 + 2 * B * S * nfft * 4
    ops = B * S * (6 * K + 5 * nfft * math.log2(nfft))
    return nbytes, ops


def _filtered_product(sr_full, si_full, sj, mother, nfft, dt):
    """The filtered (B, S, nfft) complex64 product of full spectra: the
    input of the ``torch.fft.ifft`` yardstick."""
    from pycwt_torch.ops.filterbank import angular_frequencies, filter_bank

    bank = filter_bank(mother, sj, angular_frequencies(nfft, dt, torch.float32, "cuda"), dt)
    return torch.complex(sr_full, si_full)[:, None] * bank.to(torch.complex64)[None]


def phase_real_size():
    """wct(sig=False) on a 4,000-point pair (nfft 4096, dj = 1/12 → 133
    scales) on both routes; the kernels, the plain version and the library
    yardsticks timed on the same (2, 2048) half spectra."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    y1, y2 = _wct_pair()
    n0, dt, nfft, mother = y1.size, 1.0, 4096, pt.Morlet(6)
    out, counts = {}, {}
    for small in (False, True):
        with _route(small):
            _reset_counts()
            WCT, aWCT, coi, freq, _ = pt.wct(y1, y2, dt, sig=False)
            torch.cuda.synchronize()
            counts[small] = dict(fc.KERNEL_LAUNCHES)
        check(WCT.shape == (133, n0) and np.isfinite(WCT).all(), "4,000-point wct")
        out[small] = WCT
    check(counts[True]["cwt_direct"] > 0 and counts[True]["cwt_stage_a"] == 0,
          f"4,000-point wct on the opt-in route: {counts[True]}")
    check(_four_step_only(counts[False]), f"4,000-point wct, default: {counts[False]}")
    agree = rel_err(out[True], out[False])
    check(agree < 1e-3, f"routes disagree at the 4,000-point shape: {agree}")

    ys, sj, core_call = _wct_core_inputs(y1, y2)
    S = sj.shape[0]
    core = {}
    for small in (False, True):
        with _route(small):
            core[small] = time_ms(core_call)

    x = torch.stack([y[0] for y in ys])                        # (2, 4000)
    sr, si = fft_of_real_planar(x, nfft, half=True)            # (2, 2048)
    kw = dict(mother=mother, nfft=nfft, dt=dt)
    got = fc.cwt_direct(sr, si, sj, **kw)
    ref = fc._direct_reference(sr, si, sj, **kw)
    err = max(float((got[i] - ref[i]).abs().max()) for i in range(2))
    tol = TIER_BOUND["highest"] * float(torch.sqrt(ref[0] ** 2 + ref[1] ** 2).max())
    check(err <= tol, f"cwt_direct at the WCT shape: {err} > {tol}")
    del got, ref
    K = nfft // 2
    nbytes, ops = _direct_bound(2, S, K, nfft)
    bound, by = _bound_ms(nbytes, ops)
    ms_direct = device_ms(lambda: fc.cwt_direct(sr, si, sj, **kw), floor=bound)
    wall_ms = time_ms(lambda: fc.cwt_direct(sr, si, sj, **kw))
    ms_four = device_ms(lambda: fc.stage_b(*fc.stage_a(sr, si, sj, **kw), nfft=nfft,
                                           output="planes"))
    plain_ms = device_ms(lambda: fc._direct_reference(sr, si, sj, **kw), calls=10)
    prod = _filtered_product(*fft_of_real_planar(x, nfft), sj, mother, nfft, dt)
    lib_ms = device_ms(lambda: torch.fft.ifft(prod, dim=-1))
    del prod
    log(f"cwt_direct bound at B=2 S={S} K={K} N={nfft}: {bound:.4f} ms ({by}; "
        f"{nbytes:.4e} bytes, {ops:.4e} flops on the FFT route)")
    log(f"4,000-point WCT pair (nfft 4096, {S} scales): routes agree {agree:.3e}; "
        f"_wct_core default (K1+K2) {core[False]:.4f} ms, opt-in (cwt_direct) "
        f"{core[True]:.4f} ms; launches default {counts[False]}, opt-in {counts[True]}")
    log(f"(2, {K}) half spectra, {S} scales, device time per call: cwt_direct "
        f"{ms_direct:.4f} ms ({100 * bound / ms_direct:.1f} % of its bound; one call "
        f"under CUDA events {wall_ms:.4f} ms), cwt_stage_a+cwt_stage_b {ms_four:.4f} ms, "
        f"plain cwt_direct {plain_ms:.4f} ms, torch.fft.ifft of the filtered "
        f"(2, {S}, {nfft}) product {lib_ms:.4f} ms; cwt_direct vs plain {err:.3e} "
        f"(tol {tol:.3e})")
    return dict(launches=counts[True]["cwt_direct"], err=err, tol=tol, ms=ms_direct,
                wall_ms=wall_ms, plain_ms=plain_ms, bound=bound, by=by, lib_ms=lib_ms,
                ms_four=ms_four, core=core, agree=agree, bytes=nbytes, ops=ops, S=S)


def phase_direct_sizes():
    """Both routes at every nfft from 2^8 to 2^12, by device time per call: a
    half spectrum of one signal and S = 12·log2(nfft/4) + 1 scales (a dj =
    1/12 grid's count), planes; the ifft yardstick and the bound beside."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    rows = {}
    for nfft in DIRECT_SIZES:
        S = int(round(math.log2(nfft / 4) * 12)) + 1
        sr, si, sc = _inputs(nfft, True, 1, S, seed=nfft)
        full_r, full_i, _ = _inputs(nfft, False, 1, S, seed=nfft)   # the same signal
        kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
        prod = _filtered_product(full_r, full_i, sc, kw["mother"], nfft, 1.0)
        bound, _ = _bound_ms(*_direct_bound(1, S, nfft // 2, nfft))
        rows[nfft] = dict(
            S=S, direct=device_ms(lambda: fc.cwt_direct(sr, si, sc, **kw)),
            four=device_ms(lambda: fc.stage_b(*fc.stage_a(sr, si, sc, **kw),
                                              nfft=nfft, output="planes")),
            ifft=device_ms(lambda: torch.fft.ifft(prod, dim=-1)),
            wall=time_ms(lambda: fc.cwt_direct(sr, si, sc, **kw)), bound=bound)
    log("device ms per call, one half spectrum, planes: cwt_direct vs "
        "cwt_stage_a+cwt_stage_b vs torch.fft.ifft of the product (bound; cwt_direct "
        "under CUDA events): " +
        "; ".join(f"nfft {n} S {r['S']}: {r['direct']:.4f} vs {r['four']:.4f} vs "
                  f"{r['ifft']:.4f} ({r['bound']:.4f}; {r['wall']:.4f})"
                  for n, r in rows.items()))
    return rows


def phase_column_plans():
    """Counterpart of tools/tpu_radix_experiment.py: at each nfft of SIZES,
    the radix plans of cwt_stage_a's length-R2 and cwt_stage_b's length-R1
    columns beside each kernel's device time per call (one half spectrum,
    16 scales, Morlet-6, planes), for the f32 T and, in turns, the bf16 T
    of ``fast`` (cwt_stage_a_bf16, cwt_stage_b_bf16), each with its bound
    (T at 4 or 2 bytes; W planes out); cwt_stage_b's two forms also in
    ``power_sum``, where T's loads alone move the bytes."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc

    rows = {}
    for nfft in SIZES:
        R1, R2 = fc._nfft_factors(nfft)
        sr, si, sc = _inputs(nfft, True, 1, 16, seed=nfft)
        kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
        T = fc.stage_a(sr, si, sc, **kw)
        T16 = fc.stage_a(sr, si, sc, t_dtype=torch.bfloat16, **kw)
        calls = 50 if nfft <= 1 << 16 else 10
        row = dict(plan_a=fc._column_radix_plan(R2), plan_b=fc._column_radix_plan(R1),
                   cols_a=fc._tile_cols(R2, R1),
                   cols_b=fc._stage_b_cols(R1, R2, torch.float32),
                   cols_b16=fc._stage_b_cols(R1, R2, torch.bfloat16))
        fns = {"a": lambda: fc.stage_a(sr, si, sc, **kw),
               "a16": lambda: fc.stage_a(sr, si, sc, t_dtype=torch.bfloat16, **kw),
               "b": lambda: fc.stage_b(*T, nfft=nfft, output="planes"),
               "b16": lambda: fc.stage_b(*T16, nfft=nfft, output="planes"),
               "b_ps": lambda: fc.stage_b(*T, nfft=nfft, output="power_sum"),
               "b16_ps": lambda: fc.stage_b(*T16, nfft=nfft, output="power_sum")}
        times = {k: [] for k in fns}
        for order in (("a", "a16", "b", "b16", "b_ps", "b16_ps"),
                      ("a16", "a", "b16", "b", "b16_ps", "b_ps")):
            for k in order:
                times[k].append(device_ms(fns[k], calls=calls))
        row.update({k: float(np.median(v)) for k, v in times.items()})
        for t_bytes, suffix in ((4, ""), (2, "16")):
            for output, tail in (("planes", ""), ("power_sum", "_ps")):
                (ab, ao), (bb, bo) = _bounds(nfft, 16, nfft // 2, R1, R2, t_bytes=t_bytes,
                                             output=output)
                row["bound_a" + suffix] = _bound_ms(ab, ao)[0]
                row["bound_b" + suffix + tail] = _bound_ms(bb, bo)[0]
        rows[nfft] = row
        del T, T16
    log("column plans, device ms per call (one half spectrum, 16 scales, planes; "
        "f32 T, then bf16 T, each / its bound): " +
        "; ".join(f"2^{n.bit_length() - 1}: cwt_stage_a R2 {'·'.join(map(str, r['plan_a']))} "
                  f"x{r['cols_a']} {r['a']:.4f} / {r['bound_a']:.4f}, bf16 {r['a16']:.4f} / "
                  f"{r['bound_a16']:.4f}; cwt_stage_b R1 {'·'.join(map(str, r['plan_b']))} "
                  f"x{r['cols_b']} {r['b']:.4f} / {r['bound_b']:.4f}, bf16 "
                  f"x{r['cols_b16']} {r['b16']:.4f} / {r['bound_b16']:.4f}; power_sum "
                  f"{r['b_ps']:.4f} / {r['bound_b_ps']:.4f}, bf16 {r['b16_ps']:.4f} / "
                  f"{r['bound_b16_ps']:.4f}"
                  for n, r in rows.items()))
    return rows


#: JAO/JBaltic's Monte-Carlo golden and the bands of
#: tests/test_mc_significance.py:32-41 (two independent 300-member ensembles)
MC_GOLDEN = "wct_sig_jao_jbaltic.npz"
MC_BANDS = {"max": 0.06, "mean": 0.02}
MC_COUNT, MC_SEED = 300, 7


def _mc_args():
    g = np.load(os.path.join(GOLDEN, MC_GOLDEN))
    kw = dict(dt=float(g["dt"]), dj=float(g["dj"]), s0=float(g["s0"]), J=int(g["J"]))
    return g, float(g["al1"]), float(g["al2"]), kw


def _mc_bands(sig95, ref, what):
    """The golden's NaN/zero structure exactly, and the MC bands."""
    check(sig95.shape == ref.shape, f"{what}: shape {sig95.shape}")
    check(np.array_equal(np.isnan(sig95), np.isnan(ref)), f"{what}: NaN structure")
    check(np.array_equal(sig95 == 0, ref == 0), f"{what}: zero structure")
    valid = np.isfinite(ref) & (ref != 0)
    diff = np.abs(sig95[valid] - ref[valid])
    check(diff.max() < MC_BANDS["max"] and diff.mean() < MC_BANDS["mean"],
          f"{what}: max |dsig95| {diff.max()}, mean {diff.mean()}")
    return float(diff.max()), float(diff.mean())


def _mc_chunk_inputs():
    """The golden's surrogate grid on the card: (n, nfft, scales, outside-COI
    mask, the chunk's keyword arguments)."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco

    _, al1, al2, kw = _mc_args()
    n, sj, oc, _, _ = tco._surrogate_grid(kw["dt"], kw["dj"], kw["s0"], kw["J"],
                                          pt.Morlet(6))
    nfft = 1 << (n - 1).bit_length()
    chunk_kw = dict(mother=pt.Morlet(6), nfft=nfft, dj=kw["dj"], n=n, al1=al1, al2=al2)
    return (n, nfft, torch.tensor(sj, dtype=torch.float32, device="cuda"),
            torch.tensor(oc, device="cuda"), chunk_kw)


def phase_mc_significance():
    """The Monte-Carlo WCT significance on the card, on the golden JAO/JBaltic
    pair's null (S = 76, n = 885, nfft = 1024, 300 members, seed 7):
    wct_significance on both kernel routes against the golden's bands with
    the route's launches counted, the generator kernels' too (one
    ``mc_fold_in`` and two ``mc_rednoise`` a chunk); curves and summed histograms at mc_batch
    300/64/7 bit for bit; the chunk's forward transform (2·300 rows) against
    the plain version; no host sync inside a run of chunks; the 300-member
    run timed on both routes with its peak memory per member against
    _mc_auto_batch's model; the same-seed CPU f64 curve beside the card's;
    wct_significance_batch over 8 nulls at two pair_block values; and
    wct_analysis(sig=True) against the golden."""
    import shutil
    import tempfile

    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch import stats as tst
    from pycwt_torch.analysis import wct_analysis
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops import mc_hist, mc_noise, wct_head
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar
    from pycwt_torch.sample import load
    from pycwt_torch.utils import profiling

    cache_dir = tempfile.mkdtemp(prefix="pycwt_mc_cache_")
    old_cache = os.environ.get("PYCWT_TPU_CACHE_DIR")
    os.environ["PYCWT_TPU_CACHE_DIR"] = cache_dir      # no curve from an earlier run
    try:
        g, al1, al2, kw = _mc_args()
        ref = g["sig95"]
        mc = dict(mc_count=MC_COUNT, seed=MC_SEED, cache=False, progress=False, **kw)
        n, nfft, scales, oc, chunk_kw = _mc_chunk_inputs()
        S = scales.shape[0]
        auto = tco._mc_auto_batch(MC_COUNT, S, nfft, n)
        out = dict(auto_batch=auto, S=S, n=n, nfft=nfft, routes={})
        for small in (False, True):
            name = "cwt_direct" if small else "default"
            with _route(small):
                r = out["routes"][name] = {}
                _reset_counts()
                for k in mc_noise.LAUNCHES:
                    mc_noise.LAUNCHES[k] = 0
                mc_hist.LAUNCHES["mc_coherence_counts"] = 0
                wct_head.LAUNCHES["wct_fields_head"] = 0
                profiling.MC_HIST_KERNEL_CELLS = profiling.MC_HIST_PLAIN_CELLS = 0
                profiling.WCT_HEAD_KERNEL_POINTS = profiling.WCT_HEAD_PLAIN_POINTS = 0
                sig95 = tco.wct_significance(al1, al2, **mc)
                torch.cuda.synchronize()
                r["launches"] = dict(fc.KERNEL_LAUNCHES)
                r["mc_launches"] = dict(mc_noise.LAUNCHES)
                r["hist_launches"] = mc_hist.LAUNCHES["mc_coherence_counts"]
                r["hist_cells"] = (profiling.MC_HIST_KERNEL_CELLS, profiling.MC_HIST_PLAIN_CELLS)
                r["head_launches"] = wct_head.LAUNCHES["wct_fields_head"]
                r["head_points"] = (profiling.WCT_HEAD_KERNEL_POINTS,
                                    profiling.WCT_HEAD_PLAIN_POINTS)
                chunks = r["chunks"] = -(-MC_COUNT // auto)
                check(r["mc_launches"] == {"mc_fold_in": chunks, "mc_rednoise": 2 * chunks},
                      f"MC {name}: generator launches {r['mc_launches']} for {chunks} "
                      "chunks, not one mc_fold_in and two mc_rednoise a chunk")
                check(r["hist_launches"] == chunks
                      and r["hist_cells"] == (MC_COUNT * S * n, 0),
                      f"MC {name}: {r['hist_launches']} mc_coherence_counts launches for "
                      f"{chunks} chunks, points (kernel, torch tail) {r['hist_cells']}")
                check(r["head_launches"] == chunks
                      and r["head_points"] == (MC_COUNT * S * n, 0),
                      f"MC {name}: {r['head_launches']} wct_fields_head launches for "
                      f"{chunks} chunks, points (kernel, torch head) {r['head_points']}")
                r["bands"] = _mc_bands(sig95, ref, f"MC {name}")
                want = (("cwt_direct",) if small else ("cwt_stage_a", "cwt_stage_b"))
                check(all(r["launches"][k] > 0 for k in want)
                      and sum(r["launches"].values()) == sum(r["launches"][k] for k in want),
                      f"MC {name}: wrong kernels launched: {r['launches']}")
                # chunking: curves and summed histograms bit for bit
                key = tst.PRNGKey(MC_SEED, device="cuda")
                for b in (64, 7):
                    other = tco.wct_significance(al1, al2, mc_batch=b, **mc)
                    check(np.array_equal(np.isnan(other), np.isnan(sig95))
                          and np.array_equal(other[np.isfinite(other)],
                                             sig95[np.isfinite(sig95)]),
                          f"MC {name}: mc_batch {b} changed the curve")
                hists = [sum(tco._mc_histogram_chunk(key, s0, scales, oc, kw["dt"],
                                                     batch=min(b, MC_COUNT - s0), **chunk_kw)
                             for s0 in range(0, MC_COUNT, b)) for b in (auto, 64, 7)]
                check(all(torch.equal(h, hists[0]) for h in hists[1:]),
                      f"MC {name}: summed histograms differ across mc_batch")
                check(int(hists[0].sum()) == MC_COUNT * int(oc.sum()), "MC histogram total")
                # the chunk's forward transform: 2 x 300 rows against the plain version
                k1, k2 = tst.split(key)
                idx = torch.arange(MC_COUNT, device="cuda")
                y = torch.cat([tst.rednoise_members(k, idx, n, a, dtype=torch.float32)
                               for k, a in ((k1, al1), (k2, al2))])
                # R² of the first members, bit for bit at 300, 64 and 7 members
                # a call: cuFFT's plans and the band product's cuBLAS call
                # change with the batch, the rows must not
                R2 = [tco._wct_core(y[:b], y[MC_COUNT:MC_COUNT + b], scales, kw["dt"],
                                    mother=pt.Morlet(6), nfft=nfft, dj=kw["dj"])[0]
                      for b in (MC_COUNT, 64, 7)]
                check(all(torch.equal(r2, R2[0][:r2.shape[0]]) for r2 in R2[1:]),
                      f"MC {name}: R2 rows change with the batch")
                del R2
                sr, si = fft_of_real_planar(y, nfft)
                fkw = dict(mother=pt.Morlet(6), nfft=nfft, dt=kw["dt"])
                wr, wi = fc.fused_cwt_planar(sr, si, scales, **fkw)
                plain = fc._direct_reference if small else fc._fused_cwt_planar_reference
                rr, ri = plain(sr, si, scales, **fkw)
                scale_w = float(torch.sqrt(rr * rr + ri * ri).max())
                err = max(float((wr - rr).abs().max()), float((wi - ri).abs().max())) / scale_w
                check(err < TIER_BOUND["high"], f"MC {name}: chunk transform vs plain {err}")
                r["chunk_err"] = err
                del wr, wi, rr, ri, sr, si, y
                # no host sync between chunks
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    tco._mc_histogram_run(key, 0, scales, oc, kw["dt"], batch=100,
                                          nchunks=3, **chunk_kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                # peak memory of the 300-member run (auto mc_batch)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                tco.wct_significance(al1, al2, **mc)
                r["peak_per_member"] = (torch.cuda.max_memory_allocated() - base) / auto
                r["sig95"] = sig95
            log(f"MC {name}: auto mc_batch {auto}, peak {r['peak_per_member']:.4e} bytes a member, "
                f"launches {r['launches']}, generator launches {r['mc_launches']}, "
                f"mc_coherence_counts launches {r['hist_launches']} for {r['chunks']} chunks, "
                f"points binned (kernel, torch tail) {r['hist_cells']}, wct_fields_head "
                f"launches {r['head_launches']}, points (kernel, torch head) "
                f"{r['head_points']}, bands max {r['bands'][0]:.4f} mean "
                f"{r['bands'][1]:.4f}, chunk transform vs plain {r['chunk_err']:.3e} of "
                f"max|W|; R2 rows, curves and histograms at mc_batch {auto}/64/7 "
                f"bit-identical; no host sync in a run of chunks")
        # the 300-member run on each route, timed in turns (default, cwt_direct,
        # cwt_direct, default), each turn the median of 5 after a warm-up
        turns = {"default": [], "cwt_direct": []}
        for name in ("default", "cwt_direct", "cwt_direct", "default"):
            with _route(name == "cwt_direct"):
                turns[name].append(time_ms(lambda: tco.wct_significance(al1, al2, **mc),
                                           runs=5, warmup=1))
        for name, times in turns.items():
            out["routes"][name]["ms"] = float(np.mean(times))
            out["routes"][name]["ms_turns"] = times
        log("MC 300 members, CUDA events in turns default/cwt_direct/cwt_direct/default "
            f"(median of 5 each): default {turns['default']} ms, cwt_direct "
            f"{turns['cwt_direct']} ms")
        out["model_per_member"] = tco._mc_member_bytes(S, nfft, n)
        # the generator alone: the two signals' 300 members, as one chunk draws them
        key = tst.PRNGKey(MC_SEED, device="cuda")
        k1, k2 = tst.split(key)
        idx = torch.arange(MC_COUNT, device="cuda")

        def draw():
            for k, a in ((k1, al1), (k2, al2)):
                tst.rednoise_members(k, idx, n, a, dtype=torch.float32)

        out["generator_ms"] = time_ms(draw, runs=11)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw()
        out["generator_host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # the same members in f64 on the CPU: the card's f32 curve beside it
        cpu = tco.wct_significance(al1, al2, mc_batch=60, device="cpu",
                                   config=CWTConfig(dtype=torch.float64), **mc)
        finite = np.isfinite(cpu)
        out["vs_cpu_f64"] = {k: float(np.abs(r["sig95"][finite] - cpu[finite]).max())
                             for k, r in out["routes"].items()}
        check(all(v < MC_BANDS["mean"] for v in out["vs_cpu_f64"].values()),
              f"MC: card f32 vs CPU f64 on the same members {out['vs_cpu_f64']}")
        # the batched surface: 8 distinct nulls, two pair blocks (3 pads the last
        # block with a repeat of its last null, so 9 rows are binned)
        a1 = [0.0, 0.1, 0.2, 0.3, 0.45, 0.6, 0.75, 0.9]
        a2 = [0.05, 0.5, 0.0, 0.35, 0.2, 0.1, 0.6, 0.3]
        bkw = dict(alpha_quant=0, **mc)
        _reset_counts()
        mc_hist.LAUNCHES["mc_coherence_counts"] = 0
        wct_head.LAUNCHES["wct_fields_head"] = 0
        profiling.MC_NULL_CHUNKS = profiling.MC_NULL_MEMBERS = 0
        profiling.MC_HIST_KERNEL_CELLS = profiling.MC_HIST_PLAIN_CELLS = 0
        profiling.WCT_HEAD_KERNEL_POINTS = profiling.WCT_HEAD_PLAIN_POINTS = 0
        curves = [tco.wct_significance_batch(a1, a2, pair_block=pb, **bkw) for pb in (8, 3)]
        torch.cuda.synchronize()
        blaunch = dict(fc.KERNEL_LAUNCHES)
        check(_four_step_only(blaunch), f"wct_significance_batch launches {blaunch}")
        out["batch_hist"] = dict(launches=mc_hist.LAUNCHES["mc_coherence_counts"],
                                 chunks=profiling.MC_NULL_CHUNKS,
                                 cells=(profiling.MC_HIST_KERNEL_CELLS,
                                        profiling.MC_HIST_PLAIN_CELLS),
                                 members=profiling.MC_NULL_MEMBERS,
                                 head_launches=wct_head.LAUNCHES["wct_fields_head"],
                                 head_points=(profiling.WCT_HEAD_KERNEL_POINTS,
                                              profiling.WCT_HEAD_PLAIN_POINTS))
        bh = out["batch_hist"]
        check(bh["chunks"] > 0 and bh["launches"] == bh["chunks"]
              and bh["cells"] == (sum(-(-len(a1) // pb) * pb for pb in (8, 3))
                                  * MC_COUNT * S * n, 0),
              f"wct_significance_batch: {bh['launches']} mc_coherence_counts launches for "
              f"{bh['chunks']} chunks, points (kernel, torch tail) {bh['cells']}")
        # the head runs on every member a chunk draws, the last chunk's
        # overdrawn ones too, which the counts leave out
        check(bh["head_launches"] == bh["chunks"]
              and bh["head_points"] == (bh["members"] * S * n, 0),
              f"wct_significance_batch: {bh['head_launches']} wct_fields_head launches for "
              f"{bh['chunks']} chunks, points (kernel, torch head) {bh['head_points']}")
        check(curves[0].shape == (8, kw["J"] + 1)
              and np.array_equal(np.nan_to_num(curves[0], nan=-1.0),
                                 np.nan_to_num(curves[1], nan=-1.0)),
              "wct_significance_batch: pair_block changed the curves")
        out["batch_ms"] = time_ms(lambda: tco.wct_significance_batch(a1, a2, **bkw),
                                  runs=3, warmup=1)
        # wct_analysis(sig=True) on the default route, against the golden
        jao, jba = load("jao"), load("jbaltic")
        nn = min(jao.values.size, jba.values.size)
        _reset_counts()
        res = wct_analysis(jao.values[:nn], jba.values[:nn], jao.dt, significance_level=0.95,
                           mc_count=MC_COUNT, seed=MC_SEED, progress=False)
        torch.cuda.synchronize()
        alaunch = dict(fc.KERNEL_LAUNCHES)
        check(_four_step_only(alaunch), f"wct_analysis(sig=True) launches {alaunch}")
        out["analysis_bands"] = _mc_bands(res["sig95"], ref, "wct_analysis(sig=True)")
        gf = np.load(os.path.join(GOLDEN, "figure_jao_jbaltic.npz"))
        check(rel_err(res["WCT"], gf["wct"]) < WCT_BOUND, "wct_analysis WCT golden")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("PYCWT_TPU_CACHE_DIR", None)
        else:
            os.environ["PYCWT_TPU_CACHE_DIR"] = old_cache
    ms_default = out["routes"]["default"]["ms"]
    log(f"MC: generator (2 x 300 members, n {n}) {out['generator_ms']:.4f} ms by CUDA "
        f"events ({100 * out['generator_ms'] / ms_default:.1f} % of the default route's "
        f"run), {out['generator_host_ms']:.4f} ms of host time to enqueue; peak bytes a "
        f"member {out['routes']['default']['peak_per_member']:.4e} (default), "
        f"{out['routes']['cwt_direct']['peak_per_member']:.4e} (cwt_direct) vs the model's "
        f"{out['model_per_member']:.4e}; card f32 vs CPU f64 on the same members, max "
        f"|dsig95| {out['vs_cpu_f64']}; wct_significance_batch 8 nulls x 300 members "
        f"{out['batch_ms']:.4f} ms, pair_block 8 and 3 bit-identical, launches {blaunch}, "
        f"mc_coherence_counts {out['batch_hist']}; "
        f"wct_analysis(sig=True) bands max {out['analysis_bands'][0]:.4f} mean "
        f"{out['analysis_bands'][1]:.4f}, launches {alaunch}")
    return out


def phase_mc_generator(card, calls=20):
    """The generator of one 300-member chunk (``wct_mc300``'s shape, the
    golden's g): ``split`` and the two signals' ``rednoise_members`` at
    (300, n 885) in f32, through the kernels (``mc_fold_in``, then
    ``mc_rednoise`` twice) and through the torch code on the card, in turns;
    the rows bit for bit; host ms to enqueue a call (median of 21, after a
    synchronize), device ms (torch.profiler over ``calls`` calls), launches
    a call, and the kernels' bound by bytes (the rows written, the keys and
    indices read, at 3.35 TB/s); then each kernel's device ms and launches a
    call, and its own bound, from one more profile of the kernel path."""
    from torch.profiler import ProfilerActivity, profile

    from pycwt_torch import stats as tst
    from pycwt_torch.ops import mc_noise

    _, al1, al2, kw = _mc_args()
    n = _mc_chunk_inputs()[0]
    key = tst.PRNGKey(MC_SEED, device="cuda")
    idx = torch.arange(MC_COUNT, device="cuda")

    def draw():
        k1, k2 = tst.split(key)
        return [tst.rednoise_members(k, idx, n, a, dtype=torch.float32)
                for k, a in ((k1, al1), (k2, al2))]

    on_card, out, rows = tst._on_card, {"card": card, "n": n, "members": MC_COUNT}, {}
    for path in ("kernel", "torch", "torch", "kernel"):
        tst._on_card = on_card if path == "kernel" else (lambda key: False)
        try:
            before = dict(mc_noise.LAUNCHES)
            rows[path] = draw()
            torch.cuda.synchronize()
            launches = sum(mc_noise.LAUNCHES.values()) - sum(before.values())
            host = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                draw()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev = device_ms(draw, calls=calls)
        finally:
            tst._on_card = on_card
        r = out.setdefault(path, {"host_ms": [], "device_ms": [], "launches": launches})
        r["host_ms"].append(float(np.median(host)))
        r["device_ms"].append(dev)
    check(all(torch.equal(a, b) for a, b in zip(rows["kernel"], rows["torch"])),
          "MC generator: the kernels' rows differ from the torch path's")
    check(out["kernel"]["launches"] == 3,
          f"MC generator: {out['kernel']['launches']} kernel launches a call, not 3")
    nbytes = sum(r.numel() * r.element_size() for r in rows["kernel"]) + 16 * MC_COUNT
    out["bound_ms"] = nbytes / PEAK_BYTES * 1e3
    out["bound_bytes"] = nbytes
    for path in ("kernel", "torch"):
        r = out[path]
        r["host_ms_median"] = float(np.median(r["host_ms"]))
        r["device_ms_median"] = float(np.median(r["device_ms"]))
    out["bound_share"] = out["bound_ms"] / out["kernel"]["device_ms_median"]
    # each kernel alone: fold_in writes two keys from one, rednoise the full
    # n + tau rows (the views' storage) from the keys and the indices
    kbytes = {"mc_fold_in": 3 * 16,
              "mc_rednoise": sum(r.untyped_storage().nbytes() + 8 * MC_COUNT + 16
                                 for r in rows["kernel"])}
    # launches from the counter; device ms a launch from the records CUPTI
    # kept (it drops one now and then), times the launches a call
    draw()
    torch.cuda.synchronize()
    before = dict(mc_noise.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            draw()
        torch.cuda.synchronize()
    recorded = _device_rows(prof, 1)
    out["kernels"] = {}
    for name in mc_noise.LAUNCHES:
        launches = (mc_noise.LAUNCHES[name] - before[name]) / calls
        ms = sum(r[0] for r in recorded if f"{name}_kernel" in r[2])
        records = sum(r[1] for r in recorded if f"{name}_kernel" in r[2])
        check(records > 0, f"MC generator: the profiler recorded no {name} launch")
        dev = ms / records * launches
        bound = kbytes[name] / PEAK_BYTES * 1e3
        out["kernels"][name] = dict(device_ms=dev, launches_per_call=launches,
                                    records_lost=calls * launches - records, bound_ms=bound,
                                    bound_bytes=kbytes[name], bound_share=bound / dev)
    check({k: r["launches_per_call"] for k, r in out["kernels"].items()}
          == {"mc_fold_in": 1, "mc_rednoise": 2},
          f"MC generator: launches a call {out['kernels']}")
    log("MC generator, each kernel a call: " + ", ".join(
        f"{k} {r['device_ms']:.5f} ms x{r['launches_per_call']:g}, bound {r['bound_ms']:.6f} "
        f"ms ({r['bound_bytes']} bytes)" for k, r in out["kernels"].items()))
    log(f"MC generator (split + 2 x rednoise_members, 300 x {n}, f32), kernel/torch in "
        f"turns: host {out['kernel']['host_ms']} / {out['torch']['host_ms']} ms to "
        f"enqueue, device {out['kernel']['device_ms']} / {out['torch']['device_ms']} ms, "
        f"launches {out['kernel']['launches']} / {out['torch']['launches']} (kernel "
        f"counter), bound {out['bound_ms']:.5f} ms by bytes ({nbytes} bytes, "
        f"{100 * out['bound_share']:.2f} % of it); rows bit for bit")
    return out


def _mc_chunk_fields(shape):
    """The smoothed fields ``(S, C)`` of one real Monte-Carlo chunk on the
    card, ``(P, B, S, n)`` complex64, and its outside-COI mask: ``wct_mc300``'s
    chunk (P 1, the golden's α pair, 300 members of 885 samples, S 76) or
    ``wct_matrix_mc_32st``'s (P nulls of B members, 6302 samples, S 110,
    coefficients in [0.4, 0.8])."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch import stats as tst

    P, B = shape
    _, al1, al2, kw = _mc_args()
    J = kw["J"] if P == 1 else 109
    n, sj, oc, _, _ = tco._surrogate_grid(kw["dt"], kw["dj"], kw["s0"], J, pt.Morlet(6))
    nfft = 1 << (n - 1).bit_length()
    sj = torch.tensor(sj, dtype=torch.float32, device="cuda")
    k1, k2 = tst.split(tst.PRNGKey(MC_SEED, device="cuda"))
    idx = torch.arange(B, device="cuda")
    g1 = torch.linspace(0.4, 0.8, P, device="cuda") if P > 1 else al1
    g2 = torch.linspace(0.75, 0.45, P, device="cuda") if P > 1 else al2
    if P > 1:
        slots = torch.arange(P, device="cuda")
        y1 = tst.rednoise_members_pairs(k1, slots, idx, n, g1, 64).reshape(P * B, n)
        y2 = tst.rednoise_members_pairs(k2, slots, idx, n, g2, 64).reshape(P * B, n)
    else:
        y1 = tst.rednoise_members(k1, idx, n, g1, 1.0)
        y2 = tst.rednoise_members(k2, idx, n, g2, 1.0)
    w1, w2, sj = tco._planar_ws(y1, y2, sj, kw["dt"], mother=pt.Morlet(6), nfft=nfft)
    Sm, Cm, _ = tco._planar_fields(w1, w2, sj, dt=kw["dt"], dj=kw["dj"], mother=pt.Morlet(6))
    S = sj.shape[0]
    return Sm.view(P, B, S, n), Cm.view(P, B, S, n), torch.tensor(oc, device="cuda")


#: the chunks of the two Monte-Carlo cells, (P, B): wct_mc300's 300
#: members of one null, and wct_matrix_mc_32st's ~405 member pairs (45
#: nulls of 9 members)
MC_HIST_SHAPES = {"wct_mc300": (1, 300), "wct_matrix_mc_32st": (45, 9)}


def phase_mc_histogram(card, calls=10):
    """The Monte-Carlo chunk's tail at both cells' chunk shapes, on the
    smoothed fields of a real chunk: ``mc_coherence_counts`` against the
    torch tail it replaces (the ratio's five element-wise ops,
    ``_histogram``'s passes and ``scatter_add_``, and the accumulator's add),
    in turns (kernel, torch, torch, kernel); the counts bit for bit; device ms a call (torch.profiler over ``calls``
    calls), launches a call, and the kernel's bound by bytes: 16 a point
    outside the COI of the fields, the mask, and the counts read and
    written, at 3.35 TB/s."""
    from pycwt_torch import coherence as tco
    from pycwt_torch.ops import mc_hist

    out = {"card": card, "shapes": {}}
    for cell, shape in MC_HIST_SHAPES.items():
        Sm, Cm, oc = _mc_chunk_fields(shape)
        P, B, S, n = Sm.shape
        acc = torch.zeros((P, S, tco.NBINS), dtype=torch.int64, device="cuda")
        roads = {
            "kernel": lambda: mc_hist.coherence_counts(Sm, Cm, oc, B, acc),
            "torch": lambda: acc.add_(tco._histogram(tco._coherence_ratio(Sm, Cm), oc)),
        }
        counts = {}
        for road, fn in roads.items():
            acc.zero_()
            fn()
            counts[road] = acc.clone()
        err = int((counts["kernel"] - counts["torch"]).abs().max())
        check(err == 0,
              f"MC counts at {cell}'s chunk: the kernel's counts differ from the torch path's "
              f"by up to {err}")
        outside = int(oc.sum())
        nbytes = 16 * P * B * outside + S * n + 2 * acc.numel() * 8
        bound = nbytes / PEAK_BYTES * 1e3
        r = {"shape": [P, B, S, n], "points_outside_coi": P * B * outside,
             "bound_ms": bound, "bound_bytes": nbytes, "max_abs_err": err}
        for road in ("kernel", "torch", "torch", "kernel"):
            before = mc_hist.LAUNCHES["mc_coherence_counts"]
            roads[road]()
            launches = mc_hist.LAUNCHES["mc_coherence_counts"] - before
            d = r.setdefault(road, {"device_ms": [], "kernel_launches_per_call": launches})
            d["device_ms"].append(device_ms(roads[road], calls=calls, floor=bound))
        for road in roads:
            r[road]["device_ms_median"] = float(np.median(r[road]["device_ms"]))
            r[road]["bound_share"] = bound / r[road]["device_ms_median"]
        check(r["kernel"]["kernel_launches_per_call"] == 1
              and r["torch"]["kernel_launches_per_call"] == 0,
              f"MC counts at {cell}'s chunk: launches {r}")
        out["shapes"][cell] = r
        log(f"MC counts at {cell}'s chunk {P} x {B} x {S} x {n}: device ms a call, in turns, "
            f"kernel {r['kernel']['device_ms']}, torch tail {r['torch']['device_ms']}; bound "
            f"{bound:.5f} ms by bytes ({nbytes} bytes, {100 * r['kernel']['bound_share']:.2f} % "
            f"of it); counts bit for bit")
        del Sm, Cm, acc, counts
        torch.cuda.empty_cache()
    return out


#: the coherence head's shapes: a wct_matrix_mc_32st chunk (405 member
#: pairs of 110 scales, 6302 samples trimmed from rows of 8192, no cross
#: planes) and an overlap_16m chunk (64 scales of 2^19, whole rows, the
#: cross planes kept)
WCT_HEAD_SHAPES = {"wct_matrix_mc_32st": ((405,), 110, 6302, 8192, False),
                   "overlap_16m": ((), 64, 1 << 19, 1 << 19, True)}


def phase_wct_head(card, calls=10):
    """The coherence head at both shapes: ``wct_fields_head`` against the
    torch head it replaces (18 element-wise launches), in turns (kernel,
    torch, torch, kernel), on random planes; the fields (and cross planes)
    bit for bit; device ms a call (torch.profiler over ``calls`` calls),
    launches a call, and the kernel's bound by bytes: 32 a point (the four
    planes read, the two complex64 fields written), 40 with the cross
    planes, at 3.35 TB/s."""
    from pycwt_torch import coherence as tco
    from pycwt_torch.ops import wct_head

    out = {"card": card, "shapes": {}}
    for cell, (lead, S, n, pitch, cross) in WCT_HEAD_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(S + n)
        full = torch.randn((4, *lead, S, pitch), generator=g, device="cuda")[..., :n]
        w1, w2 = (full[0], full[1]), (full[2], full[3])
        sc = torch.linspace(0.5, 1600.0, S, device="cuda")
        roads = {"kernel": lambda: wct_head.fields_head(*w1, *w2, sc, cross=cross),
                 "torch": lambda: tco._torch_head(w1, w2, sc, cross=cross)}
        got, want = roads["kernel"](), roads["torch"]()
        pairs = list(zip(got[:2], want[:2])) + (list(zip(got[2], want[2])) if cross else [])
        same = all(torch.equal(torch.view_as_real(a) if a.is_complex() else a,
                               torch.view_as_real(b) if b.is_complex() else b)
                   for a, b in pairs)
        check(same, f"coherence head at {cell}'s chunk: the kernel's fields differ from the "
                    "torch head's")
        del got, want, pairs
        points = math.prod(lead) * S * n
        nbytes = (40 if cross else 32) * points
        bound = nbytes / PEAK_BYTES * 1e3
        r = {"shape": [*lead, S, n], "pitch": pitch, "cross": cross, "points": points,
             "bound_ms": bound, "bound_bytes": nbytes, "bit_for_bit": same}
        for road in ("kernel", "torch", "torch", "kernel"):
            before = wct_head.LAUNCHES["wct_fields_head"]
            roads[road]()
            launches = wct_head.LAUNCHES["wct_fields_head"] - before
            d = r.setdefault(road, {"device_ms": [], "kernel_launches_per_call": launches})
            d["device_ms"].append(device_ms(roads[road], calls=calls, floor=bound))
        for road in roads:
            r[road]["device_ms_median"] = float(np.median(r[road]["device_ms"]))
            r[road]["bound_share"] = bound / r[road]["device_ms_median"]
        check(r["kernel"]["kernel_launches_per_call"] == 1
              and r["torch"]["kernel_launches_per_call"] == 0,
              f"coherence head at {cell}'s chunk: launches {r}")
        out["shapes"][cell] = r
        log(f"coherence head at {cell}'s chunk {r['shape']} (pitch {pitch}, cross {cross}): "
            f"device ms a call, in turns, kernel {r['kernel']['device_ms']}, torch head "
            f"{r['torch']['device_ms']}; bound {bound:.5f} ms by bytes ({nbytes} bytes, "
            f"{100 * r['kernel']['bound_share']:.2f} % of it; torch head "
            f"{100 * r['torch']['bound_share']:.2f} %); fields bit for bit")
        del full, w1, w2, roads
        torch.cuda.empty_cache()
    log(json.dumps({"wct_head": out}))
    return out


def phase_mc_trace():
    """``--trace``: torch.profiler over one 300-member wct_significance run on
    each route (after a warm-up): the device's busy time, its share of the
    wall time under the profiler, and the largest device items."""
    from torch.profiler import ProfilerActivity, profile

    from pycwt_torch import coherence as tco

    _, al1, al2, kw = _mc_args()
    mc = dict(mc_count=MC_COUNT, seed=MC_SEED, cache=False, progress=False, **kw)
    for small in (False, True):
        with _route(small):
            tco.wct_significance(al1, al2, **mc)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tco.wct_significance(al1, al2, **mc)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof, 1)
        busy = sum(r[0] for r in rows)
        ours = [(ms, cnt, re.search(r"cwt_\w+(<\d+>)?", key).group(0))
                for ms, cnt, key in rows if "cwt_" in key]
        log(f"trace, MC 300 members, route {'cwt_direct' if small else 'default (K1+K2)'}: "
            f"{wall:.4f} ms wall under the profiler, device busy {busy:.4f} ms "
            f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %, "
            f"{sum(r[1] for r in rows):g} kernel launches; the port's kernels: " +
            ", ".join(f"{name} {ms:.4f} ms x{cnt:g}" for ms, cnt, name in ours))
        for ms, cnt, key in rows[:12]:
            log(f"  {ms:.4f} ms  x{cnt:g}  {key[:90]}")


def phase_pairs_long_trace():
    """``--trace``: torch.profiler over one call each of the 32-station
    wct_matrix (unfetched) and wct_matrix_analysis (300-member nulls, no
    cache), and of cwt_overlap_save_planar and wct_overlap_planar at N =
    2^24 (after a warm-up call): the device's busy time, its share of the
    wall time under the profiler, the largest device items."""
    from torch.profiler import ProfilerActivity, profile

    import pycwt_torch as pt
    from pycwt_torch.analysis import wct_matrix_analysis
    from pycwt_torch.ops import overlap as tov

    y = _stations()
    sc = torch.tensor(2.0 * 2.0 ** (np.arange(LONG_S) / 8.0), dtype=torch.float32,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(LONG_TIME_N, generator=gen, device="cuda")
    x2 = 0.5 * x + torch.randn(LONG_TIME_N, generator=gen, device="cuda")
    kw = dict(mother=pt.Morlet(6), chunk=LONG_CHUNK)
    calls = {
        "wct_matrix, 32 stations, unfetched":
            lambda: pt.wct_matrix(y, PAIRS_DT, as_numpy=False),
        "wct_matrix_analysis, 32 stations, 300 members, no cache":
            lambda: wct_matrix_analysis(y, dt=PAIRS_DT, mc_count=PAIRS_MC, cache=False),
        "cwt_overlap_save_planar, N = 2^24":
            lambda: tov.cwt_overlap_save_planar(x, sc, 1.0, **kw),
        "wct_overlap_planar, N = 2^24":
            lambda: tov.wct_overlap_planar(x, x2, sc, 1.0, dj=LONG_DJ, **kw),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof, 1)
        busy = sum(r[0] for r in rows)
        log(f"trace, {name}: {wall:.4f} ms wall under the profiler, device busy "
            f"{busy:.4f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %, "
            f"{sum(r[1] for r in rows):g} kernel launches")
        for ms, cnt, key in rows[:10]:
            log(f"  {ms:.4f} ms  x{cnt:g}  {key[:90]}")


def phase_direct_gradient():
    """Gradients through cwt_direct's autograd Function equal the plain
    version's at nfft = 2^12 within 1e-4 (tests/test_autodiff.py:91-111)."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    nfft = 1 << 12
    x0 = np.random.default_rng(3).standard_normal(nfft)

    def grads(fn):
        x = torch.tensor(x0, dtype=torch.float32, device="cuda", requires_grad=True)
        sc = torch.tensor([4.0, 16.0, 64.0], device="cuda", requires_grad=True)
        sr, si = fft_of_real_planar(x, nfft)
        return torch.autograd.grad(fn(sr, si, sc).sum() / nfft, (x, sc))

    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output="power_sum")
    gx, gs = grads(lambda sr, si, sc: fc.fused_cwt_planar(sr, si, sc, small_kernel=True,
                                                          **kw))
    rx, rs = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    ex = float((gx - rx).abs().max() / rx.abs().max())
    es = float(((gs - rs).abs() / rs.abs()).max())
    check(ex <= 1e-4 and es <= 1e-4, f"cwt_direct gradients: x {ex}, scales {es}")
    log(f"gradient through cwt_direct vs plain: x {ex:.3e}, scales {es:.3e} (bound 1e-4)")


#: The composed 32-station network (tools/tpu_bench_composed.py:62-73): AR(1)
#: stations, g ~ U(0.4, 0.8), 256 burn-in samples, dt = 0.25 → S = 110
#: scales, nfft 1024, 496 pairs; Monte-Carlo nulls of 300 members at nfft 8192
PAIRS_B, PAIRS_N0, PAIRS_DT, PAIRS_MC = 32, 1024, 0.25, 300
#: members of the one null recomputed in f64 on the CPU (its cost grows with
#: the count; a count's f32/f64 bin crossings move the curve by ~1e-3/count)
NULL_CHECK_MC = 100
#: tools/tpu_bench_long.py:19-46: Morlet-6, 64 scales, s0 = 2·dt, dj = 1/8
#: (s_max ≈ 469·dt), dt = 1, the default chunk 2^18 (chunk nfft 2^19)
LONG_S, LONG_DJ, LONG_CHUNK = 64, 1 / 8, 1 << 18
#: N of the checks against the global transform, and of the timed runs
LONG_CHECK_N, LONG_TIME_N = 1 << 22, 1 << 24
#: pycwt_tpu's blocked WCT phase against its own global planar core where
#: R² > 0.2, 64 scales, on the CPU (tests/test_torch_overlap.py's
#: phase_figures: chunk 2^14, 2^16, 2^18 at N = 2^16, 2^18, 2^20)
JAX_PHASE_R2 = {"2^16": 5.8875e-3, "2^18": 1.3108e-2, "2^20": 4.1230e-2}


def _stations():
    rng = np.random.default_rng(7)
    g_true = rng.uniform(0.4, 0.8, PAIRS_B)
    y = np.empty((PAIRS_B, PAIRS_N0))
    for b in range(PAIRS_B):
        e = rng.standard_normal(PAIRS_N0 + 256)
        for t in range(1, len(e)):
            e[t] += g_true[b] * e[t - 1]
        y[b] = e[256:]
    return y


def _peak_bytes(fn):
    """(bytes allocated at the peak of ``fn()`` above those allocated
    before, its result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def _bytes_a_pair(call, big, small):
    """Peak bytes a pair of ``call(pair_block)``: the peaks at blocks of
    ``big`` and ``small`` pairs apart, over the pairs between (the output,
    the same at both, cancels)."""
    p_big, _ = _peak_bytes(lambda: call(big))
    p_small, _ = _peak_bytes(lambda: call(small))
    return (p_big - p_small) / (big - small)


def _vs_plain(sr, si, sc, small, **kw):
    """Max error of the route's kernels against their plain version on the
    same planar spectra, relative to max|W| (the `highest` bound)."""
    from pycwt_torch.ops import fused_cwt as fc

    wr, wi = fc.fused_cwt_planar(sr, si, sc, small_kernel=small, **kw)
    plain = fc._direct_reference if small else fc._fused_cwt_planar_reference
    rr, ri = plain(sr, si, sc, **kw)
    err = max(float((wr - rr).abs().max()), float((wi - ri).abs().max()))
    err /= float(torch.sqrt(rr * rr + ri * ri).max())
    check(math.isfinite(err) and err < TIER_BOUND["highest"],
          f"{'cwt_direct' if small else 'K1+K2'} vs plain at {tuple(sr.shape)}, "
          f"nfft {kw['nfft']}: {err}")
    return err


def phase_pairs(card):
    """The all-pairs path on the 32-station network: wct_matrix on both
    kernel routes (launches counted) against the CPU f64 port on 16 pairs;
    rows against wct(sig=False), and station 0's 31 pairs through wct_pairs,
    xwt_pairs and xwt_pairs_planar; blocking; as_numpy=False; peak bytes a
    pair against _pairs_block's planes and the resident set against its
    guard; the kernels at the path's shapes against their plain versions;
    wct_matrix_analysis(mc_count=300) cold and warm on a fresh cache, and
    one of its nulls recomputed in f64 on the CPU."""
    import shutil
    import tempfile

    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch.analysis import wct_matrix_analysis
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops import wct_head
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar
    from pycwt_torch.utils import profiling
    from pycwt_torch.transform import build_scale_grid

    y = _stations()
    B, n0, dt = PAIRS_B, PAIRS_N0, PAIRS_DT
    P = B * (B - 1) // 2
    f64 = CWTConfig(dtype=torch.float64)
    out = dict(routes={})
    maps = {}
    for small in (False, True):
        name = "cwt_direct" if small else "default"
        with _route(small):
            _reset_counts()
            W, A, coi, freq, pairs = pt.wct_matrix(y, dt)
            torch.cuda.synchronize()
            launches = dict(fc.KERNEL_LAUNCHES)
            ms = time_ms(lambda: pt.wct_matrix(y, dt), runs=5, warmup=1)
            ms_device = time_ms(lambda: pt.wct_matrix(y, dt, as_numpy=False), runs=5,
                                warmup=1)
        S = W.shape[1]
        check(W.shape == A.shape == (P, S, n0) and S == 110 and np.isfinite(W).all()
              and np.isfinite(A).all(), f"wct_matrix {name}: {W.shape}")
        want = ("cwt_direct",) if small else ("cwt_stage_a", "cwt_stage_b")
        check(all(launches[k] == 1 for k in want) and sum(launches.values()) == len(want),
              f"wct_matrix {name}: launches {launches}")
        maps[name] = (W, A)
        out["routes"][name] = dict(launches=launches, ms=ms, ms_unfetched=ms_device)
    nfft = 1 << (n0 - 1).bit_length()
    # the two f32 routes, all 496 maps, at the planar bound of
    # tests/test_coherence.py:309 (5e-5 of max R², which is ~1)
    routes_agree = float(np.abs(maps["cwt_direct"][0] - maps["default"][0]).max())
    check(routes_agree <= 5e-5, f"wct_matrix routes disagree: {routes_agree}")
    W, A = maps["default"]

    # 16 pairs against the CPU f64 port (rel_err bound tests/test_engines.py:170)
    sel = np.linspace(0, P - 1, 16).astype(int)
    Wc, *_ = pt.wct_matrix(y, dt, pairs=pairs[sel], device="cpu", config=f64)
    out["vs_cpu_f64"] = {k: rel_err(m[0][sel], Wc) for k, m in maps.items()}
    check(all(e < WCT_BOUND for e in out["vs_cpu_f64"].values()),
          f"wct_matrix vs CPU f64: {out['vs_cpu_f64']}")

    # rows against the card's wct(sig=False), and station 0's 31 pairs
    rows_err = 0.0
    for p in (0, 1, P // 2, P - 1):
        i, j = pairs[p]
        Wij, *_ = pt.wct(y[i], y[j], dt, sig=False)
        rows_err = max(rows_err, float(np.abs(W[p] - Wij).max()))
    y1, y2 = np.repeat(y[:1], B - 1, 0), y[1:]
    _reset_counts()
    Wp, Ap, *_ = pt.wct_pairs(y1, y2, dt)
    X, _, _, sig = pt.xwt_pairs(y1, y2, dt)
    mag, phase, *_ = pt.xwt_pairs_planar(y1, y2, dt)
    torch.cuda.synchronize()
    pair_launches = dict(fc.KERNEL_LAUNCHES)
    check(_four_step_only(pair_launches), f"pair surfaces launches {pair_launches}")
    Xc, _, _, sigc = pt.xwt_pairs(y1, y2, dt, device="cpu", config=f64)
    errs = dict(
        rows_vs_wct=rows_err,
        wct_pairs=float(np.abs(Wp - W[:B - 1]).max()),
        xwt_pairs_vs_cpu_f64=float(np.abs(np.abs(X) - np.abs(Xc)).max() / np.abs(Xc).max()),
        xwt_pairs_planar=float(np.abs(mag - np.abs(X)).max() / np.abs(X).max()))
    check(errs["rows_vs_wct"] <= 5e-5 and errs["wct_pairs"] <= 5e-5
          and errs["xwt_pairs_vs_cpu_f64"] <= 2e-5 and errs["xwt_pairs_planar"] <= 2e-5
          and np.allclose(sig, sigc, rtol=1e-10, atol=0), f"pair surfaces: {errs}")
    out["pair_errs"] = errs

    # blocking: the auto block (all 496) against blocks of 7, a ragged tail
    W7, A7, *_ = pt.wct_matrix(y, dt, pair_block=7)
    out["block_identical"] = bool(np.array_equal(W7, W) and np.array_equal(A7, A))
    out["block_diff"] = max(float(np.abs(W7 - W).max()),
                            float(np.abs(np.angle(np.exp(1j * (A7 - A)))).max()))
    check(out["block_diff"] <= 1e-6, f"pair_block 7 vs auto: {out['block_diff']}")
    Wd, Ad, *_ = pt.wct_matrix(y, dt, as_numpy=False)
    check(Wd.is_cuda and Ad.is_cuda and torch.equal(Wd.cpu(), torch.from_numpy(W))
          and torch.equal(Ad.cpu(), torch.from_numpy(A)), "as_numpy=False")
    del Wd, Ad, W7, A7

    # memory: peak bytes a pair against _pairs_block's planes, resident set
    plane = S * nfft * 4
    measured = {
        "xwt_pairs": _bytes_a_pair(lambda b: pt.xwt_pairs(y1, y2, dt, pair_block=b), 30, 15),
        "xwt_pairs_planar": _bytes_a_pair(
            lambda b: pt.xwt_pairs_planar(y1, y2, dt, pair_block=b), 30, 15),
        "wct_pairs": _bytes_a_pair(lambda b: pt.wct_pairs(y1, y2, dt, pair_block=b), 30, 15),
        "wct_matrix": _bytes_a_pair(lambda b: pt.wct_matrix(y, dt, pair_block=b), P, P // 2)}
    model = dict(xwt_pairs=24, xwt_pairs_planar=24, wct_pairs=112, wct_matrix=48)
    out["planes_a_pair"] = {k: v / plane for k, v in measured.items()}
    peak_one, _ = _peak_bytes(lambda: pt.wct_matrix(y, dt, pair_block=1))
    out["resident"] = peak_one - 2 * P * S * n0 * 4 - measured["wct_matrix"]
    out["resident_model"] = 6 * B * S * nfft * 4
    log(f"[{card}] pairs memory: planes a pair measured "
        + ", ".join(f"{k} {v:.2f} (model {model[k]})" for k, v in out["planes_a_pair"].items())
        + f"; wct_matrix resident set {out['resident']:.4e} bytes (guard's model "
        f"{out['resident_model']:.4e})")
    check(all(out["planes_a_pair"][k] <= model[k] for k in model),
          f"peak bytes a pair over _pairs_block's planes: {out['planes_a_pair']}")
    check(out["resident"] <= out["resident_model"], "resident set over the guard's model")

    # the kernels at the path's shapes (32 rows, S = 110, nfft 1024)
    yn = torch.tensor((y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True),
                      dtype=torch.float32, device="cuda")
    sc = torch.tensor(build_scale_grid(n0, dt).sj, dtype=torch.float32, device="cuda")
    sr, si = fft_of_real_planar(yn, nfft)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=dt)
    out["kernel_err"] = {"K1+K2": _vs_plain(sr, si, sc, False, **kw),
                         "cwt_direct": _vs_plain(sr, si, sc, True, **kw)}

    # the analysis call, cold and warm, on a fresh cache directory
    cache_dir = tempfile.mkdtemp(prefix="pycwt_pairs_cache_")
    old_cache = os.environ.get("PYCWT_TPU_CACHE_DIR")
    os.environ["PYCWT_TPU_CACHE_DIR"] = cache_dir
    try:
        runs = {}
        for kind in ("cold", "warm"):
            _reset_counts()
            wct_head.LAUNCHES["wct_fields_head"] = 0
            profiling.MC_NULL_CHUNKS = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, res = _events_ms(lambda: wct_matrix_analysis(y, dt=dt, mc_count=PAIRS_MC))
            runs[kind] = dict(ms=ms, launches=dict(fc.KERNEL_LAUNCHES), res=res,
                              peak=torch.cuda.max_memory_allocated() - base,
                              head_launches=wct_head.LAUNCHES["wct_fields_head"],
                              null_chunks=profiling.MC_NULL_CHUNKS)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("PYCWT_TPU_CACHE_DIR", None)
        else:
            os.environ["PYCWT_TPU_CACHE_DIR"] = old_cache
    res = runs["cold"]["res"]
    sig95 = res["sig95"]
    g = res["alpha"]
    keys = {tco._canonical_null_key(g[i], g[j], tco._auto_alpha_quant(PAIRS_MC))
            for i, j in res["pairs"]}
    out["distinct_nulls"] = len(keys)
    check(sig95.shape == (P, S) and np.array_equal(res["WCT"], W),
          f"wct_matrix_analysis: sig95 {sig95.shape}")
    # pairs whose AR(1) coefficients exceed 0.25 share one cache entry (the
    # reference's file name): every warm curve is one of the cold run's
    cold_rows = {np.nan_to_num(r, nan=-1.0).tobytes() for r in sig95}
    check(all(np.nan_to_num(r, nan=-1.0).tobytes() in cold_rows
              for r in runs["warm"]["res"]["sig95"]),
          "a warm (cached) curve is none of the cold run's")
    out["cache_entries"] = len({tco._sig_cache_name(g[i], g[j], 1 / 12, 2 * dt / pt.Morlet(
        6).flambda(), dt, S - 1, pt.Morlet(6), PAIRS_MC, 0, CWTConfig(), "cuda")
        for i, j in res["pairs"]})
    finite = sig95[np.isfinite(sig95)]
    check(finite.size and 0 <= finite.min() and finite.max() < 1, "sig95 outside [0, 1)")
    check(_four_step_only(runs["cold"]["launches"])
          and runs["warm"]["launches"]["cwt_stage_a"] == 1,
          f"wct_matrix_analysis launches: cold {runs['cold']['launches']}, warm "
          f"{runs['warm']['launches']}")
    # the maps' pair block builds its own cross spectrum: one head a null chunk
    check(runs["cold"]["head_launches"] == runs["cold"]["null_chunks"] > 0
          and runs["warm"]["head_launches"] == runs["warm"]["null_chunks"],
          "wct_matrix_analysis wct_fields_head launches (cold, warm) "
          f"{runs['cold']['head_launches']}, {runs['warm']['head_launches']} for null chunks "
          f"{runs['cold']['null_chunks']}, {runs['warm']['null_chunks']}")
    n, _, _, _, _ = tco._surrogate_grid(dt, 1 / 12, 2 * dt / pt.Morlet(6).flambda(), S - 1,
                                        pt.Morlet(6))
    nfft_mc = 1 << (n - 1).bit_length()
    fit = tco._mc_auto_batch(PAIRS_MC * 64, S, nfft_mc, n)
    rows = min(len(keys), 64, fit) * (fit // min(len(keys), 64, fit))
    out["mc"] = dict(n=n, nfft=nfft_mc, rows_a_chunk=rows)
    # K1+K2 at the null chunk's shape (one signal's rows, nfft 8192)
    z = torch.randn((rows, n), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    zr, zi = fft_of_real_planar(z, nfft_mc)
    out["kernel_err"]["K1+K2 null chunk"] = _vs_plain(zr, zi, sc, False, mother=pt.Morlet(6),
                                                      nfft=nfft_mc, dt=dt)
    del z, zr, zi

    # one null in f64 on the CPU from the same members, and on the card
    i, j = res["pairs"][0]
    null_kw = dict(dt=dt, dj=1 / 12, s0=2 * dt / pt.Morlet(6).flambda(), J=S - 1,
                   mc_count=NULL_CHECK_MC, seed=0, cache=False, progress=False)
    on_card = tco.wct_significance_batch([g[i]], [g[j]], **null_kw)[0]
    on_cpu = tco.wct_significance_batch([g[i]], [g[j]], device="cpu", config=f64,
                                        **null_kw)[0]
    ok = np.isfinite(on_cpu)
    out["null_vs_cpu_f64"] = float(np.abs(on_card[ok] - on_cpu[ok]).max())
    check(np.array_equal(ok, np.isfinite(on_card)) and out["null_vs_cpu_f64"] <= 1e-5,
          f"null ({g[i]:.4f}, {g[j]:.4f}) card vs CPU f64: {out['null_vs_cpu_f64']}")
    for kind, r in runs.items():
        out[f"analysis_{kind}"] = dict(ms=r["ms"], launches=r["launches"], peak=r["peak"],
                                       head_launches=r["head_launches"],
                                       null_chunks=r["null_chunks"])
    per_null = runs["cold"]["launches"]["cwt_stage_a"] - 1
    log(f"[{card}] 32-station wct_matrix (496 pairs, S {S}, nfft {nfft}): default "
        f"{out['routes']['default']['ms']:.4f} ms ({out['routes']['default']['ms_unfetched']:.4f} "
        f"unfetched), cwt_direct {out['routes']['cwt_direct']['ms']:.4f} ms "
        f"({out['routes']['cwt_direct']['ms_unfetched']:.4f} unfetched), CUDA events median of 5; "
        f"launches {out['routes']['default']['launches']} / "
        f"{out['routes']['cwt_direct']['launches']}; routes agree (max |dR2|) "
        f"{routes_agree:.3e}; vs CPU "
        f"f64 on 16 pairs {out['vs_cpu_f64']}; {errs}; pair_block 7 vs auto bit-identical "
        f"{out['block_identical']} (max diff {out['block_diff']:.3e}); kernels vs plain "
        f"{out['kernel_err']}")
    log(f"[{card}] wct_matrix_analysis(mc_count=300): cold {runs['cold']['ms']:.1f} ms, warm "
        f"{runs['warm']['ms']:.1f} ms (CUDA events); {out['distinct_nulls']} distinct nulls "
        f"(n {n}, nfft {nfft_mc}, {rows} rows a chunk; {out['cache_entries']} cache entries "
        f"for the {P} pairs); launches cold "
        f"{runs['cold']['launches']} ({per_null} K1 launches for the nulls), warm "
        f"{runs['warm']['launches']}; wct_fields_head launches cold "
        f"{runs['cold']['head_launches']} for {runs['cold']['null_chunks']} null chunks, warm "
        f"{runs['warm']['head_launches']} for {runs['warm']['null_chunks']}; peak "
        f"{runs['cold']['peak']:.4e} / "
        f"{runs['warm']['peak']:.4e} bytes; one null ({NULL_CHECK_MC} members) card vs CPU "
        f"f64 {out['null_vs_cpu_f64']:.3e}")
    return out


def phase_dog_repair(card):
    """DOG(6) with scales up to 2·nfft, where f^6 overflows f32: K1+K2 at
    nfft 2^20 and cwt_direct at its largest nfft (2^12) give finite planes
    that match the f64 plain version at the `high` bound."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    errs = {}
    for nfft, small in ((1 << 20, False), (1 << 12, True)):
        x = torch.tensor(np.random.default_rng(5).standard_normal(nfft),
                         dtype=torch.float32, device="cuda")
        sr, si = fft_of_real_planar(x[None], nfft)
        sc = torch.tensor([2.0, float(nfft) ** 0.5, 2.0 * nfft], device="cuda")
        kw = dict(mother=pt.DOG(6), nfft=nfft, dt=1.0)
        _reset_counts()
        wr, wi = fc.fused_cwt_planar(sr, si, sc, small_kernel=small, **kw)
        name = "cwt_direct" if small else "cwt_stage_a"
        check(fc.KERNEL_LAUNCHES[name] == 1, f"DOG repair: {fc.KERNEL_LAUNCHES}")
        rr, ri = fc._fused_cwt_planar_reference(sr.double(), si.double(), sc.double(), **kw)
        err = max(float((wr.double() - rr).abs().max()), float((wi.double() - ri).abs().max()))
        err /= float(torch.sqrt(rr * rr + ri * ri).max())
        check(bool(torch.isfinite(wr).all() and torch.isfinite(wi).all())
              and err <= TIER_BOUND["high"], f"DOG(6) at nfft {nfft} ({name}): {err}")
        errs[name] = err
    log(f"[{card}] DOG(6), scales to 2*nfft: finite; vs the f64 plain version (of max|W|) "
        f"K1+K2 at 2^20 {errs['cwt_stage_a']:.3e}, cwt_direct at 2^12 {errs['cwt_direct']:.3e}")
    return errs


def phase_long(card):
    """The overlap-save surfaces on tools/tpu_bench_long.py's grid: at N =
    2^22 each against the global transform on the card (interior, s ≥ 4dt)
    or against each other; at N = 2^24 each timed (CUDA events, median of
    3) with its launches and peak memory; K1+K2 at the chunk's shape
    against their plain version."""
    import pycwt_torch as pt
    from pycwt_torch.coherence import _wct_core_planar
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops import overlap as tov
    from pycwt_torch.ops import wct_head
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    mother = pt.Morlet(6)
    sj = 2.0 * 2.0 ** (np.arange(LONG_S) / 8.0)
    sc = torch.tensor(sj, dtype=torch.float32, device="cuda")
    H = tov.halo_samples(float(sj.max()), 1.0)
    nfft_c = 1 << (LONG_CHUNK + 4 * H - 1).bit_length()
    coarse = torch.tensor(sj >= 4.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = dict(halo=H, chunk_nfft=nfft_c)

    def normalized(v):
        return (v - v.mean()) / v.std(correction=0)

    # the chunk's transform against the plain version
    x = torch.randn(LONG_CHUNK + 2 * H, generator=gen, device="cuda")
    xr, xi = fft_of_real_planar(x, nfft_c)
    out["kernel_err"] = _vs_plain(xr, xi, sc, False, mother=mother, nfft=nfft_c, dt=1.0)

    N = LONG_CHECK_N
    x = torch.randn(N, generator=gen, device="cuda")
    x2 = 0.5 * x + torch.randn(N, generator=gen, device="cuda")
    sl = slice(H, N - H)
    kw = dict(mother=mother, chunk=LONG_CHUNK)
    wr, wi = tov.cwt_overlap_save_planar(x, sc, 1.0, **kw)
    gr, gi = fc._planar_cwt_of_real(x, sc, mother=mother, nfft=N, dt=1.0)
    per_scale = (torch.maximum((wr - gr)[:, sl].abs(), (wi - gi)[:, sl].abs()).amax(-1)
                 / torch.sqrt(gr * gr + gi * gi)[:, sl].amax(-1))
    del gr, gi
    errs = dict(cwt_planar_s_ge_4dt=float(per_scale[coarse].max()),
                cwt_planar_finest=[float(e) for e in per_scale[:3]])
    W = tov.cwt_overlap_save(x, sc, 1.0, **kw)
    errs["complex_vs_planar"] = float((W - torch.complex(wr, wi)).abs().max() / W.abs().max())
    del W
    pw = tov.streamed_global_power_planar(x, sc, 1.0, **kw)
    ref = (wr * wr + wi * wi).sum(-1)
    errs["streamed_power"] = float(((pw - ref).abs() / ref).max())
    del wr, wi
    n1, n2 = normalized(x), normalized(x2)
    R, A = tov.wct_overlap_planar(x, x2, sc, 1.0, dj=LONG_DJ, **kw)
    Rg, Ag, (g12r, g12i) = _wct_core_planar(n1[None], n2[None], sc, 1.0, mother=mother,
                                            nfft=N, dj=LONG_DJ)
    s2 = slice(2 * H, N - 2 * H)
    Rg, Ag = Rg[0][coarse][:, s2], Ag[0][coarse][:, s2]
    g12 = torch.sqrt(g12r[0] ** 2 + g12i[0] ** 2)[coarse][:, s2]
    del g12r, g12i
    per_scale = (R[coarse][:, s2] - Rg).abs().amax(-1)
    errs["wct"] = float(per_scale.max())
    # the scale boxcar couples the first scales above 4dt to the
    # near-Nyquist ones below it
    errs["wct_first_coarse_scales"] = [float(e) for e in per_scale[:4]]
    dphi = (torch.remainder(A[coarse][:, s2] - Ag + math.pi, 2 * math.pi) - math.pi).abs()
    # the phase is that of the unsmoothed cross spectrum: where |W12| is
    # near zero it is noise in any formulation, R² > 0.2 or not
    # under the JAX test's mask alone (tests/test_overlap.py:238-240) the
    # phase misses 2e-3 at large N in pycwt_tpu as well, by more: on the CPU,
    # same comparison on the same inputs, JAX_PHASE_R2 (the port there: 4.3e-4,
    # 7.5e-4, 4.7e-3; tests/test_torch_overlap.py's phase_figures).  The check
    # holds the cells where |W12| is not near zero.
    errs["wct_phase_R2_gt_0.2"] = float(dphi[Rg > 0.2].max())
    errs["wct_phase"] = float(dphi[(Rg > 0.2) & (g12 > 1e-3 * g12.max())].max())
    del R, A, Rg, Ag, dphi, g12
    M, _ = tov.xwt_overlap_planar(x, x2, sc, 1.0, **kw)
    w1 = torch.complex(*fc._planar_cwt_of_real(n1, sc, mother=mother, nfft=N, dt=1.0))
    w2 = torch.complex(*fc._planar_cwt_of_real(n2, sc, mother=mother, nfft=N, dt=1.0))
    ref = (w1 * w2.conj()).abs()[coarse][:, sl]
    del w1, w2
    errs["xwt"] = float((M[coarse][:, sl] - ref).abs().max() / ref.max())
    del M, ref
    out["errs_2p22"] = errs
    log(f"[{card}] overlap-save at N = 2^22 (64 scales, halo {H}, chunk 2^18, chunk nfft "
        f"{nfft_c}): {errs}")
    log(f"[{card}] blocked WCT phase where R² > 0.2 alone: the port on this card at 2^22 "
        f"{errs['wct_phase_R2_gt_0.2']:.4e}; pycwt_tpu on the CPU (phase_figures) "
        + ", ".join(f"{v:.4e} at {k}" for k, v in JAX_PHASE_R2.items()))
    check(errs["cwt_planar_s_ge_4dt"] <= TIER_BOUND["high"]
          and errs["complex_vs_planar"] <= 2e-5 and errs["streamed_power"] <= 3e-5
          and errs["wct"] <= 2e-4 and errs["wct_phase"] <= 2e-3 and errs["xwt"] <= 3e-5,
          f"overlap-save at 2^22: {errs}")
    del x, x2, n1, n2

    N = LONG_TIME_N
    x = torch.randn(N, generator=gen, device="cuda")
    x2 = 0.5 * x + torch.randn(N, generator=gen, device="cuda")
    n_chunks = N // LONG_CHUNK
    kw = dict(mother=mother, chunk=LONG_CHUNK)
    surfaces = {
        "cwt_overlap_save_planar": (1, lambda: tov.cwt_overlap_save_planar(x, sc, 1.0, **kw)),
        "cwt_overlap_save": (1, lambda: tov.cwt_overlap_save(x, sc, 1.0, **kw)),
        "streamed_global_power_planar": (
            1, lambda: tov.streamed_global_power_planar(x, sc, 1.0, **kw)),
        "wct_overlap_planar": (
            2, lambda: tov.wct_overlap_planar(x, x2, sc, 1.0, dj=LONG_DJ, **kw)),
        "xwt_overlap_planar": (2, lambda: tov.xwt_overlap_planar(x, x2, sc, 1.0, **kw)),
    }
    out["surfaces"] = {}
    for name, (signals, fn) in surfaces.items():
        _reset_counts()
        wct_head.LAUNCHES["wct_fields_head"] = 0
        peak, res = _peak_bytes(fn)
        launches = dict(fc.KERNEL_LAUNCHES)
        heads = wct_head.LAUNCHES["wct_fields_head"]
        outs = res if isinstance(res, tuple) else (res,)
        out_bytes = sum(t.untyped_storage().nbytes() for t in outs)
        check(all(bool(torch.isfinite(t).all()) for t in outs), f"{name} at 2^24: not finite")
        del res, outs
        check(launches["cwt_stage_a"] == launches["cwt_stage_b"] == signals * n_chunks
              and launches["cwt_direct"] == 0, f"{name} at 2^24: launches {launches}")
        # the coherence head: one launch a chunk, in the coherence alone
        check(heads == (n_chunks if name == "wct_overlap_planar" else 0),
              f"{name} at 2^24: {heads} wct_fields_head launches for {n_chunks} chunks")
        times = []
        for _ in range(3):
            ms, res = _events_ms(fn)
            times.append(ms)
            del res
        ms = float(np.median(times))
        out["surfaces"][name] = dict(ms=ms, ms_runs=times, rate=N * LONG_S / (ms * 1e-3),
                                     launches=launches["cwt_stage_a"], peak=peak,
                                     output_bytes=out_bytes, head_launches=heads)
        log(f"[{card}] {name} at N = 2^24, 64 scales: {ms:.2f} ms (CUDA events, median of "
            f"3: {[round(t, 2) for t in times]}), {N * LONG_S / (ms * 1e-3):.4e} sample-scales/s, "
            f"K1/K2 launches {launches['cwt_stage_a']} each ({n_chunks} chunks), "
            f"wct_fields_head launches {heads}, peak "
            f"{peak:.4e} bytes = output {out_bytes:.4e} + {peak - out_bytes:.4e}")
    return out


#: The bench shape (bench.py:101-108): 2^20 f32 samples, 64 scales
BENCH_N, BENCH_S = 1 << 20, 64
#: The JAX package's parity-cost shape (tools/tpu_bench_twofloat.py:56-61):
#: one 2^20-sample f64 signal, Morlet-6, 64 scales, dj = 0.25, s0 = 2
PARITY_N, PARITY_S = 1 << 20, 64
#: parity mode against the f64 goldens (tests/test_tpu_chip.py:63-65), and
#: the card's 2^20 × 64 W against the CPU f64 port (of max|W|)
PARITY_BOUND, PARITY_ROWS_BOUND = 1e-6, 1e-10


def phase_parity(card):
    """Parity mode on the card: the goldens through cwt_twofloat,
    xwt_twofloat and wct_twofloat at 1e-6; the 2^20 × 64 f64 transform
    against the CPU f64 port on 8 rows, timed (CUDA events, median of 5)
    as the device part alone and as the whole call with its 1 GiB fetch,
    beside the f32 K1+K2 planes path at the same shape, with its peak
    bytes; no kernel launched, also under PYCWT_TPU_ENGINE=planar; the
    batch guard."""
    import pycwt_torch as pt
    from pycwt_torch.api import _cwt_planar_parts
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops import twofloat as tf
    from pycwt_torch.transform import build_scale_grid, cwt_batch

    _reset_counts()
    g = np.load(os.path.join(GOLDEN, "cwt_nino3_morlet6.npz"))
    W, *_ = pt.cwt_twofloat(g["signal"], float(g["dt"]))
    check(W.dtype == np.complex128 and W.shape == g["W"].shape, "cwt_twofloat shape/dtype")
    errs = {"cwt_nino3_power": rel_err(np.abs(W) ** 2, np.abs(g["W"]) ** 2)}
    g = np.load(os.path.join(GOLDEN, "xwt_jao_jbaltic_norm1.npz"))
    W12, *_ = pt.xwt_twofloat(g["y1"], g["y2"], float(g["dt"]))
    errs["xwt_jao_abs"] = rel_err(np.abs(W12), np.abs(g["W12"]))
    g = np.load(os.path.join(GOLDEN, "wct_jao_jbaltic.npz"))
    WCT, *_ = pt.wct_twofloat(g["y1"], g["y2"], float(g["dt"]))
    errs["wct_jao"] = rel_err(WCT, g["WCT"])
    check(all(e <= PARITY_BOUND for e in errs.values()), f"parity goldens: {errs}")

    N, S, mother = PARITY_N, PARITY_S, pt.Morlet(6)
    kw = dict(dj=0.25, s0=2.0, J=S - 1)
    sj = build_scale_grid(N, 1.0, mother=mother, **kw).sj
    check(len(sj) == S, "parity scale grid size")
    y = np.random.default_rng(0).standard_normal(N)
    W, sj_out, *_ = pt.cwt_twofloat(y, 1.0, **kw)
    check(W.shape == (S, N) and W.dtype == np.complex128 and np.isfinite(W).all()
          and np.array_equal(sj_out, sj), "parity 2^20 x 64: shape/dtype/finite/grid")
    rows = slice(0, S, S // 8)
    W_cpu, _ = cwt_batch(torch.tensor(y)[None], torch.tensor(sj[rows]), 1.0, mother=mother,
                         nfft=N, config=CWTConfig(dtype=torch.float64), engine="xla")
    w_max = float(np.abs(W).max())
    err_rows = float(np.abs(W[rows] - W_cpu[0].numpy()).max()) / w_max
    check(err_rows <= PARITY_ROWS_BOUND, f"parity 2^20 x 64 vs CPU f64 on 8 rows: {err_rows}")
    del W_cpu

    x = torch.tensor(y, device="cuda")[None]
    device_call = lambda: tf._cwt_f64(x, sj, 1.0, mother, N)  # noqa: E731
    peak, _ = _peak_bytes(device_call)
    dev_ms = time_ms(device_call, runs=5, warmup=1)
    call_ms = time_ms(lambda: pt.cwt_twofloat(y, 1.0, **kw), runs=5, warmup=1)
    launches = dict(fc.KERNEL_LAUNCHES)
    check(sum(launches.values()) == 0, f"parity mode launched kernels: {launches}")
    with _env("PYCWT_TPU_ENGINE", "planar"):
        W_env, *_ = pt.cwt_twofloat(y, 1.0, **kw)
    env_diff = float(np.abs(W_env - W).max()) / w_max
    del W_env
    launches_env = dict(fc.KERNEL_LAUNCHES)
    check(sum(launches_env.values()) == 0 and env_diff <= 1e-14,
          f"parity under PYCWT_TPU_ENGINE=planar: launches {launches_env}, diff {env_diff}")
    try:
        pt.cwt_twofloat(np.zeros((64, 2048)), 1.0, max_bytes=1e6)
        raise AssertionError("parity batch guard did not raise")
    except ValueError as e:
        check("Split the batch" in str(e), f"parity batch guard message: {e}")

    # the f32 K1+K2 planes path at the same shape, its launches counted apart
    x32, sc32 = x.float(), torch.tensor(sj, dtype=torch.float32, device="cuda")
    f32_device = lambda: fc._planar_cwt_of_real(x32, sc32, mother=mother, nfft=N,  # noqa: E731
                                                dt=1.0)
    _reset_counts()
    f32_peak, _ = _peak_bytes(f32_device)
    check(_four_step_only(fc.KERNEL_LAUNCHES), f"f32 planes path: {fc.KERNEL_LAUNCHES}")
    f32_dev_ms = time_ms(f32_device, runs=5, warmup=1)
    f32_call_ms = time_ms(lambda: _cwt_planar_parts(y, 1.0, wavelet=mother, **kw), runs=5,
                          warmup=1)
    del W, x, x32
    out = dict(golden_errs=errs, rows_err=err_rows, device_ms=dev_ms, call_ms=call_ms,
               peak_bytes=peak, launches=launches, env_planar_diff=env_diff,
               f32_planes_device_ms=f32_dev_ms, f32_planes_call_ms=f32_call_ms,
               f32_planes_peak_bytes=f32_peak)
    log(f"[{card}] parity mode: goldens {errs} (bound {PARITY_BOUND}); 2^20 x 64 f64 W vs "
        f"the CPU f64 port on 8 rows {err_rows:.3e} of max|W| (bound {PARITY_ROWS_BOUND}); "
        f"device part {dev_ms:.4f} ms, whole call with the 1 GiB fetch {call_ms:.4f} ms "
        f"(CUDA events, median of 5), peak {peak:.4e} bytes; f32 K1+K2 planes at the same "
        f"shape: device {f32_dev_ms:.4f} ms, whole call {f32_call_ms:.4f} ms, peak "
        f"{f32_peak:.4e} bytes; kernel launches in parity mode {launches}, under "
        f"PYCWT_TPU_ENGINE=planar {launches_env} (result diff {env_diff:.1e}); the batch "
        f"guard raises")
    return out


def phase_parity_trace(calls=5):
    """``--trace``: torch.profiler over ``calls`` calls of parity mode's
    device part at 2^20 × 64 (f64 bank × spectrum, cuFFT Z2Z): device time
    by kernel, and the busy share of the wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    import pycwt_torch as pt
    from pycwt_torch.ops import twofloat as tf
    from pycwt_torch.transform import build_scale_grid

    sj = build_scale_grid(PARITY_N, 1.0, dj=0.25, s0=2.0, J=PARITY_S - 1).sj
    x = torch.tensor(np.random.default_rng(0).standard_normal(PARITY_N), device="cuda")[None]
    for _ in range(2):
        tf._cwt_f64(x, sj, 1.0, pt.Morlet(6), PARITY_N)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            tf._cwt_f64(x, sj, 1.0, pt.Morlet(6), PARITY_N)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = _device_rows(prof, calls)
    busy = sum(r[0] for r in rows)
    log(f"trace, parity mode's device part at 2^20 x 64 (f64): {wall:.4f} ms wall per call "
        f"under the profiler, device busy {busy:.4f} ms ({100 * busy / wall:.1f} %), "
        f"{sum(r[1] for r in rows):g} kernel launches")
    for ms, n, key in rows[:10]:
        log(f"  {ms:.4f} ms  x{n:g}  {key[:90]}")


def _support(name):
    """A support module of the tests (no JAX), imported by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(GOLDEN), f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_coherence_gradient():
    """Gradients through the coherence stack on the card
    (tests/test_autodiff.py:114-231): the planar _wct_core through K1+K2 at
    nfft 2^14 and through cwt_direct at 2^12 against the same loss on the
    plain versions (2e-4 of the largest gradient), the f64 xla _wct_core
    against centered finite differences (1e-4), and the 60-step lag fit in
    f64 (within 0.2 of 3.7).  The problems are the tests' own
    (tests/test_torch_autodiff_support.py)."""
    from pycwt_torch import coherence as tco
    from pycwt_torch.ops import fused_cwt as fc

    sup = _support("test_torch_autodiff_support")
    M6, TRUE_LAG = sup.M6, sup.TRUE_LAG
    out = dict(err={}, launches={})
    for small, nfft, name in ((False, 1 << 14, "K1+K2"), (True, 1 << 12, "cwt_direct")):
        rng = np.random.default_rng(6)
        y1, y2 = (torch.tensor(rng.standard_normal(nfft), dtype=torch.float32,
                               device="cuda") for _ in range(2))
        scales = torch.tensor([4.0, 16.0, 64.0], device="cuda")
        with _route(small):
            a = y1.clone().requires_grad_(True)
            _reset_counts()
            WCT, _, _ = tco._wct_core(a[None], y2[None], scales, 1.0, mother=M6,
                                      nfft=nfft, dj=0.5, engine="planar")
            (gk,) = torch.autograd.grad(WCT.mean(), a)
            torch.cuda.synchronize()
            launches = dict(fc.KERNEL_LAUNCHES)
        a = y1.clone().requires_grad_(True)
        (gr,) = torch.autograd.grad(sup.reference_loss(y2, scales, nfft)(a), a)
        err = float((gk - gr).abs().max() / gr.abs().max())
        want = dict.fromkeys(launches, 0)
        want.update({"cwt_direct": 2} if small else {"cwt_stage_a": 2, "cwt_stage_b": 2})
        check(launches == want, f"{name} gradient route launched {launches}")
        check(bool(torch.isfinite(gk).all()) and err <= 2e-4,
              f"{name} planar _wct_core gradient vs plain: {err}")
        out["err"][name] = err
        out["launches"][name] = launches

    y1, _, _, wct_loss = sup.wct_sum_problem("cuda")
    (g,) = torch.autograd.grad(wct_loss(y1), y1)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, "f64 gradient finite")
    fd_err = sup.finite_difference_error(wct_loss, y1, g)
    check(fd_err < 1e-4, f"f64 _wct_core gradient vs finite differences: {fd_err}")
    out["err"]["f64_vs_finite_differences"] = fd_err

    t0 = time.perf_counter()
    lag, losses = sup.fit_lag(sup.lag_problem("cuda"), "cuda")
    fit_s = time.perf_counter() - t0
    check(losses[-1] < losses[0] and abs(lag - TRUE_LAG) < 0.2,
          f"lag fit: lag {lag}, loss {losses[0]} -> {losses[-1]}")
    out.update(lag=lag, lag_fit_s=fit_s)
    log(f"coherence-stack gradients on the card: planar _wct_core vs plain "
        f"K1+K2 (nfft 2^14) {out['err']['K1+K2']:.3e}, cwt_direct (2^12) "
        f"{out['err']['cwt_direct']:.3e} (bound 2e-4), launches {out['launches']}; f64 xla "
        f"vs finite differences {fd_err:.3e} (bound 1e-4); lag fit {lag:.4f} "
        f"(true {TRUE_LAG}, bound 0.2) in 60 steps, {fit_s:.2f} s")
    return out


def _trace_names_kernels(path, names):
    with open(path) as f:
        text = f.read()
    return all(n in text for n in names)


def _bench_pipeline():
    """One bench-shape pipeline (2^20 samples, 64 scales, Morlet-6, planar
    rFFT then K1+K2 to power_sum) on the card, as a function of nothing."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar
    from pycwt_torch.transform import build_scale_grid

    N0, S = BENCH_N, BENCH_S
    x = torch.tensor(np.random.default_rng(0).standard_normal(N0), dtype=torch.float32,
                     device="cuda")
    scales = torch.tensor(build_scale_grid(N0, 1.0, dj=0.25, s0=2.0, J=S - 1).sj,
                          dtype=torch.float32, device="cuda")

    def pipeline():
        sr, si = fft_of_real_planar(x, N0, half=True)
        return fc.fused_cwt_planar(sr, si, scales, mother=pt.Morlet(6), nfft=N0, dt=1.0,
                                   output="power_sum")
    return pipeline


def first_call_trace(log_dir):
    """``--first-call-trace DIR``, run in a fresh process: the process's
    first CUDA work, the inputs and one bench-shape pipeline call, all under
    profiling.trace(DIR)."""
    from pycwt_torch.utils import profiling

    check(not torch.cuda.is_initialized(), "CUDA initialized before the traced region")
    with profiling.trace(log_dir):
        _bench_pipeline()()


def phase_profiling(card, bench_rate):
    """utils/profiling and the build cache: one bench-shape pipeline call
    under profiling.trace (its trace names cwt_stage_a and cwt_stage_b),
    the same trace of a fresh process whose first CUDA work is the traced
    call, 11 calls timed by PhaseTimer beside phase_bench_shape's rate, and
    enable_compilation_cache in two child processes: the first builds into
    a fresh directory, the second loads from it without running nvcc."""
    import glob
    import shutil

    from pycwt_torch.utils import profiling

    N0, S = BENCH_N, BENCH_S
    pipeline = _bench_pipeline()
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, "pycwt_torch", "_build", f"profiling-{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    pipeline()
    # CUPTI has recorded no device activity once in a few hundred profiles
    for attempt in range(3):
        log_dir = os.path.join(work, f"trace{attempt}")
        with profiling.trace(log_dir):
            pipeline()
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        check(len(files) == 1, f"trace files: {files}")
        named = _trace_names_kernels(files[0], ("cwt_stage_a", "cwt_stage_b"))
        if named:
            break
    check(named, f"the trace names neither kernel: {files[0]}")
    trace_bytes = os.path.getsize(files[0])
    for first_attempt in range(3):
        first_dir = os.path.join(work, f"first{first_attempt}")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--first-call-trace",
                        first_dir], check=True, capture_output=True, text=True, timeout=300)
        first = glob.glob(os.path.join(first_dir, "*.pt.trace.json"))
        check(len(first) == 1, f"first-call trace files: {first}")
        first_named = _trace_names_kernels(first[0], ("cwt_stage_a", "cwt_stage_b"))
        if first_named:
            break
    check(first_named, f"a fresh process's first traced call names neither kernel: {first[0]}")

    timer = profiling.PhaseTimer()
    for _ in range(11):
        with timer.phase("bench_pipeline", samples=N0, scales=S):
            pipeline()
    rate = timer.report()["bench_pipeline"]["sample_scales_per_s"]

    cache = os.path.join(work, "cuda_build")
    child = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
             "from pycwt_torch.utils import enable_compilation_cache; "
             "from pycwt_torch.ops import _build; "
             "enable_compilation_cache(sys.argv[2]); "
             "[_build.library(n) for n in _build.SOURCES]; "
             "print(json.dumps({n: s for n, (s, _) in _build.BUILD_LOG.items()}))")
    builds = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", child, here, cache], check=True,
                             capture_output=True, text=True, timeout=600)
        builds.append((json.loads(res.stdout.strip().splitlines()[-1]),
                       time.perf_counter() - t0))
    from pycwt_torch.ops import _build
    libs = sorted(os.path.basename(p) for p in glob.glob(os.path.join(cache, "*.so")))
    check(set(builds[0][0]) == set(_build.SOURCES) and len(libs) == len(_build.SOURCES),
          f"the first process built {builds[0][0]}, the cache holds {libs}")
    check(builds[1][0] == {}, f"the second process ran nvcc: {builds[1][0]}")
    shutil.rmtree(work, ignore_errors=True)
    out = dict(trace_bytes=trace_bytes, trace_attempts=attempt + 1,
               first_call_trace_attempts=first_attempt + 1, phase_timer_rate=rate,
               cache_first_build_s=builds[0][0], cache_first_process_s=builds[0][1],
               cache_second_process_s=builds[1][1], cache_libs=libs)
    log(f"[{card}] profiling: trace of one bench-shape call names cwt_stage_a and "
        f"cwt_stage_b ({trace_bytes} bytes, attempt {attempt + 1}), also as a fresh "
        f"process's first CUDA work (attempt {first_attempt + 1}); PhaseTimer over 11 "
        f"calls {rate:.4e} sample-scales/s (phase_bench_shape {bench_rate:.4e}); build "
        f"cache: first process built {builds[0][0]} in {builds[0][1]:.2f} s, second "
        f"loaded {libs} without nvcc in {builds[1][1]:.2f} s")
    return out


#: the fields of sample_cwt's analysis held at CWT_BOUND (tests/test_engines.py:156)
EXAMPLE_CWT_FIELDS = ("power", "sig95", "global_power", "scale_avg")
#: the card's f32 Monte-Carlo curve against the CPU f64 one on the same
#: members (phase_pairs' bound for a null)
EXAMPLE_SIG_BOUND = 1e-5
#: the time limit of each example run as a child process
EXAMPLE_CHILD_TIMEOUT = 300
EXAMPLE_CHILDREN = (("sample_cwt", ["--all"]), ("sample_xwt", []), ("sample_network", []))


def _example_items():
    """(example, label, call) of every ``run(...)`` of the three example
    workflows at their defaults, on the card."""
    from pycwt_torch.examples import sample_cwt, sample_network, sample_xwt

    items = [("sample_cwt", name, lambda name=name: sample_cwt.run(name))
             for name in sample_cwt.DATASETS]
    return items + [("sample_xwt", "jao_jbaltic", sample_xwt.run),
                    ("sample_network", "8 stations", sample_network.run)]


def _example_refs():
    """The CPU float64 port on each example's inputs: the five analyses,
    the JAO/JBaltic XWT and WCT with its 300-member curve (the card's
    members), and the network's coherence maps."""
    from pycwt_torch.analysis import wct_matrix_analysis
    from pycwt_torch.examples import sample_cwt, sample_network, sample_xwt

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with contextlib.redirect_stdout(None):
            return dict(
                cwt={n: sample_cwt.run(n, device="cpu")["res"] for n in sample_cwt.DATASETS},
                xwt=sample_xwt.run(device="cpu"),
                net=wct_matrix_analysis(sample_network.make_network(), dt=1.0, sig=False,
                                        device="cpu"))
    finally:
        torch.set_default_dtype(prev)


def _check_example(example, label, got, refs, what):
    """The bounds of one example run on the card; the errors by name."""
    if example == "sample_cwt":
        res, ref = got["res"], refs["cwt"][label]
        errs = {f: rel_err(getattr(res, f), getattr(ref, f)) for f in EXAMPLE_CWT_FIELDS}
        if label == "nino3":
            g = np.load(os.path.join(GOLDEN, "figure_nino3.npz"))
            errs.update({f"{f}_vs_golden": rel_err(getattr(res, f), g[f])
                         for f in EXAMPLE_CWT_FIELDS})
        bounds = {k: CWT_BOUND for k in errs}
    elif example == "sample_xwt":
        g = np.load(os.path.join(GOLDEN, "figure_jao_jbaltic.npz"))
        ref = refs["xwt"]
        sig, sig_ref = got["wct"]["sig95"], ref["wct"]["sig95"]
        check(np.array_equal(np.isnan(sig), np.isnan(sig_ref)), f"{what}: sig95 NaN rows")
        ok = np.isfinite(sig_ref)
        # the golden's inputs were not boxpdf-transformed: the cross power is
        # held against the CPU f64 port of the same call
        errs = dict(cross_power=rel_err(got["xwt"]["cross_power"], ref["xwt"]["cross_power"]),
                    wct_vs_golden=rel_err(got["wct"]["WCT"], g["wct"]),
                    sig95_vs_cpu_f64=float(np.abs(sig[ok] - sig_ref[ok]).max()))
        bounds = dict(cross_power=XWT_BOUND, wct_vs_golden=WCT_BOUND,
                      sig95_vs_cpu_f64=EXAMPLE_SIG_BOUND)
    else:
        errs = dict(maps=rel_err(got["res"]["WCT"], refs["net"]["WCT"]))
        bounds = dict(maps=WCT_BOUND)
        coupled, background = np.mean(got["coupled"]), np.mean(got["background"])
        check(coupled > background,
              f"{what}: coupled pairs {coupled} not above background {background}")
        errs["coupled_vs_background"] = [float(coupled), float(background)]
    for key, bound in bounds.items():
        check(errs[key] < bound, f"{what}: {key} {errs[key]} >= {bound}")
    return errs


def _example_trace(call, what):
    """torch.profiler over one call: wall ms under the profiler, device busy
    ms (the kernels' sum, one stream), idle share, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with contextlib.redirect_stdout(None), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    log(f"trace, {what}: {wall:.4f} ms wall under the profiler, device busy {busy:.4f} ms "
        f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for ms, n, key in rows[:8]:
        log(f"  {ms:.4f} ms  x{n:g}  {key[:90]}")
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall)


def phase_examples_trace(route="default"):
    """One sample_xwt.run on ``route``, traced: cold (a fresh Monte-Carlo
    cache, so the 300-member null runs) and warm (the curve read back from
    the cache, as the example's second run reads it)."""
    import shutil
    import tempfile

    from pycwt_torch.examples import sample_xwt

    work = tempfile.mkdtemp(prefix="pycwt_examples_trace_")
    try:
        with _env("PYCWT_TPU_CACHE_DIR", work), _env("PYCWT_TPU_MC_COUNT", None), \
                _route(route == "cwt_direct"):
            with contextlib.redirect_stdout(None):
                sample_xwt.run()     # kernels, band matrices and cuFFT plans warm
            shutil.rmtree(work)
            return {kind: _example_trace(sample_xwt.run, f"sample_xwt.run {kind}, route {route}")
                    for kind in ("cold", "warm")}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_examples(card):
    """The three example workflows (pycwt_torch/examples/) at their defaults
    on the card: each ``run(...)`` on the default route (K1+K2) and on the
    PYCWT_TPU_SMALL_KERNEL=1 route (K3), launches counted from 0 before its
    first (cold) run, timed cold and warm by CUDA events with its peak
    bytes, and held against the CPU f64 port and the goldens; sample_xwt.run
    traced; then each script once as a child process."""
    import shutil
    import tempfile

    from pycwt_torch.ops import fused_cwt as fc

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="pycwt_examples_")
    out = dict(routes={}, launches={}, children={})
    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, work, True)
        for name in ("PYCWT_TPU_MC_COUNT", "PYCWT_TPU_NETWORK_B"):
            stack.enter_context(_env(name, None))
        stack.enter_context(_env("PYCWT_TPU_CACHE_DIR", os.path.join(work, "cache-cpu")))
        t0 = time.perf_counter()
        refs = _example_refs()
        out["cpu_f64_refs_s"] = time.perf_counter() - t0
        for small in (False, True):
            route = "cwt_direct" if small else "default"
            # a fresh cache: sample_xwt's first run computes its null, the second reads it
            os.environ["PYCWT_TPU_CACHE_DIR"] = os.path.join(work, f"cache-{route}")
            runs = out["routes"][route] = {}
            with _route(small):
                for example, label, call in _example_items():
                    what = f"{example} {label}, route {route}"
                    with contextlib.redirect_stdout(None):
                        torch.cuda.synchronize()
                        base = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        _reset_counts()
                        cold, got = _events_ms(call)
                        launches = dict(fc.KERNEL_LAUNCHES)
                        peak = torch.cuda.max_memory_allocated() - base
                        warm, _ = _events_ms(call)
                    counts = out["launches"].setdefault(example, {}).setdefault(
                        route, dict.fromkeys(launches, 0))
                    for k, n in launches.items():
                        counts[k] += n
                    errs = _check_example(example, label, got, refs, what)
                    runs[f"{example} {label}"] = dict(cold_ms=cold, warm_ms=warm, peak=peak,
                                                      launches=launches, errs=errs)
                    log(f"[{card}] {what}: cold {cold:.2f} ms, warm {warm:.2f} ms (CUDA "
                        f"events), peak {peak:.4e} bytes, launches {launches}, {errs}")
            for example, counts in out["launches"].items():
                ok = (_four_step_only(counts[route]) if not small
                      else counts[route]["cwt_direct"] > 0)
                check(ok, f"{example}, route {route}: wrong kernels launched: {counts[route]}")
        out["trace"] = {route: phase_examples_trace(route) for route in ("default", "cwt_direct")}

        # a child sizes its Monte-Carlo batches to 25e9 bytes of the card:
        # this process hands back what its allocator keeps cached
        gc.collect()
        torch.cuda.empty_cache()
        out["reserved_before_children"] = torch.cuda.memory_reserved()
        env = {**os.environ, "PYCWT_TPU_CACHE_DIR": os.path.join(work, "cache-child")}
        env.pop("PYCWT_TPU_SMALL_KERNEL", None)
        for example, args in EXAMPLE_CHILDREN:
            cmd = [sys.executable, "-m", f"pycwt_torch.examples.{example}", *args]
            if example != "sample_network":
                cmd += ["--outdir", work]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=here,
                                 timeout=EXAMPLE_CHILD_TIMEOUT)
            secs = time.perf_counter() - t0
            check(res.returncode == 0,
                  f"{' '.join(cmd[2:])} exited {res.returncode}: {res.stderr[-2000:]}")
            out["children"][example] = secs
            log(f"[{card}] python {' '.join(cmd[1:4])}: exit 0 in {secs:.2f} s (a cold "
                f"process, the nvcc build cache warm); it printed: "
                + " | ".join(res.stdout.strip().splitlines()[-4:]))
    out["peak"] = max(r["peak"] for runs in out["routes"].values() for r in runs.values())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{card}] examples ({out['seconds']:.2f} s): peak max_memory_allocated "
        f"{out['peak']:.4e} bytes above the resident set; this process reserved {out['reserved_before_children']:.4e} bytes "
        f"while the children ran; CPU f64 references {out['cpu_f64_refs_s']:.2f} s; "
        f"launches {out['launches']}")
    return out


#: the caller settings of tests/test_torch_matmul_pin_support.py that reach
#: cuBLAS: the legacy setter, the legacy cuBLAS flag, the newer fp32_precision
CARD_CALLERS = ("high", "medium", "allow_tf32", "fp32_precision_cuda_tf32")


def _cwt_power_errs(card):
    """|W|² of the five records through the public ``cwt`` on the card
    against the CPU f64 port; Mauna Loa's also through ``cwt_batch`` (f64
    and f32 rows) and ``sharded_cwt`` on a one-rank mesh."""
    import pycwt_torch as pt
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.examples.sample_cwt import DATASETS
    from pycwt_torch.sample import load
    from pycwt_torch.transform import build_scale_grid, cwt_batch, drop_reference_nan_rows

    errs = {}
    for name in DATASETS:
        ds = load(name)
        x = (ds.values - ds.values.mean()) / ds.values.std()
        ref = np.abs(pt.cwt(x, ds.dt, config=CWTConfig(dtype=torch.float64),
                            device="cpu")[0]) ** 2
        errs[f"{name} cwt"] = rel_err(np.abs(pt.cwt(x, ds.dt)[0]) ** 2, ref)
        if name != "mauna":
            continue
        M6, nfft = pt.Morlet(6), 1 << (len(x) - 1).bit_length()
        grid = build_scale_grid(len(x), ds.dt, mother=M6)
        sj, _ = drop_reference_nan_rows(M6, grid.sj, grid.freqs, nfft, ds.dt)
        sc = torch.tensor(sj, device="cuda")
        for dtype in (torch.float64, torch.float32):
            rows = torch.tensor(x[None], dtype=dtype, device="cuda")
            W, _ = cwt_batch(rows, sc, ds.dt, mother=M6, nfft=nfft)
            errs[f"mauna cwt_batch {str(dtype)[6:]} rows"] = rel_err(
                (W[0].abs() ** 2).cpu().numpy(), ref)
        # f32 rows: the sharded surfaces compute in their rows' dtype
        Ws = _one_rank_sharded(rows, sc, ds.dt, nfft)
        check(torch.equal(Ws, W), "one-rank sharded_cwt differs from cwt_batch")
        errs["mauna sharded_cwt (one rank, f32 rows)"] = rel_err(
            (Ws[0].abs() ** 2).cpu().numpy(), ref)
    for what, err in errs.items():
        check(err < CWT_BOUND, f"{what}: |W|² {err} >= {CWT_BOUND}")
    log(f"[{card}] |W|² against the CPU f64 port (bound {CWT_BOUND}): " + ", ".join(
        f"{k} {v:.3e} ({CWT_BOUND / v:.1f}x margin)" for k, v in errs.items()))
    return errs


def _one_rank_sharded(rows, sc, dt, nfft):
    """On a one-rank NCCL mesh: ``sharded_cwt`` of ``rows`` (its local W,
    returned), and ``sharded_wct_matrix`` on the 8-station network's
    normalized f32 rows bit for bit against ``wct_matrix`` on the same rows
    (both run ``_wct_matrix_blocks``)."""
    import torch.distributed as dist

    import pycwt_torch as pt
    from pycwt_torch.examples.sample_network import make_network
    from pycwt_torch.parallel import distributed, make_mesh, sharded_cwt, sharded_wct_matrix
    from pycwt_torch.transform import build_scale_grid

    M6 = pt.Morlet(6)
    y = torch.tensor(make_network(), dtype=torch.float32, device="cuda")
    yn = (y - y.mean(-1, keepdim=True)) / y.std(-1, correction=0, keepdim=True)
    pairs = np.array([(i, j) for i in range(8) for j in range(i + 1, 8)])
    R, A, _, _, _ = pt.wct_matrix(yn.cpu().numpy(), 1.0, normalize=False, pairs=pairs,
                                  pair_block=4, as_numpy=False)
    mesh = make_mesh()
    try:
        Ws, _ = sharded_cwt(mesh, rows, sc, dt, mother=M6, nfft=nfft)
        Rs, As = sharded_wct_matrix(mesh, y, pairs, build_scale_grid(512, 1.0).sj, 1.0,
                                    1 / 12, mother=M6, nfft=512, block=4)
        Ws, Rs, As = Ws.to_local(), Rs.to_local(), As.to_local()
    finally:
        dist.destroy_process_group()
        distributed._GROUP_DEVICE.clear()
    check(_bitwise(Rs, R) and _bitwise(As, A),
          "one-rank sharded_wct_matrix differs from wct_matrix on the same rows")
    return Ws


def _network_errs(card):
    """sample_network's coherence maps on both kernel routes against the
    CPU f64 port, and their margin to the 1e-3 bound."""
    import pycwt_torch as pt
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.examples.sample_network import make_network

    y = make_network()
    ref = pt.wct_matrix(y, 1.0, config=CWTConfig(dtype=torch.float64), device="cpu")[0]
    errs = {}
    for small in (False, True):
        with _route(small):
            errs["cwt_direct" if small else "default"] = rel_err(
                pt.wct_matrix(y, 1.0)[0], ref)
    for route, err in errs.items():
        check(err < WCT_BOUND, f"network maps, route {route}: {err} >= {WCT_BOUND}")
    log(f"[{card}] sample_network maps against the CPU f64 port (bound {WCT_BOUND}): "
        + ", ".join(f"{k} {v:.3e} ({100 * (1 - v / WCT_BOUND):.1f} % to spare)"
                    for k, v in errs.items()))
    return errs


def _bitwise(a, b):
    """The same bits, NaN where NaN."""
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()],
                                                                  b[~b.isnan()]))


def _pinned_results():
    """The surfaces whose f32 products the pin covers, on both kernel
    routes: the 4,000-point _wct_core, the 300-member MC curve, the
    32-station wct_matrix maps (unfetched) and the gradient of the
    4,000-point coherence."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco

    ys, sj, core_call = _wct_core_inputs(*_wct_pair())
    _, al1, al2, kw = _mc_args()
    mc = dict(mc_count=MC_COUNT, seed=MC_SEED, cache=False, progress=False, **kw)
    stations = _stations()
    out = {}
    for small in (False, True):
        route = "cwt_direct" if small else "default"
        with _route(small):
            R, A, _ = core_call()
            out[f"_wct_core R2 {route}"], out[f"_wct_core phase {route}"] = R, A
            out[f"MC curve {route}"] = torch.tensor(tco.wct_significance(al1, al2, **mc))
            out[f"wct_matrix {route}"] = pt.wct_matrix(stations, PAIRS_DT,
                                                       as_numpy=False)[0]
            a = ys[0].clone().requires_grad_(True)
            R, _, _ = tco._wct_core(a, ys[1], sj, 1.0, mother=pt.Morlet(6), nfft=4096,
                                    dj=1 / 12)
            out[f"gradient {route}"] = torch.autograd.grad(R.mean(), a)[0]
    return out


def _spectrum_cost(card):
    """Device ms of the f64 spectrum (``_spectrum_f64`` rounded to f32
    planes, as ``_planar_cwt_of_real`` takes it) against the f32 rFFT it
    replaced (``fft_of_real_planar``), and of the whole ``_planar_cwt_of_real``
    call beside them: at the MC chunk (300 rows, nfft 1024, 76 scales), an
    overlap-save chunk (one row, nfft 2^19, 64 scales) and 2^20 × 1 (64
    scales)."""
    import pycwt_torch as pt
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.ops.fft import _spectrum_f64
    from pycwt_torch.ops.mxu_dft import fft_of_real_planar

    n_mc, nfft_mc, sc_mc, _, _ = _mc_chunk_inputs()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sc64 = torch.tensor(2.0 * 2.0 ** (np.arange(64) / 8.0), dtype=torch.float32,
                        device="cuda")
    shapes = {"MC chunk (300, 1024)": (300, n_mc, nfft_mc, sc_mc),
              "overlap chunk (1, 2^19)": (1, 1 << 19, 1 << 19, sc64),
              "2^20 x 1": (1, 1 << 20, 1 << 20, sc64)}
    out = {}
    for what, (B, n, nfft, sc) in shapes.items():
        x = torch.randn((B, n), generator=gen, device="cuda")

        def f64_planes():
            spec = _spectrum_f64(x, nfft)
            return spec.real.contiguous(), spec.imag.contiguous()

        r = out[what] = dict(
            f64_ms=device_ms(f64_planes, calls=20),
            f32_ms=device_ms(lambda: fft_of_real_planar(x, nfft), calls=20),
            cwt_ms=device_ms(lambda: fc._planar_cwt_of_real(
                x, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0), calls=10),
            scales=int(sc.shape[0]))
        r["share"] = (r["f64_ms"] - r["f32_ms"]) / r["cwt_ms"]
        log(f"[{card}] spectrum at {what}: f64 rounded to f32 planes {r['f64_ms']:.4f} ms "
            f"against the f32 rFFT {r['f32_ms']:.4f} ms (device time per call); the "
            f"whole _planar_cwt_of_real ({r['scales']} scales) {r['cwt_ms']:.4f} ms, of "
            f"which the f64 spectrum adds {100 * r['share']:.2f} %")
    return out


def phase_repairs(card, real, mc, long):
    """The one forward-spectrum rule and the matmul pin on the card.

    The f64 spectrum: the five records' |W|² through the public ``cwt``
    (Mauna Loa also through ``cwt_batch`` and one-rank ``sharded_cwt``)
    within 5e-3 of the CPU f64 port, sample_network's maps on both routes
    within 1e-3, one-rank ``sharded_cwt`` and ``sharded_wct_matrix`` bit for
    bit with the unsharded port on the same rows, the MC curve bit for bit
    across ``mc_batch`` 1/7/64/300 and ``pair_block``, and the spectrum's
    device cost.  The pin: under each of CARD_CALLERS the 4,000-point
    ``_wct_core`` and its gradient, the 300-member MC curve and the
    32-station maps, on both kernel routes, bit for bit against the
    default-setting run, the caller's setting read back unchanged after the
    calls, and the process's setting restored at the end."""
    from pycwt_torch import coherence as tco

    t_phase = time.perf_counter()
    out = dict(cwt_errs=_cwt_power_errs(card), network_errs=_network_errs(card))

    _, al1, al2, kw = _mc_args()
    mc_kw = dict(mc_count=MC_COUNT, seed=MC_SEED, cache=False, progress=False, **kw)
    curves = {b: tco.wct_significance(al1, al2, mc_batch=b, **mc_kw)
              for b in (300, 64, 7, 1)}
    check(all(np.array_equal(c, curves[300], equal_nan=True) for c in curves.values()),
          "MC curve changes with mc_batch on the f64 spectrum")
    batch = {(b, p): tco.wct_significance_batch([al1, 0.3], [al2, 0.5], mc_batch=b,
                                                pair_block=p, **mc_kw)
             for b, p in ((300, 2), (64, 1), (7, 2))}
    first = next(iter(batch.values()))
    check(all(np.array_equal(c, first, equal_nan=True) for c in batch.values()),
          "wct_significance_batch changes with mc_batch / pair_block")
    log(f"[{card}] MC curve bit for bit at mc_batch {list(curves)} and "
        f"wct_significance_batch at (mc_batch, pair_block) {list(batch)}")

    sup = _support("test_torch_matmul_pin_support")
    saved = sup.state()
    ref = _pinned_results()
    out["pinned"] = {}
    try:
        for setting in CARD_CALLERS:
            sup.CALLERS[setting]()
            before = sup.state()
            got = _pinned_results()
            check(sup.state() == before, f"{setting}: the caller's setting changed")
            same = {k: _bitwise(got[k], v) for k, v in ref.items()}
            check(all(same.values()), f"{setting}: results moved: {same}")
            out["pinned"][setting] = before
            sup.restore(saved)
            log(f"[{card}] under {setting} ({before['cuda.matmul']} for cuBLAS): "
                f"{len(same)} results bit for bit with the default setting "
                f"({', '.join(same)})")
    finally:
        sup.restore(saved)
    check(sup.state() == saved, "the process's matmul setting was not restored")
    del ref

    out["spectrum_cost"] = _spectrum_cost(card)
    out["phase_times"] = {
        "_wct_core 4,000 points ms": {"default": real["core"][False],
                                       "cwt_direct": real["core"][True]},
        "MC 300 members ms": {k: r["ms"] for k, r in mc["routes"].items()},
        "overlap 2^24 ms": {k: r["ms"] for k, r in long["surfaces"].items()}}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{card}] repairs ({out['seconds']:.2f} s); this run's times of the phases the "
        f"f64 spectrum reaches: {json.dumps(out['phase_times'])}")
    return out


#: each run of phase_parallel: (run, ranks, backend); and a run's time limit
PARALLEL_RUNS = (("A", 1, "nccl"), ("B", 4, "gloo"))
PARALLEL_TIMEOUT = 300
#: the surfaces whose ranks transform on the card through K1+K2
PARALLEL_KERNEL_SURFACES = ("cwt", "power_pipeline", "wct", "mc_histogram",
                            "mc_histogram_pairs", "wct_significance_batch", "wct_pairs",
                            "wct_matrix", "overlap", "wct_overlap")


def parallel_rank(rank, world, backend, out_dir):
    """``--parallel-rank RANK WORLD BACKEND DIR``: one rank of
    :func:`phase_parallel` (tests/test_torch_parallel_support.py's
    ``chip_job``); exits non-zero when a surface misses its bound."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    report = _support("test_torch_parallel_support").chip_job(
        int(rank), int(world), backend, out_dir)
    bad = {f"{n}/{k}": e for n, r in report["surfaces"].items()
           for k, e in r["errs"].items() if not e["ok"]}
    check(report["imports_clean"], "a rank imported jax or pycwt_tpu")
    check(not bad, f"rank {rank} of {world} ({backend}): {bad}")
    log(f"rank {rank} of {world} ({backend}) ok in {report['seconds']:.1f} s")


def phase_parallel(card):
    """pycwt_torch.parallel on the card, in child processes of this script
    (``--parallel-rank``), each run under a time limit after which every
    rank is killed by PID.  Run A: one NCCL rank, mesh (1, 1, 1), every
    sharded surface at its full size against the unsharded port on the card
    (bit for bit where the same kernels see the same shapes), results saved.
    Run B: four ranks sharing the card over gloo on CUDA tensors, each
    rank's block against its slice of run A's results (rtol 2e-5 / atol
    1e-6 of max for the f32 maps, exact for the Monte-Carlo counts and
    curves).  Prints each surface's errors, CUDA-event ms (median of 3),
    K1/K2/K3 launches a call and peak bytes, per rank."""
    import shutil

    from pycwt_torch.ops import _build

    _build.build_all()                     # the ranks load the built libraries
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "pycwt_torch", "_build", f"parallel-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    reports = {}
    t0 = time.perf_counter()
    try:
        for run, world, backend in PARALLEL_RUNS:
            logs = [open(os.path.join(out_dir, f"{run}-rank{r}.log"), "w")
                    for r in range(world)]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
                 str(world), backend, out_dir], stdout=logs[r], stderr=subprocess.STDOUT)
                for r in range(world)]
            deadline = time.perf_counter() + PARALLEL_TIMEOUT
            try:
                for p in procs:
                    p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in logs:
                    f.close()
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    with open(os.path.join(out_dir, f"{run}-rank{r}.log")) as f:
                        tail = f.read()[-6000:]
                    raise AssertionError(f"parallel run {run} rank {r} exited "
                                         f"{p.returncode}:\n{tail}")
            reports[run] = [json.load(open(os.path.join(out_dir, f"{run}-rank{r}.json")))
                            for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out = dict(seconds=time.perf_counter() - t0, runs={})
    for run, world, backend in PARALLEL_RUNS:
        label = ("one NCCL rank" if world == 1 else
                 "4 ranks sharing one H100 over gloo; not a multi-GPU speed")
        res = out["runs"][run] = {}
        for name in reports[run][0]["surfaces"]:
            per = [rep["surfaces"][name] for rep in reports[run]]
            launches = [r["launches"] for r in per]
            if name in PARALLEL_KERNEL_SURFACES:
                check(all(_four_step_only(lc) for lc in launches),
                      f"parallel {run} {name}: launches {launches}")
            errs = {k: max(r["errs"][k]["max_abs"] for r in per) for k in per[0]["errs"]}
            rel = {k: max(r["errs"][k]["max_rel_to_peak"] for r in per) for k in errs}
            res[name] = dict(mesh=per[0]["mesh"], ms=[r["ms"] for r in per],
                             ms_runs=[r["ms_runs"] for r in per],
                             launches=launches[0], peak_bytes=[r["peak_bytes"] for r in per],
                             max_memory_allocated=[r["max_memory_allocated"] for r in per],
                             max_abs_err=errs, max_err_of_peak=rel,
                             exact={k: all(r["errs"][k]["exact"] for r in per) for k in errs},
                             ratio={k: max(r["errs"][k]["ratio"] for r in per) for k in errs},
                             phase_wrapped={k: max(r["errs"][k]["wrapped_max_abs"] for r in per)
                                            for k in errs if k == "A"})
            log(f"[{card}] parallel run {run} ({label}), {name} on mesh {per[0]['mesh']}: "
                f"ms per rank {[round(r['ms'], 3) for r in per]} (CUDA events, median of "
                f"3), K1/K2/K3 launches a call a rank {launches[0]}, peak bytes a rank "
                f"{[r['peak_bytes'] for r in per]}, max_memory_allocated "
                f"{[r['max_memory_allocated'] for r in per]}, max |err| {errs}, of max|ref| "
                f"{rel}, ratio to rtol 2e-5 / atol 1e-6 {res[name]['ratio']}, exact "
                f"{res[name]['exact']}, wrapped phase {res[name]['phase_wrapped']}")
        log(f"[{card}] parallel run {run}: rank start-up "
            f"{[round(r['init_s'], 2) for r in reports[run]]} s, whole rank "
            f"{[round(r['seconds'], 2) for r in reports[run]]} s")
    return out


#: nfft × scales of phase_relayout: the JAX tool's shape, and the one where
#: cwt_stage_b ran at ~20 % of its byte bound
RELAYOUT_SHAPES = ((1 << 20, 64), (1 << 22, 16))
#: the variants' bound against their plain versions, relative to max|out|
#: (memcopy: exact)
RELAYOUT_BOUND = 1e-5


def _relayout_ptxas(usage):
    """Each ablation variant's and each bf16-T instantiation's registers and
    spills, and the check that the f32 kernels the library runs kept
    PTXAS_BEFORE's (under the same nvcc)."""
    release = _nvcc_release()
    bf16 = {k: _ptxas_figures(line) for k, line in usage.items() if k.endswith(", bf16>")}
    for kernel, line in usage.items():
        if "," in kernel:
            kind = ("bf16 T" if kernel in bf16 else "complex epilogue"
                    if kernel.endswith(", complex>") else "ablation")
            log(f"  {kind} {kernel}: {line}")
    if not usage:
        log("  ptxas figures: libraries loaded from an earlier build, not compared")
        return {"nvcc": release, "compared": 0, "bf16": bf16}
    if release != PTXAS_RELEASE:
        log(f"  ptxas figures recorded under nvcc {PTXAS_RELEASE}, this is {release}: "
            "not compared")
        return {"nvcc": release, "compared": 0, "bf16": bf16}
    for kernel, want in PTXAS_BEFORE.items():
        check(kernel in usage, f"ptxas printed nothing for {kernel}")
        got = _ptxas_figures(usage[kernel])
        check(got == want, f"{kernel}: registers and spills {got}, before {want}")
    check(len(bf16) == 20, f"ptxas printed {len(bf16)} bf16-T instantiations, not 20")
    log(f"  ptxas: all {len(PTXAS_BEFORE)} f32 kernels the library runs keep their "
        "registers and spills")
    return {"nvcc": release, "compared": len(PTXAS_BEFORE), "bf16": bf16}


def phase_relayout(card, usage):
    """Counterpart of tools/tpu_relayout_experiment.py: cwt_stage_b's
    ablation variants (pycwt_torch/tools/relayout_experiment.py) at each
    RELAYOUT_SHAPES.  The tool's entry point ``run`` is the path driven, its
    launch counts set to 0 just before and read just after; then on the
    same T (stage_a of the seeded signal) ``full`` against
    ``stage_b(output="planes")`` bit for bit, each variant against its plain
    version on the card, the plain versions' times, and cuFFT's column
    ``ifft`` over T's own layout."""
    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.tools import relayout_experiment as rx

    ptxas = _relayout_ptxas(usage)
    shapes = {}
    for nfft, S in RELAYOUT_SHAPES:
        for v in rx.LAUNCHES:
            rx.LAUNCHES[v] = 0
        line = rx.run(nfft=nfft, scales=S, seed=0, rounds=2)
        launches = dict(rx.LAUNCHES)
        check(all(launches[v] > 0 for v in rx.VARIANTS),
              f"relayout 2^{nfft.bit_length() - 1}: a variant was not launched: {launches}")
        tr, ti = rx.make_t(nfft, S, seed=0)
        ref = fc.stage_b(tr, ti, nfft=nfft, output="planes")
        b_launches = fc.KERNEL_LAUNCHES["cwt_stage_b"]
        rows = {}
        for v in rx.VARIANTS:
            got = rx.ablated_stage_b(tr, ti, nfft=nfft, variant=v)
            if v == "full":
                check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                      f"relayout 2^{nfft.bit_length() - 1}: full is not cwt_stage_b's planes")
            plain = fc._stage_b_ablation_reference(tr, ti, nfft=nfft, variant=v)
            err = max(float((got[0] - plain[0]).abs().max()),
                      float((got[1] - plain[1]).abs().max()))
            tol = 0.0 if v == "memcopy" else RELAYOUT_BOUND * float(
                torch.complex(*plain).abs().max())
            check(err <= tol, f"relayout 2^{nfft.bit_length() - 1} {v}: {err} > {tol}")
            del got, plain
            plain_ms = time_ms(lambda v=v: fc._stage_b_ablation_reference(
                tr, ti, nfft=nfft, variant=v), runs=3, warmup=1)
            rows[v] = dict(device_ms=line[v], event_ms=line["event_ms"][v],
                           bound_share=line["bound_share"][v], max_abs_err=err,
                           tolerance=tol, launches=launches[v], plain_ms=plain_ms)
        check(fc.KERNEL_LAUNCHES["cwt_stage_b"] == b_launches,
              f"a variant moved cwt_stage_b's counter: {fc.KERNEL_LAUNCHES}")
        del ref
        z = torch.complex(tr, ti)
        del tr, ti
        ifft = lambda: torch.fft.ifft(z, dim=-2, norm="forward")  # noqa: E731
        lib_ms = device_ms(ifft, calls=10, floor=line["bound_ms"])
        lib_event_ms = time_ms(ifft, runs=5)
        del z
        torch.cuda.empty_cache()
        key = f"2^{nfft.bit_length() - 1}x{S}"
        shapes[key] = dict(nfft=nfft, S=S, R1=line["R1"], R2=line["R2"],
                           bound_ms=line["bound_ms"], library_ms=lib_ms,
                           library_event_ms=lib_event_ms,
                           non_butterfly_share_pct=line["non_butterfly_share_pct"],
                           variants=rows)
        log(f"[{card}] relayout {key} (R1 {line['R1']}, device ms per call, share of "
            f"the {line['bound_ms']:.4f} ms byte bound; max |err| vs plain): " +
            "; ".join(f"{v} {r['device_ms']:.4f} ({100 * r['bound_share']:.1f} %; "
                      f"{r['max_abs_err']:.3e})" for v, r in rows.items()) +
            f"; cuFFT column ifft over T {lib_ms:.4f} (events {lib_event_ms:.4f}); "
            f"non-butterfly share {line['non_butterfly_share_pct']:.1f} %")
    return dict(shapes=shapes, ptxas=ptxas)


def main():
    card = phase_device()
    t0 = time.perf_counter()
    usage = phase_build()
    par = phase_parallel(card)
    worst, four_step_vs_f64 = phase_kernels_vs_plain()
    large = phase_large_columns()
    phase_public_path()
    public_fast = phase_public_fast(card)
    bench = phase_bench_shape()
    stage_b_complex = phase_stage_b_complex(card)
    phase_gradient()
    worst_direct, direct_vs_f64 = phase_direct_vs_plain()
    phase_slice_path(small=False)
    phase_slice_path(small=True)
    real = phase_real_size()
    sizes = phase_direct_sizes()
    plans = phase_column_plans()
    from pycwt_torch.tools import relayout_experiment as rx

    check(sum(rx.LAUNCHES.values()) == 0,
          f"a library path launched an ablation variant: {rx.LAUNCHES}")
    # early in the run: late in a long process CUPTI has lost kernel records
    relayout = phase_relayout(card, usage)
    for v in rx.LAUNCHES:
        rx.LAUNCHES[v] = 0
    phase_direct_gradient()
    mc = phase_mc_significance()
    mc_generator = phase_mc_generator(card)
    mc_histogram = phase_mc_histogram(card)
    wct_head = phase_wct_head(card)
    pairs = phase_pairs(card)
    dog = phase_dog_repair(card)
    long = phase_long(card)
    parity = phase_parity(card)
    grad = phase_coherence_gradient()
    prof = phase_profiling(card, bench["rate"])
    examples = phase_examples(card)
    repairs = phase_repairs(card, real, mc, long)
    # every library path, before phase_relayout and after it, launched no variant
    library_path_launches = sum(rx.LAUNCHES.values())
    check(library_path_launches == 0,
          f"a library path launched an ablation variant: {rx.LAUNCHES}")
    common = dict(route="cuda", source=KERNEL_SOURCE, library_ms=bench["lib_ms"],
                  library_call="torch.fft.ifft of the filtered (64, 2^20) complex64 product",
                  max_rel_err_by_tier=worst, planes_err_vs_f64=four_step_vs_f64,
                  large_columns_err=large,
                  shape="N=2^20, S=64, Morlet-6, power_sum", card=card)
    kernels = [
        dict(name="cwt_stage_a", replaces="pycwt_tpu/ops/pallas_fft.py:252",
             tpu_kernel="_make_kernel_a (K1)", launches=bench["launches"]["cwt_stage_a"],
             max_abs_err=bench["err_a"], tolerance=bench["tol_a"],
             ms=bench["ms_a"], device_ms=bench["dev_a"], plain_ms=bench["plain_a"],
             bound_ms=bench["bound_a"], bound_by=bench["by_a"],
             bound_share=bench["bound_a"] / bench["dev_a"],
             bound_bytes=bench["bytes_a"], **common),
        dict(name="cwt_stage_b", replaces="pycwt_tpu/ops/pallas_fft.py:289",
             tpu_kernel="_make_kernel_b (K2)", launches=bench["launches"]["cwt_stage_b"],
             max_abs_err=bench["err_b"], tolerance=bench["tol_b"],
             ms=bench["ms_b"], device_ms=bench["dev_b"], plain_ms=bench["plain_b"],
             bound_ms=bench["bound_b"], bound_by=bench["by_b"],
             bound_share=bench["bound_b"] / bench["dev_b"],
             bound_bytes=bench["bytes_b"], **common),
    ]
    fast = bench["fast"]
    for stage, tpu, line in (("a", "_make_kernel_a (K1)", 252),
                             ("b", "_make_kernel_b (K2)", 289)):
        kernels.append(dict(
            name=f"cwt_stage_{stage}_bf16", route="cuda", source=KERNEL_SOURCE,
            replaces=f"pycwt_tpu/ops/pallas_fft.py:{line}",
            tpu_kernel=f"{tpu} with a bf16 T at precision='fast' (pallas_fft.py:699-705)",
            launches=fast["launches"][f"cwt_stage_{stage}_bf16"],
            cwt_fast_launches=public_fast["launches"][f"cwt_stage_{stage}_bf16"],
            max_abs_err=fast["err_" + stage],
            tolerance=("one bf16 ulp of the plain f32 T rounded, or the f32 T's 1e-5 of "
                       "max|T| beyond it; bit for bit cwt_stage_a's T rounded"
                       if stage == "a" else fast["tol_b"]),
            t_elements_differing=fast["share"] if stage == "a" else None,
            t_elements_beyond_one_ulp=fast["beyond"] if stage == "a" else None,
            ms=fast["ms"][stage + "16"], device_ms=fast["dev"][stage + "16"],
            f32_device_ms=fast["dev"][stage], plain_ms=fast["plain_" + stage],
            bound_ms=fast["bound_" + stage], bound_by=fast["by_" + stage],
            bound_share=fast["bound_" + stage] / fast["dev"][stage + "16"],
            bound_bytes=fast["bytes_" + stage], library_ms=bench["lib_ms"],
            library_call="as the f32 form: no PyTorch call computes a bf16-rounded T",
            pipeline_vs_plain={"f32": fast["e_pipe32"], "bf16": fast["e_pipe16"]},
            cwt_fast_vs_plain=public_fast["errs"],
            max_rel_err_by_tier={"fast": worst["fast"],
                                 "fast_vs_bf16_plain": worst["fast_vs_bf16_plain"]},
            shape="N=2^20, S=64, Morlet-6, power_sum, precision='fast'", card=card))
    kernels += [
        dict(name="cwt_direct", route="cuda", source=DIRECT_SOURCE,
             replaces="pycwt_tpu/ops/pallas_fft.py:360",
             tpu_kernel="_make_kernel_direct (K3)", launches=real["launches"],
             max_abs_err=real["err"], tolerance=real["tol"], ms=real["ms"],
             ms_by="torch.profiler device time per call", wall_ms=real["wall_ms"],
             plain_ms=real["plain_ms"], bound_ms=real["bound"], bound_by=real["by"],
             bound_share=real["bound"] / real["ms"],
             bound_ops=real["ops"], bound_bytes=real["bytes"], library_ms=real["lib_ms"],
             library_call=f"torch.fft.ifft of the filtered (2, {real['S']}, 4096) "
                          "complex64 product", four_step_ms=real["ms_four"],
             max_rel_err_by_tier=worst_direct, planes_err_vs_f64=direct_vs_f64,
             shape=f"B=2, K=2048, N=4096, S={real['S']}, Morlet-6, planes", card=card),
    ]
    mc_launches = {k: r["launches"] for k, r in mc["routes"].items()}
    for k in kernels:
        name = k["name"]
        k["mc_launches_per_300_members"] = {
            route: counts[name] for route, counts in mc_launches.items()}
        k["wct_matrix_launches"] = {route: r["launches"][name]
                                    for route, r in pairs["routes"].items()}
        k["wct_matrix_analysis_launches"] = {
            kind: pairs[f"analysis_{kind}"]["launches"][name] for kind in ("cold", "warm")}
        # the overlap surfaces run the default tier: K1/K2 with an f32 T
        k["overlap_2p24_launches"] = {
            srf: (r["launches"] if name in ("cwt_stage_a", "cwt_stage_b") else 0)
            for srf, r in long["surfaces"].items()}
        if name.endswith("_bf16"):
            continue
        k["new_shapes_err_vs_plain"] = (
            {"wct_matrix (32, 110, 1024)": pairs["kernel_err"]["cwt_direct"]}
            if name == "cwt_direct" else
            {"wct_matrix (32, 110, 1024)": pairs["kernel_err"]["K1+K2"],
             f"null chunk ({pairs['mc']['rows_a_chunk']}, 110, {pairs['mc']['nfft']})":
                 pairs["kernel_err"]["K1+K2 null chunk"],
             f"overlap chunk (1, 64, {long['chunk_nfft']})": long["kernel_err"]})
        k["dog6_repair_err_vs_f64"] = dog["cwt_direct" if name == "cwt_direct"
                                          else "cwt_stage_a"]
        k["coherence_grad_launches"] = {
            route: counts[name] for route, counts in grad["launches"].items()}
        k["examples_launches"] = {
            example: {route: counts[name] for route, counts in by_route.items()}
            for example, by_route in examples["launches"].items()}
        k["sharded_launches_per_call_per_rank"] = {
            run: {srf: r["launches"][name] for srf, r in res.items()}
            for run, res in par["runs"].items()}
    for name, tpu in (("mc_fold_in", "jax.random.split / fold_in under XLA, no Pallas kernel"),
                      ("mc_rednoise", "jax.random.normal and an associative scan under XLA, "
                                      "no Pallas kernel")):
        gen = mc_generator["kernels"][name]
        kernels.append(dict(
            name=name, route="cuda", source=MC_SOURCE,
            replaces=("pycwt_tpu/coherence.py:863" if name == "mc_fold_in"
                      else "pycwt_tpu/stats.py:162"),
            tpu_kernel=tpu,
            launches=mc["routes"]["default"]["mc_launches"][name],
            mc_launches_per_300_members={route: r["mc_launches"][name]
                                         for route, r in mc["routes"].items()},
            launches_per_generator_call=gen["launches_per_call"],
            max_abs_err=0.0, tolerance="bit for bit: torch.equal with the torch code's "
                                       "words and rows on the card",
            ms=gen["device_ms"], ms_by="torch.profiler device time per call of split + "
                                       "2 x rednoise_members",
            plain_ms=mc_generator["torch"]["device_ms_median"],
            plain_call="the torch code on the card, the whole generator call",
            host_ms=mc_generator["kernel"]["host_ms_median"],
            plain_host_ms=mc_generator["torch"]["host_ms_median"],
            bound_ms=gen["bound_ms"], bound_by="bytes", bound_share=gen["bound_share"],
            bound_bytes=gen["bound_bytes"],
            shape=f"2 x {MC_COUNT} members, n {mc_generator['n']}, f32, the golden's al1/al2",
            card=card))
    for cell, r in mc_histogram["shapes"].items():
        kernels.append(dict(
            name=f"mc_coherence_counts ({cell})", route="cuda", source=MC_HIST_SOURCE,
            replaces="pycwt_tpu/coherence.py:872-892, :1306 (the bins and counts, jnp under jit)",
            tpu_kernel="none: XLA fuses the ratio, the bins and the counts",
            launches={route: rr["hist_launches"] for route, rr in mc["routes"].items()},
            chunks={route: rr["chunks"] for route, rr in mc["routes"].items()},
            launches_batch=mc["batch_hist"]["launches"], chunks_batch=mc["batch_hist"]["chunks"],
            launches_by="wct_significance (300 members, each route) and wct_significance_batch "
                        "(8 nulls at pair_block 8 and 3), counted from 0 around each run",
            max_abs_err=r["max_abs_err"],
            tolerance="bit for bit: the largest |kernel - torch tail| of the chunk's counts",
            ms=r["kernel"]["device_ms_median"],
            ms_by="torch.profiler device time per call on a real chunk's fields",
            plain_ms=r["torch"]["device_ms_median"],
            plain_call="the torch tail: the ratio, _histogram's passes and scatter_add_, acc +=",
            bound_ms=r["bound_ms"], bound_by="bytes", bound_share=r["kernel"]["bound_share"],
            bound_bytes=r["bound_bytes"], shape=r["shape"], card=card))
    for cell, r in wct_head["shapes"].items():
        kernels.append(dict(
            name=f"wct_fields_head ({cell})", route="cuda", source=WCT_HEAD_SOURCE,
            replaces="none: pycwt_tpu builds the fields with jnp ops under jit, which XLA fuses",
            tpu_kernel="none", max_abs_err=0.0,
            tolerance="bit for bit: torch.equal with the torch head's fields on the card",
            launches={route: rr["head_launches"] for route, rr in mc["routes"].items()},
            chunks={route: rr["chunks"] for route, rr in mc["routes"].items()},
            launches_batch=mc["batch_hist"]["head_launches"],
            chunks_batch=mc["batch_hist"]["chunks"],
            launches_analysis={kind: pairs[f"analysis_{kind}"]["head_launches"]
                               for kind in ("cold", "warm")},
            null_chunks_analysis={kind: pairs[f"analysis_{kind}"]["null_chunks"]
                                  for kind in ("cold", "warm")},
            launches_overlap=long["surfaces"]["wct_overlap_planar"]["head_launches"],
            chunks_overlap=LONG_TIME_N // LONG_CHUNK,
            launches_by="the main paths, counted from 0 around each run: wct_significance "
                        "(300 members, each route), wct_significance_batch (8 nulls at "
                        "pair_block 8 and 3), wct_matrix_analysis cold and warm, "
                        "wct_overlap_planar at 2^24; one launch a chunk",
            ms=r["kernel"]["device_ms_median"],
            ms_by="torch.profiler device time per call on random planes",
            plain_ms=r["torch"]["device_ms_median"],
            plain_call="the torch head: 18 element-wise launches (squares, sums, the cross "
                       "product, the divisions, two torch.complex)",
            bound_ms=r["bound_ms"], bound_by="bytes", bound_share=r["kernel"]["bound_share"],
            bound_bytes=r["bound_bytes"], shape=r["shape"], cross_planes=r["cross"],
            card=card))
    jax_shape = relayout["shapes"]["2^20x64"]
    variants = [r for sh in relayout["shapes"].values() for r in sh["variants"].values()]
    kernels.append(dict(
        name="cwt_stage_b_ablation", route="cuda", source=KERNEL_SOURCE,
        replaces="tools/tpu_relayout_experiment.py:102",
        tpu_kernel="make_kernel(variant, precision): ablated kernel B",
        launches=sum(r["launches"] for r in variants),
        max_abs_err=max(r["max_abs_err"] for r in variants),
        tolerance=f"{RELAYOUT_BOUND} of max|out| of each variant's plain version; "
                  "memcopy and full (against cwt_stage_b) exact",
        ms=jax_shape["variants"]["full"]["device_ms"],
        ms_by="torch.profiler device time per call of the full variant at 2^20 x 64",
        plain_ms=jax_shape["variants"]["full"]["plain_ms"],
        bound_ms=jax_shape["bound_ms"], bound_by="bytes",
        bound_share=jax_shape["variants"]["full"]["bound_share"],
        library_ms=jax_shape["library_ms"],
        library_call="torch.fft.ifft(torch.complex(tr, ti), dim=-2, norm='forward') "
                     "over T (rows, R1, R2)",
        library_path_launches=library_path_launches,
        shapes=relayout["shapes"], ptxas=relayout["ptxas"], card=card))
    log(json.dumps({"pipeline_ms": bench["ms_pipe"], "pipeline_device_ms": bench["dev_pipe"],
                    "plain_pipeline_ms": bench["plain_pipe"],
                    "sample_scales_per_s": bench["rate"],
                    "wct_core_ms": {"default": real["core"][False],
                                    "cwt_direct": real["core"][True]},
                    "direct_vs_four_step_vs_ifft_device_ms": {
                        str(n): [r["direct"], r["four"], r["ifft"]] for n, r in sizes.items()},
                    "stage_a_vs_stage_b_device_ms": {
                        str(n): [r["a"], r["b"]] for n, r in plans.items()},
                    "stage_a_vs_stage_b_bf16_device_ms_and_bounds": {
                        str(n): {k: r[k] for k in (
                            "a16", "b16", "b_ps", "b16_ps", "bound_a16", "bound_b16",
                            "bound_b_ps", "bound_b16_ps")}
                        for n, r in plans.items()},
                    "stage_b_epilogues_device_ms": stage_b_complex,
                    "fast_pipeline_ms": bench["fast"]["ms_pipe"],
                    "fast_pipeline_device_ms": bench["fast"]["dev_pipe"],
                    "fast_sample_scales_per_s": bench["fast"]["rate"],
                    "mc_300_members_ms": {k: r["ms"] for k, r in mc["routes"].items()},
                    "mc_peak_bytes_per_member": {
                        k: r["peak_per_member"] for k, r in mc["routes"].items()},
                    "mc_model_bytes_per_member": mc["model_per_member"],
                    "mc_auto_batch": mc["auto_batch"], "mc_generator_ms": mc["generator_ms"],
                    "mc_batch_8_nulls_ms": mc["batch_ms"],
                    "mc_generator": mc_generator,
                    "mc_histogram": mc_histogram, "wct_head": wct_head,
                    "mc_vs_cpu_f64_max_abs": mc["vs_cpu_f64"],
                    "wct_matrix_32_stations_ms": {
                        k: r["ms"] for k, r in pairs["routes"].items()},
                    "wct_matrix_32_stations_unfetched_ms": {
                        k: r["ms_unfetched"] for k, r in pairs["routes"].items()},
                    "wct_matrix_analysis_ms": {
                        k: pairs[f"analysis_{k}"]["ms"] for k in ("cold", "warm")},
                    "wct_matrix_analysis_peak_bytes": {
                        k: pairs[f"analysis_{k}"]["peak"] for k in ("cold", "warm")},
                    "distinct_nulls": pairs["distinct_nulls"],
                    "pairs_planes_a_pair": pairs["planes_a_pair"],
                    "overlap_2p24": long["surfaces"], "overlap_2p22_errs": long["errs_2p22"],
                    "parity_golden_errs": parity["golden_errs"],
                    "parity_2p20_rows_err": parity["rows_err"],
                    "parity_2p20_device_ms": parity["device_ms"],
                    "parity_2p20_call_ms": parity["call_ms"],
                    "parity_2p20_peak_bytes": parity["peak_bytes"],
                    "parity_launches": parity["launches"],
                    "parity_env_planar_diff": parity["env_planar_diff"],
                    "f32_planes_2p20_device_ms": parity["f32_planes_device_ms"],
                    "f32_planes_2p20_call_ms": parity["f32_planes_call_ms"],
                    "f32_planes_2p20_peak_bytes": parity["f32_planes_peak_bytes"],
                    "coherence_grad_errs": grad["err"],
                    "coherence_grad_launches": grad["launches"],
                    "coherence_grad_lag": grad["lag"],
                    "phase_timer_rate": prof["phase_timer_rate"],
                    "build_cache": {k: prof[k] for k in (
                        "cache_first_build_s", "cache_first_process_s",
                        "cache_second_process_s", "cache_libs")},
                    "examples_ms": {
                        route: {run: {k: r[k] for k in ("cold_ms", "warm_ms", "peak")}
                                for run, r in runs.items()}
                        for route, runs in examples["routes"].items()},
                    "examples_trace": examples["trace"],
                    "examples_child_s": examples["children"],
                    "examples_peak_bytes": examples["peak"],
                    "parallel": par, "repairs": repairs, "card": card,
                    "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["--trace"]:
        phase_device()
        phase_wct_trace()
        phase_mc_trace()
        phase_pairs_long_trace()
        phase_parity_trace()
        for route in ("default", "cwt_direct"):
            phase_examples_trace(route)
    elif sys.argv[1:2] == ["--parallel-rank"] and len(sys.argv) == 6:
        parallel_rank(*sys.argv[2:])
    elif sys.argv[1:2] == ["--first-call-trace"] and len(sys.argv) == 3:
        first_call_trace(sys.argv[2])
    elif sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        phase_device()
        phase_ab(sys.argv[2])
    elif sys.argv[1:] == ["--mc-generator"]:
        card = phase_device()
        phase_build()
        phase_mc_generator(card)
    elif sys.argv[1:] == ["--mc-histogram"]:
        card = phase_device()
        phase_build()
        phase_mc_histogram(card)
    elif sys.argv[1:] == ["--wct-head"]:
        card = phase_device()
        phase_build()
        phase_wct_head(card)
    elif sys.argv[1:] == ["--stage-b-complex"]:
        card = phase_device()
        usage = phase_build()
        phase_stage_b_complex(card)
        _relayout_ptxas(usage)
    elif sys.argv[1:2] == ["--time-wct"] and len(sys.argv) == 3:
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        phase_device()
        phase_build()
        phase_wct_timing()
    else:
        main()

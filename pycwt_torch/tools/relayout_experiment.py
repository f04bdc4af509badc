"""Where does ``cwt_stage_b``'s time go?  Its ablation variants on the card.

Counterpart of ``tools/tpu_relayout_experiment.py``, which times the TPU's
kernel B with its twiddle multiply, its inter-substage transpose, or both
taken out, at equal matmul work.  The same question is put here to
``cwt_stage_b`` (``csrc/fused_cwt.cu``), whose length-R1 column FFT is a
Stockham FFT of 16 points a thread with a shared-memory exchange between
passes.  Each variant is that kernel's own body compiled with stages taken
out (``enum Ablate`` in ``csrc/fft_common.cuh``), at the same grid, blocks,
shared memory and bytes (T in, W planes out):

* ``full``: ``cwt_stage_b`` itself (planes), bit for bit;
* ``notwiddle``: the passes after the first without their twiddle
  multiplies (the JAX tool's ``notwiddle``);
* ``noexchange``: no shared-memory round trip between passes; each thread
  runs every pass on its own 16 registers (the JAX tool's ``noswap``: the
  TPU's relayout was a transpose, the card's is this exchange);
* ``butterflies``: both taken out, the in-register radix DFTs alone (the JAX
  tool's ``dotsonly``, the arithmetic floor);
* ``memcopy``: no pass at all, the first pass's loads straight to the
  epilogue's stores, ×1/N: the device-memory floor of K2's access pattern.

Every variant but ``full`` computes wrong numbers by design.  Each has a
plain PyTorch version with the same arithmetic
(``ops/fused_cwt._stage_b_ablation_reference``), which the wrapper runs on a
CPU tensor.  ``memcopy`` near ``full`` says that the access pattern sets the
kernel's time; ``noexchange`` well below ``full``, that the exchange does.

Run on the card::

    python -m pycwt_torch.tools.relayout_experiment [tier] [--nfft N]
                                                    [--scales S] [--seed K]

prints one JSON line.  ``tier`` (highest, high, fast) is accepted for parity
with the JAX tool: every tier runs the same f32 kernel.  Without a card the
script exits non-zero and says why; there is no CPU timing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import _PRECISIONS
from ..ops import fused_cwt as fc

__all__ = ["VARIANTS", "LAUNCHES", "ablated_stage_b", "make_t", "time_variants",
           "run", "main"]

VARIANTS = tuple(fc.ABLATIONS)
#: Launches of each variant, counted by :func:`ablated_stage_b` where it
#: launches the kernel
LAUNCHES = dict.fromkeys(VARIANTS, 0)
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
PEAK_BYTES = 3.35e12
#: Longest column the kernel's variants are built for (R1 = 2048: nfft ≤ 2^23)
_MAX_R1 = 2048
#: Calls a timing of one variant spans
_CALLS = 20


def ablated_stage_b(tr, ti, *, nfft: int, variant: str):
    """``cwt_stage_b``'s planes with the stages of ``variant`` taken out:
    planar f32 T ``(rows, R1, R2)`` → W planes ``(rows, nfft)`` ×2, R1 ≤ 2048.
    A CUDA tensor launches ``cwt_stage_b_ablation`` with ``stage_b``'s
    columns per block, radix plan and shared memory; a CPU tensor runs the
    plain version.  Every variant but ``full`` is wrong by design."""
    if variant not in fc.ABLATIONS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    R1, R2 = fc._nfft_factors(nfft)
    rows = tr.shape[0] if tr.ndim else 0
    if (not fc.supported_nfft(nfft) or R1 > _MAX_R1
            or tuple(tr.shape) != (rows, R1, R2) or ti.shape != tr.shape
            or tr.dtype != torch.float32 or ti.dtype != torch.float32
            or ti.device != tr.device):
        raise ValueError(f"T must be two f32 (rows, {R1}, {R2}) planes on one device "
                         f"for nfft={nfft} (2^8..2^23), got {tr.dtype} "
                         f"{tuple(tr.shape)} and {ti.dtype} {tuple(ti.shape)}")
    if fc._check_device(tr) == "cpu":
        return fc._stage_b_ablation_reference(tr, ti, nfft=nfft, variant=variant)
    from ..ops._build import library

    tr = tr.contiguous()
    ti = ti.contiguous()
    cols = fc._stage_b_cols(R1, R2, torch.float32)
    fc._check_grid(rows * (R2 // cols))
    out0 = torch.empty((rows, nfft), dtype=torch.float32, device=tr.device)
    out1 = torch.empty_like(out0)
    with torch.cuda.device(tr.device):
        err = library("fused_cwt").cwt_stage_b_ablation(
            tr.data_ptr(), ti.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            rows, R1, R2, cols, 1.0 / nfft, *fc._plan_args(R1), fc.ABLATIONS[variant],
            torch.cuda.current_stream().cuda_stream)
    fc._raise_on(err, f"cwt_stage_b_ablation ({variant})")
    LAUNCHES[variant] += 1
    return out0, out1


def make_t(nfft: int, scales: int, seed: int = 0, device="cuda"):
    """The T that K2 reads on the bench path: a seeded N(0, 1) signal of
    ``nfft`` points, its half spectrum, Morlet-6 at ``scales`` scales
    2·2^(j/4) (``bench.py``'s grid), through ``stage_a``.  Planar f32
    ``(scales, R1, R2)``."""
    from ..mothers import Morlet
    from ..ops.mxu_dft import fft_of_real_planar
    from ..transform import build_scale_grid

    x = torch.tensor(np.random.default_rng(seed).standard_normal(nfft),
                     dtype=torch.float32, device=device)
    sr, si = fft_of_real_planar(x[None], nfft, half=True)
    grid = build_scale_grid(nfft, 1.0, dj=0.25, s0=2.0, J=scales - 1)
    sc = torch.tensor(grid.sj, dtype=torch.float32, device=device)
    return fc.stage_a(sr, si, sc, mother=Morlet(6), nfft=nfft, dt=1.0)


def bound_ms(nfft: int, rows: int) -> float:
    """The least time of any variant: T's planes read once and W's written
    once, 16·rows·nfft bytes, at :data:`PEAK_BYTES`."""
    return 16 * rows * nfft / PEAK_BYTES * 1e3


def _profiled_ms(fn, calls: int, floor: float, tries: int = 5) -> float:
    """Device time of one call of ``fn()``, which launches one kernel: the
    kernel times torch.profiler records over ``calls`` calls, per call.  A
    profile that holds fewer kernels than ``calls``, or less than ``floor``
    ms a call (CUPTI lost records: seen late in long processes), is taken
    again, up to ``tries`` times; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms, seen = 0.0, 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in rows) / calls / 1e3
        seen = sum(e.count for e in rows)
        if ms >= floor and seen >= calls:
            return ms
    raise RuntimeError(f"the profiler recorded {seen} kernels of {calls} calls, {ms} ms "
                       f"a call (bound {floor} ms), {tries} times")


def _event_ms(fn, calls: int) -> float:
    """CUDA-event time of ``calls`` calls of ``fn()`` in a row, per call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_variants(tr, ti, *, nfft: int, rounds: int = 3) -> dict:
    """Each variant timed in turns, ``rounds`` times over: device time per
    call (torch.profiler over 20 calls) and CUDA-event time per call (20
    calls in a row), after two warm-up calls.  Returns variant ->
    ``{"device_ms", "event_ms"}`` (medians over the rounds) and the rounds'
    device times (``"device_ms_rounds"``)."""
    floor = bound_ms(nfft, tr.shape[0])
    got = {v: {"device": [], "event": []} for v in VARIANTS}
    for v in VARIANTS:
        for _ in range(2):
            ablated_stage_b(tr, ti, nfft=nfft, variant=v)
    for _ in range(rounds):
        for v in VARIANTS:
            fn = lambda v=v: ablated_stage_b(tr, ti, nfft=nfft, variant=v)  # noqa: E731
            got[v]["device"].append(_profiled_ms(fn, _CALLS, floor))
            got[v]["event"].append(_event_ms(fn, _CALLS))
    return {v: {"device_ms": float(np.median(g["device"])),
                "event_ms": float(np.median(g["event"])),
                "device_ms_rounds": g["device"]} for v, g in got.items()}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]


def run(nfft: int = 1 << 20, scales: int = 64, seed: int = 0, tier: str = "high",
        rounds: int = 3) -> dict:
    """Time every variant on the card on the T of :func:`make_t`; returns the
    JSON line's dict (the JAX tool's keys, ``bound_ms`` and each variant's
    ``bound_share``, the card).  Raises without a card."""
    if tier not in _PRECISIONS:
        raise ValueError(f"tier must be one of {_PRECISIONS}, got {tier!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("relayout_experiment times cwt_stage_b's variants on an "
                           "NVIDIA card, and torch.cuda.is_available() is false: "
                           "there is no CPU timing")
    R1, R2 = fc._nfft_factors(nfft)
    tr, ti = make_t(nfft, scales, seed)
    res = time_variants(tr, ti, nfft=nfft, rounds=rounds)
    del tr, ti
    bound = bound_ms(nfft, scales)
    ms = {v: r["device_ms"] for v, r in res.items()}
    return {"metric": "kernel_b_ablation_ms", "tier": tier,
            "tier_note": "every tier runs the same f32 kernel",
            "S": scales, "R1": R1, "R2": R2, "nfft": nfft, **ms,
            "non_butterfly_share_pct": 100.0 * (ms["full"] - ms["butterflies"]) / ms["full"],
            "bound_ms": bound,
            "bound_share": {v: bound / t for v, t in ms.items()},
            "event_ms": {v: r["event_ms"] for v, r in res.items()},
            "device_ms_rounds": {v: r["device_ms_rounds"] for v, r in res.items()},
            "timing": "device_ms: torch.profiler kernel time per call; event_ms: "
                      f"CUDA events over {_CALLS} calls in a row; medians of {rounds} "
                      "rounds in turns",
            "card": card_line(), "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="cwt_stage_b's ablation variants, "
                                            "timed on the card; one JSON line")
    p.add_argument("tier", nargs="?", default="high", choices=_PRECISIONS)
    p.add_argument("--nfft", type=int, default=1 << 20)
    p.add_argument("--scales", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        line = run(args.nfft, args.scales, args.seed, args.tier)
    except (RuntimeError, ValueError) as err:
        sys.exit(f"relayout_experiment: {err}")
    print(json.dumps(line))


if __name__ == "__main__":
    main()

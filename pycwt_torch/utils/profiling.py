"""Tracing / profiling / observability hooks.

Counterpart of ``pycwt_tpu/utils/profiling.py``, with the same names: a
``torch.profiler`` trace context written as a Chrome trace, phase timers
with achieved-throughput accounting (sample-scales/s), timed by CUDA events
on the card, and logging of a tensor's layout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

import torch

logger = logging.getLogger("pycwt_torch")

__all__ = ["trace", "PhaseTimer", "log_sharding", "logger"]


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace (no-op when log_dir is
    None).

    Records CPU activity and, where a card is present, its kernels (the
    CUDA kernels ``cwt_stage_a``/``cwt_stage_b``/``cwt_direct`` and cuFFT
    among them), also when the region holds the process's first CUDA call,
    and writes one Chrome trace,
    ``pycwt_torch.<pid>.<ns>.pt.trace.json``, under ``log_dir`` when the
    region ends.  Open it in Perfetto or ``chrome://tracing``.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"pycwt_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates per-phase time and derived throughput counters.

    With a card present each phase is timed by a pair of CUDA events
    recorded on the current stream, with no synchronization inside the
    phase; :meth:`report` synchronizes once and reads them.  Without one a
    phase is timed by ``time.perf_counter``."""

    phases: dict = dataclasses.field(default_factory=dict)
    _events: list = dataclasses.field(default_factory=list, repr=False)

    @contextlib.contextmanager
    def phase(self, name: str, samples: int = 0, scales: int = 0):
        acc = self.phases.setdefault(name, {"seconds": 0.0, "sample_scales": 0})
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events.append((acc, start, end))
                acc["sample_scales"] += samples * scales
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            acc["seconds"] += time.perf_counter() - t0
            acc["sample_scales"] += samples * scales

    def report(self) -> dict:
        if self._events:
            torch.cuda.synchronize()
            for acc, start, end in self._events:
                acc["seconds"] += start.elapsed_time(end) * 1e-3
            self._events.clear()
        out = {}
        for name, acc in self.phases.items():
            entry = {"seconds": acc["seconds"]}
            if acc["sample_scales"] and acc["seconds"] > 0:
                entry["sample_scales_per_s"] = acc["sample_scales"] / acc["seconds"]
            out[name] = entry
        return out

    def log(self):
        for name, entry in self.report().items():
            logger.info("phase %-20s %8.3f s%s", name, entry["seconds"],
                        f"  ({entry['sample_scales_per_s']:.3e} sample-scales/s)"
                        if "sample_scales_per_s" in entry else "")


def log_sharding(name: str, x):
    """Log a tensor's shape, dtype and device.  A torch tensor carries no
    sharding of its own; anything without a shape logs as such."""
    if isinstance(x, torch.Tensor):
        logger.info("%s: shape=%s dtype=%s device=%s", name, tuple(x.shape),
                    x.dtype, x.device)
    else:
        logger.info("%s: shape=%s (no tensor layout)", name,
                    getattr(x, "shape", None))

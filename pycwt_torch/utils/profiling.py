"""Tracing / profiling / observability hooks.

Counterpart of ``pycwt_tpu/utils/profiling.py``, with the same names: a
``torch.profiler`` trace context written as a Chrome trace, phase timers
with achieved-throughput accounting (sample-scales/s), timed by CUDA events
on the card, and logging of a tensor's layout.

Beside them, the span recorder: named host-time spans at the program's
layer boundaries (:class:`span`), off by default and switched by
:func:`enable_spans` / :func:`disable_spans`; :func:`span_summary` gives
each name's count, total and self nanoseconds.

* ``wct``: ``coherence.wct``, the whole call (API);
* ``grid``: ``transform._host_grid``, every surface's one host grid: the
  scales and, for a mother whose NaN-row check reads them (Paul),
  ``2π·fftfreq(nfft)`` and the NaN-row drop (API);
* ``coi``: the grid's COI, built on its first read (``_HostGrid.coi``):
  in ``api.cwt`` and ``api._cwt_planar_parts`` once the kernels are
  queued and before the ``fetch``, elsewhere where the surface returns it
  (API);
* ``upload``: the host→device copies of the caller's data and grids, one
  block a site group: ``api.cwt``, ``api._cwt_planar_parts``,
  ``coherence.wct``, ``wct_matrix``, ``wct_significance`` (with the key)
  and ``wct_significance_batch`` (the grid and key, then each block's
  coefficients), and ``ops.overlap``'s single-device surfaces and
  ``sharded_wct_overlap_planar`` (the signals and scales); a copy from
  pageable memory waits for the device's queue (API, host upload);
* ``ar1``: the AR(1) fits on the host, ``stats.ar1`` twice in
  ``coherence.wct`` and ``stats.ar1_batch`` in
  ``analysis.wct_matrix_analysis`` (API);
* ``fetch``: ``api._host`` and the Monte-Carlo counts' copy in
  ``coherence.wct_significance`` and ``wct_significance_batch``, the wait
  for the device's queue and the copy (API, host fetch);
* ``wct.core``: ``coherence._wct_core``, both routes (WCT core);
* ``spectrum``: ``ops.fft._spectrum_f64`` (forward DFT);
* ``fused_cwt``: ``ops.fused_cwt.fused_cwt_planar`` (kernel wrappers);
* ``smooth``: ``ops.smoothing.smooth`` (smoothing);
* ``mc``: ``coherence.wct_significance``; ``mc.batch``:
  ``coherence.wct_significance_batch``, and ``mc.readout``: its readout of
  each distinct null and the fan-out to the pairs; ``mc.setup``: in
  either, the work from the cache's miss to the first chunk (the
  surrogate grid, the chunk sizing, the batch path's deduplication and
  padding, the checkpoint's read, ``upload``); ``mc.chunks``: the host's
  enqueue of the chunks, up to the counts' ``fetch``; ``mc.quantile``:
  ``coherence.mc_significance_from_histogram``, one null's readout into
  a curve; ``mc.generate``: ``stats.rednoise_members`` and
  ``rednoise_members_pairs``; ``mc.histogram``: ``coherence._histogram``
  and the launch of the counts kernel in ``coherence._mc_counts`` (MC
  significance);
* ``cwt_batch``: ``transform.cwt_batch`` (API, long records);
* ``cwt_power``: ``api.cwt_power``, the whole call (API);
* ``wct_matrix``: ``coherence.wct_matrix``, the whole call (API);
  ``wct_matrix.fields``: the signals' shared transforms and
  self-smoothings in ``coherence._wct_matrix_blocks``, and
  ``wct_matrix.pairs``: its loop over the blocks of pairs (WCT pairs);
* ``wct_matrix_analysis``: ``analysis.wct_matrix_analysis``, the whole
  call (API);
* ``wct_overlap``: ``ops.overlap.wct_overlap_planar``, the whole call, and
  ``cwt_overlap_save``, ``cwt_overlap_save_planar``,
  ``streamed_global_power``, ``streamed_global_power_planar``,
  ``xwt_overlap_planar``: the other single-device overlap-save surfaces,
  each its whole call (API, long records); ``overlap.chunks``: the chunk
  loop of each, so its own time is the host's enqueue of the chunks'
  work (overlap-save).

No span synchronizes the device: a span's time is the host's, and a
``fetch`` holds the wait for the device's queue.

Beside the recorder, :data:`HOST_GRIDS` counts the grids that
``transform._host_grid`` built and :data:`GRID_FTFREQ_ARRAYS` the (nfft,)
angular-frequency arrays built for them, :data:`HOST_BYTES` the bytes
that ``api._host`` has copied to the host, :data:`HOST_PINNED_FETCHES` those
of its fetches that went through page-locked memory, :data:`UPLOAD_BYTES`
the bytes that the ``upload`` sites have copied to the device, and
:data:`MATRIX_PAIRS` and :data:`MATRIX_PAIR_BLOCKS` the pairs whose maps
``coherence._wct_matrix_blocks`` computed and the blocks it ran them in,
:data:`MC_KERNEL_ROWS` and :data:`MC_PLAIN_ROWS` the Monte-Carlo
surrogate rows drawn on the card by the generator kernel
(``ops/mc_noise.py``) and by the torch path, :data:`MC_NULLS`,
:data:`MC_NULL_MEMBERS` and :data:`MC_NULL_CHUNKS` the distinct nulls that
``coherence.wct_significance_batch`` simulated, the member pairs it drew
for them and the chunks it ran, and :data:`MC_HIST_KERNEL_CELLS` and
:data:`MC_HIST_PLAIN_CELLS` the points of the Monte-Carlo chunks' fields
binned by the counts kernel (``ops/mc_hist.py``) and by the torch path,
:data:`WCT_HEAD_KERNEL_POINTS` and :data:`WCT_HEAD_PLAIN_POINTS` the
points of the coherence fields made by the head kernel
(``ops/wct_head.py``) and by the torch head, and :data:`OVERLAP_CHUNKS`,
:data:`OVERLAP_POINTS` and :data:`OVERLAP_INTERIOR_POINTS` the chunks that ``ops.overlap``'s
single-device surfaces ran, the points they transformed and those they
kept, and :data:`T_BF16_POINTS` and :data:`T_F32_POINTS` the points of
the intermediate T that ``ops.fused_cwt.stage_a`` wrote in bf16 (the
``fast`` tier) and in f32, whether the recorder is on or off;
:func:`enable_spans` sets all twenty-one back to 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time

import torch
from torch.autograd.profiler import record_function

logger = logging.getLogger("pycwt_torch")

__all__ = ["trace", "PhaseTimer", "log_sharding", "logger", "span",
           "enable_spans", "disable_spans", "span_summary"]

# --------------------------------------------------------------------------
# The span recorder
# --------------------------------------------------------------------------

#: the recorder's switch; a span that finds it off does nothing else
_on = False
#: open spans, innermost last: [name, record_function or None, child ns,
#: start ns]
_stack: list = []
#: name -> [count, total ns, self ns] of the spans closed outside a profiler
_totals: dict = {}
#: name -> count of the spans taken while a profiler was active
_profiled: dict = {}
_profiler_enabled = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns
#: grids ``transform._host_grid`` built, and the (nfft,) arrays
#: 2π·fftfreq(nfft, dt) built for them (``_HostGrid.ftfreqs``), counted
#: whether the recorder is on or off
HOST_GRIDS = 0
GRID_FTFREQ_ARRAYS = 0
#: bytes ``api._host`` has copied to the host since :func:`enable_spans`
#: last switched the recorder on (since import before that)
HOST_BYTES = 0
#: bytes the ``upload`` sites have copied from host arrays to the device
#: (as the device holds them, after any conversion of dtype), counted
#: alike, on every device
UPLOAD_BYTES = 0
#: ``api._host``'s fetches through page-locked memory, counted alike
HOST_PINNED_FETCHES = 0
#: pairs whose coherence maps ``coherence._wct_matrix_blocks`` computed,
#: and the blocks of pairs it ran, counted alike
MATRIX_PAIRS = 0
MATRIX_PAIR_BLOCKS = 0
#: Monte-Carlo surrogate rows drawn on the card by ``mc_rednoise``, and by
#: the torch path of ``stats.rednoise_members*``, counted alike
MC_KERNEL_ROWS = 0
MC_PLAIN_ROWS = 0
#: distinct nulls ``coherence.wct_significance_batch`` simulated, the member
#: pairs it drew for them (the last chunk's overdraw and a block's padding
#: included) and the chunks it ran, counted alike; each counts the whole
#: call, so under a mesh every rank adds the mesh's totals
MC_NULLS = 0
MC_NULL_MEMBERS = 0
MC_NULL_CHUNKS = 0
#: points (member × scale × time, members past ``mc_count`` left out) of
#: the Monte-Carlo chunks' fields binned by ``mc_coherence_counts``, and by
#: the torch path of ``coherence._mc_counts`` (on the CPU too), counted
#: alike
MC_HIST_KERNEL_CELLS = 0
MC_HIST_PLAIN_CELLS = 0
#: points (row × scale × time) of the coherence fields that
#: ``coherence._planar_fields`` made by ``wct_fields_head``, and by the
#: torch head (the CPU, f64, autograd), counted alike
WCT_HEAD_KERNEL_POINTS = 0
WCT_HEAD_PLAIN_POINTS = 0
#: chunks that ``ops.overlap``'s single-device surfaces ran, S × nfft_c
#: points transformed for each chunk and signal, and S × the interior
#: samples kept for each (the last chunk's zero tail left out), counted
#: alike
OVERLAP_CHUNKS = 0
OVERLAP_POINTS = 0
OVERLAP_INTERIOR_POINTS = 0
#: points (row × R1 × R2 a launch, B × S rows) of the intermediate T that
#: ``ops.fused_cwt.stage_a`` wrote in bf16 (``cwt_stage_a_bf16``, the
#: ``fast`` tier) and in f32 (``cwt_stage_a``; on the CPU the plain
#: version's T in the inputs' dtype), counted alike
T_BF16_POINTS = 0
T_F32_POINTS = 0


def enable_spans() -> None:
    """Switch the span recorder on and clear its aggregates and the
    counters; a call while it is on does nothing."""
    global _on, HOST_BYTES, UPLOAD_BYTES, HOST_PINNED_FETCHES, MATRIX_PAIRS
    global MATRIX_PAIR_BLOCKS
    global MC_KERNEL_ROWS, MC_PLAIN_ROWS, MC_NULLS, MC_NULL_MEMBERS, MC_NULL_CHUNKS
    global MC_HIST_KERNEL_CELLS, MC_HIST_PLAIN_CELLS, HOST_GRIDS, GRID_FTFREQ_ARRAYS
    global OVERLAP_CHUNKS, OVERLAP_POINTS, OVERLAP_INTERIOR_POINTS
    global WCT_HEAD_KERNEL_POINTS, WCT_HEAD_PLAIN_POINTS, T_BF16_POINTS, T_F32_POINTS
    if _on:
        return
    HOST_GRIDS = GRID_FTFREQ_ARRAYS = 0
    HOST_BYTES = UPLOAD_BYTES = HOST_PINNED_FETCHES = 0
    MATRIX_PAIRS = MATRIX_PAIR_BLOCKS = 0
    MC_KERNEL_ROWS = MC_PLAIN_ROWS = 0
    MC_NULLS = MC_NULL_MEMBERS = MC_NULL_CHUNKS = 0
    MC_HIST_KERNEL_CELLS = MC_HIST_PLAIN_CELLS = 0
    WCT_HEAD_KERNEL_POINTS = WCT_HEAD_PLAIN_POINTS = 0
    OVERLAP_CHUNKS = OVERLAP_POINTS = OVERLAP_INTERIOR_POINTS = 0
    T_BF16_POINTS = T_F32_POINTS = 0
    _stack.clear()
    _totals.clear()
    _profiled.clear()
    _on = True


def disable_spans() -> None:
    """Switch the span recorder off; its aggregates stay readable."""
    global _on
    _on = False


def span_summary() -> dict:
    """``{name: {"count", "total_ns", "self_ns", "profiled"}}`` since
    :func:`enable_spans`: the spans closed outside a profiler, their
    summed duration and that less their child spans' (the host time of the
    span's own code), and the count taken while a ``torch.profiler``
    session was active, which the times leave out."""
    out = {}
    for name in _totals.keys() | _profiled.keys():
        count, total, own = _totals.get(name, (0, 0, 0))
        out[name] = {"count": count, "total_ns": total, "self_ns": own,
                     "profiled": _profiled.get(name, 0)}
    return out


def _open(name: str) -> None:
    rf = None
    if _profiler_enabled():
        rf = record_function(name)
        rf.__enter__()
    _stack.append([name, rf, 0, _now()])


def _close() -> None:
    t1 = _now()
    if not _stack:          # opened before the recorder was switched on
        return
    name, rf, child, t0 = _stack.pop()
    dur = t1 - t0
    if rf is not None:
        rf.__exit__(None, None, None)
        _profiled[name] = _profiled.get(name, 0) + 1
    else:
        agg = _totals.get(name)
        if agg is None:
            agg = _totals[name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - child
    if _stack:
        _stack[-1][2] += dur


class span:
    """A named span of host time, as a context manager or a decorator.

    With the recorder off it tests one module-level bool and does nothing
    else.  On, it times itself with ``time.perf_counter_ns`` into per-name
    aggregates (so memory stays constant), and a parent's self time is its
    duration less its children's.  While a ``torch.profiler`` session is
    active it also opens ``record_function(name)``, which puts it on the
    profiler's CPU timeline beside the device's events, and its times are
    left out of the aggregates, which the profiler would inflate.  A span
    that raises still closes.  The recorder keeps one stack, for the thread
    that calls the program.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _on:
            _open(self.name)
        return self

    def __exit__(self, *exc):
        if _on:
            _close()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close()

        return spanned


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace (no-op when log_dir is
    None).

    Records CPU activity and, where a card is present, its kernels (the
    CUDA kernels ``cwt_stage_a``/``cwt_stage_b``/``cwt_direct`` and cuFFT
    among them), also when the region holds the process's first CUDA call,
    and writes one Chrome trace,
    ``pycwt_torch.<pid>.<ns>.pt.trace.json``, under ``log_dir`` when the
    region ends.  Open it in Perfetto or ``chrome://tracing``.  The spans
    are on inside the region, so the program's layers (:class:`span`)
    appear by name above the operations they ran; the recorder is switched
    back as it was after it.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    global _on
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    was_on, _on = _on, True
    try:
        with profile(activities=activities) as prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        _on = was_on
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

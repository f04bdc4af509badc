"""The traced run: ``torch.profiler`` over a short steady slice of the
window, kept in memory, and its reduction to what the per-layer metrics and
the breakdown read.

The slice starts ``min(2 s, window/5)`` into the window, at a call
boundary after a device synchronize, and ends at the first call boundary
``min(2 s, window/5)`` after the profiler has started, again after a
synchronize: early in the
process, because CUPTI has lost kernel records late in long processes on
the H100.  Its device timeline is every event that the profiler records on
the card (kernels, copies, sets); busy time is the length of their union,
and the slice's length is the host clock between the two synchronizes.
"""
from __future__ import annotations

import time

import numpy as np

#: idle gaps that are attributed to the host activity under them
GAPS_ATTRIBUTED = 300


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces of its own and its
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:96]


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler(call, sync) -> None:
    """Profile one call during set-up: the first profile of a process
    starts CUPTI, which takes seconds that would otherwise fall inside the
    window."""
    with profiler():
        call()
        sync()


def union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted (start, end) rows covering ``intervals``."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


class Slice:
    """Starts and stops the profiler inside :func:`harness.measure`."""

    def __init__(self, seconds: float, sync):
        self.start_at = min(2.0, seconds / 5)
        self.length = min(2.0, seconds / 5)
        self.sync = sync
        self.prof = None
        self.first = self.last = None
        self.window_s = 0.0

    def step(self, i: int, elapsed: float):
        if self.first is None and elapsed >= self.start_at:
            self.sync()
            self.prof = profiler()
            self.prof.start()
            self.first = i
            self._t0 = time.perf_counter()
        elif (self.last is None and self.first is not None
              and time.perf_counter() - self._t0 >= self.length):
            self.close(i)

    def close(self, i: int):
        if self.prof is None or self.last is not None:
            return
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.last = i

    def view(self, entry, spans: dict) -> "View":
        return View(self, entry, spans)


class View:
    """What the per-layer metrics read from one traced run."""

    def __init__(self, sl: Slice, entry, spans: dict):
        from torch.autograd import DeviceType

        self.entry = entry
        self.spans = spans
        self.first, self.last = sl.first, sl.last
        self.calls = 0 if sl.first is None else sl.last - sl.first
        self.window_s = sl.window_s
        dev, cpu = [], []
        for e in (sl.prof.events() if sl.prof is not None else []):
            row = (e.time_range.start, e.time_range.end, e.name)
            if getattr(e, "is_user_annotation", False) or e.name in spans:
                # a host span's projection onto the device timeline
                if e.device_type == DeviceType.CPU:
                    cpu.append(row)
            elif e.device_type == DeviceType.CUDA:
                dev.append(row)
            elif e.device_type == DeviceType.CPU:
                cpu.append(row)
        self.device_ops = dev
        self.cpu_ops = cpu
        iv = np.asarray([(s, e) for s, e, _ in dev], dtype=np.float64).reshape(-1, 2)
        self.busy = union(iv)
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) * 1e-6

    def device_s(self, match=None) -> float:
        """Device seconds of every op in the slice (or those whose name
        contains ``match``)."""
        return sum(e - s for s, e, n in self.device_ops
                   if match is None or match in n) * 1e-6

    def per_call_s(self, match=None):
        """Device seconds a call, or None when the slice holds no call."""
        if self.calls == 0 or not self.device_ops:
            return None
        return self.device_s(match) / self.calls

    def idle_pct(self):
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def span_ms(self, label: str):
        """Mean ms of the span ``label`` over the calls outside the profiled
        slice (all calls when every call was inside)."""
        rows = self.spans.get(label, [])
        outside = [s for c, s in rows
                   if self.first is None or not self.first <= c < self.last]
        use = outside or [s for _, s in rows]
        return 1e3 * float(np.mean(use)) if use else None

    def breakdown(self) -> dict:
        ops = {}
        for s, e, n in self.device_ops:
            k = short_name(n)
            ops[k] = ops.get(k, 0.0) + (e - s) * 1e-6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in device_ops],
                "idle_gaps": self._idle_gaps()}

    def _idle_gaps(self) -> list:
        b = self.busy
        if len(b) < 2 or not self.cpu_ops:
            return []
        gaps = np.stack([b[:-1, 1], b[1:, 0]], axis=1)
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAPS_ATTRIBUTED]
        starts = np.asarray([r[0] for r in self.cpu_ops], np.float64)
        ends = np.asarray([r[1] for r in self.cpu_ops], np.float64)
        durs = ends - starts
        names = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            cover = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (self.cpu_ops[cover[np.argmin(durs[cover])]][2]
                    if len(cover) else "host: between recorded ops")
            names[name] = names.get(name, 0.0) + (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:10]]

    def kernel_bound_pct(self) -> dict:
        """Each kernel's share of the bound the entry gives it, where it
        gives one (``Entry.kernel_bounds()``: name fragment -> seconds)."""
        bounds = getattr(self.entry, "kernel_bounds", lambda: {})()
        out = {}
        for frag, bound_s in bounds.items():
            t = self.per_call_s(frag)
            if t:
                out[frag] = 100.0 * bound_s / t
        return out

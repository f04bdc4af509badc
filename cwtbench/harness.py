"""The benchmark's engine: find a cell's files by name, make its inputs,
warm up, measure a closed loop of calls for a fixed time, read the traced
slice, check the outputs against the plain reference, and assemble the
result line.

Everything that belongs to one cell, configuration, traffic mix, entry
point or metric lives in a file of its own under this folder, found by the
name that ``BENCHMARK.json`` or the cell gives:

* ``cells/<cell>.json``      its configuration, traffic, precision tier,
                             limits and control;
* ``configs/<config>.json``  the analysis settings (``BENCHMARK.json`` names
                             the file);
* ``traffic/<mix>.json``     the entry point it drives and the parameters of
                             its inputs;
* ``inputs/<kind>.py``       ``make(params, seed, device)``, the generator
                             of one kind of input;
* ``entries/<entry>.py``     ``Entry``: the calls into the program, what a
                             call's work is, and the comparison of what the
                             calls returned with the reference;
* ``e2e/<metric>.py``        ``value(window)``, an end-to-end metric;
* ``metrics/<metric>.py``    ``read(trace)``, a per-layer metric (None when
                             there is nothing to read).

So a later cell, configuration, traffic mix or metric is new files only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pycwt_tpu")


class BenchError(RuntimeError):
    """A cell, configuration or file that the harness cannot use."""


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as err:
        raise BenchError(f"cannot read {path}: {err}") from err


def load_module(kind: str, name: str, here: str = HERE):
    """The module ``<here>/<kind>/<name>.py``, loaded by its path."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"cwtbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Cell:
    """One cell as its files give it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict            # cells/<name>.json
    end_to_end: list      # BENCHMARK.json metrics this cell reports
    per_layer: list
    here: str = HERE

    @property
    def precision(self) -> str:
        return self.spec["precision"]


def load_cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"BENCHMARK.json has no workload {name!r}")
    spec = load_json(os.path.join(here, "cells", f"{name}.json"))
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise BenchError(f"BENCHMARK.json has no config {entry['config']!r}")
    if spec.get("config") != entry["config"] or spec.get("traffic") != entry["traffic"]:
        raise BenchError(f"cells/{name}.json disagrees with BENCHMARK.json "
                         "on its config or traffic")
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(os.path.join(root, conf["file"])),
                traffic=load_json(os.path.join(here, "traffic",
                                               f"{entry['traffic']}.json")),
                spec=spec,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name), here=here)


def make_entry(cell: Cell, seed: int, device: str, precision: str | None = None,
               entry_mod=None):
    """The cell's inputs from ``seed`` and its entry point, set up."""
    params = cell.traffic["inputs"]
    inputs = load_module("inputs", params["kind"], cell.here).make(params, seed, device)
    entry_mod = entry_mod or load_module("entries", cell.traffic["entry"], cell.here)
    return entry_mod.Entry(cell, inputs, seed=seed, device=device,
                           precision=precision or cell.precision)


# --------------------------------------------------------------------------
# The measured window
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What the e2e metrics read: the closed loop of calls."""

    setup_s: float
    seconds: float = 0.0           # window start to the final synchronize
    calls: int = 0
    failed: int = 0
    times: list = dataclasses.field(default_factory=list)   # host s a call
    units: float = 0.0             # work done (the entry's units)


def device_sync(device: str):
    """A function that waits for the device's queued work (none on the CPU)."""
    if device.startswith("cuda"):
        import torch

        return torch.cuda.synchronize
    return lambda: None


class Spans:
    """Host-clock spans around module attributes, each closed by a device
    synchronize: ``spans[label]`` is a list of (call index, seconds)."""

    def __init__(self, targets, sync):
        self.targets = list(targets)
        self.sync = sync
        self.spans = {label: [] for label, _, _ in self.targets}
        self.call = -1
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for label, module_name, attr in self.targets:
            module = importlib.import_module(module_name)
            inner = getattr(module, attr)

            def wrapped(*a, _inner=inner, _label=label, **kw):
                t0 = time.perf_counter()
                with record_function(_label):
                    out = _inner(*a, **kw)
                    self.sync()
                self.spans[_label].append((self.call, time.perf_counter() - t0))
                return out

            self._saved.append((module, attr, inner))
            setattr(module, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for module, attr, inner in reversed(self._saved):
            setattr(module, attr, inner)
        self._saved.clear()


def measure(entry, seconds: float, sync, window: Window, trace=None, spans=None):
    """Calls back to back for ``seconds``; the window closes at the final
    synchronize.  ``trace`` (a ``trace.Slice``) profiles a short slice of
    it.  A call that raises ends the window and counts as failed."""
    sync()
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        if ts - t0 >= seconds:
            break
        if trace is not None:
            trace.step(i, ts - t0)
        if spans is not None:
            spans.call = i
        try:
            out = entry.call(i)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            window.failed += 1
            i += 1
            break
        window.times.append(time.perf_counter() - ts)
        entry.keep(i, out)
        window.units += entry.units(i)
        i += 1
    if trace is not None:
        trace.close(i)
    sync()
    window.seconds = time.perf_counter() - t0
    window.calls = i


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", root: str = ROOT, here: str = HERE) -> tuple[dict, dict]:
    """One run of a cell: returns ``(result, checks)``, where ``checks`` maps
    each compared number to (value, limit)."""
    import torch

    import pycwt_torch  # noqa: F401  (the import is set-up)
    from cwtbench import trace as trace_mod

    split = {"import_s": time.perf_counter() - t_start}
    cell = load_cell(name, root, here)
    cuda = device.startswith("cuda")
    sync = device_sync(device)

    t = time.perf_counter()
    entry_mod = load_module("entries", cell.traffic["entry"], here)
    if cuda:
        from pycwt_torch.ops import _build

        for lib in getattr(entry_mod, "LIBRARIES", ("fused_cwt",)):
            _build.library(lib)
    split["library_s"] = time.perf_counter() - t

    t = time.perf_counter()
    entry = make_entry(cell, seed, device, entry_mod=entry_mod)
    sync()
    split["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    entry.warm()
    sync()
    if trace and cuda:
        trace_mod.warm_profiler(lambda: entry.call(0), sync)
    split["warmup_s"] = time.perf_counter() - t

    window = Window(setup_s=time.perf_counter() - t_start)
    if trace:
        tr = trace_mod.Slice(seconds, sync)
        targets = [tuple(s) for m in cell.per_layer
                   for s in getattr(load_module("metrics", m["name"], here),
                                    "SPANS", ())]
        with Spans(targets, sync) as sp:
            measure(entry, seconds, sync, window, tr, sp)
    else:
        measure(entry, seconds, sync, window)

    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}

    metrics, extra = {}, {}
    if trace:
        view = tr.view(entry, sp.spans)
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], here).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        extra["breakdown"] = view.breakdown()
        bounds = view.kernel_bound_pct()
        if bounds:
            extra["kernel_bound_pct"] = bounds
    else:
        for m in cell.end_to_end:
            v = load_module("e2e", m["name"], here).value(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = entry.compare()
    checks = {k: (float(numbers.get(k, np.inf)), float(lim))
              for k, lim in cell.spec["limits"].items()}
    correct = (window.failed == 0 and window.calls > 0
               and all(np.isfinite(v) and v <= lim for v, lim in checks.values()))
    if window.times:
        q = np.percentile(window.times, [50, 95, 100]) * 1e3
        extra["call_ms"] = {"p50": q[0], "p95": q[1], "max": q[2]}
    result = {"correct": bool(correct), "attempted": window.calls,
              "failed": window.failed, "metrics": metrics, "device": dev,
              **extra, "setup_split": split}
    return result, checks

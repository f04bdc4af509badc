"""Host ms a ``wct`` call spends in the span ``upload``: the copy of the
pair's normalised rows and scales to the device (``coherence.wct``) and,
under ``sig=True``, that of the Monte-Carlo grid, its COI mask and the key
(``coherence.wct_significance``). A copy from pageable memory waits for
the device's queue first, so this holds that wait too.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span. Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans ``wct`` and
``upload`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct", {}).get("count", 0)
    ns = summary.get("upload", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

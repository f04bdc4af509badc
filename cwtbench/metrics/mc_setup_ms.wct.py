"""Host ms a ``wct`` call spends in the span ``mc.setup``
(``coherence.wct_significance``): from the cache's miss to the first
chunk, so the surrogate grid, the chunk sizing, the upload of the grid,
its COI mask and the key, and the checkpoint's read where there is one.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span. Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans ``wct`` and
``mc.setup`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct", {}).get("count", 0)
    ns = summary.get("mc.setup", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

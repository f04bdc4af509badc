"""Host ms a ``wct_matrix`` call spends in the span ``fetch``
(``api._host``, once for each map): the wait for the device's queue to
drain, which the first fetch holds, then the two copies of a (P, S, n0)
float32 map into page-locked host blocks.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the span ``wct_matrix``
reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_matrix", {}).get("count", 0)
    ns = summary.get("fetch", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

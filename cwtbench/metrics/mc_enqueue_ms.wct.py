"""Host ms a ``wct`` call spends in the span ``mc.chunks``
(``coherence.wct_significance``): the host's enqueue of every Monte-Carlo
chunk (``mc.generate``, the surrogates' ``wct.core`` and ``mc.histogram``
inside it), up to the counts' ``fetch``, which it leaves out.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span. Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans ``wct`` and
``mc.chunks`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct", {}).get("count", 0)
    ns = summary.get("mc.chunks", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

"""Host ms a ``wct_overlap_planar`` call spends in the span
``overlap.chunks`` (``ops.overlap``): the loop over the chunks, whose own
time is the host's enqueue of their work (the chunk CWTs' ``spectrum``
and ``fused_cwt``, the ``smooth`` calls, the ratio, ``atan2`` and the
interior's copies inside it).  Set beside the call's time, it says how far
the host is from setting the pace; an enqueue that runs far ahead of
the card can fill its launch queue and then waits for it inside the span.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans ``wct_overlap``
and ``overlap.chunks`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_overlap", {}).get("count", 0)
    ns = summary.get("overlap.chunks", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

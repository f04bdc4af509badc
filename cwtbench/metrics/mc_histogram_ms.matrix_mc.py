"""Host ms a ``wct_matrix_analysis`` call spends in the span
``mc.histogram`` (``coherence._histogram``, once a chunk): enqueueing the
binning and the ``scatter_add_`` of each chunk's Monte-Carlo coherence
counts into the distinct nulls' (nulls, S, 1000) counts.  The span does not
wait for the card, so it is the host's side of the histogram; it grows
where the launch queue is full and a launch waits for room.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the span
``wct_matrix_analysis`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_matrix_analysis", {}).get("count", 0)
    ns = summary.get("mc.histogram", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

"""Host ms a ``wct_matrix_analysis`` call spends in the span ``mc.batch``
(``coherence.wct_significance_batch``): the deduplication of the pairs'
nulls, the chunks' enqueue, the fetch of the counts, which waits for the
card's queue to drain, and the readout.  Since it ends in that wait, it
holds the card's Monte-Carlo time.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans
``wct_matrix_analysis`` and ``mc.batch`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_matrix_analysis", {}).get("count", 0)
    ns = summary.get("mc.batch", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

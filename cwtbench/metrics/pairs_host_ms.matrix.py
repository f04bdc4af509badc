"""Host ms a ``wct_matrix`` call spends in the span ``wct_matrix.pairs``
(``coherence._wct_matrix_blocks``' loop over the blocks of pairs):
enqueueing each block's gathers, cross spectrum, cross smoothing, ratio
and phase, and their copies into the maps.  Nothing in it waits for the
card, so it is the host's side of the loop.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_matrix", {}).get("count", 0)
    ns = summary.get("wct_matrix.pairs", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

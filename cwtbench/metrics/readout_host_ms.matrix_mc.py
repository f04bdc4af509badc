"""Host ms a ``wct_matrix_analysis`` call spends in the span ``mc.readout``
(``coherence.wct_significance_batch``): the empirical-CDF readout of each
distinct null's counts and the fan-out of the curves to the pairs, on the
host after the fetch.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the spans
``wct_matrix_analysis`` and ``mc.readout`` reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    calls = summary.get("wct_matrix_analysis", {}).get("count", 0)
    ns = summary.get("mc.readout", {}).get("total_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

"""Host ms a ``wct_matrix_analysis`` call spends in its own code: the self
time of the span ``wct_matrix_analysis`` (``analysis.wct_matrix_analysis``),
its total less the spans inside it (``wct_matrix``, ``mc.batch``), so the
scale grid's s0 and J, the stations' AR(1) fits, their clipping, the
pairs' coefficients and the assembly of the answer.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the span reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    row = getattr(profiling, "span_summary", dict)().get("wct_matrix_analysis", {})
    calls, ns = row.get("count", 0), row.get("self_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

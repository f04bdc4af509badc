"""Host ms a ``cwt_power`` call spends in its own code: the self time of
the span ``cwt_power`` (``api.cwt_power``), its total less the spans
inside it (``spectrum``, ``fused_cwt``, ``fetch``), so the scale grid, the
NaN-row drop, the COI, the record's copy to the card and the Python
between the layers.

Read from the program's span recorder (``pycwt_torch.utils.profiling``),
which loading this module switches on: the harness loads the per-layer
metrics in the traced run only, after the warm-up and before the window,
so the untraced runs never time a span.  Calls inside the profiled slice
are left out (the recorder keeps them apart, since the profiler slows the
host), and a program without the recorder or the span reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    row = getattr(profiling, "span_summary", dict)().get("cwt_power", {})
    calls, ns = row.get("count", 0), row.get("self_ns", 0)
    return ns * 1e-6 / calls if calls and ns else None

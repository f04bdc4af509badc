"""Distinct Monte-Carlo nulls a ``wct_matrix_analysis`` call simulates: the
program's counter ``profiling.MC_NULLS`` over the calls of the window,
which the span ``wct_matrix_analysis`` counts (those inside the profiled
slice too, as the counter does).  Each null is ``mc_count`` member pairs
through the whole coherence pipeline, so the count sets the call's
Monte-Carlo work; the reference's own deduplication of each network's
pairs is the entry's ``shape["nulls"]``, which the reading should equal
over the networks called.

Loading this module switches the span recorder on, which sets the counter
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the recorder, the span or the counter
reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    row = getattr(profiling, "span_summary", dict)().get("wct_matrix_analysis", {})
    calls = row.get("count", 0) + row.get("profiled", 0)
    nulls = getattr(profiling, "MC_NULLS", 0)
    return nulls / calls if calls and nulls else None

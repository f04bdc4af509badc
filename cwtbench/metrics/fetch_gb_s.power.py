"""GB/s of a ``cwt_power`` call's host fetch: the bytes that the
program's counter ``profiling.HOST_BYTES`` says ``api._host`` copied to
the host a call, over the seconds of the span ``fetch`` a call (the
queue's drain, the slice's copy on the card and the copy to the host, so
below the link's own rate).

The counter counts every call of the window, those inside the profiled
slice too, and the span's times leave those out, so each is taken a call
over its own calls.  Loading this module switches the span recorder on,
which sets the counter to 0 (the harness loads the per-layer metrics after
the warm-up and before the window).  A program without the recorder, the
span ``cwt_power`` or the counter reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    power = summary.get("cwt_power", {})
    calls = power.get("count", 0) + power.get("profiled", 0)
    fetch_ns = summary.get("fetch", {}).get("total_ns", 0)
    nbytes = getattr(profiling, "HOST_BYTES", 0)
    if not (calls and power.get("count") and fetch_ns and nbytes):
        return None
    return (nbytes / calls) / (fetch_ns * 1e-9 / power["count"]) * 1e-9

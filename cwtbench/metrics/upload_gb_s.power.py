"""GB/s of a ``cwt_power`` call's upload: the bytes that the program's
counter ``profiling.UPLOAD_BYTES`` says the ``upload`` sites copied to the
device a call (the float64 record and the float32 scales), over the
seconds of the span ``upload`` a call (the wait for the device's queue, the
staging of the pageable record and the copy, so below the link's own rate).

The counter counts every call of the window, those inside the profiled
slice too, and the span's times leave those out, so each is taken a call
over its own calls.  Loading this module switches the span recorder on,
which sets the counter to 0 (the harness loads the per-layer metrics after
the warm-up and before the window).  A program without the recorder, the
spans ``cwt_power`` and ``upload`` or the counter reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    summary = getattr(profiling, "span_summary", dict)()
    power = summary.get("cwt_power", {})
    calls = power.get("count", 0) + power.get("profiled", 0)
    upload_ns = summary.get("upload", {}).get("total_ns", 0)
    nbytes = getattr(profiling, "UPLOAD_BYTES", 0)
    if not (calls and power.get("count") and upload_ns and nbytes):
        return None
    return (nbytes / calls) / (upload_ns * 1e-9 / power["count"]) * 1e-9

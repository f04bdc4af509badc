"""Share of the coherence fields' points that the head kernel made: 100 ×
kernel / (kernel + plain), over the program's counters
``profiling.WCT_HEAD_KERNEL_POINTS`` (points of the fields written by
``wct_fields_head``) and ``profiling.WCT_HEAD_PLAIN_POINTS`` (points made
by the torch head).

Both count every call of the window, those inside the profiled slice too.
Loading this module switches the span recorder on, which sets the counters
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the counters, or a window that made no
field, reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    kernel = getattr(profiling, "WCT_HEAD_KERNEL_POINTS", 0)
    plain = getattr(profiling, "WCT_HEAD_PLAIN_POINTS", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None

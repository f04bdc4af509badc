"""Share of the Monte-Carlo surrogate rows drawn on the card that the
generator kernel drew: 100 × kernel / (kernel + plain), over the program's
counters ``profiling.MC_KERNEL_ROWS`` (rows from ``mc_rednoise``) and
``profiling.MC_PLAIN_ROWS`` (rows the torch path drew on the card).

Both count every call of the window, those inside the profiled slice too.
Loading this module switches the span recorder on, which sets the counters
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the counters, or a window that drew no row
on the card, reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    kernel = getattr(profiling, "MC_KERNEL_ROWS", 0)
    plain = getattr(profiling, "MC_PLAIN_ROWS", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None

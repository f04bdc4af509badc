"""Share of the Monte-Carlo chunks' binned points that the counts kernel
binned: 100 × kernel / (kernel + plain), over the program's counters
``profiling.MC_HIST_KERNEL_CELLS`` (points binned by ``mc_coherence_counts``)
and ``profiling.MC_HIST_PLAIN_CELLS`` (points binned by the torch path).

Both count every call of the window, those inside the profiled slice too.
Loading this module switches the span recorder on, which sets the counters
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the counters, or a window that binned no
point, reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    kernel = getattr(profiling, "MC_HIST_KERNEL_CELLS", 0)
    plain = getattr(profiling, "MC_HIST_PLAIN_CELLS", 0)
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None

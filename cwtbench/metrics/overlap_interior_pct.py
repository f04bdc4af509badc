"""Share of the points that ``wct_overlap_planar``'s chunk transforms
compute which the call keeps: 100 × the program's counter
``profiling.OVERLAP_INTERIOR_POINTS`` over ``OVERLAP_POINTS``, S × the
interior samples kept over S × nfft_c, for each chunk and signal, over
the calls of the window (those inside the profiled slice too, as the
counters count them).  It is chunk / nfft_c, nfft_c = pow2(chunk + 2
halo), less the last chunk's zero tail: 50 at 2^18 samples a chunk for
scales up to 469.5 dt.

Loading this module switches the span recorder on, which sets the
counters to 0 (the harness loads the per-layer metrics after the warm-up
and before the window).  A program without the recorder or the counters
reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    points = getattr(profiling, "OVERLAP_POINTS", 0)
    kept = getattr(profiling, "OVERLAP_INTERIOR_POINTS", 0)
    return 100.0 * kept / points if points and kept else None

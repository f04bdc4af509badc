"""Blocks of pairs a ``wct_matrix`` call runs: the program's counter
``profiling.MATRIX_PAIR_BLOCKS`` over the calls of the window, which the
span ``wct_matrix`` counts (those inside the profiled slice too, as the
counter does).  The program picks the block from its bytes model
(``coherence._pairs_block``), so more than one block a call means smaller
batches of the cross smoothing and more launches.

Loading this module switches the span recorder on, which sets the counter
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the recorder, the span or the counter
reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    row = getattr(profiling, "span_summary", dict)().get("wct_matrix", {})
    calls = row.get("count", 0) + row.get("profiled", 0)
    blocks = getattr(profiling, "MATRIX_PAIR_BLOCKS", 0)
    return blocks / calls if calls and blocks else None

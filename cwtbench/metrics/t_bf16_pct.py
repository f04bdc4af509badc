"""Share of the points of the intermediate T that the call's K1 wrote in
bf16: 100 × ``profiling.T_BF16_POINTS`` / (``T_BF16_POINTS`` +
``T_F32_POINTS``), the program's counters of T's points by element type
(rows × R1 × R2 a launch of ``ops.fused_cwt.stage_a``).  At the ``fast``
tier it reads 100; anything less is a silent fall-back to the f32 T.

Both count every call of the window, those inside the profiled slice too.
Loading this module switches the span recorder on, which sets the counters
to 0 (the harness loads the per-layer metrics after the warm-up and before
the window).  A program without the counters, or a window that made no T,
reads nothing."""
from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()


def read(trace):
    bf16 = getattr(profiling, "T_BF16_POINTS", 0)
    f32 = getattr(profiling, "T_F32_POINTS", 0)
    return 100.0 * bf16 / (bf16 + f32) if bf16 + f32 else None

"""Share of its bound at which K1 runs with a bf16 T (``cwt_stage_a_bf16``):
K1's bound at the call's shape with T at 2 bytes
(``kernel_bounds_t16.k1_k2``: the half spectrum and the scales read once,
T's two bf16 planes written once, or the operations at the f32 peak where
they take longer) over the device time a call of the ops whose names hold
``cwt_stage_a``.  It reads nothing unless the entry runs at ``fast``, or
where the slice holds no such op (the CPU)."""
from cwtbench import kernel_bounds_t16


def read(trace):
    return kernel_bounds_t16.bf16_share(trace, "cwt_stage_a")

"""Share of its bound at which K2 runs with a bf16 T (``cwt_stage_b_bf16``):
K2's bound at the call's shape with T at 2 bytes and the entry's own output
(``kernel_bounds_t16.k1_k2``: T's two bf16 planes read once and S f32 sums
or complex64 W written once, or the operations at the f32 peak where they
take longer) over the device time a call of the ops whose names hold
``cwt_stage_b``, the ``power_sum`` reduce pass included.  It reads nothing
unless the entry runs at ``fast``, or where the slice holds no such op."""
from cwtbench import kernel_bounds_t16


def read(trace):
    return kernel_bounds_t16.bf16_share(trace, "cwt_stage_b")

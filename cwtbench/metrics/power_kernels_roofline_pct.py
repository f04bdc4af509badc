"""Share of their roofline bound at which K1 and K2 run in a
``cwt_power`` call: the two kernels' bound at the call's shape
(``kernel_bounds.k1_k2``, K2 writing |W|^2 with the ``power`` epilogue)
over the device time a call of the operations named ``cwt_stage_``
alone, so the spectrum, the slice's copy on the card and the copy to the
host are left out.  Nothing is read where the entry is not a
``cwt_power`` call or the slice holds no such kernel."""
from cwtbench import kernel_bounds


def read(trace):
    shape = getattr(trace.entry, "shape", None)
    if not shape or shape.get("kernel_output") != "power":
        return None
    t = trace.per_call_s("cwt_stage_")
    if not t:
        return None
    bound = kernel_bounds.k1_k2(shape, shape["n_in"])
    return 100.0 * sum(bound.values()) / t

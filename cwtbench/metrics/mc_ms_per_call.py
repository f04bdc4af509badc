"""Host wall time inside ``pycwt_torch.coherence.wct_significance`` per
call, closed by a device synchronize: the Monte-Carlo layer's share of a
``wct(sig=True)`` call.  The span is put around the module attribute by the
harness in the traced run only; calls inside the profiled slice are left
out, since the profiler slows the host."""

SPANS = [("wct_significance", "pycwt_torch.coherence", "wct_significance")]


def read(trace):
    return trace.span_ms("wct_significance")

"""Share of the profiled slice in which no operation ran on the card, in
the cells that run the forward CWT."""


def read(trace):
    return trace.idle_pct()

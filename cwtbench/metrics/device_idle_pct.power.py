"""Share of the profiled slice in which no operation ran on the card, in
the cell of the public ``cwt_power`` on long host records."""


def read(trace):
    return trace.idle_pct()

"""Share of the profiled slice in which no operation ran on the card, in
the coherence cells."""


def read(trace):
    return trace.idle_pct()

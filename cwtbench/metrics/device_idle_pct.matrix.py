"""Share of the profiled slice in which no operation ran on the card, in
the cell of the all-pairs coherence matrix (``wct_matrix``)."""


def read(trace):
    return trace.idle_pct()

"""Share of the profiled slice in which no operation ran on the card, in
the cell of the blocked coherence of a long pair (``wct_overlap_planar``):
the upload and normalisation at each call's start, and whatever the
chunks' enqueue leaves the card waiting for."""


def read(trace):
    return trace.idle_pct()

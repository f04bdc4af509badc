"""The 95th percentile of the host wall time of every call in the window
(numpy's linear interpolation between order statistics)."""

import numpy as np


def value(window):
    if not window.times:
        return None
    return 1e3 * float(np.percentile(window.times, 95))

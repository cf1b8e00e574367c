"""95th percentile, over every sample placed in the window, of the time
from its batch's scoring call to the return of its own placement (numpy's
linear percentile)."""

import numpy as np


def read(run):
    lat = run.rec.latency_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3

"""The median of every registration's latency in the window: the host
clock from the call into the entry to its transform on the host; a batch's
requests each get the batch's time."""

import numpy as np

UNIT = "ms"


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 50) * 1e3)

"""The 95th percentile of every registration's latency in the window
(numpy's linear interpolation), taken over all of them at once."""

import numpy as np

UNIT = "ms"


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95) * 1e3)

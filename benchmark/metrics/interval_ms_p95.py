"""The 95th percentile of the host-clock time of every call in the window,
from its start to its quantiles on the host, in milliseconds."""

import numpy as np

SPANS = {}


def read(trace, run):
    return 1e3 * float(np.percentile(np.asarray(run.walls, dtype=np.float64), 95))

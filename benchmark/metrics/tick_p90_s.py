"""The 90th percentile of the seconds of every call of the window, each
from its arrival to its delivery on the host (a call that failed too)."""

import numpy as np


def read(run):
    secs = [c["seconds"] for c in run["calls"]]
    return float(np.percentile(secs, 90)) if secs else None

"""The 95th percentile of every request's latency in the window, from its
arrival until its ids and scores are in host memory (numpy's linear
interpolation)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3

"""The 90th percentile, over every target of the window, of the time from
the stream's hand-off of the target to the loop until the loop's completion
of its row (host clock)."""

import numpy as np


def read(run):
    lat = [s for p in run.passes for s in p["latency_s"]]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None

"""The 95th percentile of every image's time in the window, from the call
to ``render`` to the synchronised return, in ms (linear interpolation
between the two nearest ranks)."""

import numpy as np


def read(run):
    if run.get("kind") != "render" or not run["latency_s"]:
        return None
    return float(1e3 * np.percentile(run["latency_s"], 95))

"""The 95th percentile (nearest rank) of every call's time in the window,
from its start to its decision on the host, in ms."""

import math


def read(run):
    lat = sorted(c.end - c.start for c in run.calls)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3

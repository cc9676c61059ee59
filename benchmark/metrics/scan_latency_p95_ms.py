"""The 95th percentile of the window's scan latencies: from each scan's due
time to its pose polled on the host (the paced open loop)."""

import numpy as np


def read(obs):
    lat = obs.get("latencies_ms")
    if obs.get("mode") != "online" or not lat:
        return None
    return float(np.percentile(lat, 95))

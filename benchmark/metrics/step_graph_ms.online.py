"""Median device milliseconds of a step-graph replay (CUDA events around
each replay), online cells."""

import numpy as np


def read(obs):
    v = obs.get("step_graph_ms")
    if obs.get("mode") != "online" or not v:
        return None
    return float(np.median(v))

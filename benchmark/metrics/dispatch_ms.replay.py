"""Median host milliseconds of ``RealtimePipeline._replay`` over the
window up to the profiler's start (the traced run reads it): a scan's
staging, upload and graph launch, without the wait for the staging rows'
last upload (the device's backpressure, reported apart on the ``counts``
line), replay cells."""

import numpy as np


def read(obs):
    v = obs.get("dispatch_ms")
    if obs.get("mode") != "replay" or not v:
        return None
    return float(np.median(v))

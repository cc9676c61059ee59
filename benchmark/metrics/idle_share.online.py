"""Per cent of the traced window in which no operation ran on the device
(the union of the profiler's device events, every stream), online cells."""

def read(obs):
    t = obs.get("trace")
    if obs.get("mode") != "online" or not t or not t["window_s"] or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""Per cent of their roofline that the port's hand-written kernels reach in
the traced window: the sum of each launch's bound (``costs.py`` at the
launch's shapes) over the sum of their device times."""

def read(obs):
    t = obs.get("trace")
    if obs.get("mode") != "replay" or not t:
        return None
    device_s = sum(t["kernel_device_s"].values())
    if device_s <= 0 or t["kernel_bound_s"] <= 0:
        return None
    return 100.0 * t["kernel_bound_s"] / device_s

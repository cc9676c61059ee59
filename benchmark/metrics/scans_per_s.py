"""Scans whose poses were polled within the window, over the window's seconds
(the closed-loop replay; its window ends at the first poll at or after
``--seconds``)."""

def read(obs):
    if obs.get("mode") != "replay" or not obs.get("window_s"):
        return None
    return obs["polled_in_window"] / obs["window_s"]

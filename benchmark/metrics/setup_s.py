"""Process start to the first timed scan."""

def read(obs):
    return obs.get("setup_s")

"""The traffic generator: the same seed gives the same world, drive and
scans; another seed another world; the drives have the stated shape."""

import json

import numpy as np
import pytest
import torch

import world
from conftest import BENCH


# A drive out and back, 4 m over: no mix uses it now; the generator keeps it
# so that a loop-closure cell can come back as data alone.
OUT_AND_BACK = {"kind": "out_and_back", "step_m": 0.3, "sway_deg_per_scan": 0.8, "sway_period_scans": 48,
                "sensor_height_m": 1.5, "out_scans": 96, "turn_scans": 36, "lane_m": 4.0}


def small(name):
    if name == "out-and-back":
        t = small("online-street")
        t["drive"] = dict(OUT_AND_BACK)
        return t
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t["world"].update(floor_points_per_m=200, points_per_object=300)
    t["sensor"]["points"] = 2048
    return t


@pytest.mark.parametrize("mix", ["replay-street", "out-and-back"])
def test_same_seed_same_scans(mix):
    t = small(mix)
    a = world.make_scene(t, 6, "cpu", 2**31 + 17)
    b = world.make_scene(t, 6, "cpu", 2**31 + 17)
    c = world.make_scene(t, 6, "cpu", 2**31 + 18)
    assert torch.equal(a.world, b.world)
    assert not torch.equal(a.world[:100], c.world[:100])
    for k in (0, 3, 5):
        fa, sa = world.make_scan(a, k)
        fb, sb = world.make_scan(b, k)
        assert torch.equal(fa, fb) and torch.equal(sa, sb)
        assert fa.shape == (2048, 3)
    # A scan made alone is the scan made in order.
    assert torch.equal(world.make_scan(a, 4)[0], world.make_scan(b, 4)[0])


def test_street_sways_within_limits():
    t = small("replay-street")
    P = world.drive_poses(t["drive"], 200)
    yaw = np.arctan2(P[:, 1, 0], P[:, 0, 0])
    assert np.degrees(np.abs(np.diff(yaw))).max() <= 0.8 + 1e-9
    step = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
    assert np.allclose(step, 0.3)
    assert abs(P[:, 1, 3]).max() < 0.5  # the sway stays inside the lane


def test_out_and_back_returns_on_the_left_lane():
    t = small("out-and-back")
    d = t["drive"]
    n_back = 150
    P = world.drive_poses(d, d["out_scans"] + d["turn_scans"] + n_back)
    turn_end = P[d["out_scans"] + d["turn_scans"] - 1]
    assert turn_end[1, 3] == pytest.approx(4.0, abs=0.3)
    back = P[d["out_scans"] + d["turn_scans"]:]
    heading = np.arctan2(back[:, 1, 0], back[:, 0, 0])
    assert np.all(np.cos(heading) < -0.95)
    assert back[-1, 0, 3] < P[0, 0, 3]  # past the start


def test_sweep_is_undone_by_the_twist():
    """A swept scan moved back by exp((phase - 1) twist) is the still one."""
    from reference import maps

    t = small("replay-street")
    t["sensor"]["sweep"] = True  # a mix for a configuration that compensates motion
    s = world.make_scene(t, 4, "cpu", 99)
    fed, still = world.make_scan(s, 2)
    motion = torch.as_tensor(np.linalg.inv(s.poses[1]) @ s.poses[2])
    back = maps.undistort(fed.double(), motion, 0.1, 0.1)
    # The phase is read from the swept azimuth, a little off the still one.
    assert (back - still.double()).norm(dim=-1).max() < 5e-3
    assert (fed - still).norm(dim=-1).max() > 0.05

"""The check against faults planted in the timed path: a run on the CPU at
a small size (the harness's look for a card skipped, the pipeline's eager
step in place of its graph), with the step broken underneath, has
``correct`` false; the same run unbroken reads far lower. Also the loop
layer's answers altered where they are made, and the control (the
reference in bfloat16 in the program's place) at this size."""

import json
import time
import types

import numpy as np
import pytest
import torch

import compare
import harness
from conftest import BENCH

CELL = "default-online-street"


def small_spec():
    spec = harness.load_spec(CELL, BENCH.parent)
    t = spec.traffic
    t["sensor"]["points"] = 2048
    t["world"].update(floor_points_per_m=250, points_per_object=700)
    t.update(warmup_scans=4, rate_hz=4.0)
    t["check"].update(pose_samples=3, insert_samples=4, source_points=512)
    s = spec.config["slam"]
    s["submaps"]["submap_capacity"] = 1 << 13
    s["mapper"]["scan_capacity"] = 1024
    s["mapper"]["ref_capacity"] = 4096
    spec.limits["minimum"] = {"pose_samples": 3, "insert_samples": 2}
    return spec


def drive(spec, seed=2**31 + 5):
    torch.set_num_threads(2)
    run = harness.Run(spec, seed, 2.0, False, time.time(), "cpu")
    run.setup()
    run.window()
    run.close()
    vals, info = compare.numbers(run)
    need = spec.limits["minimum"]
    ok, _ = compare.judge(vals, spec.limits["limits"], {k: (info.get(k, 0), n) for k, n in need.items()})
    return ok, vals, run


@pytest.fixture(scope="module")
def sound():
    return drive(small_spec())


def _broken(monkeypatch, how):
    from open3d_slam_private_tpu_torch.slam import realtime as rt

    real = rt.rt_step

    def step(state, scan, dt, ext, cfg, **kw):
        if how == "half":  # half the scan's points left out
            keep = scan.mask & (torch.arange(scan.capacity) % 2 == 0)
            return real(state, scan.with_mask(keep), dt, ext, cfg, **kw)
        new, stats = real(state, scan, dt, ext, cfg, **kw)
        if how == "unchanged":  # the state comes back as it went in
            stats = stats.clone()
            stats[:16] = state.map_pose.reshape(-1)
            return state, stats
        if how == "altered":  # the reported pose moved 10 cm
            stats = stats.clone()
            stats[3] += 0.1
            return new, stats
        raise ValueError(how)

    monkeypatch.setattr(rt, "rt_step", step)


# A pose reported 10 cm off, the state as the step made it: the reference's
# insert at the reported pose parts from the map the step built.
@pytest.mark.parametrize("how,number", [("unchanged", "pose_gap_m"), ("half", "submap_mismatch"),
                                        ("altered", "submap_mismatch")])
def test_a_broken_step_is_not_correct(monkeypatch, sound, how, number):
    _, sound_vals, _ = sound
    _broken(monkeypatch, how)
    ok, vals, _ = drive(small_spec())
    assert not ok
    assert vals[number] > 3 * sound_vals[number] + 1e-3


def test_the_control_reads_far_above_the_program(sound):
    _, vals, run = sound
    control, _ = compare.numbers(run, control=True)
    limits = harness.load_spec(CELL, BENCH.parent).limits["limits"]
    for name in ("submap_mismatch",):
        assert control[name] > 0.5 and control[name] > 10 * vals[name]
        assert control[name] > limits[name] > vals[name]


def _square(n=3000, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g) * 12 - 6
    return torch.cat([torch.cat([u, torch.zeros(n, 1)], 1),
                      torch.stack([torch.full((n,), 6.0), u[:, 0], u[:, 1].abs()], 1),
                      torch.stack([u[:, 0], torch.full((n,), -6.0), u[:, 1].abs()], 1),
                      torch.stack([torch.full((n,), -5.0), u[:, 1], u[:, 0].abs()], 1)])


def _loop_run(T_claim, out_poses):
    cloud = _square() + torch.tensor([30.0, 10.0, 0.0])
    A_s = np.eye(4)
    A_s[:3, 3] = [31.0, 9.0, 0.0]
    A_t = np.eye(4)
    A_t[:3, 3] = [29.0, 11.0, 0.0]
    c = type("C", (), {"T_target_source": T_claim})()
    mask = torch.ones(cloud.shape[0], dtype=torch.bool)
    rec = dict(c=c, src=((cloud, mask), A_s), tgt=((cloud, mask), A_t), t=0.0)
    P = np.stack([np.eye(4)] * 3)
    P[1, 0, 3], P[2, 0, 3] = 1.0, 2.1
    meas = np.stack([np.eye(4)] * 2)
    meas[:, 0, 3] = 1.0
    graph = dict(poses=P.astype(np.float32), node_mask=np.array([True] * 3), edge_i=np.array([0, 1]),
                 edge_j=np.array([1, 2]), edge_T=meas.astype(np.float32),
                 edge_info=np.stack([np.eye(6, dtype=np.float32) * 100] * 2), edge_is_loop=np.array([False, False]),
                 edge_mask=np.array([True, True]))
    from open3d_slam_private_tpu_torch.slam.pose_graph import PoseGraphConfig

    solve = dict(graph=graph, out=out_poses, cfg=PoseGraphConfig(), t=0.0)
    spec = types.SimpleNamespace(traffic=json.loads((BENCH / "traffic" / "online-street.json").read_text()))
    return type("R", (), dict(constraints=[rec], solves=[solve], t_window=(0.0, 1.0, 1.0), seed=3,
                              dev=torch.device("cpu"), spec=spec))()


def test_loop_answers_altered_where_made():
    # The source bank in its anchor's frame lands on the target's by T = A_t^-1 A_s.
    A_s = np.eye(4); A_s[:3, 3] = [31.0, 9.0, 0.0]
    A_t = np.eye(4); A_t[:3, 3] = [29.0, 11.0, 0.0]
    T = np.linalg.inv(A_t) @ A_s
    solved = np.stack([np.eye(4)] * 3)
    solved[1, 0, 3], solved[2, 0, 3] = 1.0, 2.0
    good = _loop_run(T, solved)
    assert compare.loop_gaps(good)[0][0] < 0.01
    assert compare.solve_checks(good)[0]["gap_m"] < 0.01
    assert compare.solve_checks(good)[0]["left"] < 0.01
    bad_T = T.copy()
    bad_T[0, 3] += 0.3
    bad_P = solved.copy()
    bad_P[2, 1, 3] += 0.3
    bad = _loop_run(bad_T, bad_P)
    assert compare.loop_gaps(bad)[0][0] > 0.25  # reported beside the limits
    assert compare.solve_checks(bad)[0]["left"] > 1.0  # worse than where it started

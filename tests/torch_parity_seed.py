"""Where the PyTorch port and the JAX package part on one data seed of
``tests/test_torch_pipeline.py``'s SLAM sequence, on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_parity_seed.py 2

Prints, for the first steps of the sequence, the odometry's and the
pipeline's pose differences (m), then for the first registration: whether
the odometry's preprocessed scans are bit-equal (mask, xyz, normals, and the
share of normals equal bit for bit), and the gap of the port's
``register_pair`` from JAX's on JAX's own preprocessed clouds and on the
port's.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.torch_jax_paths import use_jax_fused_path  # noqa: E402

use_jax_fused_path()  # JAX's Pallas pair-GN in interpret mode, the port's K1 twin

import tests.conftest  # noqa: E402,F401  (JAX on the CPU)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open3d_slam_private_tpu.models import icp as jicp  # noqa: E402
from open3d_slam_private_tpu.ops import pointcloud as jpc  # noqa: E402
from open3d_slam_private_tpu.slam import odometry as jodo  # noqa: E402
from open3d_slam_private_tpu.slam import pipeline as jpipe  # noqa: E402
from open3d_slam_private_tpu_torch import interop  # noqa: E402
from open3d_slam_private_tpu_torch.models import icp as ticp  # noqa: E402
from open3d_slam_private_tpu_torch.slam import odometry as todo  # noqa: E402
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe  # noqa: E402
from tests.test_torch_odometry import scene  # noqa: E402
from tests.test_torch_pipeline import SWEEP, _config, distorted_scan  # noqa: E402


def _gap(a, b) -> float:
    return float(np.linalg.norm((np.linalg.inv(a) @ b)[:3, 3]))


def main(seed: int, steps: int = 3, odometry_from_jax: bool = False) -> None:
    """``odometry_from_jax``: the port's pipeline takes the JAX odometry's
    pose each step instead of its own, so that only its mapper parts."""
    rng = np.random.default_rng(seed)
    S = scene(rng)
    jcfg = _config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    if odometry_from_jax:
        tp.odometry.add_scan = lambda scan: jp.odometry.pose.copy()
    g_body = np.array([0.0, 9.81 * np.sin(0.02), 9.81 * np.cos(0.02)])
    for k in range(10):  # the test's IMU boot
        acc = g_body + 0.01 * rng.normal(size=3)
        jp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
        tp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
    for k in range(steps):
        pts, times = distorted_scan(S, k, seed=k)
        jb = jpc.from_points(pts, capacity=4096, extras={"times": times[:, None]})
        jp.process_scan(jb, SWEEP * k)
        tp.process_scan(interop.point_batch(jb.xyz, jb.mask, {"times": jb.extras["times"]}), SWEEP * k)
        odo = "JAX's" if odometry_from_jax else f"{_gap(jp.odometry.pose, tp.odometry.pose):.3g} m"
        print(f"step {k}: odometry {odo}, pipeline {_gap(jp.pose, tp.pose):.3g} m")

    ocfg = jcfg.odometry
    tcfg = interop.config(todo.OdometryConfig, ocfg)
    jscans, tscans = [], []
    for k in (0, 1):
        jb = jpc.from_points(distorted_scan(S, k, seed=k)[0], capacity=4096)
        j = jodo.preprocess(jb, None, ocfg)
        t = todo.preprocess(interop.point_batch(jb.xyz, jb.mask), tcfg)
        tn, jn = t.extras["normals"].numpy(), np.asarray(j.normals)
        print(f"scan {k}: mask equal {np.array_equal(t.mask.numpy(), np.asarray(j.mask))}, "
              f"xyz equal {np.array_equal(t.xyz.numpy(), np.asarray(j.xyz))}, "
              f"normals bit-equal {float((tn == jn).all(1).mean()):.3g}, "
              f"largest normal difference {float(np.abs(tn - jn).max()):.3g}")
        jscans.append(j)
        tscans.append(t)
    init = np.eye(4, dtype=np.float32)
    want = np.asarray(jicp.register_pair(jscans[1], jscans[0], jnp.asarray(init), ocfg.icp).transform,
                      np.float64)
    on_jax = [interop.point_batch(x.xyz, x.mask, {"normals": x.normals}) for x in jscans]
    for name, (curr, prev) in (("JAX's clouds", on_jax[::-1]), ("the port's clouds", tscans[::-1])):
        got = ticp.register_pair(curr, prev, torch.tensor(init), tcfg.icp).transform.double().numpy()
        print(f"register_pair on {name}: {_gap(want, got):.3g} m from JAX")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

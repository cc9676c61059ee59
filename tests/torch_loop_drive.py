"""The default ``SlamConfig`` (production configs, loop closure on) on
``chip_smoke.py``'s there-and-back loop drive (``chip_smoke.loop_drive``:
96 scans out, a 36-scan U-turn, 96 scans back on a lane 4 m to the left;
65,536-point scans of ``synth_site``), on the CPU: the JAX package's
``SlamPipeline`` (its Pallas pair-GN kernel in interpret mode, the
production configs' fused path) or the port's. Prints the ATE p50 / max
against the drive's truth, the accepted closures and the scans they came
on, and the submap count: the reference accuracy of ``chip_smoke.py``'s
``pipeline-64k-loop`` cell.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_loop_drive.py [jax|port] [scans]

(JAX: ~30 min for the 228 scans on an 8-core host, most of it in the
loop-closure verifications; ``scans`` cuts the drive.)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def main(which="jax", n_scans=None):
    poses = smoke.loop_drive()
    poses = poses[:n_scans] if n_scans else poses
    scene = smoke.synth_site(smoke.SITE_POINTS)
    if which == "jax":
        from tests.torch_jax_paths import use_jax_fused_path

        use_jax_fused_path()  # JAX's fused pair-GN path (interpret mode), the port's K1 twin
        import tests.conftest  # noqa: F401  (JAX on the CPU)
        from open3d_slam_private_tpu.ops import pointcloud as pc
        from open3d_slam_private_tpu.slam.pipeline import SlamConfig, SlamPipeline

        pipe = SlamPipeline(SlamConfig())
        make = lambda pts: pc.from_points(pts, capacity=smoke.SCAN_POINTS)  # noqa: E731
    else:
        from open3d_slam_private_tpu_torch.ops import pointcloud as pc
        from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig, SlamPipeline

        pipe = SlamPipeline(SlamConfig(), device="cpu")
        make = lambda pts: pc.from_points(pts, capacity=smoke.SCAN_POINTS)  # noqa: E731
    est, closures, t0 = [], [], time.time()
    for k, T in enumerate(poses):
        pts = smoke.sample_scan(scene, smoke.SCAN_POINTS, np.linalg.inv(T), seed=smoke.LOOP_SEED + k,
                                sensor=T[:3, 3])
        t = time.time()
        stats = pipe.process_scan(make(pts), 0.1 * k)
        est.append(np.asarray(pipe.pose))
        if "loop_closures" in stats:
            closures.append((k, stats["loop_closures"]))
            print(f"scan {k}: {stats['loop_closures']} closures, {len(pipe.submaps)} submaps, "
                  f"{time.time() - t:.1f} s", flush=True)
    truth = [np.linalg.inv(poses[0]) @ T for T in poses]
    ate = np.array([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, truth)])[1:]
    accepted = sum(n for _, n in closures)
    print(f"{which}: {len(poses)} scans, ATE p50 {np.median(ate):.6f} m, max {ate.max():.6f} m, "
          f"{accepted} closures accepted on scans {[k for k, n in closures if n]}, "
          f"{len(closures)} finished submaps tried, {len(pipe.submaps)} submaps, "
          f"{time.time() - t0:.0f} s", flush=True)
    print("ATE by scan: " + " ".join(f"{a:.3f}" for a in ate), flush=True)


if __name__ == "__main__":
    main(*(sys.argv[1:2] or ["jax"]), *[int(a) for a in sys.argv[2:3]])

"""The real-time SLAM step on ``chip_smoke.py``'s 96-scan, 28.5 m drive of
65,536-point scans (the realtime-64k cell): the JAX package's
``RealtimePipeline`` on the CPU (its Pallas pair-GN kernel in interpret
mode, the production configs' fused path) or the port's (eager ``rt_step``
on the CPU, graph replays on a card), with the production configs and
loop closure off. Prints the ATE p50 / max against the drive's truth, the
submap count and the lifecycle's switches by kind: the reference accuracy
of ``chip_smoke.py``'s ``realtime-64k`` cell, whose submap lifecycle (the
bank seeded with the old bank's patch at a switch, force-new at 90% of the
bank, decisions at the poll cadence) differs from ``SlamPipeline``'s.

``--variant`` changes the port's lifecycle to test what costs the
accuracy: ``no-force`` never forces a new submap on occupancy;
``keep`` also carries the whole bank into a new submap instead of its
seeded patch, so the step registers against one rolling map, as
``SlamPipeline``'s mapper does.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_realtime_drive.py jax --poll 8
    python tests/torch_realtime_drive.py port --poll 1 --variant keep --device cuda
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


def _port_pipeline(poll_every, variant, device):
    import dataclasses

    import torch

    from open3d_slam_private_tpu_torch.slam import realtime as rt
    from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig

    cfg = SlamConfig(loop_closure_enabled=False)
    if variant in ("no-force", "keep"):
        cfg = dataclasses.replace(cfg, submaps=dataclasses.replace(
            cfg.submaps, max_num_points=cfg.submaps.submap_capacity + 1))
    if variant == "keep":
        rt._seed_bank = lambda old, *args: rt.tree_map(torch.clone, old)
    pipe = rt.RealtimePipeline(cfg, poll_every=poll_every, device=device)
    switches = {"forced": 0, "distance": 0, "reactivated": 0}
    decide = pipe._maybe_switch_submap

    def counted(pose, occupancy):
        before, n = pipe.submaps.active_idx, len(pipe.submaps.submaps)
        decide(pose, occupancy)
        if len(pipe.submaps.submaps) > n:
            forced = occupancy >= int(0.9 * cfg.submaps.submap_capacity) and variant == "as-is"
            switches["forced" if forced else "distance"] += 1
        elif pipe.submaps.active_idx != before:
            switches["reactivated"] += 1

    pipe._maybe_switch_submap = counted
    return pipe, switches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=("jax", "port"))
    ap.add_argument("--poll", type=int, default=1, help="poll_every")
    ap.add_argument("--scans", type=int, default=smoke.PIPELINE_SCANS)
    ap.add_argument("--variant", choices=("as-is", "no-force", "keep"), default="as-is")
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    scene = smoke.synth_site(smoke.SITE_POINTS)
    poses = smoke.drive(smoke.PIPELINE_SCANS, smoke.PIPELINE_STEP_M)[:args.scans]
    switches = None
    if args.which == "jax":
        from tests.torch_jax_paths import use_jax_fused_path

        use_jax_fused_path()  # JAX's fused pair-GN path (interpret mode), the port's K1 twin
        import tests.conftest  # noqa: F401  (JAX on the CPU)
        from open3d_slam_private_tpu.ops import pointcloud as pc
        from open3d_slam_private_tpu.slam.pipeline import SlamConfig
        from open3d_slam_private_tpu.slam.realtime import RealtimePipeline

        if args.variant != "as-is":
            raise SystemExit("--variant changes the port's lifecycle only")
        pipe = RealtimePipeline(SlamConfig(loop_closure_enabled=False), poll_every=args.poll,
                                loop_closure_async=False)
        make = lambda pts: pc.from_points(pts, capacity=smoke.SCAN_POINTS)  # noqa: E731
    else:
        from open3d_slam_private_tpu_torch.ops import pointcloud as pc

        pipe, switches = _port_pipeline(args.poll, args.variant, args.device)
        make = lambda pts: pc.from_points(pts, capacity=smoke.SCAN_POINTS, device=args.device)  # noqa: E731
    t0 = time.time()
    for k, T in enumerate(poses):
        pts = smoke.sample_scan(scene, smoke.SCAN_POINTS, np.linalg.inv(T), seed=300 + k, sensor=T[:3, 3])
        pipe.process_scan(make(pts), 0.1 * k)
    pipe.finish()
    est = pipe.trajectory()
    truth = [np.linalg.inv(poses[0]) @ T for T in poses]
    ate = np.array([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, truth)])[1:]
    print(f"{args.which} realtime ({args.variant}), poll_every {args.poll}: {len(poses)} scans, "
          f"ATE p50 {np.median(ate):.6f} m, max {ate.max():.6f} m, {len(pipe.submaps.submaps)} submaps, "
          f"switches {switches}, {time.time() - t0:.0f} s", flush=True)
    worst = int(np.argmax(ate)) + 1
    print(f"worst scan {worst}: {ate[worst - 1]:.4f} m; ATE by scan: "
          + " ".join(f"{a:.3f}" for a in ate), flush=True)


if __name__ == "__main__":
    main()

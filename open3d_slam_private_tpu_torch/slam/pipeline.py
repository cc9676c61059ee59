"""The online SLAM step: odometry -> mapper -> submap collection -> loop
closure -> pose graph.

Twin of ``open3d_slam_private_tpu/slam/pipeline.py``.
:meth:`SlamPipeline.process_scan` runs, per scan: the IMU attitude boot,
out-of-order handling (a stale scan propagates the pose by the odometry
motion and is not registered), optional constant-velocity undistortion,
LiDAR odometry (or an external odometry pose), scan-to-map X-ICP against
the active submap, and insertion into the submap collection, which creates
and switches submaps. With ``loop_closure_enabled`` (the default) a submap
that has just finished is checked against its candidates
(``slam/place_recognition.py``); accepted constraints go into a pose graph
of the submap anchors (``slam/pose_graph.py``), whose increments move the
submaps and the live pose. Stepped serially it is deterministic.
:meth:`SlamPipeline.relocalize` places a scan in the map globally.
:class:`OnlineSlamRunner` feeds it from a worker thread.

Not ported, and refused by name: the dense map (``build_dense_map``); so
the config has no ``dense_map_voxel`` and ``dense_map_capacity`` fields.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.ops import pointcloud as pc
from open3d_slam_private_tpu_torch.slam import mapper as mapper_mod
from open3d_slam_private_tpu_torch.models import icp as icp_mod
from open3d_slam_private_tpu_torch.slam import motion_compensation as mc_mod
from open3d_slam_private_tpu_torch.slam import place_recognition as pr
from open3d_slam_private_tpu_torch.slam import pose_graph as pg
from open3d_slam_private_tpu_torch.slam.imu import ImuBuffer
from open3d_slam_private_tpu_torch.slam.mapper import (
    MapperConfig,
    build_map_reference,
    process_scan_for_matching,
    scan_to_map_step,
)
from open3d_slam_private_tpu_torch.slam.odometry import LidarOdometry, OdometryConfig
from open3d_slam_private_tpu_torch.slam.submap_collection import (
    SubmapCollection,
    SubmapCollectionConfig,
)
from open3d_slam_private_tpu_torch.slam.transform_buffer import TransformInterpolationBuffer


@dataclasses.dataclass(frozen=True)
class MotionCompensationConfig:
    """Undistort every scan with the body velocity of the last motion."""

    enabled: bool = False
    scan_duration: float = 0.1  # s, one sweep
    clockwise: bool = True  # spin direction
    # Use the per-point ``times`` channel when the scan carries one; the
    # azimuth-phase model otherwise.
    use_times_channel: bool = True


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The JAX twin's fields and defaults without the dense map's voxel and
    capacity; ``build_dense_map`` must stay False (see :func:`check_config`)."""

    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    submaps: SubmapCollectionConfig = dataclasses.field(default_factory=SubmapCollectionConfig)
    place_recognition: pr.PlaceRecognitionConfig = dataclasses.field(
        default_factory=pr.PlaceRecognitionConfig
    )
    pose_graph: pg.PoseGraphConfig = dataclasses.field(default_factory=pg.PoseGraphConfig)
    use_external_odometry: bool = False
    loop_closure_enabled: bool = True
    motion_compensation: MotionCompensationConfig = dataclasses.field(
        default_factory=MotionCompensationConfig
    )
    # Boot roll/pitch from buffered IMU samples, while uninitialised and
    # with an identity rotation (an explicit set_initial_transform wins).
    use_imu_attitude_init: bool = True
    build_dense_map: bool = False
    node_capacity: int = 128  # pose-graph nodes (one a submap)
    edge_capacity: int = 512


def check_config(cfg: SlamConfig) -> None:
    """Raise NotImplementedError naming a field outside the ported path."""
    if cfg.build_dense_map:
        raise NotImplementedError("SlamConfig.build_dense_map=True is not ported (no dense map)")
    mapper_mod.check_config(cfg.mapper)
    icp_mod.check_config(cfg.place_recognition.icp)
    pg.check_config(cfg.pose_graph)


def _log_se3(T: np.ndarray) -> np.ndarray:
    """float64 [4, 4] -> float64 twist, through the float32 log map."""
    return se3.log_se3(torch.as_tensor(T, dtype=torch.float32)).double().numpy()


def _exp_se3(twist: np.ndarray) -> np.ndarray:
    return se3.exp_se3(torch.as_tensor(twist, dtype=torch.float32)).double().numpy()


class SlamPipeline:
    """Single-owner SLAM state machine on ``device`` (default: the CUDA card;
    see :func:`device.resolve`). Poses live on the host in float64."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device=None):
        self.cfg = cfg or SlamConfig()
        check_config(self.cfg)
        self.device = resolve(device)
        self.odometry = LidarOdometry(self.cfg.odometry, device=self.device)
        self.submaps = SubmapCollection(self.cfg.submaps, device=self.device)
        self.odom_buffer = TransformInterpolationBuffer()
        self.map_pose_buffer = TransformInterpolationBuffer()

        self._map_pose = np.eye(4)
        self._prev_odom_pose: Optional[np.ndarray] = None
        self._ref = None
        self._ref_submap_idx = -1
        self._ref_center = None
        self._scans_since_reinit = 0
        self._last_insert_pose: Optional[np.ndarray] = None
        self._initialized = False
        # Pose-graph bookkeeping: one node a submap (its anchor).
        self._loop_constraints: List[pr.LoopClosureConstraint] = []
        # Loop-closure tracing: ``stage``, if set, is a callable name ->
        # context manager around each stage of an attempt (normals, fpfh,
        # matches, ransac, icp, pose_graph); each attempt appends a record
        # to ``loop_closure_trace``.
        self.stage = None
        self.loop_closure_trace: List[dict] = []
        self._scan_count = 0
        self.stats: List[dict] = []
        self.imu_buffer = ImuBuffer()
        self._attitude_initialized = False
        self._last_scan_time: Optional[float] = None
        self._last_motion_twist = np.zeros(6)  # log of the last odometry motion

    def add_imu(self, time: float, acc, gyro) -> None:
        """Buffer one IMU sample."""
        self.imu_buffer.push(time, acc, gyro)

    @property
    def pose(self) -> np.ndarray:
        return self._map_pose.copy()

    def _T(self, pose: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pose, dtype=torch.float32, device=self.device)

    def process_scan(
        self, scan: pc.PointBatch, time: float, external_odom_pose: Optional[np.ndarray] = None
    ) -> dict:
        """One deterministic step for the scan stamped ``time`` (moved to
        the pipeline's device). Returns its stats dict."""
        cfg = self.cfg
        scan = scan.to(self.device)

        if (
            cfg.use_imu_attitude_init
            and not self._initialized
            and not self._attitude_initialized
            and len(self.imu_buffer) >= 2
            and np.allclose(self._map_pose[:3, :3], np.eye(3))
        ):
            try:
                R_wb, _g = self.imu_buffer.estimate_attitude(t_end=time)
                self._map_pose = self._map_pose.copy()
                self._map_pose[:3, :3] = R_wb
                self._attitude_initialized = True
            except ValueError:
                pass

        if self._last_scan_time is not None and time <= self._last_scan_time:
            # A stale scan: propagate by the odometry motion, register
            # nothing, and leave the pose buffer (registrations only) alone.
            self._map_pose = self._map_pose @ self._out_of_order_motion(external_odom_pose)
            stats = dict(converged=False, inserted=False, degenerate=False, overlap=0.0,
                         out_of_order=True)
            self.stats.append(stats)
            return stats

        mc = cfg.motion_compensation
        if mc.enabled and self._last_scan_time is not None:
            dt = max(time - self._last_scan_time, 1e-6)
            # With external odometry the sweep's motion is known before the
            # registration; otherwise the last frame's motion is reused
            # (constant velocity).
            if (
                cfg.use_external_odometry
                and external_odom_pose is not None
                and self._prev_odom_pose is not None
            ):
                base_twist = _log_se3(
                    np.linalg.inv(self._prev_odom_pose) @ np.asarray(external_odom_pose, np.float64)
                )
            else:
                base_twist = self._last_motion_twist
            twist = torch.as_tensor(base_twist * (mc.scan_duration / dt), dtype=torch.float32,
                                    device=self.device)
            if mc.use_times_channel and "times" in scan.extras:
                m = scan.mask
                if bool(m.any()):
                    t_pts = scan.extras["times"][..., 0][m]
                    scan = mc_mod.undistort_with_times(
                        scan, twist, float(t_pts.min()), float(t_pts.max())
                    )
            else:
                scan = mc_mod.undistort_with_azimuth(scan, twist, mc.clockwise)

        if cfg.use_external_odometry and external_odom_pose is not None:
            odom_pose = np.asarray(external_odom_pose, np.float64)
        else:
            odom_pose = self.odometry.add_scan(scan)
        self.odom_buffer.push(time, odom_pose)
        if self._prev_odom_pose is None:
            odom_motion = np.eye(4)
        else:
            odom_motion = np.linalg.inv(self._prev_odom_pose) @ odom_pose
        self._prev_odom_pose = odom_pose
        self._last_motion_twist = _log_se3(odom_motion)
        self._last_scan_time = time

        stats = self._mapping_step(scan, odom_motion)
        self.map_pose_buffer.push(time, self._map_pose)

        if cfg.loop_closure_enabled:
            finished = self.submaps.pop_finished()
            if finished is not None:
                stats["loop_closures"] = self._attempt_loop_closures(finished)
        self._scan_count += 1
        self.stats.append(stats)
        return stats

    def _out_of_order_motion(self, external_odom_pose) -> np.ndarray:
        """Odometry motion from the last mapped time to the newest odometry
        pose; the last motion when the buffer cannot tell."""
        latest = self.odom_buffer.latest_time
        if (
            latest is not None
            and self._last_scan_time is not None
            and self.odom_buffer.has(self._last_scan_time)
            and latest > self._last_scan_time
        ):
            T_prev = self.odom_buffer.lookup(self._last_scan_time)
            return np.linalg.inv(T_prev) @ self.odom_buffer.lookup(latest)
        return _exp_se3(self._last_motion_twist)

    def _mapping_step(self, scan: pc.PointBatch, odom_motion: np.ndarray) -> dict:
        mcfg = self.cfg.mapper
        processed = process_scan_for_matching(scan, mcfg)

        if not self._initialized:
            self.submaps.insert_scan(processed, self._map_pose, self._map_pose, raw_scan=scan)
            self._rebuild_reference()
            self._last_insert_pose = self._map_pose.copy()
            self._initialized = True
            return dict(converged=True, inserted=True, degenerate=False, overlap=1.0)

        guess = self._map_pose @ odom_motion
        if (
            self._scans_since_reinit >= mcfg.reference_reinit_every
            or self.submaps.active_idx != self._ref_submap_idx
        ):
            self._rebuild_reference(center=guess[:3, 3])

        res = scan_to_map_step(processed, self._ref, self._T(guess), mcfg)
        transform = res.transform.double().cpu().numpy()
        degenerate = bool(res.degenerate)
        overlap = float(res.overlap_ratio)
        use_prior = (not np.isfinite(transform).all()) or (degenerate and overlap < 0.05)
        new_pose = guess if use_prior else transform
        self._map_pose = new_pose
        self._scans_since_reinit += 1

        inserted = False
        moved = (
            self._last_insert_pose is None
            or np.linalg.norm(new_pose[:3, 3] - self._last_insert_pose[:3, 3])
            >= mcfg.min_movement_for_insertion
        )
        if moved and not use_prior:
            self.submaps.insert_scan(processed, new_pose, new_pose, raw_scan=scan)
            self._last_insert_pose = new_pose.copy()
            inserted = True

        return dict(converged=bool(res.converged), inserted=inserted, degenerate=degenerate,
                    overlap=overlap, iterations=int(res.iterations))

    def _rebuild_reference(self, center=None) -> None:
        if center is None:
            center = self._map_pose[:3, 3]
        self._ref = build_map_reference(self.submaps.active.state.cloud, self._T(center),
                                        self.cfg.mapper)
        self._ref_submap_idx = self.submaps.active_idx
        self._ref_center = np.asarray(center, np.float64).copy()
        self._scans_since_reinit = 0

    def _attempt_loop_closures(self, finished_idx: int) -> int:
        tried: List[int] = []
        constraints = pr.build_loop_closure_constraints(self.submaps, finished_idx,
                                                        cfg=self.cfg.place_recognition,
                                                        stages=self.stage, tried=tried)
        record = dict(submap=finished_idx, tried=tried, accepted=[c.target_idx for c in constraints])
        self.loop_closure_trace.append(record)
        if not constraints:
            return 0
        self._loop_constraints.extend(constraints)
        record.update(self._optimize_pose_graph())
        return len(constraints)

    def _pose_graph(self) -> pg.PoseGraph:
        """Nodes at the submap anchors, odometry edges from each submap's
        parent, loop edges from the accepted constraints (float32, as the
        twin's builder takes them)."""
        builder = pg.PoseGraphBuilder(self.cfg.node_capacity, self.cfg.edge_capacity)
        for e in self.submaps.submaps:
            builder.add_node(e.anchor)
        for i, e in enumerate(self.submaps.submaps):
            if e.parent is not None:
                builder.add_edge(e.parent, i, np.linalg.inv(self.submaps.submaps[e.parent].anchor) @ e.anchor)
        for c in self._loop_constraints:
            builder.add_edge(c.target_idx, c.source_idx, c.T_target_source, info=c.information,
                             is_loop=True)
        return builder.build(self.device)

    def _optimize_pose_graph(self) -> dict:
        """Solve the pose graph and apply its increments: each submap moves
        by its own (or its parent's), the live pose by the active submap's.
        Returns the solve's iteration counts and the increments' count and
        largest translation."""
        solve: dict = {}
        with pr.stage_fn(self.stage)("pose_graph"):
            out = pg.optimize(self._pose_graph(), self.cfg.pose_graph, stats=solve)
            new_poses = out.poses.double().cpu().numpy()
        increments: Dict[int, np.ndarray] = {}
        for i, e in enumerate(self.submaps.submaps):
            inc = new_poses[i] @ np.linalg.inv(e.anchor)
            if not np.allclose(inc, np.eye(4), atol=1e-6):
                increments[i] = inc
        if increments:
            active_inc = increments.get(self.submaps.active_idx, np.eye(4))
            self.submaps.apply_pose_updates(increments)
            self._map_pose = active_inc @ self._map_pose
            self._ref_submap_idx = -1  # rebuild the reference
        solve["increments"] = len(increments)
        solve["max_increment_m"] = max((float(np.linalg.norm(T[:3, 3])) for T in increments.values()),
                                       default=0.0)
        return solve

    def assembled_map(self) -> np.ndarray:
        return self.submaps.map_points()

    def set_initial_map(self, points: np.ndarray, capacity: Optional[int] = None) -> None:
        """Localisation on a prior map: seed the collection with one submap
        holding ``points``."""
        capacity = capacity or self.cfg.submaps.submap_capacity
        batch = pc.from_points(points, capacity=capacity, device=self.device)
        self.submaps.insert_scan(batch, np.eye(4), np.eye(4))
        self._rebuild_reference(center=np.zeros(3))
        self._initialized = True
        self._last_insert_pose = self._map_pose.copy()

    def set_initial_transform(self, T: np.ndarray) -> None:
        self._map_pose = np.asarray(T, np.float64).copy()

    def relocalize(self, scan: pc.PointBatch, hint_pose: Optional[np.ndarray] = None,
                   search_radius: float = 10.0) -> Optional[np.ndarray]:
        """Global (re)localisation of a scan against the assembled map: the
        FPFH-RANSAC pose and a yaw x translation sweep around ``hint_pose``
        (identity if None), refined and gated as a loop closure with
        stricter gates, then polished against the active submap at the
        mapper's matching radius. Sets the live pose and returns it on
        success; leaves the state as it was and returns None otherwise."""
        mcfg = self.cfg.mapper
        prcfg = self.cfg.place_recognition
        processed = process_scan_for_matching(scan.to(self.device), mcfg)
        map_pts = self.assembled_map()
        if len(map_pts) == 0:
            return None
        target = pc.from_points(
            map_pts, capacity=max(1 << int(np.ceil(np.log2(max(len(map_pts), 2)))), 1024), device=self.device
        )
        hint = np.eye(4) if hint_pose is None else np.asarray(hint_pose, np.float64)
        # Stricter gates than a loop closure's: a wrong global pose costs
        # more than a skipped attempt.
        prcfg = dataclasses.replace(
            prcfg, num_xy_offsets=5, xy_offset=search_radius / 2.0,
            min_overlap=max(prcfg.min_overlap, 0.45), max_residual=min(prcfg.max_residual, 0.2),
        )
        got = pr.verify_candidate(processed, target, hint, prcfg)
        if got is None:
            return None
        T, _overlap, _residual = got
        # The polish is checked before any state changes.
        polish_ref = build_map_reference(self.submaps.active.state.cloud, self._T(T[:3, 3]), mcfg)
        res = scan_to_map_step(processed, polish_ref, self._T(T), mcfg)
        transform = res.transform.double().cpu().numpy()
        if not (np.isfinite(transform).all() and float(res.overlap_ratio) > 0.2):
            return None
        self._map_pose = transform
        self._ref = polish_ref
        self._ref_submap_idx = self.submaps.active_idx
        self._ref_center = np.asarray(T[:3, 3], np.float64).copy()
        self._scans_since_reinit = 0
        self._initialized = True
        return self._map_pose.copy()


class OnlineSlamRunner:
    """A worker thread over a SlamPipeline: callers enqueue scans and IMU
    samples and never block; under backpressure the oldest scan is dropped.
    Only the worker touches the pipeline."""

    def __init__(self, pipeline: SlamPipeline, queue_size: int = 20,
                 viz_server=None, viz_every: int = 5):
        import collections

        self.pipeline = pipeline
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._imu_q: "collections.deque" = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self.dropped = 0
        # Optional live publisher (anything with ``publish(map_points=,
        # trajectory=, stats=)``), fed after every ``viz_every``-th scan.
        self._viz = viz_server
        self._viz_every = max(1, int(viz_every))
        self._scan_count = 0
        self._traj: list = []

    def start(self) -> None:
        self._worker.start()

    def add_range_scan(self, scan: pc.PointBatch, time: float,
                       odom_pose: Optional[np.ndarray] = None) -> None:
        """Non-blocking enqueue; ``odom_pose`` is the external odometry pose
        paired with this scan."""
        try:
            self._q.put_nowait((scan, time, odom_pose))
        except queue.Full:
            try:
                self._q.get_nowait()
                self.dropped += 1
            except queue.Empty:
                pass
            self._q.put_nowait((scan, time, odom_pose))

    def add_imu(self, time: float, acc, gyro) -> None:
        """Enqueue one IMU sample; the worker hands it to the pipeline
        before the next scan."""
        self._imu_q.append((time, acc, gyro))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                scan, t, odom = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            while self._imu_q:
                self.pipeline.add_imu(*self._imu_q.popleft())
            stats = self.pipeline.process_scan(scan, t, external_odom_pose=odom)
            self._scan_count += 1
            if self._viz is not None:
                self._traj.append(np.asarray(self.pipeline.pose[:3, 3]))
                if self._scan_count % self._viz_every == 1 or self._viz_every == 1:
                    self._viz.publish(map_points=self.pipeline.assembled_map(),
                                      trajectory=np.asarray(self._traj), stats=stats)

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5.0)

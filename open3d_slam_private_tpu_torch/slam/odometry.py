"""Scan-to-scan LiDAR odometry.

Twin of ``open3d_slam_private_tpu/slam/odometry.py``: each scan is cropped
to a range band, voxelised to ``max_points`` (farthest bands shed first),
given KNN-PCA normals facing the sensor, and registered against the previous
scan with the hash matcher on the candidate-cached rounds (the fused pair-GN
kernel K1 on every in-round iteration). The cumulative pose and the last
motion stay on the host in float64; a registration with too little overlap,
or a non-finite one, is replaced by the last motion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.models import icp as icp_mod
from open3d_slam_private_tpu_torch.ops import filters
from open3d_slam_private_tpu_torch.ops import normals as normals_mod
from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch
from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """The JAX twin's fields and defaults: crop, voxel, normals, ICP."""

    min_range: float = 1.0
    max_range: float = 60.0
    voxel_size: float = 0.3
    max_points: int = 16384
    normals_knn: int = 8
    normals_radius: float = 1.0
    # The "hash" matcher: its table (one sort + one scatter) is cheap to
    # build, and odometry builds a reference from every scan.
    icp: icp_mod.ICPConfig = dataclasses.field(
        default_factory=lambda: icp_mod.ICPConfig(
            knn=1,
            max_match_dist=1.0,
            matcher="hash",
            grid_table_size=1 << 13,
            grid_bucket_cap=48,
            trimmed_ratio=0.8,
            minimizer="point_to_plane",
            max_iterations=20,
            min_diff_rot=1e-3,
            min_diff_trans=1e-3,
            candidate_refresh_every=5,
            fast_trimming=True,
            fused_kernel=True,
        )
    )
    min_fitness: float = 0.1


def preprocess(scan: PointBatch, cfg: OdometryConfig) -> PointBatch:
    """Crop to [min_range, max_range] -> voxelise to ``max_points`` ->
    normals oriented towards the sensor. (The JAX twin also takes a PRNG key,
    which no step of this chain uses; nothing here samples, so no generator
    is taken.)"""
    s = filters.min_max_radius(scan, cfg.min_range, cfg.max_range)
    s = voxel_downsample(
        s, cfg.voxel_size, capacity=cfg.max_points,
        priority_center=torch.zeros(3, device=s.device), const_size=True,
    )
    return normals_mod.estimate_normals(
        s, knn=cfg.normals_knn, max_dist=cfg.normals_radius, orient_towards=(0.0, 0.0, 0.0)
    )


def odometry_step(prev: PointBatch, curr: PointBatch, init_T: torch.Tensor,
                  cfg: OdometryConfig) -> icp_mod.ICPResult:
    """Register ``curr`` (reading) against ``prev`` (reference), both
    preprocessed."""
    return icp_mod.register_pair(curr, prev, init_T, cfg.icp)


class LidarOdometry:
    """Cumulative scan-to-scan odometry on ``device`` (default: the CUDA
    card; see :func:`device.resolve`)."""

    def __init__(self, cfg: Optional[OdometryConfig] = None, device=None):
        self.cfg = cfg or OdometryConfig()
        icp_mod.check_config(self.cfg.icp)
        self.device = resolve(device)
        self._prev: Optional[PointBatch] = None
        self._pose = np.eye(4, dtype=np.float64)
        self._last_motion = np.eye(4, dtype=np.float64)

    @property
    def pose(self) -> np.ndarray:
        return self._pose.copy()

    def add_scan(self, scan: PointBatch) -> np.ndarray:
        """Process one scan (moved to the odometry's device); returns the
        cumulative odometry pose."""
        processed = preprocess(scan.to(self.device), self.cfg)
        if self._prev is None:
            self._prev = processed
            return self.pose
        init = torch.as_tensor(self._last_motion, dtype=torch.float32, device=self.device)
        res = odometry_step(self._prev, processed, init, self.cfg)
        transform = res.transform.double().cpu().numpy()
        ok = float(res.overlap_ratio) >= self.cfg.min_fitness and bool(np.isfinite(transform).all())
        motion = transform if ok else self._last_motion
        self._pose = self._pose @ motion
        self._last_motion = motion
        self._prev = processed
        return self.pose

"""Scan-to-map refinement — the per-scan core loop.

Twin of ``open3d_slam_private_tpu/slam/mapper.py``. Per scan:

1. initial guess = previous map pose composed with the odometry motion;
2. every ``reference_reinit_every`` scans, rebuild the registration
   reference: crop the submap around the robot, compact it to
   ``ref_capacity``, estimate moment normals, build the cell list;
3. run X-ICP scan-to-map registration (``icp_single``);
4. insert the scan into the submap when the robot moved far enough.

When the registration is non-finite, or degenerate with almost no overlap,
the prior is kept. Device work runs on the mapper's device (the CUDA card
unless another is named); the host keeps poses and cadence in float64
numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.models import icp as icp_mod
from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig
from open3d_slam_private_tpu_torch.ops import grid_hash
from open3d_slam_private_tpu_torch.ops import normals as normals_mod
from open3d_slam_private_tpu_torch.ops.pointcloud import PAD_COORD, PointBatch
from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample
from open3d_slam_private_tpu_torch.slam import submap as submap_mod


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """The JAX twin's fields and production defaults."""

    scan_voxel_size: float = 0.3
    scan_crop_radius: float = 30.0
    scan_capacity: int = 16384
    map_patch_radius: float = 40.0
    reference_reinit_every: int = 10
    ref_capacity: Optional[int] = 65536
    normals_knn: int = 8
    normals_radius: float = 1.0
    normals_method: str = "moments"
    min_movement_for_insertion: float = 0.1
    submap_voxel_size: float = 0.15
    submap_capacity: int = 131072
    submap_crop_radius: float = 50.0
    carving_enabled: bool = False
    icp: icp_mod.ICPConfig = dataclasses.field(
        default_factory=lambda: icp_mod.ICPConfig(
            knn=1,
            max_match_dist=0.5,
            matcher="grid",
            grid_table_size=1 << 16,
            grid_bucket_cap=48,
            trimmed_ratio=0.9,
            minimizer="point_to_plane",
            max_iterations=10,
            min_diff_rot=1e-3,
            min_diff_trans=8e-3,
            coarse_iterations=20,
            coarse_stride=4,
            candidate_refresh_every=10,
            candidate_slack=0.25,
            fast_trimming=True,
            fused_kernel=True,
            degeneracy=DegeneracyConfig(
                method="optimized",
                enough_information_threshold=250.0,
                insufficient_information_threshold=180.0,
            ),
        )
    )


def check_config(cfg: MapperConfig) -> None:
    """Raise NotImplementedError naming a field outside the ported path."""
    if cfg.normals_method != "moments":
        raise NotImplementedError(f"MapperConfig.normals_method={cfg.normals_method!r} is not ported")
    if cfg.carving_enabled:
        raise NotImplementedError("MapperConfig.carving_enabled=True is not ported")
    icp_mod.check_config(cfg.icp)


def process_scan_for_matching(scan: PointBatch, cfg: MapperConfig) -> PointBatch:
    """Narrow crop around the sensor + voxelise to ``scan_capacity``,
    shedding the farthest range bands under capacity pressure."""
    xyz = scan.xyz
    d2 = (xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1]) + xyz[:, 2] * xyz[:, 2]
    r = grid_hash.f32(cfg.scan_crop_radius, scan.device)
    s = scan.with_mask(d2 <= r * r)
    return voxel_downsample(
        s, cfg.scan_voxel_size, capacity=cfg.scan_capacity,
        priority_center=torch.zeros(3, device=scan.device), const_size=True,
    )


def _compact_by_key(cloud: PointBatch, key: torch.Tensor, capacity: int) -> PointBatch:
    key = torch.where(cloud.mask, key, torch.inf)
    take = torch.sort(key, stable=True).indices[:capacity]
    mask = cloud.mask[take]
    xyz = torch.where(mask[:, None], cloud.xyz[take], PAD_COORD)
    return PointBatch(xyz=xyz, mask=mask)


def compact_nearest(cloud: PointBatch, center: torch.Tensor, capacity: int) -> PointBatch:
    """The ``capacity`` valid points nearest ``center`` (geometry only)."""
    d = cloud.xyz - center
    return _compact_by_key(cloud, (d * d).sum(-1), capacity)


def compact_uniform(cloud: PointBatch, capacity: int) -> PointBatch:
    """``capacity`` valid points under a uniform-random but deterministic
    priority (the murmur3 hash of the point index)."""
    idx = torch.arange(cloud.capacity, dtype=torch.int64, device=cloud.device)
    return _compact_by_key(cloud, grid_hash._fmix32(idx).float(), capacity)


def build_map_reference(map_cloud: PointBatch, center: torch.Tensor, cfg: MapperConfig) -> icp_mod.ICPReference:
    """Crop the patch around the robot, compact it, estimate moment normals
    (oriented towards ``center``) and build the cell list."""
    patch = submap_mod.crop_around(map_cloud, center, cfg.map_patch_radius)
    if cfg.ref_capacity is not None and cfg.ref_capacity < patch.capacity:
        patch = compact_uniform(patch, cfg.ref_capacity)
    ngrid = grid_hash.build_grid(
        patch.padded_xyz(), patch.mask, 2.0 * cfg.normals_radius, cfg.icp.grid_table_size, 32,
        const_size=True,
    )
    patch = normals_mod.estimate_normals_moments(
        patch, ngrid, max_dist=cfg.normals_radius, orient_towards=center
    )
    ref = icp_mod.build_reference(patch, cfg.icp, const_size=True)
    # The JAX twin hands the reference to the next jitted step as an
    # argument, where its cell size is traced: the scan-to-map queries divide.
    if ref.grid is not None:
        ref = dataclasses.replace(ref, grid=dataclasses.replace(ref.grid, cell_inv=None))
    return ref


def scan_to_map_step(scan_processed: PointBatch, ref: icp_mod.ICPReference, init_T: torch.Tensor,
                     cfg: MapperConfig) -> icp_mod.ICPResult:
    return icp_mod.icp_single(scan_processed, ref, init_T, cfg.icp)


class Mapper:
    """Host orchestration of the scan-to-map loop on one submap, on
    ``device`` (default: the CUDA card; see :func:`device.resolve`)."""

    def __init__(self, cfg: Optional[MapperConfig] = None, device=None):
        self.cfg = cfg or MapperConfig()
        check_config(self.cfg)
        self.device = resolve(device)
        self.submap = submap_mod.create(self.cfg.submap_capacity, device=self.device)
        self._ref: Optional[icp_mod.ICPReference] = None
        self._scans_since_reinit = 0
        self._map_pose = np.eye(4)
        self._last_insert_pose: Optional[np.ndarray] = None
        self._initialized = False

    @property
    def pose(self) -> np.ndarray:
        return self._map_pose.copy()

    def _T(self, pose: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pose, dtype=torch.float32, device=self.device)

    def add_scan(self, scan: PointBatch, odom_motion: np.ndarray) -> dict:
        """Process one scan; ``odom_motion`` is the relative odometry motion
        since the previous scan. The scan is moved to the mapper's device.
        Returns a stats dict."""
        cfg = self.cfg
        processed = process_scan_for_matching(scan.to(self.device), cfg)

        if not self._initialized:
            self.submap = submap_mod.insert_scan(
                self.submap, processed, self._T(self._map_pose),
                cfg.submap_voxel_size, cfg.submap_crop_radius,
            )
            self._rebuild_reference()
            self._last_insert_pose = self._map_pose.copy()
            self._initialized = True
            return dict(converged=True, inserted=True, degenerate=False)

        guess = self._map_pose @ odom_motion
        if self._scans_since_reinit >= cfg.reference_reinit_every:
            self._rebuild_reference(center=guess[:3, 3])

        res = scan_to_map_step(processed, self._ref, self._T(guess), cfg)
        transform = res.transform.double().cpu().numpy()
        degenerate = bool(res.degenerate)
        overlap = float(res.overlap_ratio)
        finite = bool(np.isfinite(transform).all())
        use_prior = (not finite) or (degenerate and overlap < 0.05)
        new_pose = guess if use_prior else transform
        self._map_pose = new_pose
        self._scans_since_reinit += 1

        inserted = False
        moved = (
            self._last_insert_pose is None
            or np.linalg.norm(new_pose[:3, 3] - self._last_insert_pose[:3, 3])
            >= cfg.min_movement_for_insertion
        )
        if moved and not use_prior:
            self.submap = submap_mod.insert_scan(
                self.submap, processed, self._T(new_pose),
                cfg.submap_voxel_size, cfg.submap_crop_radius,
            )
            self._last_insert_pose = new_pose.copy()
            inserted = True

        return dict(
            converged=bool(res.converged),
            inserted=inserted,
            degenerate=degenerate,
            overlap=overlap,
            iterations=int(res.iterations),
        )

    def _rebuild_reference(self, center=None) -> None:
        if center is None:
            center = self._map_pose[:3, 3]
        self._ref = build_map_reference(self.submap.cloud, self._T(center), self.cfg)
        self._scans_since_reinit = 0

    def map_points(self) -> np.ndarray:
        cloud = self.submap.cloud
        return cloud.xyz[cloud.mask].cpu().numpy()

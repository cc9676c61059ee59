"""Submaps as fixed-capacity device point banks.

Twin of ``open3d_slam_private_tpu/slam/submap.py``: a registered scan is
moved to the map frame, cropped around its origin, concatenated with the
bank and voxel-aggregated back to the bank's capacity, nearest voxels first
under capacity pressure. Space carving erases the bank points a new scan
sees through (a ray with the nearest direction ends well behind the point),
by a hash-grid nearest-neighbour search over unit ray directions; a submap
moved by a pose-graph increment moves rigidly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.ops import grid_hash
from open3d_slam_private_tpu_torch.ops.grid_hash import _sq3
from open3d_slam_private_tpu_torch.ops.pointcloud import PAD_COORD, PointBatch
from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample


@dataclasses.dataclass(frozen=True)
class SubmapState:
    """One submap: map-frame point bank, anchor pose, scans inserted."""

    cloud: PointBatch
    pose: torch.Tensor  # [4, 4]
    num_scans: int


def create(capacity: int, pose: Optional[torch.Tensor] = None, device=None) -> SubmapState:
    """An empty bank of ``capacity`` points on ``device`` (default: the CUDA
    card; see :func:`device.resolve`)."""
    device = resolve(device)
    cloud = PointBatch(
        xyz=torch.full((capacity, 3), PAD_COORD, device=device),
        mask=torch.zeros(capacity, dtype=torch.bool, device=device),
    )
    pose = torch.eye(4, device=device) if pose is None else pose.to(device)
    return SubmapState(cloud=cloud, pose=pose, num_scans=0)


def crop_around(cloud: PointBatch, center: torch.Tensor, radius) -> PointBatch:
    """Keep the points within ``radius`` of ``center``."""
    d2 = _sq3(cloud.xyz - center)
    r = grid_hash.f32(radius, cloud.device)
    return cloud.with_mask(d2 <= r * r)


def insert_scan(
    state: SubmapState, scan: PointBatch, T_map_scan: torch.Tensor, voxel_size, crop_radius
) -> SubmapState:
    """Insert a registered scan (geometry only; normals are recomputed at
    each reference rebuild). The scan moves to the map frame in the rounding
    XLA's CPU backend gives the JAX twin here (``se3.apply_transform_fma``)."""
    posed = crop_around(
        PointBatch(xyz=se3.apply_transform_fma(T_map_scan, scan.xyz), mask=scan.mask),
        T_map_scan[:3, 3],
        crop_radius,
    )
    bank = state.cloud
    merged = PointBatch(
        xyz=torch.cat([bank.xyz, posed.xyz]), mask=torch.cat([bank.mask, posed.mask])
    )
    new_cloud = voxel_downsample(
        merged, voxel_size, capacity=bank.capacity, priority_center=T_map_scan[:3, 3]
    )
    return dataclasses.replace(state, cloud=new_cloud, num_scans=state.num_scans + 1)


def _unit_rays(xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor):
    """Ranges and unit directions from ``origin``; masked rows at PAD_COORD."""
    ray = xyz - origin
    rng = torch.sqrt(_sq3(ray))
    dirs = ray / torch.clamp(rng[:, None], min=1e-9)
    return rng, torch.where(mask[:, None], dirs, PAD_COORD)


def carve(
    state: SubmapState,
    scan: PointBatch,
    T_map_scan: torch.Tensor,
    angle_tol: float = 0.01,
    range_margin: float = 0.3,
    max_range: float = 60.0,
    table_size: int = 1 << 14,
    bucket_cap: int = 16,
) -> SubmapState:
    """Clear the bank points the scan proves to be free space: for bank
    point p (sensor at o), the scan ray of nearest direction (within
    ``angle_tol`` in chord units) measured a range beyond ``|p - o| +
    range_margin``."""
    o = T_map_scan[:3, 3]
    rng, dirs = _unit_rays(se3.apply_transform(T_map_scan, scan.xyz), scan.mask, o)
    grid = grid_hash.build_grid(dirs, scan.mask, 2.0 * angle_tol, table_size, bucket_cap)
    vr, vdirs = _unit_rays(state.cloud.xyz, state.cloud.mask, o)
    res = grid_hash.grid_match(grid, vdirs, state.cloud.mask, k=1, max_dist=angle_tol)
    ids = res.ids[:, 0]
    ray_range = rng[torch.clamp(ids, min=0).long()]
    seen_through = (ids >= 0) & (ray_range > vr + range_margin) & (vr < max_range)
    return dataclasses.replace(state, cloud=state.cloud.with_mask(~seen_through))


def transform_submap(state: SubmapState, T: torch.Tensor) -> SubmapState:
    """Move a submap rigidly by ``T`` (a pose-graph increment)."""
    return dataclasses.replace(state, cloud=state.cloud.transformed(T), pose=T @ state.pose)

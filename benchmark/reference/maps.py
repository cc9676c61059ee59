"""Plain versions of what a SLAM step writes into its maps: the scan's
undistortion, its voxel filter, the submap insert (voxel means over the
bank and the posed scan, nearest range bands kept first when the bank is
full) and the dense map (every inserted point summed into its voxel).

A voxel is ``floor(x / size)`` per axis; a voxel's value is the mean of the
points in it. Positions are worked in float64 where the step's own
arithmetic is not the point (poses, undistortion), and in the dtype given
where it is (the voxel means: float32 for the check, bfloat16 for its
control)."""

from __future__ import annotations

import math

import torch

from reference import se3

_OFF = 1 << 19


def cell_keys(cells: torch.Tensor) -> torch.Tensor:
    """Integer cells ``[N, 3]`` -> one int64 key each, ordered as (x, y, z)."""
    c = cells.long() + _OFF
    return (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]


def key_cells(keys: torch.Tensor) -> torch.Tensor:
    return torch.stack([(keys >> 40) & 0xFFFFF, (keys >> 20) & 0xFFFFF, keys & 0xFFFFF], -1) - _OFF


def cells_of(xyz: torch.Tensor, size: float, by_reciprocal: bool = False) -> torch.Tensor:
    """Voxel cells of float32 points: ``floor(x / size)``, or ``floor(x *
    (1 / size))`` with the reciprocal rounded to float32."""
    x = xyz.float()
    s = torch.tensor(size, dtype=torch.float32, device=x.device)
    return torch.floor(x * (1.0 / s) if by_reciprocal else x / s).long()


def voxel_means(xyz: torch.Tensor, size: float, capacity: int, center=None, by_reciprocal: bool = False,
                dtype=torch.float32):
    """``(keys [V], means [V, 3])`` of the points ``xyz`` in voxels of
    ``size``, at most ``capacity`` voxels: those nearest ``center`` first
    by range bands of 32 voxels (the whole band, then by key), or by key."""
    cells = cells_of(xyz, size, by_reciprocal)
    keys, inv = torch.unique(cell_keys(cells), return_inverse=True)
    sums = torch.zeros((keys.numel(), 3), dtype=dtype, device=xyz.device).index_add_(0, inv, xyz.to(dtype))
    cnt = torch.zeros(keys.numel(), dtype=dtype, device=xyz.device).index_add_(
        0, inv, torch.ones(inv.numel(), dtype=dtype, device=xyz.device))
    means = sums / cnt[:, None]
    if keys.numel() > capacity:
        order = torch.arange(keys.numel(), device=xyz.device)
        if center is not None:
            c = (key_cells(keys).double() + 0.5) * size - torch.as_tensor(center, dtype=torch.float64,
                                                                        device=xyz.device)
            band = torch.clamp(torch.floor(torch.linalg.vector_norm(c, dim=-1) / (32.0 * size)), 0, 63)
            order = torch.sort(band, stable=True).indices  # keys are sorted: (band, key) order
        order = order[:capacity]
        keys, means = keys[order], means[order]
    return keys, means


def undistort(xyz: torch.Tensor, motion: torch.Tensor, dt: float, sweep_s: float) -> torch.Tensor:
    """A clockwise sweep's points moved to the stamp's frame under the
    constant body velocity of ``motion`` (the last scan-to-scan motion over
    ``dt`` s): point i by ``exp((phase_i - 1) twist)``, its phase from its
    azimuth. float64 in and out."""
    twist = se3.log(motion.double()) * (sweep_s / max(dt, 1e-6))
    az = torch.atan2(xyz[:, 1], xyz[:, 0])
    phase = 1.0 - (az + math.pi) / (2.0 * math.pi)
    M = se3.exp((phase - 1.0)[:, None] * twist[None, :])
    return (M[:, :3, :3] @ xyz[:, :, None])[..., 0] + M[:, :3, 3]


def scan_for_matching(xyz: torch.Tensor, crop_radius: float, voxel: float, capacity: int, dtype):
    """The mapper's scan: the points within ``crop_radius`` of the sensor,
    voxel means (the nearest range bands kept) -> ``[V, 3]``."""
    x32 = xyz.float()
    d2 = (x32 * x32).sum(-1)
    keep = d2 <= torch.tensor(crop_radius, dtype=torch.float32) ** 2
    _, means = voxel_means(x32[keep], voxel, capacity, center=(0.0, 0.0, 0.0), by_reciprocal=True, dtype=dtype)
    return means


def submap_insert(bank: torch.Tensor, scan_pts: torch.Tensor, pose: torch.Tensor, voxel: float,
                  crop_radius: float, capacity: int, dtype):
    """The bank's points ``[B, 3]`` after inserting ``scan_pts`` (sensor
    frame) at ``pose``: the posed points within ``crop_radius`` of the
    sensor and the bank's, voxel means over both -> ``(keys, means)``."""
    P = pose.double()
    posed = (scan_pts.double() @ P[:3, :3].transpose(0, 1) + P[:3, 3]).float()
    c = P[:3, 3].float()
    d = posed - c
    near = (d * d).sum(-1) <= torch.tensor(crop_radius, dtype=torch.float32) ** 2
    merged = torch.cat([bank.float(), posed[near]])
    return voxel_means(merged, voxel, capacity, center=P[:3, 3].tolist(), dtype=dtype)


def dense_map(chunks, size: float, dtype=torch.float64):
    """``(keys, counts, means)`` of every point of the posed chunks (float32
    positions in the map frame) summed into voxels of ``size``."""
    keys_all, sums_all, cnt_all = [], [], []
    for xyz in chunks:
        k, inv = torch.unique(cell_keys(cells_of(xyz, size)), return_inverse=True)
        s = torch.zeros((k.numel(), 3), dtype=dtype, device=xyz.device).index_add_(0, inv, xyz.to(dtype))
        n = torch.zeros(k.numel(), dtype=torch.float64, device=xyz.device).index_add_(
            0, inv, torch.ones(inv.numel(), dtype=torch.float64, device=xyz.device))
        keys_all.append(k)
        sums_all.append(s)
        cnt_all.append(n)
    k, inv = torch.unique(torch.cat(keys_all), return_inverse=True)
    s = torch.zeros((k.numel(), 3), dtype=dtype, device=k.device).index_add_(0, inv, torch.cat(sums_all))
    n = torch.zeros(k.numel(), dtype=torch.float64, device=k.device).index_add_(0, inv, torch.cat(cnt_all))
    return k, n, s / n[:, None].to(dtype)

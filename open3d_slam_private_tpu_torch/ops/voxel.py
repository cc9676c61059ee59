"""Exact voxel-grid aggregation.

Twin of ``open3d_slam_private_tpu/ops/voxel.py``: quantise to integer cells,
group equal cells by a lexicographic double stable sort of two packed keys,
take per-voxel means with a segment sum, and keep the first ``capacity``
voxels. With ``priority_center`` the voxels are ranked near-to-far in
distance bands first, so capacity pressure sheds the farthest geometry.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3d_slam_private_tpu_torch.ops.grid_hash import cell_coords, const3, f32, floor_cells, recip
from open3d_slam_private_tpu_torch.ops.pointcloud import PAD_COORD, PointBatch

_AXIS_BITS = 20
_AXIS_OFFSET = 1 << (_AXIS_BITS - 1)
_BIG = 0x7FFFFFFF


def _pack_keys(cell: torch.Tensor):
    """``[N, 3]`` int32 cells -> two lexicographic keys (int64)."""
    c = torch.clamp(cell.to(torch.int64) + _AXIS_OFFSET, 0, (1 << _AXIS_BITS) - 1)
    x, y, z = c.unbind(-1)
    key_hi = x * (1 << 10) + (y >> 10)
    key_lo = (y & 0x3FF) * (1 << _AXIS_BITS) + z
    return key_hi, key_lo


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def voxel_downsample(
    batch: PointBatch,
    voxel_size,
    capacity: Optional[int] = None,
    priority_center=None,
    const_size: bool = False,
) -> PointBatch:
    """Average the valid points (and extra channels) of each voxel of an
    unbatched ``[N]`` PointBatch into a ``[capacity]`` one (normals are
    re-normalised). ``const_size``: the voxel size is a compile-time
    constant of the JAX twin's step, so its two divisions by it (the cell
    and the distance band) are multiplies by the float32 reciprocal
    (``grid_hash.recip``)."""
    dev = batch.device
    capacity = batch.capacity if capacity is None else capacity
    vs = f32(voxel_size, dev)
    cell = floor_cells(batch.xyz, vs, recip(vs) if const_size else None)
    key_hi, key_lo = _pack_keys(cell)
    key_hi = torch.where(batch.mask, key_hi, _BIG)
    key_lo = torch.where(batch.mask, key_lo, _BIG)

    order0 = _stable_argsort(key_lo)
    order = order0[_stable_argsort(key_hi[order0])]
    if priority_center is not None:
        center = const3(priority_center, dev)
        d = (cell.float() + 0.5) * vs - center
        dist = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        band_m = 32.0 * vs
        band = torch.clamp(cell_coords(dist, band_m, recip(band_m) if const_size else None),
                           0.0, 63.0).to(torch.int32)
        band = torch.where(batch.mask, band, 64)
        order = order[_stable_argsort(band[order])]
    s_hi, s_lo = key_hi[order], key_lo[order]
    s_mask = batch.mask[order]

    new_seg = torch.ones_like(s_mask)
    new_seg[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    # Invalid points and voxels past ``capacity`` go to the dropped segment.
    seg_id = torch.clamp(torch.where(s_mask, seg_id, capacity), max=capacity)

    ones = s_mask.float()
    # seg_id is non-decreasing (invalid points sort last), so every segment
    # is one contiguous run: its length comes from a binary search, and a
    # segmented reduction adds each run in a fixed order. No atomics, so the
    # sums are the same bits on every run (``index_add_`` on CUDA is not).
    bounds = torch.searchsorted(seg_id, torch.arange(capacity + 2, device=dev))
    lengths = bounds[1:] - bounds[:-1]

    def segment_sum(vals: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)[:capacity]

    counts = segment_sum(ones)
    out_mask = counts > 0
    denom = torch.clamp(counts, min=1.0)[:, None]
    sums = segment_sum(batch.xyz[order] * ones[:, None])
    out_xyz = torch.where(out_mask[:, None], sums / denom, PAD_COORD)

    extras = {}
    for name, vals in batch.extras.items():
        avg = segment_sum(vals[order] * ones[:, None]) / denom
        if name == "normals":
            avg = avg / torch.clamp(torch.linalg.vector_norm(avg, dim=-1, keepdim=True), min=1e-12)
        extras[name] = torch.where(out_mask[:, None], avg, 0.0)
    return PointBatch(xyz=out_xyz, mask=out_mask, extras=extras)

"""PointBatch — the fixed-shape, masked point-cloud container.

Twin of ``open3d_slam_private_tpu/ops/pointcloud.py``: padded
``[..., N, 3]`` coordinates with a validity ``mask [..., N]``; "removing" a
point clears its mask bit, padded slots sit at ``PAD_COORD``. Named
per-point channels (normals, ...) live in ``extras``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

# Large finite coordinate for padded slots: keeps them out of every radius,
# voxel and match query without putting NaN or inf into reductions.
PAD_COORD = 1.0e9


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Padded point cloud(s): ``xyz [..., N, 3]`` float32, ``mask [..., N]``
    bool, ``extras`` name -> ``[..., N, d]`` (normals under ``"normals"``)."""

    xyz: torch.Tensor
    mask: torch.Tensor
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> torch.Tensor:
        """Number of valid points, ``[...]`` int32."""
        return self.mask.sum(-1, dtype=torch.int32)

    @property
    def normals(self) -> Optional[torch.Tensor]:
        return self.extras.get("normals")

    def with_extras(self, **channels: torch.Tensor) -> "PointBatch":
        return dataclasses.replace(self, extras={**self.extras, **channels})

    def with_mask(self, mask: torch.Tensor) -> "PointBatch":
        """Intersect validity with ``mask`` (does not touch xyz)."""
        return dataclasses.replace(self, mask=self.mask & mask)

    def padded_xyz(self) -> torch.Tensor:
        """xyz with padded slots pushed to PAD_COORD."""
        return torch.where(self.mask[..., None], self.xyz, PAD_COORD)

    def to(self, device) -> "PointBatch":
        """The same batch on ``device`` (no copy where it already lies there)."""
        return PointBatch(
            xyz=self.xyz.to(device), mask=self.mask.to(device),
            extras={k: v.to(device) for k, v in self.extras.items()},
        )

    def transformed(self, T: torch.Tensor) -> "PointBatch":
        """Apply a ``[..., 4, 4]`` rigid transform; rotates normals too."""
        from open3d_slam_private_tpu_torch.geometry import se3

        extras = dict(self.extras)
        if "normals" in extras:
            extras["normals"] = se3.apply_rotation(T, extras["normals"])
        return dataclasses.replace(self, xyz=se3.apply_transform(T, self.xyz), extras=extras)


def from_points(points, capacity: Optional[int] = None, extras=None, device=None) -> PointBatch:
    """Single PointBatch from ``[n, 3]`` points, padded (or truncated) to
    ``capacity``."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    device = points.device
    n = points.shape[0]
    capacity = n if capacity is None else capacity
    extras = {
        k: torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in (extras or {}).items()
    }
    if n >= capacity:
        return PointBatch(
            xyz=points[:capacity],
            mask=torch.ones(capacity, dtype=torch.bool, device=device),
            extras={k: v[:capacity] for k, v in extras.items()},
        )
    pad = capacity - n
    xyz = torch.cat([points, torch.full((pad, 3), PAD_COORD, device=device)])
    mask = torch.arange(capacity, device=device) < n
    extras = {
        k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) for k, v in extras.items()
    }
    return PointBatch(xyz=xyz, mask=mask, extras=extras)


def stack(batches) -> PointBatch:
    """Stack same-capacity PointBatches along a new leading batch axis."""
    batches = list(batches)
    names = batches[0].extras.keys()
    return PointBatch(
        xyz=torch.stack([b.xyz for b in batches]),
        mask=torch.stack([b.mask for b in batches]),
        extras={k: torch.stack([b.extras[k] for b in batches]) for k in names},
    )


_SUM_WINDOW = 32


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x [..., n]`` over its last axis in XLA's CPU order: while
    more than 32 remain, sum windows of 32 (zeros padded to a multiple of
    32, half before the values and the rest after), each from 0 left to
    right in float32; then the last <= 32 the same way. The order is fixed
    by ``n`` alone, on every device."""
    def run(v):
        s = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
        for j in range(v.shape[-1]):
            s = s + v[..., j]
        return s

    while x.shape[-1] > _SUM_WINDOW:
        pad = -x.shape[-1] % _SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = run(x.reshape(*x.shape[:-1], -1, _SUM_WINDOW))
    return run(x)


def masked_centroid(batch: PointBatch, xla_order: bool = False) -> torch.Tensor:
    """``[..., 3]`` centroid of the valid points (zero when empty). With
    ``xla_order`` the sum runs in XLA's CPU order (:func:`_ordered_sum`,
    about 100 small launches on a card) and the centroid equals the JAX
    package's bit for bit."""
    m = batch.mask[..., None].to(batch.xyz.dtype)
    xm = batch.xyz * m
    s = _ordered_sum(xm.transpose(-1, -2)) if xla_order else xm.sum(-2)
    c = m.sum(-2)
    return s / torch.clamp(c, min=1.0)


def masked_quantile(values: torch.Tensor, mask: torch.Tensor, q, axis: int = -1) -> torch.Tensor:
    """Reference-compatible quantile over the masked entries along ``axis``
    (``Matches::getDistsQuantile``): the element at index ``floor(count *
    q)`` (clamped to ``count - 1``) of the ascending valid values, an
    nth-element pick rather than an interpolation; ``q == 1`` is the max."""
    big = torch.finfo(values.dtype).max
    svals = torch.sort(torch.where(mask, values, big), dim=axis).values
    count = mask.sum(axis, dtype=torch.int32)
    n = values.shape[axis]
    qf = (q.to(values.device, torch.float32) if torch.is_tensor(q)
          else torch.full((), float(q), dtype=torch.float32, device=values.device))
    idx = torch.minimum((count.float() * qf).to(torch.int32), torch.clamp(count - 1, min=0))
    idx = torch.clamp(idx, 0, n - 1).to(torch.int64)
    return torch.take_along_dim(svals, idx.unsqueeze(axis), dim=axis).squeeze(axis)

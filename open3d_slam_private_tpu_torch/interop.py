"""Build this package's objects from the JAX package's state.

Every function takes array-likes (numpy arrays, or anything ``np.asarray``
reads) laid out as in the JAX package, and returns the port's object on
``device``. The parity tests use it to feed the port exactly the table,
reference or submap the JAX side built. Configs are rebuilt field by field
from ``dataclasses.asdict`` of the JAX config, nested configs included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from open3d_slam_private_tpu_torch.models.icp import ICPReference
from open3d_slam_private_tpu_torch.ops.cell_list import CellList
from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch
from open3d_slam_private_tpu_torch.slam.submap import SubmapState


def tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A contiguous tensor holding ``np.asarray(a)`` (bit-exact copy)."""
    return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(device=device, dtype=dtype)


def point_batch(xyz, mask, extras=None, device=None) -> PointBatch:
    return PointBatch(
        xyz=tensor(xyz, device, torch.float32),
        mask=tensor(mask, device, torch.bool),
        extras={k: tensor(v, device, torch.float32) for k, v in (extras or {}).items()},
    )


def cell_list(table, cell_size, dropped=0, device=None) -> CellList:
    return CellList(
        table=tensor(table, device, torch.float32),
        cell_size=tensor(cell_size, device, torch.float32),
        dropped=tensor(dropped, device, torch.int32),
    )


def icp_reference(cloud_xyz, cloud_mask, normals, centroid, table=None, cell_size=None, dropped=0,
                  device=None) -> ICPReference:
    """A reference with its cell list, or with none (``table=None``: the
    brute matchers' reference, whose JAX twin has ``grid=None``)."""
    extras = {} if normals is None else {"normals": normals}
    return ICPReference(
        cloud=point_batch(cloud_xyz, cloud_mask, extras, device),
        centroid=tensor(centroid, device, torch.float32),
        grid=None if table is None else cell_list(table, cell_size, dropped, device),
    )


def submap_state(xyz, mask, pose, num_scans, device=None) -> SubmapState:
    return SubmapState(
        cloud=point_batch(xyz, mask, device=device),
        pose=tensor(pose, device, torch.float32),
        num_scans=int(np.asarray(num_scans)),
    )


def config(cls, values):
    """``cls(**values)`` where ``values`` is ``dataclasses.asdict`` of the
    twin config (or the twin config itself); nested config fields are
    rebuilt as the port's nested config classes."""
    if dataclasses.is_dataclass(values) and not isinstance(values, type):
        values = dataclasses.asdict(values)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
            if dataclasses.is_dataclass(default):
                v = config(type(default), v)
        kwargs[f.name] = v
    return cls(**kwargs)


def rt_state_from_jax(state, device=None):
    """The port's ``slam.realtime.RtState`` from a JAX ``RtState`` (its
    arrays read with ``np.asarray``): the odometry's previous scan, the
    motion and pose, the scan-to-map reference with its cell list (queries
    divide: the twin hands it to the next step as an argument), the cadence
    counters and the active bank."""
    from open3d_slam_private_tpu_torch.slam.realtime import RtState

    op, ref, bank = state.odom_prev, state.ref, state.bank
    return RtState(
        odom_prev=point_batch(op.xyz, op.mask, dict(op.extras), device),
        last_motion=tensor(state.last_motion, device, torch.float32),
        map_pose=tensor(state.map_pose, device, torch.float32),
        ref=icp_reference(ref.cloud.xyz, ref.cloud.mask, ref.cloud.extras.get("normals"), ref.centroid,
                          table=ref.grid.table, cell_size=ref.grid.cell_size, dropped=ref.grid.dropped,
                          device=device),
        scans_since_reinit=tensor(state.scans_since_reinit, device, torch.int32),
        last_insert_pos=tensor(state.last_insert_pos, device, torch.float32),
        bank=submap_state(bank.cloud.xyz, bank.cloud.mask, bank.pose, bank.num_scans, device),
        scans_in_active=tensor(state.scans_in_active, device, torch.int32),
    )

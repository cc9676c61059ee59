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


def pose_graph(graph, device=None):
    """The port's ``slam.pose_graph.PoseGraph`` from a JAX ``PoseGraph``."""
    from open3d_slam_private_tpu_torch.slam.pose_graph import PoseGraph

    dtypes = dict(poses=torch.float32, node_mask=torch.bool, edge_i=torch.int32, edge_j=torch.int32,
                  edge_T=torch.float32, edge_info=torch.float32, edge_is_loop=torch.bool,
                  edge_mask=torch.bool)
    return PoseGraph(**{k: tensor(getattr(graph, k), device, dt) for k, dt in dtypes.items()})


def loop_constraints(constraints):
    """The port's ``LoopClosureConstraint`` list from the JAX package's
    (host numpy fields, copied)."""
    from open3d_slam_private_tpu_torch.slam.place_recognition import LoopClosureConstraint

    return [LoopClosureConstraint(
        source_idx=int(c.source_idx), target_idx=int(c.target_idx),
        T_target_source=np.array(c.T_target_source, np.float64), overlap=float(c.overlap),
        residual=float(c.residual), information=np.array(c.information, np.float64))
        for c in constraints]


def submap_collection(collection, cfg=None, device=None):
    """The port's ``SubmapCollection`` from a JAX one: its config (or
    ``cfg``), each submap's cloud, pose, scan count, anchor, parent and
    finished flag, the adjacency, the active index, the finished queue and
    the cadence state."""
    from open3d_slam_private_tpu_torch.slam import submap_collection as sc

    out = sc.SubmapCollection(cfg or config(sc.SubmapCollectionConfig, collection.cfg), device=device)
    for e in collection.submaps:
        cloud = e.state.cloud
        out.submaps.append(sc.SubmapEntry(
            state=submap_state(cloud.xyz, cloud.mask, e.state.pose, e.state.num_scans, out.device),
            anchor=np.array(e.anchor, np.float64), parent=e.parent, finished=bool(e.finished)))
    for i, nbs in collection.adjacency._adj.items():
        for j in nbs:
            out.adjacency.add_edge(i, j)
    out.active_idx = collection.active_idx
    out.finished_queue = list(collection.finished_queue)
    out._scans_in_active = collection._scans_in_active
    out._force_new_submap = collection._force_new_submap
    return out

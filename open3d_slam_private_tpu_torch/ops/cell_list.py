"""Precomputed cell candidate lists — the scan-to-map matcher structure.

Twin of ``open3d_slam_private_tpu/ops/cell_list.py`` (unpacked 32-byte
payloads). Cells have side = search radius; each occupied cell's row of
``table [T, C, 8]`` lists every reference point within the radius of any
query in that cell. A query then needs one row gather and a distance
re-rank. Under row overflow the points nearest the cell centre win, with
ties broken by pair index, so the table equals the JAX package's bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_slam_private_tpu_torch.ops.grid_hash import (
    MatchResult,
    _cell_hash,
    _sq3,
    f32,
    floor_cells,
    match_from_candidates,
    payload_ids,
    recip,
    run_ranks,
    scatter_payload,
    _CH,
)


@dataclasses.dataclass(frozen=True)
class CellList:
    """``table [T, C, 8]`` payload lists; ``cell_size`` = search radius
    (0-d float32); ``dropped``: eligible (cell, point) pairs that did not
    fit in ``list_cap`` (0 means the lists are exact); ``cell_inv``: the
    reciprocal queries multiply by (``grid_hash.recip``) where the JAX twin
    builds and queries the lists in one jitted step of a static config;
    None: queries divide."""

    table: torch.Tensor
    cell_size: torch.Tensor
    dropped: torch.Tensor
    cell_inv: Optional[torch.Tensor] = None

    @property
    def list_cap(self) -> int:
        return self.table.shape[1]

    @property
    def table_size(self) -> int:
        return self.table.shape[0]


def build_cell_list(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    radius,
    table_size: int = 1 << 16,
    list_cap: int = 64,
    normals: Optional[torch.Tensor] = None,
    const_size: bool = False,
) -> CellList:
    """Point p is listed in cell c iff ``dist(p, box(c)) <= radius``; one
    stable sort on the key ``hash << 13 | quantised centre distance``.
    ``const_size``: the radius is a compile-time constant of the JAX twin's
    step, so cells come from its ``grid_hash.recip`` (and so do the lists'
    queries)."""
    if table_size > (1 << 17):
        raise ValueError(
            "cell-list table_size is limited to 2^17 (the build's composite "
            f"sort key uses 18 hash bits + 13 priority bits), got {table_size}"
        )
    dev = xyz.device
    r = f32(radius, dev)
    inv = recip(r) if const_size else None
    cell = floor_cells(xyz, r, inv)
    # The 27 neighbour offsets (x slowest), made on the device (no
    # host-to-device copy).
    i = torch.arange(27, dtype=torch.int32, device=dev)[:, None]
    offsets = torch.cat([i // 9, i // 3 % 3, i % 3], 1) - 1
    tgt = cell[:, None, :] + offsets[None, :, :]  # [M, 27, 3]

    p = xyz[:, None, :]
    lo = tgt.float() * r
    hi = lo + r
    dx = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    eligible = (_sq3(dx) <= r * r) & mask[:, None]
    ctr_d2 = _sq3(p - (lo + 0.5 * r))

    flat_h = torch.where(eligible, _cell_hash(tgt, table_size), table_size).reshape(-1)
    scale = torch.full_like(r, 8191.0) / (4.0 * r * r)
    qd = torch.clamp(ctr_d2.reshape(-1) * scale, 0.0, 8191.0).to(torch.int32)
    sorted_key, order = torch.sort(flat_h * 8192 + qd, stable=True)
    s_h = sorted_key >> 13
    s_pt = order // 27
    rank = run_ranks(s_h)
    in_table = (s_h < table_size) & (rank < list_cap)
    slot = torch.where(in_table, s_h * list_cap + rank, table_size * list_cap)
    table = scatter_payload(table_size * list_cap, slot, s_pt, xyz, normals)
    dropped = ((s_h < table_size) & (rank >= list_cap)).sum(dtype=torch.int32)
    return CellList(
        table=table[:-1].reshape(table_size, list_cap, _CH), cell_size=r, dropped=dropped,
        cell_inv=inv,
    )


def query_hash(cl: CellList, query_xyz: torch.Tensor) -> torch.Tensor:
    """Row index (cell hash) of each query ``[..., 3]`` -> ``[...]`` int32."""
    return _cell_hash(floor_cells(query_xyz, cl.cell_size, cl.cell_inv), cl.table_size)


def gather_cell_candidates(cl: CellList, query_xyz: torch.Tensor, query_mask: torch.Tensor):
    """One row gather per query: ``rows [..., C, 8]``, ``valid [..., C]``."""
    rows = cl.table[query_hash(cl, query_xyz)]
    valid = (payload_ids(rows) >= 0) & query_mask[..., None]
    return rows, valid


def cell_match(
    cl: CellList, query_xyz: torch.Tensor, query_mask: torch.Tensor, k: int = 1, max_dist=None
) -> MatchResult:
    """Exact within-radius k nearest neighbours through the lists (one row
    gather + re-rank); the radius defaults to the cell size."""
    radius = cl.cell_size if max_dist is None else max_dist
    rows, valid = gather_cell_candidates(cl, query_xyz, query_mask)
    return match_from_candidates(rows, valid, query_xyz, query_mask, radius, k)

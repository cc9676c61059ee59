"""K4: rank + select the knn = 1 winner of a query's cell-list row.

Replaces ``rank_select_rows``
(``open3d_slam_private_tpu/kernels/select_pallas.py:117``), the per-round
selection of ``ICPConfig(select_kernel=True)``, with two entries of one
function:

- :func:`rank_select_rows` on rows gathered beforehand (``[N, cap * 8]``),
  the Pallas kernel's own contract; its CUDA kernel is
  ``csrc/rank_select.cu`` (rank routine ``csrc/rank_select.cuh``), its plain
  version :func:`rank_select_rows_plain`;
- :func:`rank_select_table` on the cell-list ``table [T, cap, 8]`` and the
  row index ``h [N]``: the same function on ``table.reshape(T, -1)[h]``
  without gathering the rows, through K2's grouped machinery
  (``csrc/gather_select.cu`` with K4's contract); its plain version is
  :func:`rank_select_table_plain`. The select leg of ``models/icp.py``
  calls this entry, at any row width whose staging fits in a block's
  shared memory (the kernel refuses wider rows).

Each runs its plain version for CPU tensors and its kernel for CUDA tensors,
with no fallback between them.

For query i and its cell-list row (cap candidates of x, y, z, id bits, nx,
ny, nz, 0) the output row ``[16]`` holds the winner's x, y, z, id bits, nx,
ny, nz, the winner's squared distance, the row occupancy and 7 zeros. Every
slot competes: padded slots carry ``xyz = 1e9``, so they lose to any real
candidate and an empty row's distance is finite (~3e18); a masked query sees
inf everywhere. The winner is the first slot at the minimum; occupancy
counts the slots whose ``x < 1e8``. :func:`match_result_from_selected`
turns the rows into a knn=1 ``MatchResult``.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.kernels.gather_select import (  # noqa: F401  (re-export)
    N_OUT,
    launch_grouped,
    match_result_from_selected,
)
from open3d_slam_private_tpu_torch.ops.grid_hash import _sq3
from open3d_slam_private_tpu_torch.ops.knn import INF

_P, _I = ctypes.c_void_p, ctypes.c_int
# rank_select_launch(rows, query, mask, N, cap, out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _I, _I, _P, _P]


def rank_select_rows_plain(rows, query_xyz, query_mask):
    """Plain PyTorch K4 -> ``[N, 16]`` float32 (payload words copied as bits)."""
    n = rows.shape[0]
    cand = rows.reshape(n, -1, 8)
    d2 = _sq3(cand[..., :3] - query_xyz[:, None, :])
    d2 = torch.where(query_mask.bool()[:, None], d2, INF)
    best = d2.min(-1).values
    win = (d2 <= best[:, None]).to(torch.int8).argmax(-1)
    bits = cand.view(torch.int32)[torch.arange(n, device=rows.device), win]  # [N, 8]
    out = torch.zeros((n, N_OUT), dtype=torch.int32, device=rows.device)
    out[:, :7] = bits[:, :7]
    out[:, 7] = best.view(torch.int32)
    out[:, 8] = (cand[..., 0] < 1e8).sum(-1).float().view(torch.int32)
    return out.view(torch.float32)


def rank_select_rows(rows, query_xyz, query_mask):
    """K4 on ``rows [N, cap * 8]`` float32, ``query_xyz [N, 3]`` float32 and
    ``query_mask [N]`` bool or uint8 -> ``[N, 16]``. CPU tensors take
    :func:`rank_select_rows_plain`; CUDA tensors launch the kernel (counted
    in ``rank_select_rows.launches``) or raise."""
    dev = rows.device
    if dev.type == "cpu":
        return rank_select_rows_plain(rows, query_xyz, query_mask)
    if dev.type != "cuda":
        raise ValueError(f"rank_select_rows: unsupported device {dev}")
    if rows.dim() != 2 or rows.shape[1] % 8 or rows.shape[1] == 0:
        raise ValueError(f"rows: shape {tuple(rows.shape)}, expected [N, cap * 8]")
    N, L = rows.shape
    _build.check_tensor("rows", rows, (N, L), (torch.float32,), dev)
    _build.check_tensor("query_xyz", query_xyz, (N, 3), (torch.float32,), dev)
    _build.check_tensor("query_mask", query_mask, (N,), (torch.bool, torch.uint8), dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned (candidates are read as 16-byte words)")
    out = torch.empty((N, N_OUT), dtype=torch.float32, device=dev)
    lib = _build.load("rank_select", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rank_select_launch(
            rows.data_ptr(), query_xyz.data_ptr(), query_mask.view(torch.uint8).data_ptr(),
            N, L // 8, out.data_ptr(), stream,
        )
    _build.check_launch(lib, "rank_select", rc)
    _build.count_launch(rank_select_rows)
    return out


rank_select_rows.launches = 0


def rank_select_table_plain(table, h, query_xyz, query_mask):
    """Plain PyTorch K4 on the rows ``table.reshape(T, -1)[h]``."""
    return rank_select_rows_plain(table.reshape(table.shape[0], -1)[h.long()], query_xyz, query_mask)


def rank_select_table(table, h, query_xyz, query_mask):
    """K4 on ``table [T, cap, 8]`` float32 and ``h [N]`` int32 row indices
    in ``[0, T)``, ``query_xyz [N, 3]`` float32 and ``query_mask [N]`` bool
    or uint8 -> ``[N, 16]``, the rows read in place. CPU tensors take
    :func:`rank_select_table_plain`; CUDA tensors launch the kernel (counted
    in ``rank_select_table.launches``; five ``__global__`` functions: K2's
    count, rowsum, scan, scatter and its rank kernel with K4's contract) or
    raise. A row index outside ``[0, T)`` is outside the contract (the plain
    version indexes as PyTorch does; the kernel writes K2's INVALID row)."""
    if table.device.type == "cpu":
        return rank_select_table_plain(table, h, query_xyz, query_mask)
    out = launch_grouped("rank_select_table", table, h, query_xyz, query_mask, by_coords=True)
    _build.count_launch(rank_select_table)
    return out


rank_select_table.launches = 0

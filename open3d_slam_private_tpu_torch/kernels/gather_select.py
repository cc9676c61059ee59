"""K2: fused cell-list row gather + rank + select (knn = 1).

Replaces ``gather_select``
(``open3d_slam_private_tpu/kernels/gather_select_pallas.py:207``). The CUDA
kernel is ``csrc/gather_select.cu`` (the queries grouped by row, then each
row ranked from one staged copy); :func:`gather_select_plain` is the same
function in plain PyTorch. :func:`gather_select` runs the plain version for
CPU tensors and the kernel for CUDA tensors, with no fallback between them.

For query i with row index ``h[i]`` into the cell-list ``table [T, cap, 8]``
the output row ``[16]`` holds the winner's x, y, z, id bits, nx, ny, nz, the
winner's squared distance (inf when the row has no valid candidate or the
query is masked out), the row occupancy and 7 zeros. The winner is the first
slot at the minimum distance. :func:`match_result_from_selected` turns the
rows into a knn=1 ``MatchResult``.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.ops.grid_hash import MatchResult, _sq3, f32, payload_ids
from open3d_slam_private_tpu_torch.ops.knn import INF, INVALID_ID

N_OUT = 16
# The rank kernel's grid: 16 blocks of 8 warps an H100 SM, two waves of the 8
# that fit at once (it walks the work items with a grid stride); one wave
# measured slower on the headline's queries.
_RANK_BLOCKS = 132 * 16
_P, _I = ctypes.c_void_p, ctypes.c_int
# gather_select_launch(table, h, query, mask, N, T, cap, count, scratch, rank_blocks, by_coords,
#                      out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P]
_COUNT: dict = {}  # device -> int32 row counts, zero between calls
_SCRATCH: dict = {}  # device -> int32 scratch


def scratch_words(N: int, T: int) -> int:
    """int32 words of the kernel's scratch (``csrc/gather_select.cu``
    ``Work``): the work items, the row blocks' totals, the row offsets, the
    item count, the grouped order and each query's place in its row."""
    return 2 * N + 4 * (-(-N // 32) + T) + T + 2 * -(-T // 1024) + 3


def _buffers(dev, N: int, T: int):
    count = _COUNT.get(dev)
    if count is None or count.numel() < T:
        _build.no_capture("gather_select")
        count = _COUNT[dev] = torch.zeros(T, dtype=torch.int32, device=dev)
    words = scratch_words(N, T)
    scratch = _SCRATCH.get(dev)
    if scratch is None or scratch.numel() < words:
        _build.no_capture("gather_select")
        scratch = _SCRATCH[dev] = torch.empty(words, dtype=torch.int32, device=dev)
    return count, scratch


def gather_select_plain(table, h, query_xyz, query_mask):
    """Plain PyTorch K2 -> ``[N, 16]`` float32 (payload words copied as bits);
    an ``h`` outside ``[0, T)`` gives the INVALID row (id -1, d2 inf, zeros)."""
    inside = (h >= 0) & (h < table.shape[0])
    h = torch.where(inside, h, 0)
    rows = table[h.long()]  # [N, cap, 8]
    ids = payload_ids(rows)
    validc = ids >= 0
    d2 = _sq3(rows[..., :3] - query_xyz[:, None, :])
    d2 = torch.where(validc & query_mask.bool()[:, None], d2, INF)
    best = d2.min(-1).values
    win = (d2 <= best[:, None]).to(torch.int8).argmax(-1)
    bits = table.view(torch.int32)[h.long(), win]  # [N, 8]
    out = torch.zeros((h.shape[0], N_OUT), dtype=torch.int32, device=table.device)
    out[:, :7] = bits[:, :7]
    out[:, 7] = best.view(torch.int32)
    out[:, 8] = validc.sum(-1).float().view(torch.int32)
    invalid = torch.zeros(N_OUT, dtype=torch.int32, device=table.device)
    invalid[3] = INVALID_ID
    invalid[7] = 0x7F800000  # the bits of +inf
    out = torch.where(inside[:, None], out, invalid)
    return out.view(torch.float32)


def gather_select(table, h, query_xyz, query_mask):
    """K2 on ``table [T, cap, 8]`` float32, ``h [N]`` int32 row indices,
    ``query_xyz [N, 3]`` float32 and ``query_mask [N]`` bool or uint8 ->
    ``[N, 16]``. CPU tensors take :func:`gather_select_plain`; CUDA
    tensors launch the kernel (counted in ``gather_select.launches``; five
    ``__global__`` functions: count, rowsum, scan, scatter, rank) or raise.
    An ``h`` outside ``[0, T)`` gives the INVALID row."""
    dev = table.device
    if dev.type == "cpu":
        return gather_select_plain(table, h, query_xyz, query_mask)
    out = launch_grouped("gather_select", table, h, query_xyz, query_mask, by_coords=False)
    _build.count_launch(gather_select)
    return out


gather_select.launches = 0


def launch_grouped(name, table, h, query_xyz, query_mask, by_coords: bool):
    """Check the inputs and launch ``csrc/gather_select.cu`` on CUDA tensors
    -> ``[N, 16]``: K2's contract, or K4's with ``by_coords`` (the table
    entry of ``kernels/select.py``). ``name`` names the caller in errors."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if table.dim() != 3:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected [T, cap, 8]")
    T, cap = table.shape[0], table.shape[1]
    N = h.shape[0]
    _build.check_tensor("table", table, (T, cap, 8), (torch.float32,), dev)
    _build.check_tensor("h", h, (N,), (torch.int32,), dev)
    _build.check_tensor("query_xyz", query_xyz, (N, 3), (torch.float32,), dev)
    _build.check_tensor("query_mask", query_mask, (N,), (torch.bool, torch.uint8), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel reads rows as 16-byte words; it must be 16-byte aligned")
    out = torch.empty((N, N_OUT), dtype=torch.float32, device=dev)
    count, scratch = _buffers(dev, N, T)
    lib = _build.load("gather_select", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_select_launch(
            table.data_ptr(), h.data_ptr(), query_xyz.data_ptr(), query_mask.data_ptr(), N, T,
            cap, count.data_ptr(), scratch.data_ptr(), _RANK_BLOCKS, int(by_coords),
            out.data_ptr(), stream,
        )
    _build.check_launch(lib, "gather_select", rc)
    return out


def match_result_from_selected(sel, query_mask, max_d2) -> MatchResult:
    """``[..., 16]`` selected rows -> a knn=1 ``MatchResult`` (the contract
    of ``match_from_candidates``): winners beyond ``max_d2``, without a
    candidate or of masked queries become invalid."""
    bd = sel[..., 7]
    ids = sel.view(torch.int32)[..., 3]
    bad = (bd > f32(max_d2, sel.device)) | ~torch.isfinite(bd) | ~query_mask
    return MatchResult(
        dists=torch.where(bad, INF, bd)[..., None],
        ids=torch.where(bad, INVALID_ID, ids)[..., None],
        xyz=torch.where(bad[..., None], 0.0, sel[..., :3])[..., None, :],
        normals=torch.where(bad[..., None], 0.0, sel[..., 4:7])[..., None, :],
    )

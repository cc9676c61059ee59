"""K2: fused cell-list row gather + rank + select (knn = 1).

Replaces ``gather_select``
(``open3d_slam_private_tpu/kernels/gather_select_pallas.py:207``). The CUDA
kernel is ``csrc/gather_select.cu`` (the queries grouped by row as 16-byte
records, then each row ranked from one copy staged by the bulk copy engine;
its scratch and grid from :func:`k2_plan`, each call's own, so a CUDA graph
that holds a call holds nothing a later call frees; the grouping modelled
by ``tests/gather_select_model.py``); :func:`gather_select_plain` is the same
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
import dataclasses

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.ops.grid_hash import MatchResult, _sq3, f32, payload_ids
from open3d_slam_private_tpu_torch.ops.knn import INF, INVALID_ID

N_OUT = 16
K2_Q = 32  # queries a work item: one a lane of a rank warp
K2_WARPS = 8  # rank warps a block
K2_SCAN_ROWS = 1024  # rows a scan block
K2_RECORD_WORDS = 4  # a grouped query's record: x, y, z bits, index | mask << 31
K2_SMS = 132  # an H100 SXM's SMs: the unit of the rank grid
K2_SM_SMEM = 233472  # shared memory of an H100 SM (228 KB)
K2_BLOCK_SMEM = 232448  # a block's opt-in maximum on an H100 (227 KB)
K2_BLOCK_RESERVED = 1024  # shared memory the runtime keeps for each block
K2_MAX_N = (1 << 31) - 1  # the record's index has 31 bits
K2_MAX_T = 1 << 30  # the scan's packed item prefix stays below 2^31
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# gather_select_launch(table, h, query, mask, N, T, cap, scratch, scratch_words, rank_blocks,
#                      block_smem, by_coords, out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _L, _I, _I, _P, _L, _I, _I, _I, _P, _P]


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """One K2 call's scratch and rank grid (``csrc/gather_select.cu``
    ``make_plan`` computes the same and refuses a mismatch). The scratch is
    int32 words; each field below is a word offset into it:

    - ``records``: ``[N]`` 16-byte records in grouped order;
    - ``items``: ``[max_items]`` work items (row, first position, queries, 0);
    - ``state``: ``[row_blocks]`` 64-bit look-back words of the scan;
    - ``ticket``: the scan blocks' ticket counter;
    - ``count``: ``[T]`` row counts;
    - ``offset``: ``[T]`` each row's first position in the grouped order,
      then the scatter's cursor;
    - ``n_items``: the work item count.

    The call's memset zeroes ``zero_words`` words from ``state`` (the
    look-back words, the ticket and the row counts): nothing has to be zero
    on entry. ``warp_smem`` / ``block_smem`` are the rank kernel's shared
    memory bytes a warp (:func:`k2_warp_smem`) and a block; ``rank_blocks``
    is its grid: ``K2_SMS`` times the blocks an SM holds by shared memory,
    at most 8."""

    row_blocks: int
    max_items: int
    records: int
    items: int
    state: int
    ticket: int
    count: int
    offset: int
    n_items: int
    words: int
    zero_words: int
    warp_smem: int
    block_smem: int
    rank_blocks: int


def k2_warp_smem(cap: int) -> int:
    """Shared memory bytes of a rank warp at ``cap`` slots a row: two
    mbarriers and two stages of a row and 32 records, each at least the 2 KB
    of the 32 output rows that go through it."""
    return 16 + 2 * max(cap * 32 + K2_Q * K2_RECORD_WORDS * 4, K2_Q * N_OUT * 4)


def k2_max_cap(block_smem: int = K2_BLOCK_SMEM) -> int:
    """The widest row (slots) whose rank block fits in ``block_smem`` bytes
    (437 on an H100); the launcher refuses wider rows."""
    return (block_smem // K2_WARPS - 16 - 2 * K2_Q * K2_RECORD_WORDS * 4) // 64


def k2_plan(N: int, T: int, cap: int) -> K2Plan:
    """K2's plan for ``N`` queries into a ``[T, cap, 8]`` table; raises
    ValueError outside ``0 <= N < 2^31``, ``1 <= T <= 2^30``, ``cap >= 1``."""
    if not (0 <= N <= K2_MAX_N and 1 <= T <= K2_MAX_T and cap >= 1):
        raise ValueError(f"gather_select: N={N}, T={T}, cap={cap} outside 0 <= N < 2^31, "
                         "1 <= T <= 2^30, cap >= 1")
    row_blocks = -(-T // K2_SCAN_ROWS)
    max_items = -(-N // K2_Q) + min(N, T)
    items = K2_RECORD_WORDS * N
    state = items + 4 * max_items
    ticket = state + 2 * row_blocks
    count = ticket + 1
    offset = count + T
    n_items = offset + T
    warp_smem = k2_warp_smem(cap)
    block_smem = K2_WARPS * warp_smem
    per_sm = max(1, min(8, K2_SM_SMEM // (block_smem + K2_BLOCK_RESERVED)))
    return K2Plan(row_blocks=row_blocks, max_items=max_items, records=0, items=items, state=state,
                  ticket=ticket, count=count, offset=offset, n_items=n_items,
                  words=n_items + 1, zero_words=offset - state, warp_smem=warp_smem,
                  block_smem=block_smem, rank_blocks=K2_SMS * per_sm)


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
    tensors launch the kernel (counted in ``gather_select.launches``; a
    memset and four ``__global__`` functions: count, scan, scatter, rank) or
    raise.
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
    plan = k2_plan(N, T, cap)
    out = torch.empty((N, N_OUT), dtype=torch.float32, device=dev)
    # Scratch of this call alone (inside a capture, from the graph's own
    # pool); the launcher zeroes what must start at zero.
    scratch = torch.empty(plan.words, dtype=torch.int32, device=dev)
    lib = _build.load("gather_select", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_select_launch(
            table.data_ptr(), h.data_ptr(), query_xyz.data_ptr(), query_mask.data_ptr(), N, T, cap,
            scratch.data_ptr(), plan.words, plan.rank_blocks, plan.block_smem, int(by_coords),
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

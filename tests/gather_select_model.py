"""A numpy model of K2's passes (``open3d_slam_private_tpu_torch/csrc/gather_select.cu``)
on the scratch of ``kernels.gather_select.k2_plan``, for K2's contract and
K4's table entry (``by_coords``).

One int32 scratch of ``plan.words`` words, filled with garbage, goes through
the kernel's passes at the plan's offsets:

- memset: ``plan.zero_words`` words from ``plan.state`` (the scan's
  look-back words, its ticket and the row counts) set to 0;
- count: each row's queries; an ``h`` outside ``[0, T)`` writes the INVALID
  row and takes no further part;
- scan: per block of 1,024 rows the inclusive scans of (queries, items);
  block b's look-back word holds ``flag << 62 | items << 31 | queries`` of
  its inclusive prefix; each row's first position and one work item (row,
  first position, queries) a 32 queries of a row; the item count;
- scatter: each query's 16-byte record ``(x, y, z, i | mask << 31)`` at its
  row's cursor (the row's offset, moved on by one a record; the atomics'
  order is the model's choice: query order, or a shuffle with ``seed``);
- rank: per work item, its row and its records as the stages hold them;
  each query's d2 over the row's slots rounded step by step in float32
  (``(dx*dx + dy*dy) + dz*dz``), inf for K2's empty slots and for a
  masked query; the first slot at the minimum; the winner's words copied
  as bits, the d2, the occupancy, at the query's index.

The output does not depend on the order within a row (the atomics'), which
``seed`` varies. :func:`stress_inputs` builds the inputs the CPU tests and
the card tests hold the model and the kernel to.

    python tests/gather_select_model.py

prints the plan at the headline's shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from chip_smoke import stress_cases
from open3d_slam_private_tpu_torch.kernels.gather_select import K2_Q, K2_SCAN_ROWS, N_OUT, k2_plan
from open3d_slam_private_tpu_torch.ops import cell_list as tcl
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh

_INF_BITS = 0x7F800000
_MASK_BIT = np.uint32(1 << 31)
_FLAG_INCLUSIVE = 2


def pack_record(xyz, index, mask):
    """``[N, 4]`` uint32 records: the xyz bits and ``index | mask << 31``."""
    rec = np.empty((len(index), 4), np.uint32)
    rec[:, :3] = np.asarray(xyz, np.float32).view(np.uint32)
    rec[:, 3] = np.asarray(index, np.uint32) | np.where(np.asarray(mask, bool), _MASK_BIT, np.uint32(0))
    return rec


def unpack_record(rec):
    """Records -> (xyz float32 ``[N, 3]``, index ``[N]`` int64, mask ``[N]`` bool)."""
    rec = np.asarray(rec, np.uint32)
    return (rec[:, :3].view(np.float32), (rec[:, 3] & ~_MASK_BIT).astype(np.int64),
            (rec[:, 3] & _MASK_BIT) != 0)


def pack_state(queries, items, flag=_FLAG_INCLUSIVE):
    """A look-back word: ``flag << 62 | items << 31 | queries``."""
    return np.uint64(flag) << np.uint64(62) | np.uint64(items) << np.uint64(31) | np.uint64(queries)


def grouped(table, h, query_xyz, query_mask, by_coords=False, seed=None):
    """K2 (or K4's table entry with ``by_coords``) through the model's
    passes -> ``([N, 16]`` float32 output, the scratch, the plan)."""
    table = np.ascontiguousarray(table, np.float32)
    h = np.asarray(h, np.int64)
    xyz = np.ascontiguousarray(query_xyz, np.float32)
    mask = np.asarray(query_mask).astype(bool)
    T, cap = table.shape[:2]
    N = h.shape[0]
    plan = k2_plan(N, T, cap)
    rng = np.random.default_rng(12345)
    scratch = rng.integers(-2**31, 2**31, plan.words, dtype=np.int64).astype(np.int32)
    out = rng.integers(-2**31, 2**31, (N, N_OUT), dtype=np.int64).astype(np.int32)

    # memset
    scratch[plan.state: plan.state + plan.zero_words] = 0
    count = scratch[plan.count: plan.count + T]
    offset = scratch[plan.offset: plan.offset + T]

    # count: the row counts; an h outside [0, T) gets the INVALID row
    inside = (h >= 0) & (h < T)
    count[:] = np.bincount(h[inside], minlength=T)
    out[~inside] = 0
    out[~inside, 3], out[~inside, 7] = -1, _INF_BITS  # INVALID_ID, inf

    # scan
    c = count.astype(np.int64)
    items = -(-c // K2_Q)
    state = scratch[plan.state: plan.state + 2 * plan.row_blocks].view(np.uint64)
    item_rec = scratch[plan.items: plan.items + 4 * plan.max_items].reshape(-1, 4)
    base_q = base_i = 0
    for b in range(plan.row_blocks):
        rows = np.arange(b * K2_SCAN_ROWS, min(T, (b + 1) * K2_SCAN_ROWS))
        first = base_q + np.cumsum(c[rows]) - c[rows]
        item0 = base_i + np.cumsum(items[rows]) - items[rows]
        offset[rows] = first
        k = np.arange(items[rows].sum()) - np.repeat(item0 - base_i, items[rows])  # item k of its row
        r_of = np.repeat(rows, items[rows])
        f_of = np.repeat(first, items[rows])
        item_rec[np.repeat(item0, items[rows]) + k] = np.stack(
            [r_of, f_of + k * K2_Q, np.minimum(K2_Q, c[r_of] - k * K2_Q), np.zeros_like(k)], -1)
        base_q += int(c[rows].sum())
        base_i += int(items[rows].sum())
        state[b] = pack_state(base_q, base_i)
    n_items = base_i
    scratch[plan.n_items] = n_items

    # scatter: each record at its row's cursor, in the atomics' order
    records = scratch[plan.records: plan.records + 4 * N].reshape(-1, 4).view(np.uint32)
    order = np.flatnonzero(inside)
    if seed is not None:
        order = np.random.default_rng(seed).permutation(order)
    by_row = order[np.argsort(h[order], kind="stable")]
    place = np.arange(by_row.size) - offset[h[by_row]]  # the cursor's moves before each record
    records[offset[h[by_row]] + place] = pack_record(xyz[by_row], by_row, mask[by_row])
    offset += count  # the cursors end at the next row's first position

    # rank: every work item's lanes at once (query l of item k is the record
    # at the item's first position + l); the least (d2, slot), the first slot
    # at the minimum; each output row at its query's index
    its = item_rec[:n_items].astype(np.int64)
    lanes = np.arange(K2_Q)[None, :]
    live = lanes < its[:, 2:3]
    at = (its[:, 1:2] + lanes)[live]
    row = np.broadcast_to(its[:, :1], live.shape)[live]
    q, index, qm = unpack_record(records[at])
    bits = table.view(np.int32)
    slots = table[row]  # [M, cap, 8]: each query's staged row
    d = slots[..., :3] - q[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    if by_coords:
        occ = (slots[..., 0] < np.float32(1e8)).sum(1)
    else:
        empty = bits[row, :, 3] < 0
        d2[empty] = np.inf
        occ = (~empty).sum(1)
    d2[~qm] = np.inf
    win = np.argmin(d2, axis=1)
    o = np.zeros((at.size, N_OUT), np.int32)
    o[:, :7] = bits[row, win, :7]
    o[:, 7] = d2[np.arange(at.size), win].view(np.int32)
    o[:, 8] = occ.astype(np.float32).view(np.int32)
    out[index] = o
    return out.view(np.float32), scratch, plan


N_QUERIES = 2345  # off every block size: 32, 256 and 1,024


def _base(cap, by_coords):
    """A floor-and-walls scene's cell list (2^12 rows of ``cap`` slots) and
    ``N_QUERIES`` queries, 1 in 20 masked and 1 in 10 far from the scene
    (mostly empty rows). K4's contract pads its empty slots (xyz 1e9)."""
    rng = np.random.default_rng(cap)
    n = 4000
    floor = np.c_[rng.uniform(-8, 8, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    wall = np.c_[np.full((n // 2, 1), 5.0), rng.uniform(-8, 8, (n // 2, 1)), rng.uniform(0, 3, (n // 2, 1))]
    scene = torch.tensor(np.vstack([floor, wall]), dtype=torch.float32)
    nrm = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    cl = tcl.build_cell_list(scene, torch.ones(n, dtype=torch.bool), 0.5, table_size=1 << 12,
                             list_cap=cap, normals=torch.nn.functional.normalize(nrm, dim=-1))
    table = cl.table
    if by_coords:
        empty = tgh.payload_ids(table) < 0
        table = torch.where(empty[..., None], tgh.empty_payload(1, "cpu")[0], table)
    q = scene[rng.integers(0, n, N_QUERIES)] + torch.tensor(rng.normal(scale=0.05, size=(N_QUERIES, 3)),
                                                           dtype=torch.float32)
    q[::10] = torch.tensor(rng.uniform(-30, 30, size=(q[::10].shape[0], 3)), dtype=torch.float32)
    m = torch.tensor(rng.uniform(size=N_QUERIES) > 0.05)
    return table, tcl.query_hash(cl, q), q, m


@functools.lru_cache(maxsize=None)
def stress_inputs(cap, by_coords):
    """The smoke's :func:`chip_smoke.stress_cases` on :func:`_base`'s
    inputs, and two more: rows of 33 and 65 queries, and a table of 3,000
    rows (off the scan's 1,024) -> name -> (table, h, query_xyz, mask), CPU
    tensors (shared: clone before writing)."""
    table, h, q, m = _base(cap, by_coords)
    cases = dict(rows=(table, h, q, m), **stress_cases(table, h, q, m, by_coords=by_coords))
    hot = h.clone()
    hot[:33] = h[0]  # a row of 33 queries and one of 65 (two and three work items)
    hot[33:98] = h[40]
    cases["rows_of_33_and_65"] = (table, hot, q, m)
    T = 3000  # rows off the scan's 1,024
    cases["table_of_3000_rows"] = (table[:T].contiguous(), (h % T).contiguous(), q, m)
    return cases


NAMES = ["rows", "one_row", "distinct_rows", "all_masked", "empty_row", "out_of_range",
         "rows_of_33_and_65", "table_of_3000_rows"]
# A row index outside [0, T) is outside K4's contract.
CONTRACTS = [(c, False) for c in NAMES] + [(c, True) for c in NAMES if c != "out_of_range"]


if __name__ == "__main__":
    print(k2_plan(8 * 65536, 1 << 16, 48))

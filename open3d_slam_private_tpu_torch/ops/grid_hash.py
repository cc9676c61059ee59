"""Spatial grid hash and shared matching pieces.

Twin of ``open3d_slam_private_tpu/ops/grid_hash.py``: the murmur3 cell hash,
the bucket-table build (one stable sort + one scatter into a dense
``[T, C, 8]`` payload table), the radius moment pass that feeds the map
normals, the 8-bucket candidate gather of the "hash" matcher, and the
k-nearest re-rank of gathered candidates.

Payload rows are ``[x, y, z, id, nx, ny, nz, 0]`` with the int32 id stored
as its bit pattern in the float32 slot. The id channel is only ever read and
written through an int32 view: ids below 2^23 are denormal floats, and float
arithmetic that flushes denormals would zero them.

The hash is uint32 arithmetic in the JAX package. It is emulated here in
int64 with every product split so that no intermediate exceeds 2^49, which
keeps each cell's bucket equal to the JAX table's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from open3d_slam_private_tpu_torch.geometry.se3 import fma32

from open3d_slam_private_tpu_torch.ops.knn import INF, INVALID_ID

_P1 = 2654435761
_P2 = 805459861
_P3 = 3674653429
_M32 = 0xFFFFFFFF

_PAD = 1.0e9  # coordinate of empty payload slots

_CH = 8
_IDX_CH = 3
_NRM = slice(4, 7)


def f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``. Divisions go through tensors like
    this one, never through Python scalars: CUDA divides by a CPU scalar as
    a multiply by its reciprocal, which moves cell boundaries by an ulp.
    A number is filled in on the device (no host-to-device copy, which a
    CUDA graph could not capture); a sequence of numbers is copied."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=torch.float32)
    if isinstance(value, (int, float)) or getattr(value, "ndim", None) == 0:
        return torch.full((), float(value), dtype=torch.float32, device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def const3(values, device, dtype=torch.float32) -> torch.Tensor:
    """A ``[3]`` vector on ``device``: a tensor as it is, or three numbers
    filled in on the device (no host-to-device copy)."""
    if torch.is_tensor(values):
        return values.to(device=device, dtype=dtype)
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])


def recip(size: torch.Tensor) -> torch.Tensor:
    """The float32 ``1 / size`` that XLA multiplies by where it divides by a
    compile-time constant ``size``. Inside the JAX twins' jitted steps with a
    static config (``odometry.preprocess``, ``mapper.process_scan_for_matching``,
    ``mapper.build_map_reference``, ``register_pair``) the voxel and cell
    sizes are such constants, so ``x / 0.3`` runs as ``x * 3.3333333``: a
    cell boundary then falls an ulp away from a true division's, once in
    ~10^4 coordinates. Where the size is traced, XLA divides."""
    return torch.ones_like(size) / size


def cell_coords(xyz: torch.Tensor, size: torch.Tensor, inv=None) -> torch.Tensor:
    """``xyz / size``, or ``xyz * inv`` where ``inv = recip(size)`` is given."""
    return xyz / size if inv is None else xyz * inv


def floor_cells(xyz: torch.Tensor, size: torch.Tensor, inv=None) -> torch.Tensor:
    """``floor(cell_coords(xyz, size, inv))`` as int32, saturating like
    XLA's float->int conversion (padded ``PAD_COORD`` rows would otherwise
    overflow)."""
    f = torch.floor(cell_coords(xyz, size, inv))
    return f.double().clamp(-2147483648.0, 2147483647.0).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant
    ``c`` in [0, 2^32), without int64 overflow."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _cell_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash ``[..., 3]`` int32 cells into ``[0, table_size)`` (int32).
    Negative cells wrap as two's complement, as the uint32 cast does."""
    c = cell.to(torch.int64) & _M32
    s = (_mul32(c[..., 0], _P1) + _mul32(c[..., 1], _P2) + _mul32(c[..., 2], _P3)) & _M32
    return (_fmix32(s) % table_size).to(torch.int32)


def empty_payload(rows: int, device) -> torch.Tensor:
    """``[rows, 8]`` empty payload slots: xyz at _PAD, id INVALID_ID."""
    table = torch.zeros((rows, _CH), dtype=torch.float32, device=device)
    table[:, :3].fill_(_PAD)
    table.view(torch.int32)[:, _IDX_CH].fill_(INVALID_ID)
    return table


def payload_ids(rows: torch.Tensor) -> torch.Tensor:
    """The int32 id channel of ``[..., 8]`` payload rows (bit view)."""
    return rows.view(torch.int32)[..., _IDX_CH]


def scatter_payload(
    table_rows: int, slot: torch.Tensor, src: torch.Tensor, xyz, normals
) -> torch.Tensor:
    """Payload table ``[table_rows + 1, 8]``: row ``slot[i]`` holds point
    ``src[i]``; the extra last row takes every slot that did not fit (the
    scatter's dropped writes) and is sliced off by the caller."""
    payload = torch.zeros((src.shape[0], _CH), dtype=torch.float32, device=xyz.device)
    payload[:, :3] = xyz[src]
    payload.view(torch.int32)[:, _IDX_CH] = src.to(torch.int32)
    if normals is not None:
        payload[:, _NRM] = normals[src]
    table = empty_payload(table_rows + 1, xyz.device)
    table[slot] = payload
    return table


def run_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal sorted keys."""
    n = sorted_keys.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    idxs = torch.arange(n, device=sorted_keys.device)
    return idxs - torch.cummax(torch.where(first, idxs, 0), 0).values


@dataclasses.dataclass(frozen=True)
class GridHash:
    """Built spatial hash: payload table ``[T, C, 8]`` + cell size.
    ``cell_inv``: the reciprocal queries multiply by (see :func:`recip`)
    where the JAX twin builds and queries the grid in one jitted step of a
    static config; None: queries divide."""

    table: torch.Tensor
    cell_size: torch.Tensor
    has_normals: bool = False
    cell_inv: Optional[torch.Tensor] = None

    @property
    def bucket_cap(self) -> int:
        return self.table.shape[1]

    @property
    def table_size(self) -> int:
        return self.table.shape[0]


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Correspondences with inlined payloads: ``dists [..., N, k]`` squared
    (inf invalid), ``ids [..., N, k]`` int32 (-1 invalid), ``xyz`` and
    ``normals`` ``[..., N, k, 3]`` (zeros where invalid)."""

    dists: torch.Tensor
    ids: torch.Tensor
    xyz: torch.Tensor
    normals: torch.Tensor

    def valid(self) -> torch.Tensor:
        return self.ids >= 0


def build_grid(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    cell_size,
    table_size: int = 1 << 16,
    bucket_cap: int = 16,
    normals: Optional[torch.Tensor] = None,
    const_size: bool = False,
) -> GridHash:
    """Hash ``xyz [M, 3]`` (mask-valid points only) into a GridHash; under
    bucket overflow the lowest point indices win (stable sort).
    ``const_size``: the cell size is a compile-time constant of the JAX
    twin's step, so cells come from its :func:`recip` (and so do the
    grid's queries)."""
    cs = f32(cell_size, xyz.device)
    inv = recip(cs) if const_size else None
    hkey = _cell_hash(floor_cells(xyz, cs, inv), table_size)
    hkey = torch.where(mask, hkey, table_size)
    sorted_keys, order = torch.sort(hkey, stable=True)
    rank = run_ranks(sorted_keys)
    in_table = (sorted_keys < table_size) & (rank < bucket_cap)
    slot = torch.where(in_table, sorted_keys * bucket_cap + rank, table_size * bucket_cap)
    table = scatter_payload(table_size * bucket_cap, slot, order, xyz, normals)
    return GridHash(
        table=table[:-1].reshape(table_size, bucket_cap, _CH),
        cell_size=cs,
        has_normals=normals is not None,
        cell_inv=inv,
    )


def _block_hashes(grid: GridHash, query_xyz: torch.Tensor):
    """The 8 hashes of the 2x2x2 cell block nearest each query."""
    u = cell_coords(query_xyz, grid.cell_size, grid.cell_inv)
    base = floor_cells(query_xyz, grid.cell_size, grid.cell_inv)
    frac = u - torch.floor(u)
    step = torch.where(frac < 0.5, -1, 1).to(torch.int32)
    hashes = []
    shifts = 2 - torch.arange(3, dtype=torch.int32, device=query_xyz.device)
    for bits in range(8):
        offs = (bits >> shifts) & 1  # [(bits >> 2) & 1, (bits >> 1) & 1, bits & 1]
        hashes.append(_cell_hash(base + step * offs, grid.table_size))
    return hashes


def _sq3(d: torch.Tensor) -> torch.Tensor:
    """``(dx*dx + dy*dy) + dz*dz`` over the last axis, in that order."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


_LANES = 8  # the vector width of XLA's CPU loop over a bucket's slots


def _row_dot_xla(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, -1)`` in the order XLA's CPU backend sums a fused row
    reduction: an 8-lane vector loop with one fused multiply-add a slot over
    the first ``(n - 1) // 8 * 8`` slots, the lanes added by halves (4 + 4,
    2 + 2, 1 + 1), then the remaining slots one at a time, fused."""
    n = a.shape[-1]
    it = (n - 1) // _LANES
    s = a.new_zeros(a.shape[:-1])
    if it:
        ah = a[..., :it * _LANES].reshape(*a.shape[:-1], it, _LANES)
        bh = b[..., :it * _LANES].reshape(*b.shape[:-1], it, _LANES)
        acc = ah[..., 0, :] * bh[..., 0, :]
        for k in range(1, it):
            acc = fma32(ah[..., k, :], bh[..., k, :], acc)
        w = _LANES
        while w > 1:
            w //= 2
            acc = acc[..., :w] + acc[..., w:2 * w]
        s = acc[..., 0]
    for j in range(it * _LANES, n):
        s = fma32(a[..., j], b[..., j], s)
    return s


def grid_moments(grid: GridHash, query_xyz: torch.Tensor, query_mask: torch.Tensor, max_dist):
    """Within-radius neighbourhood moments per query, in one pass over the
    8 candidate buckets: ``(count [N], mean [N, 3], cov [N, 3, 3])``, with
    the mean query-centred (moments are accumulated in query-centred
    coordinates to avoid float32 cancellation). The second moments and the
    covariance ``fma(-m_a, m_b, s_ab / count)`` round as XLA's CPU backend
    rounds the JAX twin (:func:`_row_dot_xla`): near-degenerate
    neighbourhoods turn the last bit of the covariance into another normal."""
    n = query_xyz.shape[0]
    dev = query_xyz.device
    cap = grid.bucket_cap
    radius = f32(max_dist, dev)
    max_d2 = radius * radius
    hashes = _block_hashes(grid, query_xyz)
    flat = grid.table.reshape(grid.table_size, cap * _CH)
    cnt = torch.zeros(n, device=dev)
    s1 = torch.zeros(n, 3, device=dev)
    s2 = torch.zeros(n, 6, device=dev)  # xx, yy, zz, xy, xz, yz
    for bits in range(8):
        h = hashes[bits]
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        rows = flat[h].reshape(n, cap, _CH)
        diff = rows[..., :3] - query_xyz[:, None, :]
        d2 = _sq3(diff)
        w = ((payload_ids(rows) >= 0) & ~seen[:, None] & (d2 <= max_d2)).float()
        cnt = cnt + w.sum(-1)
        s1 = s1 + torch.einsum("nc,nci->ni", w, diff)
        x, y, z = diff.unbind(-1)
        s2 = s2 + _row_dot_xla(torch.stack([w * x, w * y, w * z, w * x, w * x, w * y], 1),
                               torch.stack([x, y, z, y, z, z], 1))
    c = torch.clamp(cnt, min=1.0)
    mean = s1 / c[:, None]
    m = mean.unbind(-1)
    cxx, cyy, czz, cxy, cxz, cyz = (
        fma32(-m[i], m[j], s2[:, k] / c)
        for k, (i, j) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)))
    )
    cov = torch.stack(
        [
            torch.stack([cxx, cxy, cxz], -1),
            torch.stack([cxy, cyy, cyz], -1),
            torch.stack([cxz, cyz, czz], -1),
        ],
        dim=-2,
    )
    valid = query_mask & (cnt >= 1.0)
    return torch.where(valid, cnt, 0.0), mean, cov


def gather_candidates(grid: GridHash, query_xyz: torch.Tensor, query_mask: torch.Tensor):
    """The payloads of the 2x2x2 cell block nearest each query ``[..., 3]``:
    ``rows [..., 8C, 8]`` and ``valid [..., 8C]``, blocks in the JAX twin's
    order; a bucket already visited by an earlier block of the same query
    (hash collision) and empty slots are invalid."""
    cap = grid.bucket_cap
    hashes = _block_hashes(grid, query_xyz)
    flat = grid.table.reshape(grid.table_size, cap * _CH)
    rows_out, valid_out = [], []
    for bits in range(8):
        h = hashes[bits]
        seen = torch.zeros_like(query_mask)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        rows = flat[h.long()].reshape(*h.shape, cap, _CH)
        rows_out.append(rows)
        valid_out.append((payload_ids(rows) >= 0) & ~seen[..., None] & query_mask[..., None])
    return torch.cat(rows_out, -2), torch.cat(valid_out, -1)


def grid_match(
    grid: GridHash, query_xyz: torch.Tensor, query_mask: torch.Tensor, k: int = 1, max_dist=None
) -> MatchResult:
    """The ``k`` nearest table points within ``max_dist`` (default: half
    the cell size) among the 2x2x2 block's buckets, payloads inlined. Ties
    go to the earlier block, then the lower slot, as in the JAX twin's
    block-by-block merge."""
    radius = grid.cell_size * 0.5 if max_dist is None else max_dist
    rows, valid = gather_candidates(grid, query_xyz, query_mask)
    return match_from_candidates(rows, valid, query_xyz, query_mask, radius, k)


def match_from_candidates(
    rows: torch.Tensor,
    valid: torch.Tensor,
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    max_dist,
    k: int = 1,
) -> MatchResult:
    """Re-rank gathered candidates ``rows [..., M, 8]`` with ``valid
    [..., M]`` for queries ``[..., 3]`` -> the ``k`` nearest, ascending,
    each kept if within ``max_dist``. Each of the k passes takes the first
    candidate at the minimum squared distance (ties go to the lowest slot)
    and removes it; a slot without a valid candidate ends with id -1 and
    zeroed xyz / normals."""
    radius = f32(max_dist, query_xyz.device)
    max_d2 = radius * radius
    d2 = _sq3(rows[..., :3] - query_xyz[..., None, :])
    d2 = torch.where(valid, d2, INF)
    if k == 1:
        best_d, _ = d2.min(-1, keepdim=True)
        win = (d2 <= best_d).to(torch.int8).argmax(-1, keepdim=True)
    else:
        ds, wins = [], []
        for j in range(k):
            best, arg = d2.min(-1, keepdim=True)
            ds.append(best)
            wins.append(arg)
            if j + 1 < k:
                d2 = d2.scatter(-1, arg, INF)
        best_d, win = torch.cat(ds, -1), torch.cat(wins, -1)
    sel = torch.gather(rows, -2, win[..., None].expand(*win.shape, _CH))
    best_i = torch.gather(payload_ids(rows), -1, win)
    invalid = (best_d > max_d2) | ~torch.isfinite(best_d) | ~query_mask[..., None]
    return MatchResult(
        dists=torch.where(invalid, INF, best_d),
        ids=torch.where(invalid, INVALID_ID, best_i),
        xyz=torch.where(invalid[..., None], 0.0, sel[..., :3]),
        normals=torch.where(invalid[..., None], 0.0, sel[..., _NRM]),
    )

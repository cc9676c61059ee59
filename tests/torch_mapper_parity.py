"""Where the pipeline parity test's data seed 2 parts from the JAX package, and
three candidate repairs that reproduce XLA's CPU rounding, on the CPU. None
of them is wired into the port (ROADMAP queue 3).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_mapper_parity.py                  # op table
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_mapper_parity.py --seed 3 \\
        --repairs insert,moments,eigh                                                    # pipeline gaps

The op table runs both pipelines over the first scan of a data seed and
compares, bit for bit, the submap bank after the insertion and the map
reference's moment normals: the port's own, and with the repairs. The
second form runs ``tests/torch_parity_seed.py``'s steps with the chosen
repairs and prints the odometry's and the pipeline's pose gaps.

What XLA's CPU backend does, read from its LLVM IR (``--xla_dump_to``):

- ``insert``: the submap insertion (``slam/submap.py`` ``insert_scan``)
  rounds each row of ``R p + t`` as ``fma(R_i2, z, fma(R_i0, x, R_i1 y)) +
  t_i``;
- ``moments``: ``grid_moments`` sums each of the 6 second moments over a
  bucket's 32 slots with an 8-lane vector loop over the first
  ``(32 - 1) // 8 * 8`` slots (one fused multiply-add a slot), adds the
  lanes by halves (4 + 4, 2 + 2, 1 + 1), then the remaining slots one at a
  time with fused multiply-adds; the covariance is
  ``fma(-m_a, m_b, s_ab / count)``;
- ``eigh``: ``tests/torch_eigh_parity.py``'s candidate ``eigh3x3``.

A fused multiply-add is formed in float64 and rounded to float32, as
``tests/torch_eigh_parity.py`` does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import torch_eigh_parity as tep  # noqa: E402  (sets the fused-path flag, JAX on the CPU)

from open3d_slam_private_tpu.ops import pointcloud as jpc  # noqa: E402
from open3d_slam_private_tpu.slam import pipeline as jpipe  # noqa: E402
from open3d_slam_private_tpu_torch import interop  # noqa: E402
from open3d_slam_private_tpu_torch.geometry import se3 as tse3  # noqa: E402
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh  # noqa: E402
from open3d_slam_private_tpu_torch.ops import normals as tnm  # noqa: E402
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe  # noqa: E402
from open3d_slam_private_tpu_torch.slam import submap as tsub  # noqa: E402

fma = tep.fma
_LANES = 8


def row_dot(a, b):
    """``sum(a * b, -1)`` in XLA's CPU order for a fused row reduction."""
    n = a.shape[-1]
    it = (n - 1) // _LANES
    s = torch.zeros(a.shape[:-1], dtype=a.dtype)
    if it:
        ah = a[..., :it * _LANES].reshape(*a.shape[:-1], it, _LANES)
        bh = b[..., :it * _LANES].reshape(*b.shape[:-1], it, _LANES)
        acc = ah[..., 0, :] * bh[..., 0, :]
        for k in range(1, it):
            acc = fma(ah[..., k, :], bh[..., k, :], acc)
        w = _LANES
        while w > 1:
            w //= 2
            acc = acc[..., :w] + acc[..., w:2 * w]
        s = acc[..., 0]
    for j in range(it * _LANES, n):
        s = fma(a[..., j], b[..., j], s)
    return s


def grid_moments(grid, query_xyz, query_mask, max_dist):
    """``ops/grid_hash.py`` ``grid_moments`` with the second moments and the
    covariance in XLA's CPU order (the count and the first moments already
    equal JAX's)."""
    n, cap = query_xyz.shape[0], grid.bucket_cap
    radius = tgh.f32(max_dist, query_xyz.device)
    hashes = tgh._block_hashes(grid, query_xyz)
    flat = grid.table.reshape(grid.table_size, cap * tgh._CH)
    cnt, s1, s2 = torch.zeros(n), torch.zeros(n, 3), torch.zeros(n, 6)
    for bits in range(8):
        h = hashes[bits]
        seen = torch.zeros(n, dtype=torch.bool)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        rows = flat[h].reshape(n, cap, tgh._CH)
        diff = rows[..., :3] - query_xyz[:, None, :]
        w = ((tgh.payload_ids(rows) >= 0) & ~seen[:, None] & (tgh._sq3(diff) <= radius * radius)).float()
        cnt = cnt + w.sum(-1)
        s1 = s1 + torch.einsum("nc,nci->ni", w, diff)
        x, y, z = diff.unbind(-1)
        s2 = s2 + row_dot(torch.stack([w * x, w * y, w * z, w * x, w * x, w * y], 1),
                          torch.stack([x, y, z, y, z, z], 1))
    c = torch.clamp(cnt, min=1.0)
    mean = s1 / c[:, None]
    m = mean.unbind(-1)
    e = [fma(-m[i], m[j], s2[:, k] / c) for k, (i, j) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)))]
    cov = torch.stack([torch.stack([e[0], e[3], e[4]], -1), torch.stack([e[3], e[1], e[5]], -1),
                       torch.stack([e[4], e[5], e[2]], -1)], dim=-2)
    return torch.where(query_mask & (cnt >= 1.0), cnt, 0.0), mean, cov


def apply_transform_insert(T, points):
    """The submap insertion's ``R p + t`` in XLA's CPU rounding."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    x, y, z = points.unbind(-1)
    rows = [fma(R[..., None, i, 2].expand_as(z), z, fma(R[..., None, i, 0].expand_as(x), x, R[..., None, i, 1] * y))
            for i in range(3)]
    return torch.stack(rows, -1) + t[..., None, :]


def use_repairs(names) -> None:
    """Wire the named repairs into the port's modules (this process only)."""
    if "moments" in names:
        tnm.grid_moments = grid_moments
    if "eigh" in names:
        tnm._normals_from_neighbors = tep.normals_with_candidate
        tnm.eigh3x3 = lambda A: (lambda s: (s["evals"], s["vecs"]))(tep.steps(A))
    if "insert" in names:
        insert = tsub.insert_scan

        def insert_scan(*a, **k):
            keep, tse3.apply_transform = tse3.apply_transform, apply_transform_insert
            try:
                return insert(*a, **k)
            finally:
                tse3.apply_transform = keep
        tsub.insert_scan = insert_scan


def _first_scan(seed):
    """Both pipelines after the test's IMU boot and the first scan of ``seed``."""
    from test_torch_odometry import scene
    from test_torch_pipeline import _config, distorted_scan

    rng = np.random.default_rng(seed)
    S = scene(rng)
    jcfg = _config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    g_body = np.array([0.0, 9.81 * np.sin(0.02), 9.81 * np.cos(0.02)])
    for k in range(10):
        acc = g_body + 0.01 * rng.normal(size=3)
        jp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
        tp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
    pts, times = distorted_scan(S, 0, seed=0)
    jb = jpc.from_points(pts, capacity=4096, extras={"times": times[:, None]})
    jp.process_scan(jb, 0.0)
    tp.process_scan(interop.point_batch(jb.xyz, jb.mask, {"times": jb.extras["times"]}), 0.0)
    return jp, tp


def _rows_equal(a, b, mask) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((a.view(np.int32) == b.view(np.int32)).reshape(len(a), -1).all(1)[mask].mean())


def op_table(seed=2):
    """Share of rows bit-equal to JAX's after the first scan of ``seed``: the
    submap bank, and the map reference's normals (each with the port's
    own code, then with the repairs)."""
    from open3d_slam_private_tpu_torch.slam import mapper as tmapper

    jp, tp = _first_scan(seed)
    jc, tc = jp.submaps.active.state.cloud, tp.submaps.active.state.cloud
    m = np.asarray(jc.mask)
    print(f"| seed {seed}, after scan 0 | the port's code | with the repairs |\n|---|---|---|")
    use_repairs(("insert",))
    _, tp2 = _first_scan(seed)
    print(f"| bank xyz | {100 * _rows_equal(jc.xyz, tc.xyz, m):.1f}% "
          f"| {100 * _rows_equal(jc.xyz, tp2.submaps.active.state.cloud.xyz, m):.1f}% (insert) |")
    # The reference rebuilt from JAX's own bank, so that only the normals differ.
    bank = interop.point_batch(jc.xyz, jc.mask)
    center = torch.tensor(jp.pose[:3, 3], dtype=torch.float32)  # the rebuild's center at scan 0
    tcfg = tp.cfg.mapper
    rm = np.asarray(jp._ref.cloud.mask)
    own = tmapper.build_map_reference(bank, center, tcfg).cloud.normals
    use_repairs(("moments", "eigh"))
    fixed = tmapper.build_map_reference(bank, center, tcfg).cloud.normals
    want = jp._ref.cloud.normals
    print(f"| reference normals on JAX's bank | {100 * _rows_equal(want, own, rm):.1f}% "
          f"| {100 * _rows_equal(want, fixed, rm):.1f}% (moments, eigh) |")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, help="run tests/torch_parity_seed.py's 9 steps")
    ap.add_argument("--repairs", default="", help="comma-separated: insert, moments, eigh")
    args = ap.parse_args()
    if args.seed is None:
        op_table()
        return
    import torch_parity_seed

    use_repairs(tuple(r for r in args.repairs.split(",") if r))
    torch_parity_seed.main(args.seed, 9)


if __name__ == "__main__":
    main()

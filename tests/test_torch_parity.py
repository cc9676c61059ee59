"""Three roundings of the JAX package that the port reproduces, on crafted
float32 inputs, on the CPU.

(a) Under ``jax.jit`` with a static config, a voxel or cell size is a
compile-time constant, and XLA runs ``floor(x / v)`` as
``floor(x * fl32(1 / v))``; where the size is traced it divides. The
crafted coordinates sit within a few ulps of multiples of 0.3 m and 0.75 m,
where the two rules give different cells. They go through JAX's jitted
``odometry.preprocess``, ``mapper.process_scan_for_matching`` and
``mapper.build_map_reference`` (its cell list) and through the port's
twins: the same cells, the same retained points. The hash grid of the
odometry's ``register_pair`` (2.5 m cells) has no float32 coordinate
within 100 m where the rules part.

(b) JAX ranks the brute KNN by ``max((|q|^2 - 2 q.r) + |r|^2, 0)``, the dot
and the sums of squares fused multiply-add chains on the CPU. A crafted
near-tie where direct differences rank otherwise: the port's ids equal
JAX's at k = 1 and k = 8; and ``estimate_normals``' neighbours equal JAX's
on every row of the odometry tests' scans.

(c) XLA's CPU reduction sums windows of 32, left to right, then the window
sums: the port's ``masked_centroid(xla_order=True)``, the brute matchers'
centroid, sums in that order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.ops import cell_list as jcl
from open3d_slam_private_tpu.ops import knn as jknn
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import mapper as jmapper
from open3d_slam_private_tpu.slam import odometry as jodo
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.models import icp as ticp
from open3d_slam_private_tpu_torch.ops import cell_list as tcl
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import knn as tknn
from open3d_slam_private_tpu_torch.ops import normals as tnm
from open3d_slam_private_tpu_torch.ops import pointcloud as tpc
from open3d_slam_private_tpu_torch.slam import mapper as tmapper
from open3d_slam_private_tpu_torch.slam import odometry as todo
from tests.test_torch_odometry import pose, scan_at, scene

f32 = np.float32


def crafted(v, lo, hi, half=False, span=8):
    """float32 values in [lo, hi] within ``span`` ulps of a multiple of
    ``v`` (of an odd multiple of ``v / 2`` with ``half``) where
    ``floor(x / v)`` and ``floor(x * fl32(1 / v))`` differ (with ``half``:
    where ``x / v`` and ``x * fl32(1 / v)`` fall on two sides of the cell's
    midpoint)."""
    v32 = f32(v)
    inv = f32(1) / v32
    out = []
    for k in range(int(np.floor(lo / v)) - 1, int(np.ceil(hi / v)) + 1):
        x = f32((k + (0.5 if half else 0.0)) * np.float64(v))
        for _ in range(span):
            x = np.nextafter(x, f32(-np.inf))
        for _ in range(2 * span):
            a, b = x / v32, x * inv
            if half:
                differ = (a - np.floor(a) < 0.5) != (b - np.floor(b) < 0.5)
            else:
                differ = np.floor(a) != np.floor(b)
            if differ and lo <= x <= hi:
                out.append(x)
            x = np.nextafter(x, f32(np.inf))
    return np.array(out, f32)


def boundary_scan(v):
    """Points whose x is a crafted 0.3 m-boundary value, each with a partner
    at the centre of the cell ``x * fl32(1 / v)`` gives, so that only the
    reciprocal rule merges the two; y and z on distinct cell centres."""
    xs = np.concatenate([crafted(v, -24.0, -2.0), crafted(v, 2.0, 24.0)])
    inv = f32(1) / f32(v)
    j = np.arange(len(xs))
    y = f32(v) * (2 * (j % 40) + 0.5).astype(f32) - f32(12.0)
    z = f32(v) * (2 * (j // 40) + 0.5).astype(f32)
    partner = ((np.floor(xs * inv) + 0.5) * v).astype(f32)
    pts = np.concatenate([np.c_[xs, y, z], np.c_[partner, y, z]]).astype(f32)
    cells = lambda rule: {tuple(c) for c in np.floor(rule(pts)).astype(np.int64)}
    n_div, n_mul = len(cells(lambda p: p / f32(v))), len(cells(lambda p: p * inv))
    assert len(xs) >= 20 and n_div == n_mul + len(xs), (len(xs), n_div, n_mul)
    return pts, n_mul


def test_crafted_values_part_where_expected():
    """The experiment behind each site's rule: a jitted step with a static
    size multiplies by the reciprocal, a traced size divides; at 0.5, 1, 2
    and 2.5 m no float32 coordinate within 100 m tells them apart."""
    xs = jnp.asarray(crafted(0.3, -40.0, 40.0))
    div, mul = np.floor(np.asarray(xs) / f32(0.3)), np.floor(np.asarray(xs) * (f32(1) / f32(0.3)))
    assert (div != mul).all()
    static = jax.jit(lambda x, v: jnp.floor(x / v), static_argnames=("v",))
    traced = jax.jit(lambda x, v: jnp.floor(x / v))
    np.testing.assert_array_equal(np.asarray(static(xs, v=0.3)), mul)
    np.testing.assert_array_equal(np.asarray(traced(xs, 0.3)), div)
    for v in (0.5, 1.0, 2.0, 2.5):
        assert len(crafted(v, -100.0, 100.0)) == len(crafted(v, -100.0, 100.0, half=True)) == 0


@pytest.mark.parametrize("capacity", [2048, 48], ids=["all-voxels", "capacity-cut"])
def test_odometry_preprocess_cells_match_jax(capacity):
    pts, n_cells = boundary_scan(0.3)
    cfg = jodo.OdometryConfig(max_points=capacity)
    jb = jpc.from_points(pts, capacity=4096)
    want = jodo.preprocess(jb, None, cfg)
    got = todo.preprocess(interop.point_batch(jb.xyz, jb.mask), interop.config(todo.OdometryConfig, cfg))
    assert int(np.asarray(want.mask).sum()) == min(capacity, n_cells)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


@pytest.mark.parametrize("capacity", [2048, 48], ids=["all-voxels", "capacity-cut"])
def test_mapper_scan_cells_match_jax(capacity):
    pts, n_cells = boundary_scan(0.3)
    cfg = dataclasses.replace(jmapper.MapperConfig(), scan_capacity=capacity)
    jb = jpc.from_points(pts, capacity=4096)
    want = jmapper.process_scan_for_matching(jb, cfg)
    got = tmapper.process_scan_for_matching(interop.point_batch(jb.xyz, jb.mask),
                                            interop.config(tmapper.MapperConfig, cfg))
    assert int(np.asarray(want.mask).sum()) == min(capacity, n_cells)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def _boundary_map(v=0.75):
    """A symmetric cloud of every float32 value within 8 ulps of the
    multiples of ``v`` in 2..24 m (both signs), on distinct y/z cells."""
    xs = []
    for k in range(3, 33):
        x = f32(k * np.float64(v))
        for _ in range(8):
            x = np.nextafter(x, f32(-np.inf))
        for _ in range(16):
            xs.append(x)
            x = np.nextafter(x, f32(np.inf))
    xs = np.array(xs, f32)
    j = np.arange(len(xs))
    y = f32(v) * (3 * (j % 16) + 0.5).astype(f32) - f32(18.0)
    z = f32(v) * (3 * (j // 16 % 4) + 0.5).astype(f32)
    half = np.c_[xs, y, z].astype(f32)
    return np.concatenate([half, -half])


def test_map_reference_cell_list_matches_jax():
    """``build_map_reference``'s cell list (radius 0.75 m) is built with the
    reciprocal, inside JAX's jitted step; the reference leaves that step as
    an argument, so the scan-to-map queries divide."""
    cfg = dataclasses.replace(jmapper.MapperConfig(), ref_capacity=None)
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, grid_table_size=1 << 13))
    jb = jpc.from_points(_boundary_map(), capacity=8192)
    jref = jmapper.build_map_reference(jb, jnp.zeros(3), cfg)
    radius = f32(cfg.icp.max_match_dist + cfg.icp.candidate_slack)
    cx = np.asarray(jref.cloud.xyz)[np.asarray(jref.cloud.mask)]
    assert (np.floor(cx / radius) != np.floor(cx * (f32(1) / radius))).any()
    # The port's build on JAX's centred cloud and normals, as build_map_reference runs it.
    tcfg = interop.config(tmapper.MapperConfig, cfg)
    cloud = interop.point_batch(jref.cloud.xyz, jref.cloud.mask, {"normals": jref.cloud.normals})
    want = np.asarray(jref.grid.table).view(np.int32)
    for const, equal in ((True, True), (False, False)):
        ref = ticp.build_reference(cloud, tcfg.icp, centroid=torch.zeros(3), const_size=const)
        assert np.array_equal(ref.grid.table.numpy().view(np.int32), want) == equal
    tref = tmapper.build_map_reference(interop.point_batch(jb.xyz, jb.mask), torch.zeros(3), tcfg)
    assert tref.grid.cell_inv is None
    # Queries against the built list in another jitted step divide.
    q = np.concatenate([crafted(0.75, -24.0, -2.0), crafted(0.75, 2.0, 24.0)])
    q = np.c_[q, np.full_like(q, 0.375), np.full_like(q, 0.375)].astype(f32)
    rows, _ = jcl.gather_cell_candidates(jref.grid, jnp.asarray(q), jnp.ones(len(q), bool))
    tl = tcl.CellList(table=torch.tensor(np.asarray(jref.grid.table)), cell_size=torch.tensor(radius),
                      dropped=torch.tensor(0))
    trows, _ = tcl.gather_cell_candidates(tl, torch.tensor(q), torch.ones(len(q), dtype=torch.bool))
    np.testing.assert_array_equal(trows.numpy().view(np.int32), np.asarray(rows).view(np.int32))
    tl = dataclasses.replace(tl, cell_inv=tgh.recip(tl.cell_size))
    trows, _ = tcl.gather_cell_candidates(tl, torch.tensor(q), torch.ones(len(q), dtype=torch.bool))
    assert not np.array_equal(trows.numpy().view(np.int32), np.asarray(rows).view(np.int32))


def _direct_sq_dists(q, r):
    """``[n, m]`` squared distances by direct differences,
    ``(dx*dx + dy*dy) + dz*dz``, each step rounded to float32."""
    d = q[:, None, :] - r[None, :, :]
    d2 = d * d
    return (d2[..., 0] + d2[..., 1]) + d2[..., 2]


def _near_tie(seed=1):
    """A query at map coordinates and 10 reference points at 0.5 m +- 1e-6,
    where ranking by direct differences and by the expansion disagree on
    the nearest and on the order of the 8 nearest."""
    r = np.random.default_rng(seed)
    q = np.array([[23.7, -11.3, 1.9]], f32)
    qt = torch.tensor(q)
    while True:
        u = r.normal(size=(10, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        ref = (q + u * (0.5 + 1e-6 * r.normal(size=(10, 1)))).astype(f32)
        direct = _direct_sq_dists(qt, torch.tensor(ref))[0].numpy()
        od = np.lexsort((np.arange(10), direct))
        rt = torch.tensor(ref)
        exp = tknn.expansion_sq_dists(qt, rt, tknn.sq_norms(qt), tknn.sq_norms(rt))[0].numpy()
        oe = np.lexsort((np.arange(10), exp))
        if od[0] != oe[0] and (od[:8] != oe[:8]).any():
            return q, ref


@pytest.mark.parametrize("k", [1, 8])
def test_knn_near_tie_matches_jax(k):
    q, ref = _near_tie()
    ones_q, ones_r = np.ones(1, bool), np.ones(len(ref), bool)
    want = jknn.knn_bruteforce(jnp.asarray(q), jnp.asarray(ones_q), jnp.asarray(ref),
                               jnp.asarray(ones_r), k=k)
    got = tknn.knn_bruteforce(torch.tensor(q), torch.tensor(ones_q), torch.tensor(ref),
                              torch.tensor(ones_r), k=k)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


def test_normals_neighbours_match_jax(rng):
    """Every row's 8 nearest within 1 m on the odometry tests' voxelised
    scans (where a ranking by direct differences swaps the 8th neighbour of
    some rows), and the normals built from them."""
    S = scene(rng)
    cfg = jodo.OdometryConfig(max_points=2048)
    swapped, worst = 0, 1.0
    for i, seed in [(0, 0), (1, 1)] + [(i, 10 + i) for i in range(6)]:
        raw = jpc.from_points(scan_at(S, pose(i), seed), capacity=4096)
        vox = jodo.preprocess(raw, None, cfg)  # its normals are JAX's estimate_normals
        xyz, m = vox.padded_xyz(), vox.mask
        want = jknn.knn_bruteforce(xyz, m, xyz, m, k=8, max_dist=1.0)
        tb = interop.point_batch(vox.xyz, vox.mask)
        txyz = tb.padded_xyz()
        got = tknn.knn_bruteforce(txyz, tb.mask, txyz, tb.mask, k=8, max_dist=1.0)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        swapped += int((_direct_knn(txyz, tb.mask, 8, 1.0) != got.ids).any(1).sum())
        tn = tnm.estimate_normals(tb, knn=8, max_dist=1.0, orient_towards=(0.0, 0.0, 0.0))
        tn, jn = tn.extras["normals"].numpy(), np.asarray(vox.normals)
        np.testing.assert_array_equal(np.abs(tn).sum(1) > 0, np.abs(jn).sum(1) > 0)
        dots = (tn * jn).sum(1)[np.abs(jn).sum(1) > 0]
        worst = min(worst, float(dots.min()))
    # The scans hold rows that a direct-difference ranking gets wrong.
    assert swapped > 0
    assert worst >= 1 - 1e-4, worst


def _direct_knn(xyz, mask, k, radius):
    """The k nearest by direct differences (first index among equals),
    -1 beyond ``radius``: the ranking the port used before."""
    d2 = torch.where(mask[None, :], _direct_sq_dists(xyz, xyz), torch.inf)
    ids = []
    for _ in range(k):
        best, arg = d2.min(-1, keepdim=True)
        ids.append(torch.where((best <= radius * radius) & mask[:, None], arg, -1))
        d2.scatter_(-1, arg, torch.inf)
    return torch.cat(ids, -1).to(torch.int32)


@pytest.mark.parametrize("shape", [(20,), (1000,), (8192,), (70_000,), (3, 1000)])
def test_masked_centroid_matches_jax(rng, shape):
    """(c) The reference's centroid, bit for bit: XLA sums windows of 32
    left to right, then the window sums the same way; a sum in any other
    order parts from it in the last bit, and the brute-force matcher's
    expansion turns that bit into other near-tie picks."""
    xyz = np.c_[rng.uniform(-40, 40, shape + (2,)).reshape(-1, 2),
                rng.uniform(0, 4, shape + (1,)).reshape(-1, 1)].reshape(shape + (3,)).astype(f32)
    mask = rng.uniform(size=shape) < 0.8
    jb = jpc.PointBatch(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))
    want = np.asarray(jax.jit(jpc.masked_centroid)(jb))
    np.testing.assert_array_equal(want.view(np.int32), np.asarray(jpc.masked_centroid(jb)).view(np.int32))
    tb = tpc.PointBatch(xyz=torch.tensor(xyz), mask=torch.tensor(mask))
    got = tpc.masked_centroid(tb, xla_order=True).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if shape[-1] >= 1000:  # PyTorch's own sum parts
        assert not np.array_equal(tpc.masked_centroid(tb).numpy(), got)

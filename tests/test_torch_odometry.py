"""The odometry slice of the PyTorch port against the JAX package on the CPU:
the range crops (masks exact), KNN-PCA normals (|dot| >= 1 - 1e-4 where the
two smallest eigenvalues are apart; both rank neighbours by the
|q|^2 - 2q.r + |r|^2 expansion, and the eigen solvers differ in the last
bits), the hash matcher's 8-bucket gather and match (rows, valid and
ids bit-equal, the table built by the port), ``register_pair`` with the hash
matcher on the cached rounds (K1's plain version against JAX's Pallas kernel
in interpret mode; 1e-4 m / 1e-4 rad), and ``LidarOdometry`` over 6 scans
(cumulative pose within 2e-4 m / 2e-4 rad)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.models import icp as jicp
from open3d_slam_private_tpu.ops import filters as jfl
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import normals as jnm
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import odometry as jodo
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from open3d_slam_private_tpu_torch.models import icp as ticp
from open3d_slam_private_tpu_torch.ops import filters as tfl
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import normals as tnm
from open3d_slam_private_tpu_torch.slam import odometry as todo
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

# A table size no other test file uses: the JAX jitted steps are cached per
# static config, and these must be traced with the fused path on.
JODO = jodo.OdometryConfig(max_points=2048)
JODO = dataclasses.replace(JODO, icp=dataclasses.replace(JODO.icp, grid_table_size=1 << 11))


def scene(rng, n=40000):
    """A floor and four walls (every direction constrained), dense enough
    that the odometry's neighbourhoods are planar."""
    floor = np.c_[rng.uniform(-12, 12, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    parts = [floor]
    for i in range(4):
        m = n // 8
        ang = np.pi / 2 * i + 0.3
        u = np.array([np.cos(ang), np.sin(ang)])
        t = rng.uniform(-12, 12, (m, 1))
        parts.append(np.c_[(7 + 1.5 * i) * u[None, :] + t * np.array([[-u[1], u[0]]]),
                           rng.uniform(0, 4, (m, 1))])
    return (np.vstack(parts) + 0.005 * rng.normal(size=(n, 3))).astype(np.float32)


def pose(i, step=0.25, yaw_deg=1.0):
    return np.asarray(jse3.exp_se3(jnp.asarray([0, 0, np.radians(yaw_deg) * i, step * i, 0.03 * i, 0.0])),
                      np.float64)


def scan_at(S, T, seed, n=4000):
    r = np.random.default_rng(seed)
    Ti = np.linalg.inv(T)
    sel = r.choice(len(S), n, replace=False)
    return (S[sel] @ Ti[:3, :3].T + Ti[:3, 3] + 0.01 * r.normal(size=(n, 3))).astype(np.float32)


def both(pts, capacity):
    jb = jpc.from_points(pts, capacity=capacity)
    return jb, interop.point_batch(jb.xyz, jb.mask)


@pytest.mark.parametrize("center", [None, (1.0, -2.0, 0.5)], ids=["origin", "center"])
def test_range_crops_match_jax(rng, center):
    jb, tb = both(rng.uniform(-30, 30, (3000, 3)).astype(np.float32), 4096)
    c = None if center is None else np.asarray(center, np.float32)
    for jf, tf, args in ((jfl.max_dist, tfl.max_dist, (20.0,)), (jfl.min_dist, tfl.min_dist, (10.0,)),
                         (jfl.min_max_radius, tfl.min_max_radius, (5.0, 25.0))):
        want = np.asarray(jf(jb, *args, center=c).mask)
        got = tf(tb, *args, center=c).mask.numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < 3000


def test_estimate_normals_match_jax(rng):
    jb, tb = both(scene(rng, 4000), 4096)
    vp = (0.5, 0.2, 4.0)
    want = jnm.estimate_normals(jb, knn=8, max_dist=1.0, orient_towards=vp, return_eigen=True)
    got = tnm.estimate_normals(tb, knn=8, max_dist=1.0, orient_towards=vp, return_eigen=True)
    wn, gn = np.asarray(want.normals), got.normals.numpy()
    nz_w, nz_g = np.abs(wn).sum(1) > 0, np.abs(gn).sum(1) > 0
    assert (nz_w == nz_g).mean() >= 0.99 and nz_w.sum() > 1000
    ev = np.asarray(want.extras["eigValues"])
    defined = nz_w & nz_g & (ev[:, 1] - ev[:, 0] > 1e-3 * np.abs(ev).max(1))
    assert defined.sum() >= 0.9 * nz_w.sum()
    dots = (wn * gn).sum(1)[defined]
    # The neighbour sets agree (test_torch_parity.py); a few near-degenerate
    # neighbourhoods turn the eigen solvers' last-bit differences into other
    # normals.
    assert np.mean(np.abs(dots) >= 1 - 1e-4) >= 0.99
    assert np.mean(dots > 0) >= 0.99
    ds = np.abs(got.extras["surfaceness"].numpy() - np.asarray(want.extras["surfaceness"]))[defined]
    assert np.mean(ds <= 1e-4) >= 0.99


def _hash_grid(rng):
    pts = scene(rng, 6000)
    jb = jpc.from_points(pts, capacity=8192)
    nrm = rng.normal(size=(8192, 3)).astype(np.float32)
    # 4,096 valid points into 512 buckets of 8: overflow is the normal case.
    jg = jgh.build_grid(jb.padded_xyz(), jb.mask, 2.5, 1 << 9, 8, normals=jnp.asarray(nrm))
    tb = interop.point_batch(jb.xyz, jb.mask)
    tg = tgh.build_grid(tb.padded_xyz(), tb.mask, 2.5, 1 << 9, 8, normals=torch.tensor(nrm))
    np.testing.assert_array_equal(tg.table.numpy().view(np.int32), np.asarray(jg.table).view(np.int32))
    q = (pts[:3000] + 0.3 * rng.normal(size=(3000, 3))).astype(np.float32)
    qm = rng.uniform(size=3000) > 0.05
    return jg, tg, q, qm


def test_gather_candidates_match_jax(rng):
    jg, tg, q, qm = _hash_grid(rng)
    rows, valid = jgh.gather_candidates(jg, jnp.asarray(q), jnp.asarray(qm))
    trows, tvalid = tgh.gather_candidates(tg, torch.tensor(q), torch.tensor(qm))
    np.testing.assert_array_equal(trows.numpy().view(np.int32), np.asarray(rows).view(np.int32))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    # Batched queries [B, N, 3] give the rows of each problem.
    b_rows, b_valid = tgh.gather_candidates(tg, torch.tensor(q).reshape(2, 1500, 3),
                                            torch.tensor(qm).reshape(2, 1500))
    assert torch.equal(b_rows.reshape(trows.shape).view(torch.int32), trows.view(torch.int32))
    assert torch.equal(b_valid.reshape(tvalid.shape), tvalid)


@pytest.mark.parametrize("k,max_dist", [(1, None), (1, 0.6), (3, 0.8)])
def test_grid_match_matches_jax(rng, k, max_dist):
    jg, tg, q, qm = _hash_grid(rng)
    want = jgh.grid_match(jg, jnp.asarray(q), jnp.asarray(qm), k=k, max_dist=max_dist)
    got = tgh.grid_match(tg, torch.tensor(q), torch.tensor(qm), k=k, max_dist=max_dist)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    ok = np.asarray(want.ids) >= 0
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got.dists.numpy()[ok], np.asarray(want.dists)[ok], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.normals.numpy(), np.asarray(want.normals))


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def _close(a, b, tol):
    d = np.linalg.inv(a) @ b
    return np.linalg.norm(d[:3, 3]) < tol and _rot_angle(d[:3, :3]) < tol


@pytest.mark.parametrize("refresh", [5, 0], ids=["cached-K1", "per-iteration"])
def test_register_pair_hash_matches_jax(rng, refresh):
    S = scene(rng)
    cfg = dataclasses.replace(JODO.icp, candidate_refresh_every=refresh)
    jprev = jodo.preprocess(jpc.from_points(scan_at(S, pose(0), 0), capacity=4096), None, JODO)
    jcurr = jodo.preprocess(jpc.from_points(scan_at(S, pose(1), 1), capacity=4096), None, JODO)
    init = (np.linalg.inv(pose(0)) @ pose(1)).astype(np.float32)
    want = jicp.register_pair(jcurr, jprev, jnp.asarray(init), cfg)
    tprev = interop.point_batch(jprev.xyz, jprev.mask, {"normals": jprev.normals})
    tcurr = interop.point_batch(jcurr.xyz, jcurr.mask, {"normals": jcurr.normals})
    before = tpg.pair_gn.launches
    got = ticp.register_pair(tcurr, tprev, torch.tensor(init), interop.config(ticp.ICPConfig, cfg))
    assert tpg.pair_gn.launches == before  # CPU tensors: K1's plain version
    assert _close(np.asarray(want.transform, np.float64), got.transform.double().numpy(), 1e-4)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(float(got.overlap_ratio), float(want.overlap_ratio), atol=2e-3)
    assert bool(got.converged) == bool(want.converged)


def test_lidar_odometry_matches_jax(rng):
    S = scene(rng)
    jo = jodo.LidarOdometry(JODO)
    to = todo.LidarOdometry(interop.config(todo.OdometryConfig, JODO), device="cpu")
    for i in range(6):
        jb = jpc.from_points(scan_at(S, pose(i), 10 + i), capacity=4096)
        if i == 0:  # the preprocessed scans agree
            jp = jodo.preprocess(jb, None, JODO)
            tp = todo.preprocess(interop.point_batch(jb.xyz, jb.mask), to.cfg)
            np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
            np.testing.assert_allclose(tp.xyz.numpy(), np.asarray(jp.xyz), rtol=1e-5, atol=1e-5)
        jpose = jo.add_scan(jb)
        tpose = to.add_scan(interop.point_batch(jb.xyz, jb.mask))
        assert _close(jpose, tpose, 2e-4), (i, np.linalg.inv(jpose) @ tpose)
    truth = np.linalg.inv(pose(0)) @ pose(5)
    assert _close(truth, to.pose, 0.05)


def test_hash_matcher_config():
    cfg = todo.OdometryConfig().icp
    ticp.check_config(cfg)
    with pytest.raises(ValueError, match="hash matcher requires a finite"):
        ticp.check_config(dataclasses.replace(cfg, max_match_dist=float("inf")))

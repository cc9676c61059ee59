"""The port's coarse-alignment pieces against the JAX package's on the CPU:
``compact`` (bit for bit), the weighted Kabsch solve (R, t within 1e-5 on
well-conditioned samples), the FPFH pair angles (within 1e-5) and their
bins (equal except where a value lies within 1e-5 of a bin edge), the FPFH
features, mutual feature matches (equal wherever the best and second
distances of a point, in both directions, are more than 0.05 apart: the
distance product's float32 cancellation noise at feature norms of ~1e2 is
~5e-3), and ``ransac_align`` on the same correspondences (JAX's draws from
``jax.random.key(seed)``): the same ``ok`` and inlier count, T within
1e-4."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.models import minimizers as jmin
from open3d_slam_private_tpu.models import ransac as jransac
from open3d_slam_private_tpu.ops import fpfh as jfpfh
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import normals as jnormals
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.models import minimizers as tmin
from open3d_slam_private_tpu_torch.models import ransac as transac
from open3d_slam_private_tpu_torch.ops import fpfh as tfpfh
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import pointcloud as tpc
from tests.test_fpfh_ransac import landmark_scene, structured_scene


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def _assert_T_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got[..., :3, 3] - want[..., :3, 3]).max() < tol
    rel = np.einsum("...ji,...jk->...ik", want[..., :3, :3], got[..., :3, :3]).reshape(-1, 3, 3)
    assert max(_rot_angle(R) for R in rel) < tol


def test_compact_equals_jax(rng):
    n = 500
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    b = jpc.from_points(pts, capacity=n, extras={"normals": nrm})
    b = b.with_mask(jnp.asarray(rng.uniform(size=n) < 0.4))
    t = interop.point_batch(b.xyz, b.mask, {"normals": b.normals})
    for cap in (64, 300, n, 2 * n):
        j, p = jpc.compact(b, cap), tpc.compact(t, cap)
        assert p.capacity == j.capacity == min(cap, n)
        assert np.array_equal(p.mask.numpy(), np.asarray(j.mask))
        assert np.array_equal(p.xyz.numpy(), np.asarray(j.xyz))
        assert np.array_equal(p.normals.numpy(), np.asarray(j.extras["normals"]))


def test_kabsch_equals_jax(rng):
    """Three-point samples with clear singular gaps (RANSAC's), and a
    weighted cloud (the polish)."""
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.sign(np.linalg.det(
        np.linalg.qr(rng.normal(size=(3, 3)))[0]))
    H = 256
    s = rng.uniform(-5, 5, (H, 3, 3)).astype(np.float32)
    t = (s @ T_true[:3, :3].T + rng.normal(0, 0.05, (H, 3, 3)) + [1.0, -2.0, 0.5]).astype(np.float32)
    w = np.ones((H, 3), np.float32)
    sv = np.linalg.svd(np.einsum("hpi,hpj->hij", s - s.mean(1, keepdims=True), t - t.mean(1, keepdims=True)),
                       compute_uv=False)
    clear = (sv[:, 0] - sv[:, 1] > 1.0) & (sv[:, 1] - sv[:, 2] > 1.0)  # rank 2: s3 ~ 0
    want = np.asarray(jax.vmap(jmin.point_to_point_transform)(jnp.asarray(s), jnp.asarray(t), jnp.asarray(w)))
    got = tmin.point_to_point_transform(torch.as_tensor(s), torch.as_tensor(t), torch.as_tensor(w)).numpy()
    assert clear.sum() > H // 2
    _assert_T_close(got[clear], want[clear], 1e-5)
    pts = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    q = (pts @ T_true[:3, :3].T + [3.0, 1.0, -1.0] + rng.normal(0, 0.02, (2000, 3))).astype(np.float32)
    wt = (rng.uniform(size=2000) < 0.7).astype(np.float32)
    want = np.asarray(jmin.point_to_point_transform(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(wt)))
    got = tmin.point_to_point_transform(torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(wt)).numpy()
    _assert_T_close(got, want, 1e-5)


def _with_features(pts, cap=4096):
    """JAX's normals, grid and FPFH; the port's from the same normals."""
    b = jnormals.estimate_normals(jpc.from_points(pts, capacity=cap), knn=8, max_dist=2.0)
    g = jgh.build_grid(b.padded_xyz(), b.mask, 2.0, 1 << 14, 32, normals=b.normals)
    t = interop.point_batch(b.xyz, b.mask, {"normals": b.normals})
    tg = tgh.build_grid(t.padded_xyz(), t.mask, 2.0, 1 << 14, 32, normals=t.normals)
    return b, g, t, tg


def test_fpfh_angles_bins_and_features(rng):
    b, g, t, tg = _with_features(landmark_scene(rng)[:4096])
    jres = jgh.grid_match(g, b.padded_xyz(), b.mask, k=16)
    res = tgh.grid_match(tg, t.padded_xyz(), t.mask, k=16, sq=tgh.sq3_fma)
    assert np.array_equal(res.ids.numpy(), np.asarray(jres.ids))
    assert np.array_equal(res.dists.numpy(), np.asarray(jres.dists))
    valid = res.valid().numpy() & (res.dists.numpy() > 1e-12)
    got = tfpfh.pair_features(t.padded_xyz()[:, None], t.normals[:, None], res.xyz, res.normals)
    want = jfpfh._pair_features(b.padded_xyz()[:, None], b.normals[:, None], jres.xyz, jres.normals)
    for x, y, (lo, hi) in zip(got, want, [(-1.0, 1.0), (-1.0, 1.0), (-math.pi, math.pi)]):
        x, y = x.numpy(), np.asarray(y)
        assert np.abs(x - y)[valid].max() < 1e-5
        edge = np.abs((y.astype(np.float64) - lo) / (hi - lo) * 11 - np.round((y.astype(np.float64) - lo)
                                                                                / (hi - lo) * 11))
        near = edge * (hi - lo) / 11 < 1e-5
        want_bins = np.clip(((jnp.asarray(y) - lo) / (hi - lo) * 11).astype(jnp.int32), 0, 10)
        diff = (tfpfh.bins(torch.as_tensor(x), lo, hi).numpy() != np.asarray(want_bins)) & valid
        assert not (diff & ~near).any()
    f_j = np.asarray(jfpfh.compute_fpfh(b, g, knn=16))
    f_t = tfpfh.compute_fpfh(t, tg, knn=16).numpy()
    assert np.abs(f_t - f_j).max() < 1e-3  # of 100 a part


def _nearest(fa, fb, mask_b):
    """Each a's nearest b in float64 and its gap to the second nearest."""
    fa, fb = fa.astype(np.float64), fb.astype(np.float64)
    d = (fa * fa).sum(1)[:, None] - 2.0 * fa @ fb.T + (fb * fb).sum(1)[None]
    d[:, ~mask_b] = np.inf
    two = np.sort(d, axis=1)[:, :2]
    return d.argmin(1), two[:, 1] - two[:, 0]


def test_mutual_matches_equal_away_from_ties(rng):
    b_a, g_a, _, _ = _with_features(structured_scene(rng, 3000))
    b_b, g_b, _, _ = _with_features(structured_scene(rng, 3000))
    fa = jfpfh.compute_fpfh(b_a, g_a, knn=16)
    fb = jfpfh.compute_fpfh(b_b, g_b, knn=16)
    ids_j, ok_j = jfpfh.mutual_matches(fa, b_a.mask, fb, b_b.mask)
    ids_t, ok_t = tfpfh.mutual_matches(interop.tensor(fa), interop.tensor(b_a.mask), interop.tensor(fb),
                                       interop.tensor(b_b.mask))
    ma, mb = np.asarray(b_a.mask), np.asarray(b_b.mask)
    fa, fb = np.asarray(fa), np.asarray(fb)
    ab, gap_a = _nearest(fa, fb, mb)
    _, gap_b = _nearest(fb, fa, ma)
    ids_j = np.asarray(ids_j)
    clear = ma & (gap_a > 0.05) & (gap_b[ab] > 0.05)
    assert clear.sum() > 0.2 * ma.sum()  # planar points tie with one another
    assert np.array_equal(ok_t.numpy()[clear], np.asarray(ok_j)[clear])
    assert np.array_equal(ids_t.numpy()[clear], ids_j[clear])
    assert ok_t.sum() > 0


def _ransac_pair(src, tgt, mask, seed, cfg_kw):
    j = jransac.ransac_align(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), jax.random.key(seed),
                             jransac.RansacConfig(**cfg_kw))
    t = transac.ransac_align(interop.tensor(src), interop.tensor(tgt), interop.tensor(mask), seed,
                             transac.RansacConfig(**cfg_kw))
    assert bool(t.ok) == bool(j.ok)
    assert int(t.inliers) == int(j.inliers)
    assert float(t.fitness) == pytest.approx(float(j.fitness), rel=1e-6)
    _assert_T_close(t.transform.numpy(), np.asarray(j.transform), 1e-4)
    return t


def test_ransac_on_synthetic_correspondences(rng):
    pts = structured_scene(rng)
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, :3] *= np.sign(np.linalg.det(T[:3, :3]))
    T[:3, 3] = [2.0, -1.0, 0.3]
    sel = rng.choice(len(pts), 500, replace=False)
    src = pts[sel].astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt[:150] = rng.uniform(-5, 5, (150, 3))
    mask = rng.uniform(size=500) < 0.9
    res = _ransac_pair(src, tgt, mask, 0, dict(num_hypotheses=256, inlier_dist=0.1))
    assert bool(res.ok)
    garbage = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    res = _ransac_pair(garbage, rng.uniform(-5, 5, (300, 3)).astype(np.float32), np.ones(300, bool), 1,
                       dict(num_hypotheses=128, inlier_dist=0.05, min_inliers=15))
    assert not bool(res.ok)


def test_ransac_on_jax_fpfh_matches(rng):
    """The coarse alignment's own input: JAX's mutual FPFH matches between a
    landmark scene and a moved, resampled copy."""
    pts_a = landmark_scene(rng)
    T = np.eye(4)
    T[:2, :2] = [[math.cos(0.6), -math.sin(0.6)], [math.sin(0.6), math.cos(0.6)]]
    T[:3, 3] = [2.0, 1.0, 0.0]
    pts_b = (pts_a @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    a, ga, _, _ = _with_features(pts_a[rng.uniform(size=len(pts_a)) < 0.6], cap=8192)
    b, gb, _, _ = _with_features(pts_b[rng.uniform(size=len(pts_b)) < 0.6], cap=8192)
    ids, ok = jfpfh.mutual_matches(jfpfh.compute_fpfh(a, ga), a.mask, jfpfh.compute_fpfh(b, gb), b.mask)
    tgt = np.asarray(b.xyz)[np.maximum(np.asarray(ids), 0)]
    res = _ransac_pair(np.asarray(a.xyz), tgt, np.asarray(ok), 0, dict(num_hypotheses=128, inlier_dist=0.5,
                                                                       min_inliers=15))
    assert int(res.inliers) >= 15

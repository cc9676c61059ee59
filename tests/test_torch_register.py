"""``register_pair`` of the PyTorch port against the JAX package's, on the
CPU: the per-iteration chain (re-match, re-trim and solve every iteration)
with the cell-list matcher at knn 1 and 3, exact and histogram trimming,
X-ICP "none" and "optimized"; and the brute matchers, "brute" and
"brute_pallas" (the JAX side runs its Pallas 1-NN kernel in interpret mode);
and ``ICPSequence``.
Tolerances as for the cached chain: transforms within 1e-4 m / 1e-4 rad,
iterations within 1, X-ICP decisions equal."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.models import icp as jicp
from open3d_slam_private_tpu.models import localizability as jloc
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import normals as jnm
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.models import icp as ticp
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

DEG = jloc.DegeneracyConfig(method="optimized", enough_information_threshold=250.0,
                            insufficient_information_threshold=180.0)
BASE = dict(max_match_dist=0.5, matcher="grid", grid_table_size=1 << 12, grid_bucket_cap=24,
            trimmed_ratio=0.9, max_iterations=15)


PERTURB = np.asarray(jse3.exp_se3(jnp.asarray([0.01, -0.01, 0.015, 0.05, 0.04, -0.05])), np.float64)


def scene(rng, n=6000, planar=False):
    """Floor + two perpendicular walls (every direction constrained), or
    two floors only (``planar``: x, y and yaw unconstrained)."""
    floor = np.c_[rng.uniform(-8, 8, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    if planar:
        return (np.vstack([floor, floor + [0.03, 0.02, 0.0]]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)
    wx = np.c_[np.full((n // 4, 1), 5.0), rng.uniform(-8, 8, (n // 4, 1)), rng.uniform(0, 3, (n // 4, 1))]
    wy = np.c_[rng.uniform(-8, 8, (n // 4, 1)), np.full((n // 4, 1), -4.0), rng.uniform(0, 3, (n // 4, 1))]
    return (np.vstack([floor, wx, wy]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)


def reference(pts):
    """JAX reference cloud with moment normals, and its port twin."""
    ref = jpc.from_points(pts, capacity=8192)
    g = jgh.build_grid(ref.padded_xyz(), ref.mask, 2.0, 1 << 12, 32)
    ref = jnm.estimate_normals_moments(ref, g, max_dist=1.0, orient_towards=jnp.zeros(3))
    return ref, interop.point_batch(ref.xyz, ref.mask, {"normals": ref.normals})


def reading(rng, pts, twist, n=1024):
    T_true = np.asarray(jse3.exp_se3(jnp.asarray(twist, jnp.float32)))
    sel = pts[rng.choice(len(pts), n, replace=False)] + 0.01 * rng.normal(size=(n, 3))
    Ti = np.linalg.inv(T_true)
    r = jpc.from_points((sel @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32), capacity=n)
    return r, interop.point_batch(r.xyz, r.mask), (T_true @ PERTURB).astype(np.float32)


def rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def assert_same_result(got, want):
    Tw = np.asarray(want.transform, np.float64).reshape(-1, 4, 4)
    Tg = got.transform.double().numpy().reshape(-1, 4, 4)
    for a, b in zip(Tw, Tg):
        d = np.linalg.inv(a) @ b
        assert np.linalg.norm(d[:3, 3]) < 1e-4
        assert rot_angle(d[:3, :3]) < 1e-4
    it_w = np.asarray(want.iterations).reshape(-1)
    assert (np.abs(got.iterations.numpy().reshape(-1) - it_w) <= 1).all()
    for f in ("degenerate", "localizability_rot", "localizability_trans"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.match_ratio.numpy(), np.asarray(want.match_ratio), atol=2e-3)
    np.testing.assert_allclose(got.overlap_ratio.numpy(), np.asarray(want.overlap_ratio), atol=2e-3)


@pytest.mark.parametrize("change,planar", [
    (dict(knn=1, fast_trimming=False, coarse_iterations=5, coarse_stride=4), False),
    (dict(knn=1, fast_trimming=True, degeneracy=DEG), False),
    (dict(knn=1, fast_trimming=True, degeneracy=DEG), True),
    (dict(knn=3, fast_trimming=False, degeneracy=DEG), False),
    (dict(knn=3, fast_trimming=True), False),
    (dict(matcher="brute", fast_trimming=True), False),
    (dict(matcher="brute_pallas", max_match_dist=math.inf, fast_trimming=False), False),
], ids=["grid-k1-exact-coarse", "grid-k1-hist-xicp", "grid-k1-hist-xicp-planar",
        "grid-k3-exact-xicp", "grid-k3-hist", "brute", "brute_pallas"])
def test_register_pair_matches_jax(rng, change, planar):
    cfg = jicp.ICPConfig(**{**BASE, **change})
    pts = scene(rng, planar=planar)
    jref, tref = reference(pts)
    jr, tr, init = reading(rng, pts, [0.01, -0.008, 0.012, 0.08, -0.05, 0.03])
    want = jicp.register_pair(jr, jref, jnp.asarray(init), cfg)
    got = ticp.register_pair(tr, tref, torch.tensor(init), interop.config(ticp.ICPConfig, cfg))
    assert got.transform.shape == (4, 4)
    assert_same_result(got, want)
    assert bool(np.asarray(want.converged)) and bool(got.converged)
    assert planar == bool(got.degenerate)
    if not planar:  # both found the truth
        T_true = init @ np.linalg.inv(PERTURB)
        d = np.linalg.inv(T_true) @ got.transform.double().numpy()
        assert np.linalg.norm(d[:3, 3]) < 0.01


def test_icp_sequence(rng):
    """A persistent map and a stream of readings."""
    pts = scene(rng)
    jref, tref = reference(pts)
    cfg = jicp.ICPConfig(**BASE, fast_trimming=True, degeneracy=DEG)
    seq_j, seq_t = jicp.ICPSequence(cfg), ticp.ICPSequence(interop.config(ticp.ICPConfig, cfg))
    with pytest.raises(RuntimeError, match="no map"):
        seq_t(tref)
    seq_j.set_map(jref)
    seq_t.set_map(tref)
    assert seq_t.has_map()
    for twist in ([0.01, -0.008, 0.012, 0.08, -0.05, 0.03],
                  [0.012, -0.01, 0.02, 0.1, -0.06, 0.035]):
        jr, tr, init = reading(rng, pts, twist)
        assert_same_result(seq_t(tr, torch.tensor(init)), seq_j(jr, jnp.asarray(init)))
    seq_t.clear_map()
    assert not seq_t.has_map()

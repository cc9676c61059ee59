"""The port's scan-to-map ICP chain against the JAX package.

The JAX side runs its fused path, which off a TPU it takes only with
``O3S_FUSED_INTERPRET=1`` (Pallas kernels in interpret mode); the port takes
its fused path by config on any device (the kernels' plain versions on the
CPU). Tolerances: X-ICP decisions equal; transforms within 1e-4 m and 1e-4
rad; iteration counts within 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.models import icp as jicp
from open3d_slam_private_tpu.models import localizability as jloc
from open3d_slam_private_tpu.models import minimizers as jmin
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import normals as jnm
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.models import icp as ticp
from open3d_slam_private_tpu_torch.models import localizability as tloc
from open3d_slam_private_tpu_torch.models import minimizers as tmin
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

DEG = jloc.DegeneracyConfig(method="optimized", enough_information_threshold=250.0,
                            insufficient_information_threshold=180.0)
CFG = jicp.ICPConfig(
    knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 12, grid_bucket_cap=24,
    trimmed_ratio=0.9, fast_trimming=True, minimizer="point_to_plane", max_iterations=10,
    min_diff_rot=1e-3, min_diff_trans=8e-3, coarse_iterations=20, coarse_stride=4,
    candidate_refresh_every=10, candidate_slack=0.25, fused_kernel=True, degeneracy=DEG,
)


def _scene(rng, planar=False, n=6000):
    floor = np.c_[rng.uniform(-8, 8, (n // 2, 2)), 0.01 * rng.normal(size=(n // 2, 1))]
    if planar:
        return (np.vstack([floor, floor + [0.03, 0.02, 0.0]]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)
    wx = np.c_[np.full((n // 4, 1), 5.0), rng.uniform(-8, 8, (n // 4, 1)), rng.uniform(0, 3, (n // 4, 1))]
    wy = np.c_[rng.uniform(-8, 8, (n // 4, 1)), np.full((n // 4, 1), -4.0), rng.uniform(0, 3, (n // 4, 1))]
    return (np.vstack([floor, wx, wy]) + 0.004 * rng.normal(size=(n, 3))).astype(np.float32)


def _jax_reference(scene, cfg):
    ref_b = jpc.from_points(scene, capacity=8192)
    g = jgh.build_grid(ref_b.padded_xyz(), ref_b.mask, 2.0, 1 << 12, 32)
    ref_b = jnm.estimate_normals_moments(ref_b, g, max_dist=1.0, orient_towards=jnp.zeros(3))
    return ref_b, jicp.build_reference(ref_b, cfg)


def _port_reference(ref):
    return interop.icp_reference(ref.cloud.xyz, ref.cloud.mask, ref.cloud.normals, ref.centroid,
                                 ref.grid.table, ref.grid.cell_size, ref.grid.dropped)


def _readings(rng, scene, B=2, n=2000):
    reads, inits = [], []
    for i in range(B):
        T_true = np.asarray(jse3.exp_se3(jnp.asarray([0.01, -0.008, 0.012 * (i + 1), 0.08, -0.05, 0.03])))
        pts = scene[rng.choice(len(scene), n, replace=False)] + 0.01 * rng.normal(size=(n, 3))
        Ti = np.linalg.inv(T_true)
        reads.append(jpc.from_points((pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32), capacity=2048))
        perturb = np.asarray(jse3.exp_se3(jnp.asarray([0.01, -0.01, 0.015, 0.05, 0.04, -0.05])))
        inits.append((T_true @ perturb).astype(np.float32))
    return jpc.stack(reads), np.stack(inits)


_JAX_BATCH = {}


def _jax_icp_batch(readings, ref, init, cfg):
    fn = _JAX_BATCH.get(cfg)
    if fn is None:
        fn = _JAX_BATCH[cfg] = jax.jit(
            lambda r, rf, T: jax.vmap(lambda rr, TT: jicp.icp_single(rr, rf, TT, cfg))(r, T))
    return fn(readings, ref, jnp.asarray(init))


def _rot_angle(R):
    """Rotation angle of R; atan2 of the skew and symmetric parts stays exact
    for small angles of a float32 (not exactly orthonormal) matrix."""
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


@pytest.mark.parametrize("gather_kernel,planar", [(False, False), (True, False), (True, True)],
                         ids=["rerank", "gather", "gather-planar"])
def test_icp_batch_matches_vmapped_icp_single(rng, gather_kernel, planar):
    cfg = dataclasses.replace(CFG, gather_kernel=gather_kernel)
    scene = _scene(rng, planar)
    _, ref = _jax_reference(scene, cfg)
    readings, init = _readings(rng, scene)
    want = _jax_icp_batch(readings, ref, init, cfg)
    got = ticp.icp_batch(interop.point_batch(readings.xyz, readings.mask), _port_reference(ref),
                         torch.tensor(init), interop.config(ticp.ICPConfig, cfg))
    Tw, Tg = np.asarray(want.transform, np.float64), got.transform.double().numpy()
    for i in range(len(init)):
        d = np.linalg.inv(Tw[i]) @ Tg[i]
        assert np.linalg.norm(d[:3, 3]) < 1e-4
        assert _rot_angle(d[:3, :3]) < 1e-4
    assert (np.abs(got.iterations.numpy() - np.asarray(want.iterations)) <= 1).all()
    np.testing.assert_array_equal(got.degenerate.numpy(), np.asarray(want.degenerate))
    np.testing.assert_array_equal(got.localizability_rot.numpy(), np.asarray(want.localizability_rot))
    np.testing.assert_array_equal(got.localizability_trans.numpy(), np.asarray(want.localizability_trans))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.match_row_saturation.numpy(), np.asarray(want.match_row_saturation), atol=2e-3)
    np.testing.assert_allclose(got.overlap_ratio.numpy(), np.asarray(want.overlap_ratio), atol=2e-3)
    assert planar == bool(np.asarray(want.degenerate).all())


def test_icp_single_is_batch_of_one(rng):
    cfg = interop.config(ticp.ICPConfig, CFG)
    scene = _scene(rng)
    _, ref = _jax_reference(scene, CFG)
    readings, init = _readings(rng, scene, B=1)
    pref = _port_reference(ref)
    single = ticp.icp_single(interop.point_batch(readings.xyz[0], readings.mask[0]), pref,
                             torch.tensor(init[0]), cfg)
    batch = ticp.icp_batch(interop.point_batch(readings.xyz, readings.mask), pref, torch.tensor(init), cfg)
    assert single.transform.shape == (4, 4)
    assert torch.equal(single.transform, batch.transform[0])
    assert int(single.iterations) == int(batch.iterations[0])


def test_build_reference_matches(rng):
    scene = _scene(rng)
    ref_b, ref = _jax_reference(scene, CFG)
    cfg = interop.config(ticp.ICPConfig, CFG)
    got = ticp.build_reference(interop.point_batch(ref_b.xyz, ref_b.mask, {"normals": ref_b.normals}),
                               cfg, centroid=interop.tensor(ref.centroid))
    np.testing.assert_array_equal(got.grid.table.numpy().view(np.int32), np.asarray(ref.grid.table).view(np.int32))
    auto = ticp.build_reference(interop.point_batch(ref_b.xyz, ref_b.mask), cfg)
    np.testing.assert_allclose(auto.centroid.numpy(), np.asarray(ref.centroid), atol=1e-5)


def _pairs_for_analysis(rng, planar):
    n = 3000
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    nrm = np.zeros((n, 3), np.float32)
    nrm[:, 2] = 1.0
    if not planar:
        k = n // 3
        nrm[:k] = [1.0, 0.0, 0.0]
        nrm[k:2 * k] = [0.0, 0.6, 0.8]
    nrm += 0.05 * rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = src - 0.02 * nrm
    w = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return src, q, nrm, w


@pytest.mark.parametrize("planar", [False, True], ids=["constrained", "planar"])
def test_xicp_decisions_and_kkt_solve(rng, planar):
    src, q, nrm, w = _pairs_for_analysis(rng, planar)
    A, b = jmin.point_to_plane_normal_equations_bc(jnp.asarray(src), jnp.asarray(q[:, None]),
                                                   jnp.asarray(nrm[:, None]), jnp.asarray(w[:, None]))
    At, bt = tmin.point_to_plane_normal_equations_bc(torch.tensor(src)[None], torch.tensor(q[:, None])[None],
                                                     torch.tensor(nrm[:, None])[None], torch.tensor(w[:, None])[None])
    scale = float(np.abs(np.asarray(A)).max())
    np.testing.assert_allclose(At[0].numpy(), np.asarray(A), atol=1e-5 * scale)
    np.testing.assert_allclose(bt[0].numpy(), np.asarray(b), atol=1e-5 * scale)

    mask = w > 0
    want = jloc.analyze_optimized(A, b, jnp.asarray(src), jnp.asarray(nrm), jnp.asarray(mask), DEG)
    got = tloc.analyze_optimized(torch.tensor(np.asarray(A))[None], torch.tensor(np.asarray(b))[None],
                                 torch.tensor(src)[None], torch.tensor(nrm)[None], torch.tensor(mask)[None],
                                 interop.config(tloc.DegeneracyConfig, DEG))
    lr, lt = np.asarray(want.localizability_rot), np.asarray(want.localizability_trans)
    np.testing.assert_array_equal(got.localizability_rot[0].numpy(), lr)
    np.testing.assert_array_equal(got.localizability_trans[0].numpy(), lt)
    assert planar == (lr.min() < 0.5 or lt.min() < 0.5)
    # Constrained subspaces (sign-free): projectors onto the locked directions.
    for V_w, V_g, loc in ((want.rotation_eigenvectors, got.rotation_eigenvectors[0], lr),
                          (want.translation_eigenvectors, got.translation_eigenvectors[0], lt)):
        Vw, Vg = np.asarray(V_w) * (1 - loc), V_g.numpy() * (1 - loc)
        np.testing.assert_allclose(Vg @ Vg.T, Vw @ Vw.T, atol=1e-4)

    x_w = jloc.solve_with_equality_constraints(A, b, want)
    loc_t = tloc.LocalizabilityResult(**{
        f.name: interop.tensor(getattr(want, f.name))[None] for f in dataclasses.fields(want)})
    x_g = tloc.solve_with_equality_constraints(torch.tensor(np.asarray(A))[None],
                                               torch.tensor(np.asarray(b))[None], loc_t)
    np.testing.assert_allclose(x_g[0].numpy(), np.asarray(x_w), atol=1e-5 * float(np.abs(np.asarray(x_w)).max()) + 1e-7)


def test_solve_spd_unrolled(rng):
    X = rng.normal(size=(4, 50, 6)).astype(np.float32)
    A = X.transpose(0, 2, 1) @ X
    b = rng.normal(size=(4, 6)).astype(np.float32)
    got = tmin.solve_spd_unrolled(torch.tensor(A), torch.tensor(b)).numpy()
    for i in range(4):
        np.testing.assert_allclose(got[i], np.asarray(jmin.solve_spd_unrolled(jnp.asarray(A[i]), jnp.asarray(b[i]))),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tmin.delta_transform_from_x(torch.tensor(b)).numpy(),
                               np.asarray(jmin.delta_transform_from_x(jnp.asarray(b))), atol=1e-6)

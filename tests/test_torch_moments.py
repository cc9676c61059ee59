"""The moment algebra of the cached rounds, GICP's normal equations and the
grid normals, against the JAX package on the CPU.

Tolerances: a moment sum within 1e-5 of the sum of its terms' magnitudes
(float32 sums in other orders); a system rebuilt from moments within 1e-5
of the largest entry of the JAX system on the same moments; the port's
moments against its own direct per-pair system at the JAX package's own
tolerance (``tests/test_icp.py``: rtol 1e-4, atol 1e-2); normals as
``test_torch_ops.py`` holds them (|dot| >= 1 - 1e-4 where the two smallest
covariance eigenvalues differ). The kernel's summation order, route by
route, through its numpy model (``tests/moments_model.py``): within 1e-5 of
each sum's scale of the float64 sum, and a raw column's bits fixed by P
alone (the card tests hold the kernel to the model's bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.models import minimizers as jmin
from open3d_slam_private_tpu.ops import grid_hash as jgh
from open3d_slam_private_tpu.ops import normals as jnm
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.geometry import se3 as tse3
from open3d_slam_private_tpu_torch.kernels import moments as tmk
from open3d_slam_private_tpu_torch.models import minimizers as tmin
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import normals as tnm
from moments_model import raw_model, structured_model
from tests.test_torch_register import reading, scene

TWIST = [0.05, -0.1, 0.2, 0.3, -0.2, 0.1]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _pairs(rng, B=2, P=600):
    """Pairs ``[B, P]`` as the cached rounds freeze them: reading points,
    matches, reference normals, rotated reading normals and weights (some
    0, some fractional)."""
    p0 = rng.normal(0, 4, (B, P, 3)).astype(np.float32)
    q = (p0 + rng.normal(0, 0.05, (B, P, 3))).astype(np.float32)
    n = _unit(rng.normal(size=(B, P, 3)))
    sn = _unit(rng.normal(size=(B, P, 3)))
    w = ((rng.uniform(0, 1, (B, P)) > 0.25) * rng.uniform(0.5, 2, (B, P))).astype(np.float32)
    return p0, q, n, sn, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _magnitudes(mom_fn, *arrays):
    """The sum of each moment's terms' magnitudes (float64)."""
    return mom_fn(*[torch.from_numpy(np.abs(a).astype(np.float64)) for a in arrays])


@pytest.mark.parametrize("kind", ["point_to_plane", "gicp"])
def test_moments_match_jax(rng, kind):
    p0, q, n, sn, w = _pairs(rng)
    for b in range(p0.shape[0]):
        if kind == "gicp":
            want = jmin.gicp_moments(*map(jnp.asarray, (p0[b], sn[b], q[b], n[b], w[b])))
            got = tmk.gicp_moments(*_t(p0, sn, q, n, w))
            # |M| <= 1 / (2 eps) entrywise bounds the precision's terms.
            scale = _magnitudes(tmin.gicp_moments, p0, sn, q, n, w * 500.0)
            layout = tmin.GICP_LAYOUT
        else:
            want = jmin.point_to_plane_moments(*map(jnp.asarray, (p0[b], q[b], n[b], w[b])))
            got = tmk.point_to_plane_moments(*_t(p0, q, n, w))
            scale = _magnitudes(tmin.point_to_plane_moments, p0, q, n, w)
            layout = tmin.P2PL_LAYOUT
        assert set(got) == set(want) == {name for name, _ in layout}
        for name in want:
            err = np.abs(got[name][b].numpy() - np.asarray(want[name]))
            assert (err <= 1e-5 * scale[name][b].numpy() + 1e-30).all(), name


@pytest.mark.parametrize("kind", ["point_to_plane", "gicp"])
def test_system_from_moments_matches_jax(rng, kind):
    """At a perturbed pose, on the same (JAX) moments."""
    p0, q, n, sn, w = _pairs(rng, B=1)
    T = jse3.exp_se3(jnp.asarray(TWIST, jnp.float32))
    if kind == "gicp":
        mom = jmin.gicp_moments(*map(jnp.asarray, (p0[0], sn[0], q[0], n[0], w[0])))
        want = jmin.gicp_system_from_moments(T, mom)
        fn = tmin.gicp_system_from_moments
    else:
        mom = jmin.point_to_plane_moments(*map(jnp.asarray, (p0[0], q[0], n[0], w[0])))
        want = jmin.point_to_plane_system_from_moments(T, mom)
        fn = tmin.point_to_plane_system_from_moments
    got = fn(interop.tensor(T)[None], {k: interop.tensor(v)[None] for k, v in mom.items()})
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g[0].numpy(), wnt, rtol=0, atol=1e-5 * np.abs(wnt).max())


@pytest.mark.parametrize("kind", ["point_to_plane", "gicp"])
def test_moments_match_direct_system(rng, kind):
    """Twins of the JAX package's own checks (``tests/test_icp.py``
    ``test_gicp_moments_match_direct_system``,
    ``test_pt2plane_moments_match_direct_system``): the moments' system at
    a pose equals the direct per-pair reduction there, and so does the
    residual."""
    p0, q, n, sn, w = _t(*_pairs(rng, B=1, P=500))
    T = tse3.exp_se3(torch.tensor(TWIST))[None]
    p = tse3.apply_transform(T, p0)
    if kind == "gicp":
        sn_rot = tse3.apply_rotation(T, sn)
        A_d, b_d = tmin.gicp_normal_equations(p, sn_rot, q, n, w)
        A_m, b_m, resid = tmin.gicp_system_from_moments(T, tmk.gicp_moments(p0, sn_rot, q, n, w))
        rd = torch.sqrt((w * ((p - q) ** 2).sum(-1)).sum() / w.sum())
    else:
        A_d, b_d = tmin.point_to_plane_normal_equations_bc(p, q[:, :, None], n[:, :, None], w[:, :, None])
        A_m, b_m, resid = tmin.point_to_plane_system_from_moments(T, tmk.point_to_plane_moments(p0, q, n, w))
        r = ((p - q) * n).sum(-1)
        rd = torch.sqrt((w * r * r).sum() / w.sum())
    np.testing.assert_allclose(A_m.numpy(), A_d.numpy(), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(b_m.numpy(), b_d.numpy(), rtol=1e-4, atol=1e-2)
    assert abs(float(resid) - float(rd)) < 1e-3 * max(float(rd), 1e-6)


def test_gicp_normal_equations_match_jax(rng):
    p0, q, n, sn, w = _pairs(rng, B=1)
    want = jmin.gicp_normal_equations(*map(jnp.asarray, (p0[0], sn[0], q[0], n[0], w[0])), epsilon=2e-3)
    got = tmin.gicp_normal_equations(*_t(p0, sn, q, n, w), epsilon=2e-3)
    terms = tmin.gicp_pair_terms(*_t(p0, sn, q, n, w), epsilon=2e-3)
    np.testing.assert_array_equal(tmk.pair_sums(terms).numpy(), terms.sum(-2).numpy())
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g[0].numpy(), wnt, rtol=0, atol=1e-5 * np.abs(wnt).max())


def test_flat_layouts_and_esum(rng):
    """The kernel's flat rows: 131 and 147 sums, packed and unpacked in the
    layouts' order; ``esum`` is the einsum it replaces."""
    p0, q, n, sn, w = _t(*_pairs(rng, B=3, P=50))
    for mom, layout, size in ((tmin.point_to_plane_moments(p0, q, n, w), tmin.P2PL_LAYOUT, 131),
                              (tmin.gicp_moments(p0, sn, q, n, w), tmin.GICP_LAYOUT, 147)):
        flat = tmin.pack_moments(mom, layout)
        assert flat.shape == (3, size) == (3, tmin.layout_size(layout))
        for name, v in tmin.unpack_moments(flat, layout).items():
            assert torch.equal(v, mom[name])
    a = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(1))
    b = torch.randn(4, 5, 3, 3, generator=torch.Generator().manual_seed(2))
    for spec, ops in (("ij,jk->ik", (a[0, :, :3], b[0, :3, 0])), ("...ij,...jkl->...ikl", (a, b)),
                      ("...eae->...a", (b[:, :3],)), ("...ij,...ji->...", (a, b[..., 0]))):
        np.testing.assert_allclose(tmin.esum(spec.replace("...", ""), *ops).numpy(),
                                   torch.einsum(spec, *ops).numpy(), rtol=1e-5, atol=1e-5)


def test_estimate_normals_grid_matches_jax(rng):
    """GICP's reading normals as the bench makes them: a hash grid of the
    reading itself (cell 0.5 m), 8 neighbours within 0.5 m."""
    pts = scene(rng)
    jr, tr, _ = reading(rng, pts, [0.01, -0.008, 0.012, 0.08, -0.05, 0.03], n=2048)
    jg = jgh.build_grid(jr.padded_xyz(), jr.mask, 0.5, 1 << 12, 32)
    tg = tgh.build_grid(tr.padded_xyz(), tr.mask, 0.5, table_size=1 << 12, bucket_cap=32)
    want = np.asarray(jnm.estimate_normals_grid(jr, jg, knn=8, max_dist=0.5).normals)
    got = tnm.estimate_normals_grid(tr, tg, knn=8, max_dist=0.5).normals.numpy()
    nz_w, nz_g = np.abs(want).sum(1) > 0, np.abs(got).sum(1) > 0
    np.testing.assert_array_equal(nz_g, nz_w)
    res = jgh.grid_match(jg, jr.padded_xyz(), jr.mask, k=8, max_dist=0.5)
    nb, valid = np.asarray(res.xyz, np.float64), np.asarray(res.valid())
    cnt = np.maximum(valid.sum(1), 1)[:, None]
    mean = (nb * valid[..., None]).sum(1) / cnt
    c = (nb - mean[:, None]) * valid[..., None]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c) / cnt[..., None])
    defined = nz_w & (ev[:, 1] - ev[:, 0] > 1e-3 * np.abs(ev).max(1))
    assert defined.sum() >= 0.95 * nz_w.sum()
    assert np.abs((want * got).sum(1)[defined]).min() >= 1 - 1e-4


@pytest.mark.parametrize("P", [1, 255, 1000, 1025, 4096, 9000, 16383, 16384, 16385, 40000])
def test_raw_plan_chunks(P):
    """The raw entry's chunks cover the P pairs, none empty; one launch (a
    cluster of at most 8 blocks) exactly up to 16,384 pairs."""
    G, CH, one = tmk.raw_plan(P)
    assert one == (P <= tmk.RAW_ONE_LAUNCH)
    assert (G <= 8) if one else (G > 8)
    assert (G - 1) * CH < P <= G * CH


@pytest.mark.parametrize("P", [1, 300, 1000, 4096, 16384, 16385, 40000])
def test_raw_order_model_matches_fp64(P):
    """The raw entry's order (both routes) within 1e-5 of each column's
    scale of the float64 sum, on terms with a spread of magnitudes and
    signs, zeros among them."""
    rng = np.random.default_rng(P)
    t = (rng.normal(size=(2, P, 5)) * np.exp(rng.normal(0, 2, (2, P, 5)))).astype(np.float32)
    t[:, ::7, 1] = 0.0
    t64 = t.astype(np.float64)
    err = np.abs(raw_model(t) - t64.sum(1))
    assert (err <= 1e-5 * np.abs(t64).sum(1) + 1e-30).all()


@pytest.mark.parametrize("P", [777, 16384, 20000])
def test_raw_order_depends_on_p_alone(P):
    """A column's bits in the raw order are the same at S = 1, 3, 6, 36 and
    160, at any position, in any group and for any B."""
    rng = np.random.default_rng(3)
    col = (rng.normal(size=P) * 10.0 ** rng.integers(-3, 4, P)).astype(np.float32)
    want = raw_model(col[None, :, None])[0, 0]
    for S, j, B in ((1, 0, 1), (3, 2, 2), (6, 1, 1), (36, 20, 3), (160, 159, 1), (160, 77, 2)):
        t = rng.normal(size=(B, P, S)).astype(np.float32)
        t[-1, :, j] = col
        got = raw_model(t)[-1, j]
        assert got.view(np.int32) == want.view(np.int32), (S, j, B)


@pytest.mark.parametrize("kind", ["point_to_plane", "gicp"])
@pytest.mark.parametrize("P", [600, 9000])
def test_structured_order_model_matches_fp64(rng, kind, P):
    """The structured entries' order within 1e-5 of each sum's scale of the
    float64 moments, and a problem's bits alone equal to its bits in a
    batch (the order depends on P alone)."""
    p0, q, n, sn, w = _pairs(rng, B=3, P=P)
    got = structured_model(kind, p0, q, n, w, sn)
    alone = structured_model(kind, p0[1:2], q[1:2], n[1:2], w[1:2], sn[1:2])
    assert np.array_equal(got[1:2].view(np.int32), alone.view(np.int32))
    d = [torch.from_numpy(a.astype(np.float64)) for a in (p0, q, n, sn, w)]
    if kind == "gicp":
        layout = tmin.GICP_LAYOUT
        M = tmin._gicp_precision(d[3], d[2], 1e-3) * d[4][..., None, None]
        want = tmin.gicp_moments_from_precision(d[0], d[1], M, d[4])
        scale = tmin.gicp_moments_from_precision(d[0].abs(), d[1].abs(), M.abs(), d[4])
    else:
        layout = tmin.P2PL_LAYOUT
        want = tmin.point_to_plane_moments(d[0], d[1], d[2], d[4])
        scale = tmin.point_to_plane_moments(d[0].abs(), d[1].abs(), d[2].abs(), d[4])
    want, scale = tmin.pack_moments(want, layout).numpy(), tmin.pack_moments(scale, layout).numpy()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-30).all()


def test_pair_sums_groups_cpu_is_each_groups_sum(rng):
    """On the CPU each group's sums are its own ``t.sum(-2)``, bit for bit
    (a sum of the groups' concatenation would not be), with lead axes."""
    groups = [torch.from_numpy(rng.normal(size=(2, 3, 5000, S)).astype(np.float32)) for S in (3, 3, 36, 1)]
    got = tmk.pair_sums_groups(*groups)
    assert len(got) == len(groups)
    for g, t in zip(got, groups):
        assert g.shape == t.shape[:-2] + t.shape[-1:]
        assert torch.equal(g, t.sum(-2))
    assert torch.equal(tmk.pair_sums(groups[2]), groups[2].sum(-2))

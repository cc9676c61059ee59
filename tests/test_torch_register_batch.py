"""The PyTorch port's batched registration against the JAX package on the
CPU: the candidate-cached rounds at knn = 4 through K3 and with the
rank-select kernel K4 (``select_kernel=True``), ``register_batch`` (B = 2)
and ``register_hypotheses`` (H = 4). The JAX side runs its
Pallas kernels in interpret mode (``O3S_FUSED_INTERPRET=1``; without it its
fused and select paths take XLA). Transforms within 1e-4 m / 1e-4 rad,
iterations within 1, X-ICP decisions equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.models import icp as jicp
from open3d_slam_private_tpu.models import localizability as jloc
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.geometry import se3 as tse3
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from open3d_slam_private_tpu_torch.models import icp as ticp
from test_torch_register import assert_same_result, reading, reference, scene
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

DEG = jloc.DegeneracyConfig(method="optimized", enough_information_threshold=250.0,
                            insufficient_information_threshold=180.0)
CACHED = jicp.ICPConfig(
    knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 12, grid_bucket_cap=24,
    trimmed_ratio=0.9, fast_trimming=True, max_iterations=10, min_diff_rot=1e-3,
    min_diff_trans=8e-3, coarse_iterations=20, coarse_stride=4, candidate_refresh_every=10,
    candidate_slack=0.25, fused_kernel=True, degeneracy=DEG,
)
HYP = dataclasses.replace(CACHED, coarse_iterations=0, candidate_refresh_every=0, max_iterations=12,
                          degeneracy=jloc.DegeneracyConfig())
TWISTS = [[0.01, -0.008, 0.012, 0.08, -0.05, 0.03], [0.012, -0.01, 0.02, 0.1, -0.06, 0.035]]


def _batch(rng, pts, n=1024):
    reads = [reading(rng, pts, t, n) for t in TWISTS]
    jr = jpc.stack([r[0] for r in reads])
    return jr, interop.point_batch(jr.xyz, jr.mask), np.stack([r[2] for r in reads])


@pytest.mark.parametrize("change", [dict(knn=4), dict(select_kernel=True)], ids=["knn4-K3", "select-K4"])
def test_cached_rounds_match_vmapped_icp_single(rng, change):
    cfg = dataclasses.replace(CACHED, **change)
    pts = scene(rng)
    jb, _ = reference(pts)
    jref = jicp.build_reference(jb, cfg)
    tref = interop.icp_reference(jref.cloud.xyz, jref.cloud.mask, jref.cloud.normals, jref.centroid,
                                 jref.grid.table, jref.grid.cell_size, jref.grid.dropped)
    jr, tr, init = _batch(rng, pts)
    want = jax.jit(jax.vmap(lambda r, T: jicp.icp_single(r, jref, T, cfg)))(jr, jnp.asarray(init))
    got = ticp.icp_batch(tr, tref, torch.tensor(init), interop.config(ticp.ICPConfig, cfg))
    assert_same_result(got, want)
    np.testing.assert_allclose(got.match_row_saturation.numpy(), np.asarray(want.match_row_saturation),
                               atol=2e-3)


def test_cached_knn4_runs_k3_not_k1(rng, monkeypatch):
    """The knn = 4 rounds linearise through K3's wrapper only."""
    calls = {"pair_gn": 0, "pair_gn_k": 0}

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ticp, "pair_gn", count("pair_gn", tpg.pair_gn))
    monkeypatch.setattr(ticp, "pair_gn_k", count("pair_gn_k", tpg.pair_gn_k))
    pts = scene(rng, n=3000)
    _, tref = reference(pts)
    _, tr, init = _batch(rng, pts, n=512)
    cfg = interop.config(ticp.ICPConfig, dataclasses.replace(CACHED, knn=4))
    ticp.icp_batch(tr, ticp.build_reference(tref, cfg), torch.tensor(init), cfg)
    assert calls["pair_gn"] == 0 and calls["pair_gn_k"] > 0


def test_register_batch(rng):
    """Two problems, each against its own reference (the second a shifted,
    thinned copy of the scene)."""
    pts = scene(rng)
    refs = [reference(pts), reference((pts[::2] + [0.5, -0.3, 0.1]).astype(np.float32))]
    jrefs = jpc.stack([r[0] for r in refs])
    trefs = interop.point_batch(jrefs.xyz, jrefs.mask, {"normals": jrefs.normals})
    jr, tr, init = _batch(rng, pts)
    cfg = CACHED
    want = jicp.register_batch(jr, jrefs, jnp.asarray(init), cfg)
    got = ticp.register_batch(tr, trefs, torch.tensor(init), interop.config(ticp.ICPConfig, cfg))
    assert got.transform.shape == (2, 4, 4)
    assert_same_result(got, want)


def test_register_hypotheses(rng):
    """Four seeds around one reading, the relocalisation burst's shape (the
    per-iteration chain with histogram trimming)."""
    pts = scene(rng)
    jref, tref = reference(pts)
    jr, tr, init = reading(rng, pts, TWISTS[0], n=512)
    offsets = [[0, 0, 0, 0, 0, 0], [0.02, 0, -0.03, 0.1, 0, 0], [0, 0.03, 0, 0, -0.15, 0.05],
               [0, 0, 0.2, 1.5, 1.5, 0]]
    seeds = np.stack([init @ tse3.exp_se3(torch.tensor(o, dtype=torch.float64)).numpy()
                      for o in offsets]).astype(np.float32)
    want = jicp.register_hypotheses(jr, jref, jnp.asarray(seeds), HYP)
    got = ticp.register_hypotheses(tr, tref, torch.tensor(seeds), interop.config(ticp.ICPConfig, HYP))
    assert got.transform.shape == (4, 4, 4)
    assert_same_result(got, want)

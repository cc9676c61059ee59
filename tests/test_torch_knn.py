"""Brute-force matching of the PyTorch port against the JAX package: the
exact KNN (``ops/knn.py``) and K5's plain version against the Pallas kernel
``knn_bruteforce_pallas`` in interpret mode, on the CPU.

Both JAX versions form squared distances by the expansion
``|q|^2 - 2 q.r + |r|^2`` in XLA's rounding (fused multiply-add chains in
coordinate order), and so do the port's: ``knn_bruteforce`` clamped at 0 as
JAX's ``ops/knn.py`` does (``test_torch_parity.py`` holds it bit for bit on a
crafted near-tie), K5's plain version unclamped as the Pallas kernel is.
K5's plain version is held bit for bit (ids and distances) against the
Pallas kernel: on uniform data, on map-scale near-ties, where the unclamped
distance goes negative, and on a reference that is all padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import near_ties
from open3d_slam_private_tpu.kernels.knn_pallas import knn_bruteforce_pallas
from open3d_slam_private_tpu.ops import knn as jknn
from open3d_slam_private_tpu_torch.kernels import knn_brute as tkb
from open3d_slam_private_tpu_torch.ops import knn as tknn
from open3d_slam_private_tpu_torch.ops.pointcloud import PAD_COORD


@pytest.mark.parametrize("k", [1, 4, 8])
def test_knn_bruteforce_matches_jax(rng, k):
    q = rng.uniform(-4, 4, size=(600, 3)).astype(np.float32)
    r = rng.uniform(-4, 4, size=(1500, 3)).astype(np.float32)
    qm = rng.uniform(size=600) > 0.1
    rm = rng.uniform(size=1500) > 0.2
    want = jknn.knn_bruteforce(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm),
                               k=k, max_dist=0.9, q_tile=256, r_tile=512)
    got = tknn.knn_bruteforce(torch.tensor(q), torch.tensor(qm), torch.tensor(r), torch.tensor(rm),
                              k=k, max_dist=0.9)
    ids = got.ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    ok = ids >= 0
    assert ok.any() and (~ok).any()  # the radius gate and the query mask both bite
    np.testing.assert_allclose(got.dists.numpy()[ok], np.asarray(want.dists)[ok], atol=1e-4)
    assert np.isinf(got.dists.numpy()[~ok]).all()
    assert (ids[~qm] == -1).all()
    assert rm[ids[ok]].all()  # masked reference points never returned
    d = got.dists.numpy()
    assert (np.diff(np.where(ok, d, 1e30), axis=1) >= 0).all()  # ascending


def test_knn_bruteforce_batched_queries_and_gather(rng):
    """Leading batch axes flatten against the one reference; k beyond the
    valid reference count leaves invalid slots."""
    q = rng.uniform(-1, 1, size=(2, 50, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    rm = np.array([1, 1, 0, 1, 0, 1], bool)
    got = tknn.knn_bruteforce(torch.tensor(q), torch.ones(2, 50, dtype=torch.bool), torch.tensor(r),
                              torch.tensor(rm), k=5)
    assert got.ids.shape == (2, 50, 5)
    assert (got.ids[..., :4] >= 0).all() and (got.ids[..., 4] == -1).all()
    for b in range(2):
        one = tknn.knn_bruteforce(torch.tensor(q[b]), torch.ones(50, dtype=torch.bool),
                                  torch.tensor(r), torch.tensor(rm), k=5)
        assert torch.equal(one.ids, got.ids[b])
    vals = tknn.gather_matched(torch.tensor(r), got.ids)
    want = np.asarray(jknn.gather_matched(jnp.asarray(r), jnp.asarray(got.ids.numpy())))
    np.testing.assert_array_equal(vals.numpy(), want)


@pytest.mark.parametrize("nq,nr", [(137, 401), (300, 700), (64, 1024)])
def test_knn_brute_plain_matches_pallas(rng, nq, nr):
    q = rng.uniform(-3, 3, size=(nq, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, size=(nr, 3)).astype(np.float32)
    r[-5:] = PAD_COORD  # a padded cloud's tail
    d_w, i_w = knn_bruteforce_pallas(jnp.asarray(q), jnp.asarray(r), q_tile=64, r_tile=128,
                                     interpret=True)
    d_g, i_g = tkb.knn_brute(torch.tensor(q), torch.tensor(r))
    assert i_g.dtype == torch.int32
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(i_w))
    np.testing.assert_array_equal(d_g.numpy().view(np.int32), np.asarray(d_w).view(np.int32))
    assert i_g.max() < nr - 5  # padded rows never win


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_knn_brute_plain_near_ties_match_pallas(seed):
    """Where ranking by direct differences and by the expansion part (the
    midpoints), the plain version takes the Pallas kernel's winner and
    distance, bit for bit."""
    q, r = near_ties(1024, 2048, seed, pad=5)
    d_w, i_w = knn_bruteforce_pallas(jnp.asarray(q), jnp.asarray(r), r_tile=512, interpret=True)
    d_g, i_g = tkb.knn_brute(torch.tensor(q), torch.tensor(r))
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(i_w))
    np.testing.assert_array_equal(d_g.numpy().view(np.int32), np.asarray(d_w).view(np.int32))
    direct = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1).argmin(1)
    assert (direct != i_g.numpy()).any()  # the set holds ties the expansion breaks its own way


def test_knn_brute_plain_negative_distances_match_pallas(rng):
    """Queries 10 um off reference points at ~40 m: the unclamped expansion
    goes negative (|q|^2 ~ 3e3, one unit in its last place ~2.4e-4) and is
    returned as it is, bit for bit as the Pallas kernel returns it."""
    r = np.c_[rng.uniform(30, 40, (256, 2)), rng.uniform(-2, 4, (256, 1))].astype(np.float32)
    u = rng.normal(size=(256, 3))
    q = (r + 1e-5 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    d_w, i_w = knn_bruteforce_pallas(jnp.asarray(q), jnp.asarray(r), q_tile=64, r_tile=128,
                                     interpret=True)
    d_g, i_g = tkb.knn_brute(torch.tensor(q), torch.tensor(r))
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(i_w))
    np.testing.assert_array_equal(d_g.numpy().view(np.int32), np.asarray(d_w).view(np.int32))
    assert (d_g < 0).sum() > 10 and (np.asarray(d_w) < 0).sum() > 10


def test_knn_brute_plain_all_padded_reference_matches_pallas(rng):
    """An empty cloud's ``padded_xyz()``: every row at ``PAD_COORD``; the
    first row wins, at the pad's distance, as in the Pallas kernel."""
    q = rng.uniform(-40, 40, size=(70, 3)).astype(np.float32)
    r = np.full((128, 3), PAD_COORD, np.float32)
    d_w, i_w = knn_bruteforce_pallas(jnp.asarray(q), jnp.asarray(r), q_tile=64, r_tile=128,
                                     interpret=True)
    d_g, i_g = tkb.knn_brute(torch.tensor(q), torch.tensor(r))
    assert (i_g == 0).all()
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(i_w))
    np.testing.assert_array_equal(d_g.numpy().view(np.int32), np.asarray(d_w).view(np.int32))


def test_knn_brute_ties_and_empty_reference():
    q = torch.tensor([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    r = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    d2, ids = tkb.knn_brute(q, r)
    assert ids.tolist()[0] == 0 and float(d2[0]) == 1.0  # lowest index among equals
    d2, ids = tkb.knn_brute(q, torch.zeros((0, 3)))
    assert torch.isinf(d2).all() and (ids == 0).all()

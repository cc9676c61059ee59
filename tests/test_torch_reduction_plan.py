"""The summation plans and order models of K1 (``csrc/pair_gn.cu``) and
``normal_eq`` (``csrc/normal_eq.cu``), on the CPU: the plans
(``kernels.pair_gn.k1_plan``, ``kernels.normal_eq.ne_plan``) depend on a
problem's size alone, cover every tile or pair once and keep a cluster
within 16 blocks (past 8 the non-portable size, which the kernels opt into); the numpy models of the kernels' orders
(``tests/pair_gn_model.py``, ``tests/normal_eq_model.py``, which the card
tests hold the kernels to bit for bit) stay within 1e-5 of each entry's
magnitude of the float64 sums (the card tests' tolerance), with K1's weight
and count sums exact and equal to the plain version's."""

import numpy as np
import pytest
import torch

from normal_eq_model import inputs as ne_inputs
from normal_eq_model import ne_fp64, ne_model, ne_terms
from open3d_slam_private_tpu_torch.kernels import normal_eq as tne
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from pair_gn_model import k1_fp64, k1_model, k1_terms, pairs, worst_over_tolerance

_SIZES = [0, 1, 511, 512, 513, 1000, 4096, 5001, 7777, 16383, 16384, 16385, 16411, 20003, 65536, 200_001]


@pytest.mark.parametrize("N", _SIZES)
def test_k1_plan_covers_every_tile_once(N):
    G, per_block, one = tpg.k1_plan(N)
    tiles = -(-N // tpg.k1_tile(N))
    chunks = [range(g * per_block, min(tiles, (g + 1) * per_block)) for g in range(G)]
    assert [t for c in chunks for t in c] == list(range(tiles))
    assert all(len(c) > 0 for c in chunks) or tiles == 0
    assert 1 <= per_block <= tpg.K1_MAX_TILES
    assert one == (N <= tpg.K1_ONE_LAUNCH)
    if one:
        assert 1 <= G <= tpg.K1_MAX_CLUSTER == 16  # one cluster (past 8 blocks the non-portable size)
    assert tpg.k1_plan(N) == (G, per_block, one)  # a function of N alone
    if N == 16384:
        assert (G, per_block) == (16, 4)
    if N == 4096:
        assert (G, per_block) == (16, 1)


@pytest.mark.parametrize("P", _SIZES + [524_288])
def test_normal_eq_plan_covers_every_pair_once(P):
    route, G, chunk = tne.ne_plan(P)
    spans = [range(g * chunk, min(P, (g + 1) * chunk)) for g in range(G)]
    assert [e for s in spans for e in s] == list(range(P))
    assert all(len(s) > 0 for s in spans) or P == 0
    if route == tne.ROUTE_WARP:
        assert P <= tne.WARP_ROUTE and G == 1
    elif route == tne.ROUTE_CLUSTER:
        assert tne.WARP_ROUTE < P <= tne.ONE_LAUNCH and 1 <= G <= tne.MAX_CLUSTER == 16
        assert chunk <= tne.CLUSTER_LANES * 8  # one batch of 8 pairs a lane
    else:
        assert P > tne.ONE_LAUNCH and chunk == tne.CHUNK
    assert tne.ne_plan(P) == (route, G, chunk)


@pytest.mark.parametrize("B,N", [(1, 4096), (1, 16384), (2, 20003), (3, 777), (2, 0)])
def test_k1_model_within_fp64_tolerance(rng, B, N):
    """The model's sums against the float64 sums of the same terms, within
    1e-5 of each entry's magnitude; its weight and count sums exact."""
    args = pairs(rng, B, N)
    got = k1_model(*args)
    ref, scale = k1_fp64(*args)
    assert got.shape == (B, tpg.K1_OUT) and got.dtype == np.float32
    assert worst_over_tolerance(got, ref, scale) <= 1.0
    np.testing.assert_array_equal(got[:, [42, 44]].astype(np.float64), ref[:, [42, 44]])  # sum w, n ok


def test_k1_model_weights_equal_the_plain_versions(rng):
    """Every point's weight and count, as the kernel forms them (the model's
    step-by-step rounding), equal the plain version's (``terms``), so the
    sums equal the plain version's ``sum w`` and ``n ok``; a problem's bits
    do not depend on its batch."""
    args = pairs(rng, 3, 9000)
    t = k1_terms(*args)
    plain = tpg.terms(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args)).numpy()
    np.testing.assert_array_equal(t[..., 27], plain[..., 27])  # w
    np.testing.assert_array_equal(t[..., 29], plain[..., 30])  # ok
    got = k1_model(*args)
    _, _, sw, _, nok = tpg.pair_gn_plain(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args))
    np.testing.assert_array_equal(got[:, 42], sw.numpy())
    np.testing.assert_array_equal(got[:, 44], nok.numpy())
    alone = k1_model(*(a[1:2] if isinstance(a, np.ndarray) else a for a in args))
    np.testing.assert_array_equal(alone.view(np.int32), got[1:2].view(np.int32))


@pytest.mark.parametrize("B,N,K", [(1, 4096, 1), (1, 16384, 1), (64, 512, 1), (1, 20000, 8), (2, 5003, 3),
                                   (1, 0, 1), (2, 513, 1)])
def test_normal_eq_model_within_fp64_tolerance(rng, B, N, K):
    """The model's A and b against the float64 sums of the same terms
    within 1e-5 of each entry's magnitude, against the plain version within
    2e-5, on each route; a problem alone gives its bits in the batch; weight
    0 pairs add nothing."""
    args = ne_inputs(rng, B, N, K)
    got = ne_model(*args)
    ref, scale = ne_fp64(*args)
    assert got.shape == (B, tne.N_OUT) and got.dtype == np.float32
    assert worst_over_tolerance(got, ref, scale) <= 1.0
    A, b = tne.normal_eq(*(torch.tensor(x) for x in args))  # CPU tensors: the plain einsum
    plain = torch.cat([A.reshape(B, 36), b], 1).numpy()
    assert worst_over_tolerance(plain, ref, scale) <= 2.0
    if B > 1:
        alone = ne_model(*(x[1:2] for x in args))
        np.testing.assert_array_equal(alone.view(np.int32), got[1:2].view(np.int32))
    assert not ne_terms(args[0], args[1], args[2], np.zeros_like(args[3])).any()

"""``normal_eq`` (the point-to-plane normal equations, summed on the card in
an order fixed by a problem's size) against the JAX package's
``point_to_plane_normal_equations_bc`` on the CPU, where the wrapper runs
its plain version: A and b within 1e-5 of each entry's magnitude (the sum
of its terms' absolute values; the two packages sum float32 terms in other
orders), over batches of problems with K = 1 and K = 8 pairs a point, with
unweighted and zero-weight pairs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.models import minimizers as jmin
from open3d_slam_private_tpu_torch.kernels import normal_eq as tne


def _inputs(rng, B, n, K):
    src = rng.uniform(-5, 5, (B, n, 3)).astype(np.float32)
    nrm = rng.normal(size=(B, n, K, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    q = (src[:, :, None, :] - 0.03 * nrm + 0.01 * rng.normal(size=(B, n, K, 3))).astype(np.float32)
    w = (rng.uniform(size=(B, n, K)) > 0.25).astype(np.float32)
    return src, q, nrm, w


def _magnitude(src, q, nrm, w):
    """Float64 sums of the terms' absolute values: (|A| [B, 6, 6], |b| [B, 6])."""
    p = np.broadcast_to(src[:, :, None, :], q.shape).astype(np.float64)
    n = nrm.astype(np.float64)
    cols = np.abs(np.concatenate([np.cross(p, n), n], -1))
    r = np.abs(((p - q) * n).sum(-1))
    cw = cols * w[..., None]
    return np.einsum("bnki,bnkj->bij", cw, cols), np.einsum("bnki,bnk->bi", cw, r)


@pytest.mark.parametrize("B,n,K", [(3, 1500, 1), (2, 700, 8)])
def test_normal_eq_matches_jax(rng, B, n, K):
    src, q, nrm, w = _inputs(rng, B, n, K)
    # JAX's function takes one problem (the chain vmaps it).
    outs = [jmin.point_to_plane_normal_equations_bc(*(jnp.asarray(x[i]) for x in (src, q, nrm, w)))
            for i in range(B)]
    A_j, b_j = np.stack([np.asarray(o[0]) for o in outs]), np.stack([np.asarray(o[1]) for o in outs])
    before = tne.normal_eq.launches
    A_t, b_t = tne.normal_eq(*(torch.tensor(x) for x in (src, q, nrm, w)))
    assert tne.normal_eq.launches == before  # CPU tensors: the plain version
    assert A_t.shape == (B, 6, 6) and b_t.shape == (B, 6) and A_t.dtype == torch.float32
    sA, sb = _magnitude(src, q, nrm, w)
    assert (np.abs(A_t.numpy() - A_j) <= 1e-5 * (sA + 1.0)).all()
    assert (np.abs(b_t.numpy() - b_j) <= 1e-5 * (sb + 1.0)).all()
    np.testing.assert_array_equal(A_t.numpy(), np.swapaxes(A_t.numpy(), 1, 2))


def test_normal_eq_of_unweighted_pairs_is_zero(rng):
    src, q, nrm, w = _inputs(rng, 2, 300, 2)
    A, b = tne.normal_eq(*(torch.tensor(x) for x in (src, q, nrm, np.zeros_like(w))))
    assert not A.any() and not b.any()

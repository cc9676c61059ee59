"""``kernels/sym_eig.py``'s plain version (``torch.linalg.eigh``, one matrix
a call: what the CUDA kernel ``csrc/sym_eig.cu`` is held to on the card,
``tests/test_torch_cuda.py``) against numpy's ``eigh``, on the shapes the
ICP chain hands it: float64 12 x 12 KKT matrices with inert zero rows (the
equality-constrained pseudo-solve), float64 and float32 6 x 6 normal
equations, float64 3 x 3 blocks (the ternary analysis).

Eigenvector signs, and bases of repeated eigenvalues, are arbitrary
(ROADMAP "Rules"), so the tests hold eigenvalues, pseudo-solves and
projectors, each at a float64 (or float32) tolerance relative to the
matrix's scale."""

import numpy as np
import pytest
import torch

from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig, sym_eig_plain
from open3d_slam_private_tpu_torch.models import minimizers


def kkt(rng, locked: int):
    """A 12 x 12 KKT matrix [[A, C^T], [C, 0]] of an SPD 6 x 6 A with
    ``locked`` constraint rows (unit eigen-directions of the subspaces) and
    the other rows zero, and its right-hand side."""
    X = rng.normal(size=(6, 6))
    A = X @ X.T * 100.0 + np.diag([1e3, 1e3, 1e3, 1e2, 1e2, 1e-1])
    C = np.zeros((6, 6))
    for i in range(locked):
        v = rng.normal(size=3)
        C[i, (i // 3) * 3:(i // 3) * 3 + 3] = v / np.linalg.norm(v)
    M = np.zeros((12, 12))
    M[:6, :6], M[:6, 6:], M[6:, :6] = A, C.T, C
    return M, rng.normal(size=12)


def pinv_solve(M, rhs, rcond=1e-7):
    w, V = np.linalg.eigh(M)
    keep = np.abs(w) > rcond * np.abs(w).max()
    return V[:, keep] @ ((V[:, keep].T @ rhs) / w[keep])


@pytest.mark.parametrize("locked", [0, 1, 3, 5])
def test_kkt_pseudo_solve_matches_numpy(locked):
    rng = np.random.default_rng(locked)
    mats, rhss = zip(*(kkt(rng, locked) for _ in range(8)))
    M, rhs = torch.tensor(np.stack(mats)), torch.tensor(np.stack(rhss))
    w, V = sym_eig(M)
    want_w = np.linalg.eigvalsh(np.stack(mats))
    scale = np.abs(want_w).max(-1, keepdims=True)
    np.testing.assert_allclose(w.numpy(), want_w, rtol=0, atol=1e-12 * scale.max())
    np.testing.assert_allclose(torch.linalg.matrix_norm(V.mT @ V - torch.eye(12, dtype=V.dtype)).numpy(),
                               0.0, atol=1e-12)
    got = minimizers.solve_normal_equations(M, rhs).numpy()
    want = np.stack([pinv_solve(m, r) for m, r in zip(mats, rhss)])
    # Two float64 eigen-solvers part by the condition number (up to ~1e8
    # with 5 locked rows) times float64's epsilon, relative.
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_normal_equations_spectrum_and_projectors(dtype, tol):
    """6 x 6 normal equations with a weak direction: eigenvalues, and the
    projector onto the eigenvectors above a threshold (solution
    remapping's), against numpy in float64."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(16, 6, 6))
    A = X @ X.transpose(0, 2, 1) * 50.0
    A[:, 5, :] *= 1e-2
    A[:, :, 5] *= 1e-2
    w, V = sym_eig(torch.tensor(A, dtype=dtype))
    ww, VV = np.linalg.eigh(A)
    scale = np.abs(ww).max()
    np.testing.assert_allclose(w.double().numpy(), ww, rtol=0, atol=tol * scale)
    thresh = 5.0
    keep = ww >= thresh
    assert keep.any() and (~keep).any()  # the projector drops a direction
    P = torch.einsum("bik,bjk->bij", V.double() * torch.tensor(keep, dtype=torch.float64)[:, None, :],
                     V.double()).numpy()
    want = np.einsum("bik,bjk->bij", VV * keep[:, None, :], VV)
    np.testing.assert_allclose(P, want, atol=100 * tol)


def test_three_by_three_blocks_and_batch_shapes():
    """The ternary analysis's [B, 3, 3, 3] blocks: leading shape kept, each
    matrix's bits independent of its batch (one LAPACK call a matrix)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2, 3, 3, 3))
    A = torch.tensor(X @ np.swapaxes(X, -1, -2))
    w, V = sym_eig(A)
    assert w.shape == (2, 3, 3) and V.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(A.numpy()), atol=1e-12 * float(A.abs().max()))
    w1, V1 = sym_eig(A[1, 2])
    assert torch.equal(w1, w[1, 2]) and torch.equal(V1, V[1, 2])
    e0, _ = sym_eig_plain(torch.zeros((0, 6, 6), dtype=torch.float64))
    assert e0.shape == (0, 6)


def test_sweep_count_is_the_kernels():
    with pytest.raises(ValueError, match="sweeps"):
        sym_eig(torch.eye(6), sweeps=True)

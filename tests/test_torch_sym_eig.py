"""``kernels/sym_eig.py``'s plain version (``torch.linalg.eigh``, one matrix
a call: what the CUDA kernel ``csrc/sym_eig.cu`` is held to on the card,
``tests/test_torch_cuda.py``) against numpy's ``eigh``, on the shapes the
ICP chain hands it: float64 12 x 12 KKT matrices with inert zero rows (the
equality-constrained pseudo-solve), float64 and float32 6 x 6 normal
equations, float64 3 x 3 blocks (the ternary analysis). And the kernel's
loop itself, as ``tests/sym_eig_model.py`` models it lane by lane in
float64 (its compile-time round-robin schedule, skip rule, rotation and
parallel stop test), against numpy's ``eigh`` on the chain's matrix
families at every n the kernel takes.

Eigenvector signs, and bases of repeated eigenvalues, are arbitrary
(ROADMAP "Rules"), so the tests hold eigenvalues, pseudo-solves and
projectors, each at a float64 (or float32) tolerance relative to the
matrix's scale."""

import numpy as np
import pytest
import torch

from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig, sym_eig_plain
from open3d_slam_private_tpu_torch.models import minimizers
import sym_eig_model as model
from sym_eig_model import kkt


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


@pytest.mark.parametrize("n", range(1, 17))
def test_round_robin_schedule(n):
    """The kernel's schedule: each step's pairs are disjoint, a sweep meets
    every pair of the n indices once, and the run-time partner formula
    (no division) names the table's partner."""
    steps = model.round_robin(n)
    met = set()
    for r, pairs in enumerate(steps):
        seen = [i for pq in pairs for i in pq]
        assert len(seen) == len(set(seen))
        for p, q in pairs:
            assert p < q
            assert model.partner(p, r, n) == q and model.partner(q, r, n) == p
            if q < n:
                met.add((p, q))
        for j in range(n + n % 2, 16):
            assert model.partner(j, r, n) == j
    assert met == {(p, q) for q in range(n) for p in range(q)}


CHAIN_FAMILIES = [(12, f"kkt{k}") for k in (0, 1, 3, 5)] + [(6, "spd"), (3, "spd")] + [
    (n, fam) for n in (2, 5, 12, 16)
    for fam in ("spd", "diagonal", "zero", "repeated", "scale_1e_20", "scale_1e20")]


@pytest.mark.parametrize("n,family", CHAIN_FAMILIES)
def test_model_matches_numpy(n, family):
    """The kernel's loop (float64 model) against ``numpy.linalg.eigh``:
    eigenvalues within 64 n eps of the matrix's scale, orthonormal
    eigenvectors, fewer than 30 sweeps, and the same minimum-norm
    pseudo-solve (two float64 solvers part by about the condition number
    times eps, up to ~1e8 with 5 locked KKT rows)."""
    rng = np.random.default_rng(n)
    mats = model.families(rng, n)[family]
    eps = np.finfo(np.float64).eps
    for M in mats:
        w, V, sweeps, _ = model.jacobi(M)
        want_w, want_V = np.linalg.eigh(M)
        scale = np.abs(M).max()
        assert sweeps < model.MAX_SWEEPS
        np.testing.assert_allclose(w, want_w, rtol=0, atol=64 * n * eps * scale)
        np.testing.assert_allclose(V.T @ V, np.eye(n), rtol=0, atol=64 * n * eps)
        b = rng.normal(size=n)
        got, want = model.pseudo_solve(w, V, b), model.pseudo_solve(want_w, want_V, b)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12 * np.abs(want).max())


def test_model_float32_normal_equations():
    """The float32 path's shapes (6 x 6 normal equations, 3 x 3 blocks) in
    the model's float32 arithmetic, against numpy in float64."""
    rng = np.random.default_rng(5)
    eps = np.finfo(np.float32).eps
    for n in (3, 6):
        for M in model.families(rng, n)["spd"].astype(np.float32):
            w, V, sweeps, _ = model.jacobi(M)
            assert w.dtype == np.float32 and sweeps < model.MAX_SWEEPS
            want = np.linalg.eigvalsh(M.astype(np.float64))
            np.testing.assert_allclose(w, want, rtol=0, atol=64 * n * eps * np.abs(M).max())


@pytest.mark.parametrize("n", [3, 6, 12, 16])
def test_parallel_stop_test_matches_no_rotation_sweep(n):
    """The stop test of every pair before each sweep decides the same stop
    as the former closing sweep that rotates nothing: the same sweep count
    and the same bits of A and V, on families that stop early (diagonal,
    zero), late (repeated eigenvalues) and in between."""
    rng = np.random.default_rng(100 + n)
    fam = model.families(rng, n)
    mats = np.concatenate([fam["spd"], fam["diagonal"], fam["zero"], fam["repeated"]]
                          + ([fam["kkt5"]] if n == 12 else []))
    for M in mats:
        w1, V1, s1, A1 = model.jacobi(M, stop="test")
        w2, V2, s2, A2 = model.jacobi(M, stop="sweep")
        assert s1 == s2
        assert np.array_equal(A1, A2) and np.array_equal(V1, V2) and np.array_equal(w1, w2)
    # Capped at the same count when neither stop is reached.
    M = fam["spd"][0]
    assert model.jacobi(M, max_sweeps=2)[2] == model.jacobi(M, stop="sweep", max_sweeps=2)[2] == 2

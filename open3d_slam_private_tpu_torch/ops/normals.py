"""Surface normals by neighbourhood PCA.

Twin of ``open3d_slam_private_tpu/ops/normals.py`` (``eigh3x3``,
``estimate_normals``, ``estimate_normals_grid`` and
``estimate_normals_moments``): a closed-form symmetric 3x3 eigensolver
(trigonometric eigenvalues, cross-product eigenvectors), batched and
branch-free, applied to the covariance of each point's k nearest neighbours
(exact brute-force KNN, or the hash grid's 2x2x2 block) or to the
covariance that ``grid_moments`` accumulates over a radius.
"""

from __future__ import annotations

import math

import torch

from open3d_slam_private_tpu_torch.ops.grid_hash import const3, grid_match, grid_moments
from open3d_slam_private_tpu_torch.ops.knn import gather_matched, knn_bruteforce
from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant by the rule of Sarrus, in the JAX twin's term order."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def eigh3x3(A: torch.Tensor):
    """Symmetric ``[..., 3, 3]`` -> (eigenvalues ``[..., 3]`` ascending,
    eigenvectors ``[..., 3, 3]`` as columns, right-handed frame)."""
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    B = A / scale
    eye = torch.eye(3, dtype=A.dtype, device=A.device)

    q = (B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2]) / 3.0
    Bq = B - q[..., None, None] * eye
    sq = (Bq * Bq).flatten(-2)
    p2 = sq[..., 0]
    for k in range(1, 9):
        p2 = p2 + sq[..., k]
    p2 = p2 / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(Bq / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    evals = torch.stack([e3, e2, e1], dim=-1)

    def eigvec(lmbda, fallback):
        # Null space of (B - lambda I) from the two most independent rows;
        # the fallback covers (near-)repeated eigenvalues.
        M = B - lmbda[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = torch.linalg.cross(r0, r1)
        c02 = torch.linalg.cross(r0, r2)
        c12 = torch.linalg.cross(r1, r2)
        n01 = (c01 * c01).sum(-1, keepdim=True)
        n02 = (c02 * c02).sum(-1, keepdim=True)
        n12 = (c12 * c12).sum(-1, keepdim=True)
        best = torch.where(
            (n01 >= n02) & (n01 >= n12), c01, torch.where(n02 >= n12, c02, c12)
        )
        nrm = torch.linalg.vector_norm(best, dim=-1, keepdim=True)
        best = torch.where(nrm < 1e-12, fallback, best)
        return _normalize(best)

    ez = eye[2].expand(B[..., 0, :].shape)
    v_large = eigvec(evals[..., 2], ez)
    ex, ey = eye[0].expand(v_large.shape), eye[1].expand(v_large.shape)
    alt = torch.where(v_large[..., :1].abs() > 0.9, ey, ex)
    v_small = eigvec(evals[..., 0], torch.linalg.cross(v_large, alt))
    v_mid = _normalize(torch.linalg.cross(v_large, v_small))
    v_small_o = torch.linalg.cross(v_mid, v_large)
    vecs = torch.stack([v_small_o, v_mid, v_large], dim=-1)
    return evals * scale[..., 0], vecs


def estimate_normals(
    batch: PointBatch,
    knn: int = 10,
    max_dist: float = math.inf,
    orient_towards=None,
    return_eigen: bool = False,
) -> PointBatch:
    """KNN-PCA normals (the ``knn`` nearest within ``max_dist``, the point
    itself included, by exact brute-force search), stored under
    ``"normals"``. With ``return_eigen``, also ``"eigValues" [N, 3]``
    (ascending) and the ``"surfaceness"`` planarity weight."""
    xyz = batch.padded_xyz()
    res = knn_bruteforce(xyz, batch.mask, xyz, batch.mask, k=knn, max_dist=max_dist)
    nb = gather_matched(batch.xyz, res.ids)  # [N, k, 3]
    return _normals_from_neighbors(batch, nb, res.valid(), orient_towards, return_eigen)


def estimate_normals_grid(
    batch: PointBatch,
    grid,
    knn: int = 10,
    max_dist: float = math.inf,
    orient_towards=None,
    return_eigen: bool = False,
) -> PointBatch:
    """:func:`estimate_normals` with the neighbours taken from ``grid``, a
    GridHash over the batch itself (its 2x2x2 block of buckets, payloads
    inlined) instead of an exact brute-force search."""
    res = grid_match(grid, batch.padded_xyz(), batch.mask, k=knn, max_dist=max_dist)
    return _normals_from_neighbors(batch, res.xyz, res.valid(), orient_towards, return_eigen)


def _normals_from_neighbors(batch: PointBatch, nb, valid, orient_towards, return_eigen):
    """Normals from ``nb [N, k, 3]`` neighbour positions (``valid [N, k]``):
    the smallest-eigenvalue eigenvector of their covariance; zero where
    fewer than 3 neighbours."""
    xyz = batch.xyz
    w = valid.to(xyz.dtype)[..., None]
    cnt = torch.clamp(w.sum(-2), min=1.0)
    nbw = nb * w
    mean = nbw[:, 0]
    for k in range(1, nb.shape[1]):  # in neighbour order
        mean = mean + nbw[:, k]
    mean = mean / cnt
    # The covariance sums the k products of each entry as a fused
    # multiply-add chain in neighbour order, as XLA's dot does on the CPU: a
    # float32 product is exact in float64, and each step rounds once to
    # float32. (Near-degenerate neighbourhoods turn the last bit of the
    # covariance into a visibly different normal.)
    c = ((nb - mean[:, None, :]) * w).double()
    cov = torch.zeros((nb.shape[0], 3, 3), dtype=torch.float64, device=nb.device)
    for k in range(nb.shape[1]):
        cov = (c[:, k, :, None] * c[:, k, None, :] + cov).float().double()
    cov = cov.float() / cnt[..., None]
    evals, evecs = eigh3x3(cov)
    normal = evecs[..., :, 0]
    if orient_towards is not None:
        vp = const3(orient_towards, batch.device, xyz.dtype)
        flip = (normal * (vp - xyz)).sum(-1, keepdim=True) < 0
        normal = torch.where(flip, -normal, normal)
    ok = batch.mask & (valid.sum(-1) >= 3)
    out = batch.with_extras(normals=torch.where(ok[:, None], normal, 0.0))
    if return_eigen:
        ev = torch.where(ok[:, None], evals, 0.0)
        lsum = torch.clamp(ev.abs().sum(-1), min=1e-30)
        surfaceness = torch.where(ok, 2.0 * (ev[:, 1] - ev[:, 0]) / lsum, 0.0)
        out = out.with_extras(eigValues=ev, surfaceness=surfaceness[:, None])
    return out


def estimate_normals_moments(
    batch: PointBatch, grid, max_dist: float, orient_towards=None
) -> PointBatch:
    """Radius-neighbourhood PCA normals (``grid`` is a GridHash over the
    batch itself), stored under ``"normals"``; zero where fewer than 3
    neighbours. ``orient_towards``: normals are flipped to face it."""
    cnt, _, cov = grid_moments(grid, batch.padded_xyz(), batch.mask, max_dist)
    _, evecs = eigh3x3(cov)
    normal = evecs[..., :, 0]
    if orient_towards is not None:
        vp = const3(orient_towards, batch.device, batch.xyz.dtype)
        flip = (normal * (vp - batch.xyz)).sum(-1, keepdim=True) < 0
        normal = torch.where(flip, -normal, normal)
    enough = cnt >= 3.0
    normal = torch.where((batch.mask & enough)[:, None], normal, 0.0)
    return batch.with_extras(normals=normal)

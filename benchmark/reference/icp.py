"""Plain point-to-plane ICP: exact nearest neighbours by brute force, normals
from the covariance of each matched point's neighbours, Gauss-Newton steps
on the trimmed pairs, in the frame the points are given in (the map's).
Everything runs in the dtype of the inputs (float32 for the check, bfloat16
for its control); only the 6 x 6 solve (float64) and the 3 x 3
eigen-solves (float32) are lifted, which PyTorch's solvers need."""

from __future__ import annotations

import torch

from reference import se3


def knn(query: torch.Tensor, ref: torch.Tensor, k: int, rows: int = 512):
    """``(d2 [Q, k], idx [Q, k])`` of each query's ``k`` nearest reference
    points, from the exact squared differences in the inputs' dtype."""
    d_out, i_out = [], []
    for a in range(0, query.shape[0], rows):
        q = query[a:a + rows]
        d2 = ((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
        d, i = torch.topk(d2, k, dim=1, largest=False)
        d_out.append(d)
        i_out.append(i)
    return torch.cat(d_out), torch.cat(i_out)


def normals_at(ref: torch.Tensor, idx: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Unit normals ``[len(idx), 3]`` of ``ref[idx]``: the least eigenvector
    of the covariance of its ``k`` nearest points in ``ref``."""
    _, nb = knn(ref[idx], ref, k)
    pts = ref[nb]  # [Q, k, 3]
    c = pts - pts.mean(1, keepdim=True)
    cov = (c[:, :, :, None] * c[:, :, None, :]).sum(1)
    _, vec = torch.linalg.eigh(cov.float())
    return vec[..., 0].to(ref.dtype)


def point_to_plane(src: torch.Tensor, ref: torch.Tensor, T0: torch.Tensor, iterations: int = 8,
                   max_dist: float = 0.5, keep: float = 0.8) -> torch.Tensor:
    """Register ``src [N, 3]`` onto ``ref [M, 3]`` from ``T0`` (ref <- src,
    ``[4, 4]``) -> the pose after ``iterations`` associations, each with
    one Gauss-Newton step over the ``keep`` share of its pairs within
    ``max_dist`` that lie nearest their planes. The step turns about the
    pose's own origin ``c``: a pair's row is ``[(p - c) x n, n]``."""
    dt = src.dtype
    T = T0.to(dt)
    for _ in range(iterations):
        c = T[:3, 3].clone()
        p = src @ T[:3, :3].transpose(0, 1) + T[:3, 3]
        d2, j = knn(p, ref, 1)
        d2, j = d2[:, 0], j[:, 0]
        near = d2 <= max_dist * max_dist
        if int(near.sum()) < 6:
            break
        p, q = p[near], ref[j[near]]
        n = normals_at(ref, j[near])
        r = ((p - q) * n).sum(-1)
        a = r.abs()
        cut = torch.quantile(a.float(), keep).to(dt)
        use = a <= cut
        p, n, r = p[use], n[use], r[use]
        J = torch.cat([torch.linalg.cross(p - c, n), n], -1)  # [P, 6]
        A = (J[:, :, None] * J[:, None, :]).sum(0)
        b = (J * r[:, None]).sum(0)
        A64 = A.double()
        A64 = A64 + 1e-12 * torch.trace(A64) * torch.eye(6, dtype=A64.dtype, device=A64.device)
        delta = -torch.linalg.solve(A64, b.double())
        M = se3.exp(delta).to(dt)  # about c: x -> R (x - c) + c + v
        M[:3, 3] = M[:3, 3] + c - M[:3, :3] @ c
        T = M @ T
    return T

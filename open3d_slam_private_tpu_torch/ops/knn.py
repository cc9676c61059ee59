"""Exact brute-force k-nearest neighbours and the match-result sentinels.

Twin of ``open3d_slam_private_tpu/ops/knn.py``. Squared distances hold
``INF`` and ids hold ``INVALID_ID`` where a query has no correspondence (the
``Matches`` contract); the k results of a query are sorted ascending.

:func:`knn_bruteforce` ranks by the JAX twin's expansion
``max((|q|^2 - 2 q.r) + |r|^2, 0)`` in its rounding: XLA's CPU dot and sum
of squares over the 3 coordinates are fused multiply-add chains in
coordinate order (``fma(x2, y2, fma(x1, y1, x0 * y0))``, each step rounded
once to float32), which this module reproduces elementwise in float64 (the
product of two float32 values is exact there). The expansion cancels in
float32 at map coordinates, so a direct difference would swap near-tied
neighbours against the reference. The brute-force kernel K5's plain version
ranks by the same expansion without the clamp, as the Pallas kernel does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

INVALID_ID = -1
INF = math.inf

# Query rows per chunk: a chunk's [rows, M] distance matrix stays ~2^26
# elements (256 MB of float32) whatever the reference size.
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class KnnResult:
    """``dists [..., N, k]`` squared (inf = no match); ``ids [..., N, k]``
    (-1 = no match)."""

    dists: torch.Tensor
    ids: torch.Tensor

    @property
    def k(self) -> int:
        return self.dists.shape[-1]

    def valid(self) -> torch.Tensor:
        return self.ids >= 0


def chunk_rows(m: int) -> int:
    """Query rows per chunk against a reference of ``m`` points."""
    return max(1, _CHUNK_ELEMS // max(m, 1))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 values, rounded once to float32."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` over the last axis of ``[..., 3]`` as XLA's CPU reduction
    forms it: ``fma(x2, x2, fma(x1, x1, x0 * x0))``."""
    x0, x1, x2 = x.unbind(-1)
    return _fma(x2, x2, _fma(x1, x1, x0 * x0))


def expansion_sq_dists(q: torch.Tensor, r: torch.Tensor, q_sq: torch.Tensor,
                       r_sq: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """``[n, m]`` squared distances ``(q_sq - 2 q.r) + r_sq`` of ``q [n, 3]``
    and ``r [m, 3]`` (``q_sq``, ``r_sq``: their :func:`sq_norms`), the cross
    term a fused multiply-add chain in coordinate order, as ``jnp.dot`` runs
    it on the CPU; clamped at 0 unless ``clamp`` is False (a distance may
    then come out negative). Elementwise: no matrix product, so no
    reduced-precision path on any device."""
    q0, q1, q2 = (c[:, None] for c in q.unbind(-1))
    r0, r1, r2 = (c[None, :] for c in r.unbind(-1))
    cross = _fma(q2, r2, _fma(q1, r1, q0 * r0))
    d2 = (q_sq[:, None] - 2.0 * cross) + r_sq[None, :]
    return torch.clamp(d2, min=0.0) if clamp else d2


def knn_bruteforce(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    ref_xyz: torch.Tensor,
    ref_mask: torch.Tensor,
    k: int = 1,
    max_dist=INF,
) -> KnnResult:
    """Exact KNN of ``query_xyz [..., N, 3]`` against one reference
    ``ref_xyz [M, 3]``, ranked by :func:`expansion_sq_dists`: ``k``
    first-index argmin passes per chunk of queries, so ties go to the lowest
    reference index (the JAX twin's per-tile ``top_k`` and merge keep the
    same order, and at k = 1 a later tile wins only on a strict ``<``).
    ``max_dist`` is a euclidean
    radius gate; masked queries get all-invalid rows; masked reference
    points are never returned."""
    lead = query_xyz.shape[:-1]
    q = query_xyz.reshape(-1, 3)
    qm = query_mask.reshape(-1)
    dev = q.device
    m = ref_xyz.shape[0]
    radius = (max_dist.to(dev, torch.float32) if torch.is_tensor(max_dist)
              else torch.full((), float(max_dist), dtype=torch.float32, device=dev))
    max_d2 = radius * radius
    dists = torch.full((q.shape[0], k), INF, device=dev)
    ids = torch.zeros((q.shape[0], k), dtype=torch.int32, device=dev)
    step = chunk_rows(m)
    q_sq, r_sq = sq_norms(q), sq_norms(ref_xyz)
    for s in range(0, q.shape[0] if m else 0, step):
        d2 = expansion_sq_dists(q[s:s + step], ref_xyz, q_sq[s:s + step], r_sq)
        d2 = torch.where(ref_mask[None, :], d2, INF)
        for j in range(k):
            best, arg = d2.min(-1, keepdim=True)
            dists[s:s + step, j] = best[:, 0]
            ids[s:s + step, j] = arg[:, 0].to(torch.int32)
            if j + 1 < k:
                d2.scatter_(-1, arg, INF)
    invalid = (dists > max_d2) | ~torch.isfinite(dists) | ~qm[:, None]
    return KnnResult(
        dists=torch.where(invalid, INF, dists).reshape(*lead, k),
        ids=torch.where(invalid, INVALID_ID, ids).reshape(*lead, k),
    )


def gather_matched(ref_values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-match reference attributes; invalid ids read slot 0 (callers mask
    by ``ids >= 0``)."""
    return ref_values[torch.clamp(ids, min=0).long()]

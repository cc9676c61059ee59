"""FPFH (Fast Point Feature Histograms) and feature matching.

Twin of ``open3d_slam_private_tpu/ops/fpfh.py``:

- SPFH: each point's Darboux-frame angles (alpha, phi, theta) against its
  k nearest neighbours in the grid (positions and normals from the grid's
  payload), binned into 11 bins an angle;
- FPFH: SPFH(p) + the inverse-distance-weighted mean of the neighbours'
  SPFH, each 11-bin part L1-normalised to 100: 33 dimensions;
- matching: nearest neighbours in feature space by one distance product
  ``|a|^2 - 2 a.b + |b|^2``, in row chunks, and mutual-nearest filtering.

A bin is the truncation of ``(v - lo) / (hi - lo) * 11``; the division by
the constant range runs as the JAX twin's jitted step runs it, a multiply
by the float32 reciprocal (``grid_hash.recip``). Nearest neighbours are
taken as ``lax.top_k`` takes them: ties go to the lower index.
"""

from __future__ import annotations

import math

import torch

from open3d_slam_private_tpu_torch.ops import grid_hash
from open3d_slam_private_tpu_torch.ops.knn import INF, INVALID_ID
from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch

BINS = 11
DIM = 3 * BINS


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def pair_features(p, n_p, q, n_q):
    """Darboux angles of point pairs ``p, q [..., 3]`` with normals:
    (alpha, phi) cosines in [-1, 1] and theta in [-pi, pi]."""
    d = q - p
    dist = torch.sqrt(_dot3(d, d))[..., None]
    du = d / torch.clamp(dist, min=1e-12)
    u = n_p
    v = _cross(du, u)
    v = v / torch.clamp(torch.sqrt(_dot3(v, v))[..., None], min=1e-12)
    w = _cross(u, v)
    return _dot3(v, n_q), _dot3(u, du), torch.atan2(_dot3(w, n_q), _dot3(u, n_q))


def bins(vals: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """The int64 bin of each value (truncation toward zero, clipped)."""
    dev = vals.device
    lo_t = grid_hash.f32(lo, dev)
    inv = grid_hash.recip(grid_hash.f32(hi - lo, dev))
    idx = ((vals - lo_t) * inv * BINS).to(torch.int32)
    return torch.clamp(idx, 0, BINS - 1).to(torch.int64)


def _hist(vals, lo, hi, valid):
    """``vals [N, k]`` -> ``[N, BINS]`` counts of the valid entries."""
    onehot = bins(vals, lo, hi)[..., None] == torch.arange(BINS, device=vals.device)
    return (onehot & valid[..., None]).to(vals.dtype).sum(-2)


def compute_fpfh(batch: PointBatch, grid: grid_hash.GridHash, knn: int = 16, radius=None) -> torch.Tensor:
    """FPFH descriptors ``[N, 33]`` of the valid points (zeros elsewhere).
    ``grid`` is built over ``batch`` itself with its normals inlined."""
    if batch.normals is None:
        raise ValueError("compute_fpfh requires normals")
    xyz = batch.padded_xyz()
    res = grid_hash.grid_match(grid, xyz, batch.mask, k=knn, max_dist=radius, sq=grid_hash.sq3_fma)
    valid = res.valid() & (res.dists > 1e-12)  # not the point itself

    alpha, phi, theta = pair_features(xyz[:, None, :], batch.normals[:, None, :], res.xyz, res.normals)
    spfh = torch.cat([_hist(alpha, -1.0, 1.0, valid), _hist(phi, -1.0, 1.0, valid),
                      _hist(theta, -math.pi, math.pi, valid)], -1)  # [N, 33]
    counts = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    spfh = spfh / counts.to(spfh.dtype)

    # Neighbours' SPFH weighted by inverse distance.
    nb_spfh = spfh[torch.clamp(res.ids, min=0).long()]  # [N, k, 33]
    wgt = torch.where(valid, 1.0 / torch.sqrt(torch.clamp(res.dists, min=1e-9)), 0.0)
    wsum = torch.clamp(wgt.sum(-1, keepdim=True), min=1e-9)
    fpfh = spfh + ((wgt / wsum)[..., None] * nb_spfh).sum(-2)

    parts = []
    for i in range(3):
        sub = fpfh[:, i * BINS:(i + 1) * BINS]
        parts.append(sub / torch.clamp(sub.sum(-1, keepdim=True), min=1e-9) * 100.0)
    return torch.where(batch.mask[:, None], torch.cat(parts, -1), 0.0)


def match_features(feat_a: torch.Tensor, mask_a: torch.Tensor, feat_b: torch.Tensor,
                   mask_b: torch.Tensor, k: int = 1, chunk: int = 2048):
    """The ``k`` nearest ``b`` features of each ``a`` feature: squared
    distances ``[Na, k]`` (inf where invalid) and ids ``[Na, k]`` (-1),
    ascending, each pass taking the first minimum. ``chunk`` rows of ``a``
    a distance product."""
    Nb = feat_b.shape[0]
    a2 = (feat_a * feat_a).sum(-1, keepdim=True)
    b2 = (feat_b * feat_b).sum(-1)
    cols = torch.arange(Nb, device=feat_b.device)
    ds, ids = [], []
    for a in range(0, feat_a.shape[0], chunk):
        cross = feat_a[a:a + chunk] @ feat_b.T
        d2 = (a2[a:a + chunk] - 2.0 * cross) + b2[None, :]
        d2 = torch.where(mask_b[None, :], d2, INF)
        dk, ik = [], []
        for j in range(k):
            best = d2.min(-1, keepdim=True).values
            first = torch.where(d2 == best, cols, Nb).min(-1, keepdim=True).values
            first = torch.where(first < Nb, first, 0)  # NaN rows: index 0, as top_k
            dk.append(best)
            ik.append(first)
            if j + 1 < k:
                d2 = d2.scatter(-1, first, INF)
        ds.append(torch.cat(dk, -1))
        ids.append(torch.cat(ik, -1))
    d, i = torch.cat(ds), torch.cat(ids).to(torch.int32)
    bad = ~mask_a[:, None] | ~torch.isfinite(d)
    return torch.where(bad, INF, d), torch.where(bad, INVALID_ID, i)


def mutual_matches(feat_a, mask_a, feat_b, mask_b, ratio=None):
    """Mutual-nearest correspondences: ``a -> b`` and ``b -> a`` agree.
    ``ratio``: keep a match only if its squared feature distance is below
    ``ratio^2`` times the second best's. Returns (ids ``[Na]`` into b, -1
    where not kept; ok ``[Na]``)."""
    da, ab2 = match_features(feat_a, mask_a, feat_b, mask_b, k=2 if ratio else 1)
    _, ba = match_features(feat_b, mask_b, feat_a, mask_a, k=1)
    ab = ab2[:, 0]
    back = ba[torch.clamp(ab, min=0).long(), 0]
    ok = (ab >= 0) & (back == torch.arange(feat_a.shape[0], device=ab.device)) & mask_a
    if ratio is not None:
        ok = ok & (da[:, 0] < (ratio * ratio) * da[:, 1])
    return torch.where(ok, ab, INVALID_ID), ok

"""RANSAC rigid alignment on feature correspondences, all hypotheses at once.

Twin of ``open3d_slam_private_tpu/models/ransac.py``: H minimal samples of
three correspondences drawn from the valid ones (JAX's threefry draw, bit
for bit: :func:`ops.prng.masked_categorical`), an edge-length similarity
gate on each sample, a weighted Kabsch solve per sample, every hypothesis
scored by its inliers over all correspondences, the first best (the lowest
index among equal counts, as ``jnp.argmax``), and a Kabsch polish on the
winner's inliers; identity below ``min_inliers``.
"""

from __future__ import annotations

import dataclasses

import torch

from open3d_slam_private_tpu_torch.models.minimizers import point_to_point_transform
from open3d_slam_private_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 512
    inlier_dist: float = 0.5
    min_inliers: int = 10
    # Edge-length similarity of a minimal sample's two triangles.
    edge_similarity: float = 0.9


@dataclasses.dataclass(frozen=True)
class RansacResult:
    transform: torch.Tensor  # [4, 4]
    inliers: torch.Tensor  # int32
    fitness: torch.Tensor  # inliers / valid correspondences
    ok: torch.Tensor  # bool


def _norm3(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])


def _edges(x: torch.Tensor) -> torch.Tensor:
    """The three edge lengths of ``[H, 3, 3]`` triangles."""
    return torch.stack([_norm3(x[:, 0] - x[:, 1]), _norm3(x[:, 1] - x[:, 2]),
                        _norm3(x[:, 0] - x[:, 2])], -1)


def _moved_d2(T: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``|R src + t - tgt|^2`` for ``[H, 4, 4]`` against ``[C, 3]``: ``[H, C]``."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    x, y, z = src[:, 0], src[:, 1], src[:, 2]
    d2 = None
    for i in range(3):
        m = (R[:, i, 0, None] * x + R[:, i, 1, None] * y + R[:, i, 2, None] * z) + t[:, i, None]
        e = m - tgt[:, i]
        d2 = e * e if d2 is None else d2 + e * e
    return d2


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of a 1-D tensor (0-d int64)."""
    top = v.max()
    idx = torch.arange(v.shape[0], device=v.device)
    return torch.where(v == top, idx, v.shape[0]).min()


def ransac_align(src_xyz: torch.Tensor, tgt_xyz: torch.Tensor, corr_mask: torch.Tensor,
                 seed: int = 0, cfg: RansacConfig = RansacConfig()) -> RansacResult:
    """Rigid transform ``src -> tgt`` from ``[C, 3]`` putative
    correspondences under ``corr_mask [C]``; the samples are those of
    ``jax.random.categorical(jax.random.key(seed), ...)`` in the JAX twin."""
    dev, dtype = src_xyz.device, src_xyz.dtype
    n_valid = torch.clamp(corr_mask.sum(dtype=torch.int32), min=1)
    if bool(corr_mask.any()):
        idx = prng.masked_categorical(seed, corr_mask, cfg.num_hypotheses, 3)
    else:  # every logit -inf: argmax takes index 0
        idx = torch.zeros((cfg.num_hypotheses, 3), dtype=torch.int64, device=dev)
    s, t = src_xyz[idx], tgt_xyz[idx]  # [H, 3, 3]
    w = corr_mask[idx].to(dtype)
    es, et = _edges(s), _edges(t)
    ratio = torch.minimum(es, et) / torch.clamp(torch.maximum(es, et), min=1e-9)
    sample_ok = (ratio > cfg.edge_similarity).all(-1) & (w.sum(-1) >= 3)
    Ts = point_to_point_transform(s, t, w)  # [H, 4, 4]

    # Inlier counts over the valid correspondences (an invalid one never counts).
    cols = torch.nonzero(corr_mask).reshape(-1)
    inl_v = _moved_d2(Ts, src_xyz[cols], tgt_xyz[cols]) <= cfg.inlier_dist ** 2
    counts = inl_v.sum(-1, dtype=torch.int32)
    counts = torch.where(sample_ok, counts, -1)
    best = _first_argmax(counts)
    best_count = counts[best]
    best_inl = (_moved_d2(Ts[best][None], src_xyz, tgt_xyz)[0] <= cfg.inlier_dist ** 2) & corr_mask
    polish_T = point_to_point_transform(src_xyz, tgt_xyz, best_inl.to(dtype))
    ok = best_count >= cfg.min_inliers
    T_out = torch.where(ok, polish_T, torch.eye(4, dtype=dtype, device=dev))
    return RansacResult(transform=T_out, inliers=best_count,
                        fitness=best_count.to(dtype) / n_valid.to(dtype), ok=ok)

"""Loop-closure detection: candidate gating, coarse alignment, verification.

Twin of ``open3d_slam_private_tpu/slam/place_recognition.py``:

- candidates of a finished submap: other finished submaps at least
  ``min_submaps_between_candidates`` indices and ``min_adjacency_distance``
  hops away, anchors within ``max_candidate_distance``, the nearest
  ``max_candidates`` first;
- coarse alignment: FPFH features, mutual-nearest matches and RANSAC
  (JAX's threefry draws from ``jax.random.key(seed)``), whose pose leads
  a seed grid of yaws (and translation offsets) around the anchors'
  relative pose;
- verification: multi-hypothesis ICP (``register_hypotheses``) over the
  seeds, the best accepted hypothesis by residual among those with enough
  overlap, then the drift-consistency gate.

Reproduced from the twin, not repaired: the index gate
``min_submaps_between_candidates`` is a static 2, where open3d_slam derives
it from the search radius over the submap radius; and
``build_loop_closure_constraints`` takes a ``drift_estimate`` it never
reads, the gate testing the correction against the anchors' relative pose
alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from open3d_slam_private_tpu_torch.models import icp as icp_mod
from open3d_slam_private_tpu_torch.models import ransac as ransac_mod
from open3d_slam_private_tpu_torch.ops import fpfh as fpfh_mod
from open3d_slam_private_tpu_torch.ops import grid_hash
from open3d_slam_private_tpu_torch.ops import normals as normals_mod
from open3d_slam_private_tpu_torch.ops import pointcloud as pc


@dataclasses.dataclass(frozen=True)
class PlaceRecognitionConfig:
    """The JAX twin's fields and defaults."""

    max_candidate_distance: float = 40.0  # anchor distance gate
    min_submaps_between_candidates: int = 2  # index gate
    min_adjacency_distance: int = 2  # hop gate: reject candidates fewer hops away
    max_candidates: Optional[int] = 4  # verify the K nearest gated candidates (None: all)
    use_fpfh_ransac: bool = True
    fpfh_knn: int = 16
    fpfh_ratio: Optional[float] = None  # Lowe ratio on feature matches
    ransac_hypotheses: int = 1024
    ransac_inlier_dist: float = 0.5
    ransac_min_inliers: int = 15
    num_yaw_hypotheses: int = 16
    num_xy_offsets: int = 1  # 1: center only; 5: center + 4 offsets
    xy_offset: float = 5.0
    min_overlap: float = 0.35
    max_residual: float = 0.3
    max_drift_trans: float = 10.0  # drift-consistency gate
    max_drift_rot: float = 0.6
    icp: icp_mod.ICPConfig = dataclasses.field(
        default_factory=lambda: icp_mod.ICPConfig(
            knn=1,
            max_match_dist=1.0,
            matcher="grid",
            grid_table_size=1 << 15,
            grid_bucket_cap=96,
            trimmed_ratio=0.8,
            minimizer="point_to_plane",
            max_iterations=30,
            min_diff_rot=1e-3,
            min_diff_trans=1e-3,
        )
    )


@dataclasses.dataclass
class LoopClosureConstraint:
    source_idx: int
    target_idx: int
    T_target_source: np.ndarray  # relative pose between the submap anchors
    overlap: float
    residual: float
    information: np.ndarray  # [6, 6]


def candidate_pairs(collection, query_idx: int, cfg: PlaceRecognitionConfig) -> List[int]:
    """Gated loop-closure candidates of a finished submap, nearest first."""
    out = []
    q = collection.submaps[query_idx]
    for i, e in enumerate(collection.submaps):
        if i == query_idx or not e.finished:
            continue
        if abs(i - query_idx) < cfg.min_submaps_between_candidates:
            continue
        if collection.adjacency.distance(i, query_idx) < cfg.min_adjacency_distance:
            continue
        d = np.linalg.norm(e.anchor[:3, 3] - q.anchor[:3, 3])
        if d > cfg.max_candidate_distance:
            continue
        out.append((d, i))
    out.sort()
    if cfg.max_candidates is not None:
        out = out[: cfg.max_candidates]
    return [i for _, i in out]


def _seed_grid(T_anchor_rel: np.ndarray, cfg: PlaceRecognitionConfig) -> np.ndarray:
    """Yaw x translation hypothesis grid around the anchor-relative pose."""
    seeds = []
    yaws = np.linspace(0, 2 * np.pi, cfg.num_yaw_hypotheses, endpoint=False)
    offsets = [(0.0, 0.0)]
    if cfg.num_xy_offsets > 1:
        r = cfg.xy_offset
        offsets += [(r, 0.0), (-r, 0.0), (0.0, r), (0.0, -r)][: cfg.num_xy_offsets - 1]
    for yaw in yaws:
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        for ox, oy in offsets:
            T = np.asarray(T_anchor_rel, np.float64).copy()
            T[:3, :3] = R @ T[:3, :3]
            T[0, 3] += ox
            T[1, 3] += oy
            seeds.append(T)
    return np.stack(seeds).astype(np.float32)


def fpfh_coarse_align(source: pc.PointBatch, target: pc.PointBatch, cfg: PlaceRecognitionConfig,
                      seed: int = 0, stages=None) -> Optional[np.ndarray]:
    """FPFH features + mutual matching + RANSAC -> coarse T (float64) or
    None. Both clouds carry normals. ``stages``: see :func:`stage_fn`."""
    stage = stage_fn(stages)
    radius = 2.0 * cfg.icp.max_match_dist
    with stage("fpfh"):
        g_s = grid_hash.build_grid(source.padded_xyz(), source.mask, radius, 1 << 14, 32,
                                   normals=source.normals)
        g_t = grid_hash.build_grid(target.padded_xyz(), target.mask, radius, 1 << 14, 32,
                                   normals=target.normals)
        f_s = fpfh_mod.compute_fpfh(source, g_s, knn=cfg.fpfh_knn)
        f_t = fpfh_mod.compute_fpfh(target, g_t, knn=cfg.fpfh_knn)
    with stage("matches"):
        ids, ok = fpfh_mod.mutual_matches(f_s, source.mask, f_t, target.mask, ratio=cfg.fpfh_ratio)
        enough = int(ok.sum()) >= cfg.ransac_min_inliers
    if not enough:
        return None
    with stage("ransac"):
        tgt_pts = target.xyz[torch.clamp(ids, min=0).long()]
        res = ransac_mod.ransac_align(
            source.xyz, tgt_pts, ok, seed,
            ransac_mod.RansacConfig(num_hypotheses=cfg.ransac_hypotheses,
                                    inlier_dist=cfg.ransac_inlier_dist,
                                    min_inliers=cfg.ransac_min_inliers),
        )
        accepted = bool(res.ok)
    if not accepted:
        return None
    return res.transform.double().cpu().numpy()


def stage_fn(stages):
    """``stages`` (a callable name -> context manager around that stage),
    or one that does nothing."""
    return stages if callable(stages) else (lambda name: contextlib.nullcontext())


def verify_candidate(source_cloud: pc.PointBatch, target_cloud: pc.PointBatch, T_init: np.ndarray,
                     cfg: PlaceRecognitionConfig, stages=None) -> Optional[tuple]:
    """Refine source -> target from the RANSAC pose (when it succeeds) and
    the seed grid around ``T_init``. Returns (T, overlap, residual) of the
    best accepted hypothesis or None."""
    stage = stage_fn(stages)
    with stage("normals"):
        source_cloud = normals_mod.estimate_normals(source_cloud, knn=8,
                                                    max_dist=2.0 * cfg.icp.max_match_dist)
        target = normals_mod.estimate_normals(target_cloud, knn=8, max_dist=2.0 * cfg.icp.max_match_dist)
    seeds_list = [_seed_grid(T_init, cfg)]
    if cfg.use_fpfh_ransac:
        T_coarse = fpfh_coarse_align(source_cloud, target, cfg, stages=stages)
        if T_coarse is not None:
            seeds_list.insert(0, T_coarse[None].astype(np.float32))
    with stage("icp"):
        seeds = torch.as_tensor(np.concatenate(seeds_list, axis=0), device=source_cloud.device)
        res = icp_mod.register_hypotheses(source_cloud, target, seeds, cfg.icp)
        overlap = res.overlap_ratio.cpu().numpy()
        residual = res.residual.cpu().numpy()
        transforms = res.transform.cpu().numpy()
    score = np.where(overlap >= cfg.min_overlap, residual, np.inf)
    best = int(np.argmin(score))
    if not np.isfinite(score[best]) or residual[best] > cfg.max_residual:
        return None
    return transforms[best].astype(np.float64), float(overlap[best]), float(residual[best])


def information_from_quality(overlap: float, residual: float) -> np.ndarray:
    """Information matrix from the registration's quality: tighter residual
    and higher overlap give a stronger constraint."""
    strength = overlap / max(residual, 1e-3)
    return np.eye(6) * float(np.clip(strength, 1e-2, 1e4))


def build_loop_closure_constraints(collection, query_idx: int, drift_estimate: Optional[np.ndarray] = None,
                                   cfg: Optional[PlaceRecognitionConfig] = None, scan_capacity: int = 16384,
                                   stages=None, tried: Optional[list] = None) -> List[LoopClosureConstraint]:
    """Candidates -> verification -> drift gate for one finished submap.
    ``tried``, if given, receives each verified candidate's index."""
    cfg = cfg or PlaceRecognitionConfig()
    out: List[LoopClosureConstraint] = []
    q = collection.submaps[query_idx]
    src_cloud = pc.compact(q.state.cloud, scan_capacity)
    dev = src_cloud.device
    for tgt_idx in candidate_pairs(collection, query_idx, cfg):
        if tried is not None:
            tried.append(tgt_idx)
        t = collection.submaps[tgt_idx]
        T_rel = np.linalg.inv(t.anchor) @ q.anchor
        # Each submap in its own anchor frame.
        src_local = src_cloud.transformed(torch.as_tensor(np.linalg.inv(q.anchor), dtype=torch.float32,
                                                          device=dev))
        tgt_local = pc.compact(t.state.cloud, scan_capacity).transformed(
            torch.as_tensor(np.linalg.inv(t.anchor), dtype=torch.float32, device=dev))
        got = verify_candidate(src_local, tgt_local, T_rel, cfg, stages=stages)
        if got is None:
            continue
        T, overlap, residual = got
        # Drift consistency: the implied correction stays bounded.
        corr = T @ np.linalg.inv(T_rel)
        dt = np.linalg.norm(corr[:3, 3])
        dr = np.arccos(np.clip((np.trace(corr[:3, :3]) - 1) / 2, -1, 1))
        if dt > cfg.max_drift_trans or dr > cfg.max_drift_rot:
            continue
        out.append(LoopClosureConstraint(source_idx=query_idx, target_idx=tgt_idx, T_target_source=T,
                                         overlap=overlap, residual=residual,
                                         information=information_from_quality(overlap, residual)))
    return out

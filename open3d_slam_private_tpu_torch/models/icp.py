"""The batched, degeneracy-aware ICP chain and its entry points.

Twin of ``open3d_slam_private_tpu/models/icp.py`` for the point-to-plane,
6-DoF chain with TrimmedDist weights and X-ICP (degeneracy "none" or the
binary Optimized method with the equality-constrained KKT solve), in two
forms, picked by the config as the JAX package picks them:

- the **candidate-cached rounds** (``candidate_refresh_every > 0`` with the
  grid or hash matcher): one selection per round (the cell list's row, or the
  hash grid's 8 buckets), then in-round GN steps
  on the frozen pairs through the fused pair-GN kernels, K1 (knn = 1) or K3
  (knn 2..8), with the trim threshold frozen per round (histogram). The
  round's selection is a row gather + k-pass re-rank, the gather-select
  kernel K2 (``gather_kernel=True``, knn = 1), or the rank-select kernel K4
  (``select_kernel=True``, knn = 1; K2 wins when both are set) on the rows
  read in place, where the JAX package gathers them first;
- the **per-iteration chain** (libpointmatcher's reference-exact loop:
  ``candidate_refresh_every = 0``, or a brute matcher): every iteration
  re-matches (cell list, hash grid, brute KNN, or the brute 1-NN kernel K5 for
  ``matcher="brute_pallas"``), re-trims (exact nth-element or histogram) and
  solves.

X-ICP detection runs at the first iteration of each GN loop, so the coarse
loop and the fine loop each detect once. ``icp_batch`` runs B problems
against one shared reference, written out with a leading batch axis (the
JAX package vmaps ``icp_single``): every problem carries its own ``done``
flag and the loops run while any problem is active, updating only the active
ones. The path is chosen by the config alone, never by the device: on CPU
tensors the kernels' plain versions run. Both chains form their normal
equations through ``normal_eq``, which on the card sums each problem in an
order fixed by its own size, so a problem's result does not depend on the
batch it runs in.

User entry points, as in the JAX package: :func:`register_pair`,
:func:`register_batch`, :func:`register_hypotheses` and
:class:`ICPSequence`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.kernels.gather_select import (
    gather_select,
    match_result_from_selected,
)
from open3d_slam_private_tpu_torch.kernels.knn_brute import knn_brute
from open3d_slam_private_tpu_torch.kernels.normal_eq import normal_eq
from open3d_slam_private_tpu_torch.kernels.pair_gn import pair_gn, pair_gn_k
from open3d_slam_private_tpu_torch.kernels.select import rank_select_table
from open3d_slam_private_tpu_torch.models import localizability as xicp
from open3d_slam_private_tpu_torch.models import minimizers
from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod
from open3d_slam_private_tpu_torch.ops import grid_hash as grid_mod
from open3d_slam_private_tpu_torch.ops.grid_hash import MatchResult, f32, match_from_candidates
from open3d_slam_private_tpu_torch.ops.knn import INF, INVALID_ID, gather_matched, knn_bruteforce
from open3d_slam_private_tpu_torch.ops.outliers import (
    trimmed_dist,
    trimmed_dist_histogram,
    trimmed_dist_limit,
)
from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch, masked_centroid


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """The JAX twin's fields and defaults. :func:`check_config` names the
    fields whose values select a path this package does not run."""

    knn: int = 1
    max_match_dist: float = math.inf
    matcher: str = "grid"
    grid_table_size: int = 1 << 15
    grid_bucket_cap: int = 48
    max_dist_field: Optional[str] = None
    reading_step_random_prob: Optional[float] = None
    reading_step_filters: Optional[tuple] = None
    packed_payload: bool = False
    trimmed_ratio: Optional[float] = None
    fast_trimming: bool = False
    var_trimmed: Optional[tuple] = None
    median_factor: Optional[float] = None
    normal_angle_max: Optional[float] = None
    robust: Optional[str] = None
    robust_scale: float = 1.0
    max_residual_dist: Optional[float] = None
    min_residual_dist: Optional[float] = None
    generic_descriptor: Optional[tuple] = None
    minimizer: str = "point_to_plane"
    gicp_epsilon: float = 1e-3
    force_4dof: bool = False
    force_2d: bool = False
    degeneracy: xicp.DegeneracyConfig = dataclasses.field(default_factory=xicp.DegeneracyConfig)
    max_iterations: int = 30
    min_diff_rot: float = 1e-3
    min_diff_trans: float = 1e-3
    smooth_length: int = 3
    max_rotation_norm: float = math.inf
    max_translation_norm: float = math.inf
    coarse_iterations: int = 0
    coarse_stride: int = 8
    candidate_refresh_every: int = 0
    candidate_slack: float = 0.25
    anderson: bool = False
    anderson_max: float = 25.0
    fused_kernel: bool = False
    select_kernel: bool = False
    gather_kernel: bool = False
    moment_cached: bool = True
    moment_revisit_scale: float = 1.0
    shard_axis: Optional[str] = None


_MATCHERS = ("grid", "hash", "brute", "brute_pallas")


def _cached(cfg: ICPConfig) -> bool:
    """The JAX chain's switch to candidate-cached rounds."""
    return cfg.candidate_refresh_every > 0 and cfg.matcher in ("grid", "hash")


def check_config(cfg: ICPConfig) -> None:
    """Raise NotImplementedError naming the first field that selects a path
    outside the ported chains (see the module docstring), and ValueError
    where the JAX package raises one."""
    required = dict(
        minimizer="point_to_plane", packed_payload=False, force_2d=False, force_4dof=False,
        anderson=False,
    )
    for name, want in required.items():
        if getattr(cfg, name) != want:
            raise NotImplementedError(f"ICPConfig.{name}={getattr(cfg, name)!r} is not ported")
    if cfg.matcher not in _MATCHERS:
        raise NotImplementedError(f"ICPConfig.matcher={cfg.matcher!r} is not ported")
    if not 1 <= cfg.knn <= 8:
        raise NotImplementedError(f"ICPConfig.knn={cfg.knn} is not ported (1..8 are)")
    for name in (
        "max_dist_field", "reading_step_random_prob", "reading_step_filters",
        "var_trimmed", "median_factor", "normal_angle_max", "robust",
        "max_residual_dist", "min_residual_dist", "generic_descriptor", "shard_axis",
    ):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(f"ICPConfig.{name}={getattr(cfg, name)!r} is not ported")
    if cfg.degeneracy.method not in ("none", "optimized"):
        raise NotImplementedError(
            f"DegeneracyConfig.method={cfg.degeneracy.method!r} is not ported"
        )
    if _cached(cfg):
        if not cfg.fused_kernel:
            raise NotImplementedError(
                "ICPConfig.fused_kernel=False (the moment/direct path of the cached rounds) "
                "is not ported"
            )
        if cfg.trimmed_ratio is not None and not cfg.fast_trimming:
            raise NotImplementedError(
                "ICPConfig.fast_trimming=False (exact trimming in the cached rounds) is not ported"
            )
    if cfg.matcher in ("grid", "hash") and not math.isfinite(cfg.max_match_dist):
        raise ValueError(f"{cfg.matcher} matcher requires a finite max_match_dist; use "
                         "matcher='brute' for unbounded search")


@dataclasses.dataclass(frozen=True)
class ICPReference:
    """Reference cloud centred at its centroid + its matcher structure: the
    cell list (grid matcher), the hash grid (hash matcher) or None (brute
    matchers)."""

    cloud: PointBatch
    centroid: torch.Tensor  # [3]
    grid: Optional[object]  # CellList, GridHash or None


@dataclasses.dataclass(frozen=True)
class ICPResult:
    """Per-problem outputs, each with the leading batch shape."""

    transform: torch.Tensor  # [..., 4, 4] reading -> reference
    iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    match_ratio: torch.Tensor
    overlap_ratio: torch.Tensor
    residual: torch.Tensor
    eigenvalues: torch.Tensor  # [..., 6]
    condition_number: torch.Tensor
    localizability_rot: torch.Tensor  # [..., 3]
    localizability_trans: torch.Tensor  # [..., 3]
    degenerate: torch.Tensor  # bool
    aborted: torch.Tensor  # bool
    covariance: torch.Tensor  # [..., 6, 6]
    match_row_saturation: torch.Tensor


def build_reference(
    reference: PointBatch, cfg: ICPConfig, centroid: Optional[torch.Tensor] = None,
    const_size: bool = False,
) -> ICPReference:
    """Centre the reference at its centroid and build its matcher
    structure: for the grid matcher a cell list of side ``max_match_dist``,
    for the hash matcher a hash grid of cell ``2 * max_match_dist``, each
    widened by ``candidate_slack`` when the rounds cache candidates. The
    brute matchers build none. ``const_size``: the JAX twin builds (and
    queries) the structure inside a jitted step of a static config, where
    the cell size is a compile-time constant (``grid_hash.recip``).

    The brute matchers centre at JAX's centroid bit for bit: they rank by
    the expansion ``|q|^2 - 2 q.r + |r|^2``, whose float32 rounding turns a
    last-bit shift of the centred coordinates into other near-tie picks.
    The cell matchers keep PyTorch's own sum (one launch)."""
    check_config(cfg)
    if centroid is None:
        centroid = masked_centroid(reference, xla_order=cfg.matcher in ("brute", "brute_pallas"))
    c = centroid
    centered = dataclasses.replace(
        reference,
        xyz=torch.where(reference.mask[..., None], reference.xyz - c, reference.xyz),
    )
    grid = None
    slack = cfg.candidate_slack if cfg.candidate_refresh_every > 0 else 0.0
    if cfg.matcher == "hash":
        grid = grid_mod.build_grid(
            centered.padded_xyz(),
            centered.mask,
            2.0 * (cfg.max_match_dist + slack),
            table_size=cfg.grid_table_size,
            bucket_cap=cfg.grid_bucket_cap,
            normals=centered.normals,
            const_size=const_size,
        )
    elif cfg.matcher == "grid":
        grid = cell_mod.build_cell_list(
            centered.padded_xyz(),
            centered.mask,
            cfg.max_match_dist + slack,
            table_size=cfg.grid_table_size,
            list_cap=cfg.grid_bucket_cap,
            normals=centered.normals,
            const_size=const_size,
        )
    return ICPReference(cloud=centered, centroid=c, grid=grid)


def _strided(batch: PointBatch, stride: int) -> PointBatch:
    """Static strided subsample of the point axis (contiguous copies)."""
    return PointBatch(
        xyz=batch.xyz[..., ::stride, :].contiguous(),
        mask=batch.mask[..., ::stride].contiguous(),
        extras={k: v[..., ::stride, :].contiguous() for k, v in batch.extras.items()},
    )


def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def _moment_eligible(cfg: ICPConfig) -> bool:
    """The JAX chain's static moment-path eligibility; it sets the round
    budget even though the fused path takes the rounds."""
    return cfg.moment_cached and (cfg.trimmed_ratio is None or cfg.fast_trimming)


def _match(src: torch.Tensor, mask: torch.Tensor, ref: ICPReference, cfg: ICPConfig,
           ref_padded: Optional[torch.Tensor]) -> MatchResult:
    """Per-iteration correspondences ``[B, N, knn]`` of ``src [B, N, 3]``
    (``ref_padded``: the reference's ``padded_xyz()``, brute matchers)."""
    if cfg.matcher == "grid":
        return cell_mod.cell_match(ref.grid, src, mask, k=cfg.knn, max_dist=cfg.max_match_dist)
    if cfg.matcher == "hash":
        return grid_mod.grid_match(ref.grid, src, mask, k=cfg.knn, max_dist=cfg.max_match_dist)
    if cfg.matcher == "brute_pallas":
        if cfg.knn != 1:
            raise ValueError("brute_pallas matcher supports knn=1 only")
        d2, ids = knn_brute(src.reshape(-1, 3), ref_padded)
        d2, ids = d2.reshape(mask.shape), ids.reshape(mask.shape)
        radius = f32(cfg.max_match_dist, src.device)
        ok = mask & (d2 <= radius * radius)
        ids = torch.where(ok, ids, INVALID_ID)[..., None]
        d2 = torch.where(ok, d2, INF)[..., None]
    else:
        res = knn_bruteforce(src, mask, ref_padded, ref.cloud.mask, k=cfg.knn,
                             max_dist=cfg.max_match_dist)
        d2, ids = res.dists, res.ids
    # As in the JAX package, unmatched slots read reference point 0 (their
    # weight is 0).
    q = gather_matched(ref.cloud.xyz, ids)
    normals = ref.cloud.normals
    return MatchResult(dists=d2, ids=ids, xyz=q,
                       normals=gather_matched(normals, ids) if normals is not None
                       else torch.zeros_like(q))


def _weights(res: MatchResult, cfg: ICPConfig, trim_limit=None) -> torch.Tensor:
    """TrimmedDist weights ``[B, N, k]`` (float): the round-frozen limit
    ``trim_limit [B]`` when given, else the histogram (``fast_trimming``) or
    exact nth-element threshold of this iteration's distances."""
    valid = res.valid()
    if cfg.trimmed_ratio is None:
        return valid.float()
    if trim_limit is not None:
        return (valid & (res.dists <= trim_limit[:, None, None])).float()
    if cfg.fast_trimming:
        return trimmed_dist_histogram(res.dists, valid, cfg.trimmed_ratio, cfg.max_match_dist**2)
    return trimmed_dist(res.dists, valid, cfg.trimmed_ratio)


def _flat_pairs(src: torch.Tensor, res: MatchResult, w: torch.Tensor):
    """X-ICP inputs over the ``[B, N * k]`` pairs: the source point repeated
    per pair, the matched normals, and ``valid & (w > 0)``."""
    B, N, K = res.ids.shape
    src_flat = src[:, :, None, :].expand(B, N, K, 3).reshape(B, N * K, 3)
    pm = (res.valid() & (w > 0)).reshape(B, N * K)
    return src_flat, res.normals.reshape(B, N * K, 3), pm


def _detect(A, b, src, res, w, cfg, fresh, loc):
    """The Optimized method's detection for the problems in ``fresh`` [B];
    the others keep ``loc``."""
    return xicp.analyze_optimized(A, b, *_flat_pairs(src, res, w), cfg.degeneracy).select(fresh, loc)


def _init_state(T0: torch.Tensor, cfg: ICPConfig) -> dict:
    dev = T0.device
    B, S = T0.shape[0], cfg.smooth_length
    return dict(
        T=T0,
        it=torch.zeros(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        drot=torch.full((B, S), 1e9, device=dev),
        dtrans=torch.full((B, S), 1e9, device=dev),
        match_ratio=torch.zeros(B, device=dev),
        overlap=torch.zeros(B, device=dev),
        resid=torch.zeros(B, device=dev),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
        aborted=torch.zeros(B, dtype=torch.bool, device=dev),
        A=torch.zeros((B, 6, 6), device=dev),
        row_sat=torch.zeros(B, device=dev),
    )


def _match_round(reading: PointBatch, ref: ICPReference, src0, cfg: ICPConfig, n_valid):
    """Per-round correspondence selection -> (MatchResult [B, N, knn], row
    saturation [B])."""
    B, N = reading.mask.shape
    grid = ref.grid
    if cfg.knn == 1 and cfg.matcher == "grid" and (cfg.gather_kernel or cfg.select_kernel):
        h = cell_mod.query_hash(grid, src0).reshape(-1)
        q = src0.reshape(-1, 3).contiguous()
        m = reading.mask.reshape(-1).contiguous()
        if cfg.gather_kernel:
            sel = gather_select(grid.table, h, q, m)
        else:  # K4 on the rows read in place
            sel = rank_select_table(grid.table, h, q, m)
        sel = sel.reshape(B, N, -1)
        res = match_result_from_selected(sel, reading.mask, cfg.max_match_dist**2)
        full_rows = sel[..., 8] >= grid.list_cap
    else:
        gather = grid_mod.gather_candidates if cfg.matcher == "hash" else cell_mod.gather_cell_candidates
        rows, valid = gather(grid, src0, reading.mask)
        res = match_from_candidates(rows, valid, src0, reading.mask, cfg.max_match_dist, cfg.knn)
        full_rows = valid.sum(-1) >= valid.shape[-1]
    sat = (full_rows & reading.mask).sum(-1).float() / n_valid
    return res, sat


def _run_cached_loop(reading: PointBatch, ref: ICPReference, T0: torch.Tensor, cfg: ICPConfig,
                     max_iterations: int) -> dict:
    """Candidate-cached GN rounds over ``[B, N]`` readings from ``T0 [B, 4, 4]``."""
    dev = T0.device
    B = T0.shape[0]
    R = cfg.candidate_refresh_every
    rounds = max_iterations if _moment_eligible(cfg) else -(-max_iterations // R)
    max_d2 = cfg.max_match_dist**2
    n_valid = torch.clamp(reading.count().float(), min=1.0)
    denom = n_valid * cfg.knn
    optimized = cfg.degeneracy.method == "optimized"
    xyz = reading.xyz.contiguous()

    s = _init_state(T0, cfg)
    loc = xicp._identity_result((B,), dev)

    r = 0
    while r < rounds:
        round_active = ~s["done"] & (s["it"] < max_iterations)
        if not bool(round_active.any()):
            break
        src0 = se3.apply_transform(s["T"], xyz)
        res0, sat = _match_round(reading, ref, src0, cfg, n_valid)
        s["row_sat"] = torch.where(round_active, sat, s["row_sat"])
        valid0 = res0.valid()
        if cfg.trimmed_ratio is not None:
            tau = trimmed_dist_limit(res0.dists, valid0, cfg.trimmed_ratio, max_d2)
        else:
            tau = torch.full((B,), math.inf, device=dev)

        # Binary X-ICP detection runs in the first round of each loop (the
        # reference detects on the first iteration only); later rounds reuse
        # the carried decision.
        fresh = round_active & (s["it"] == 0)
        if optimized and bool(fresh.any()):
            w0 = _weights(res0, cfg, trim_limit=tau)
            A0, b0 = normal_eq(src0, res0.xyz.contiguous(), res0.normals.contiguous(), w0)
            loc = _detect(A0, b0, src0, res0, w0, cfg, fresh, loc)

        if cfg.knn == 1:
            pairs = (res0.xyz[:, :, 0].contiguous(), res0.normals[:, :, 0].contiguous(),
                     valid0[:, :, 0].contiguous())
            step = pair_gn
        else:
            pairs = (res0.xyz.contiguous(), res0.normals.contiguous(), valid0.contiguous())
            step = pair_gn_k
        tau = tau.contiguous()
        i = 0
        while i < R:
            active = round_active & ~s["done"] & (s["it"] < max_iterations)
            if not bool(active.any()):
                break
            A, b, sw, swr2, nok = step(xyz, *pairs, s["T"], tau, max_d2)
            if optimized:
                x = xicp.solve_with_equality_constraints(A, b, loc)
            else:
                x = minimizers.solve_spd_unrolled(A, b)
            dT = minimizers.delta_transform_from_x(x)
            resid = torch.sqrt(swr2 / torch.clamp(sw, min=1e-9))
            new = _advance(s, T0, dT, nok / denom, sw / denom, resid, A, cfg)
            s = {k: _where(active, new[k], v) if k in new else v for k, v in s.items()}
            i += 1
        r += 1
    s["loc"] = loc
    return s


def _run_iter_loop(reading: PointBatch, ref: ICPReference, T0: torch.Tensor, cfg: ICPConfig,
                   max_iterations: int) -> dict:
    """The per-iteration chain (match -> weights -> normal equations ->
    solve every iteration) over ``[B, N]`` readings from ``T0 [B, 4, 4]``."""
    dev = T0.device
    B = T0.shape[0]
    n_valid = torch.clamp(reading.count().float(), min=1.0)
    denom = n_valid * cfg.knn
    optimized = cfg.degeneracy.method == "optimized"
    ref_padded = ref.cloud.padded_xyz() if cfg.matcher.startswith("brute") else None

    s = _init_state(T0, cfg)
    loc = xicp._identity_result((B,), dev)
    while True:
        active = ~s["done"] & (s["it"] < max_iterations)
        if not bool(active.any()):
            break
        src = se3.apply_transform(s["T"], reading.xyz)
        res = _match(src, reading.mask, ref, cfg, ref_padded)
        w = _weights(res, cfg)
        A, b = normal_eq(src, res.xyz.contiguous(), res.normals.contiguous(), w)
        if optimized:
            fresh = active & (s["it"] == 0)
            if bool(fresh.any()):
                loc = _detect(A, b, src, res, w, cfg, fresh, loc)
            x = xicp.solve_with_equality_constraints(A, b, loc)
        else:
            x = minimizers.solve_spd_unrolled(A, b)
        dT = minimizers.delta_transform_from_x(x)
        r = ((src[:, :, None, :] - res.xyz) * res.normals).sum(-1)
        resid = torch.sqrt((w * r * r).sum((1, 2)) / torch.clamp(w.sum((1, 2)), min=1e-9))
        match_ratio = res.valid().sum((1, 2)).float() / denom
        overlap = (w > 0).sum((1, 2)).float() / denom
        new = _advance(s, T0, dT, match_ratio, overlap, resid, A, cfg)
        s = {k: _where(active, new[k], v) if k in new else v for k, v in s.items()}
    s["loc"] = loc
    return s


def _advance(s: dict, T0, dT, match_ratio, overlap, resid, A, cfg: ICPConfig) -> dict:
    """One GN step's state update: compose, differential and bound checks."""
    T = s["T"]
    T_new = dT @ T
    dr = se3.rotation_angular_distance(T_new[:, :3, :3], T[:, :3, :3])
    dt = torch.linalg.vector_norm(T_new[:, :3, 3] - T[:, :3, 3], dim=-1)
    drot = torch.cat([dr[:, None], s["drot"][:, :-1]], dim=1)
    dtrans = torch.cat([dt[:, None], s["dtrans"][:, :-1]], dim=1)
    converged = (drot.mean(1) < cfg.min_diff_rot) & (dtrans.mean(1) < cfg.min_diff_trans)
    tot_rot = se3.rotation_angular_distance(T_new[:, :3, :3], T0[:, :3, :3])
    tot_trans = torch.linalg.vector_norm(T_new[:, :3, 3] - T0[:, :3, 3], dim=-1)
    aborted = s["aborted"] | (tot_rot > cfg.max_rotation_norm) | (
        tot_trans > cfg.max_translation_norm
    )
    return dict(
        T=_where(aborted, T0, T_new),
        it=s["it"] + 1,
        done=converged | aborted,
        drot=drot,
        dtrans=dtrans,
        match_ratio=match_ratio,
        overlap=overlap,
        resid=resid,
        converged=converged & ~aborted,
        aborted=aborted,
        A=A,
    )


def icp_batch(
    readings: PointBatch, ref: ICPReference, init_T: torch.Tensor, cfg: ICPConfig
) -> ICPResult:
    """Register ``B`` readings (``xyz [B, N, 3]``) against one reference from
    ``init_T [B, 4, 4]``."""
    check_config(cfg)
    dev = init_T.device
    B = init_T.shape[0]
    shift = torch.eye(4, device=dev).repeat(B, 1, 1)
    unshift = shift.clone()
    shift[:, :3, 3] = -ref.centroid
    unshift[:, :3, 3] = ref.centroid
    T0 = shift @ init_T

    run_loop = _run_cached_loop if _cached(cfg) else _run_iter_loop
    coarse_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    if cfg.coarse_iterations > 0 and cfg.coarse_stride > 1:
        cstate = run_loop(
            _strided(readings, cfg.coarse_stride), ref, T0, cfg, cfg.coarse_iterations
        )
        T0 = cstate["T"]
        coarse_iters = cstate["it"]
    final = run_loop(readings, ref, T0, cfg, cfg.max_iterations)

    loc = final["loc"]
    degenerate = (loc.localizability_rot.amin(-1) < 0.5) | (loc.localizability_trans.amin(-1) < 0.5)
    # Spectral diagnostics + covariance from the final hessian, once.
    A = final["A"]
    w6, V6 = torch.linalg.eigh(A)
    aw = w6.abs()
    inv = torch.where(aw > 1e-7 * aw.amax(-1, keepdim=True), 1.0 / w6, 0.0)
    cov = (V6 * inv[:, None, :]) @ V6.transpose(-1, -2)
    cov = cov * (torch.clamp(final["resid"], min=1e-6) ** 2)[:, None, None]
    have_A = A.abs().amax(dim=(-2, -1)) > 0
    return ICPResult(
        transform=unshift @ final["T"],
        iterations=final["it"] + coarse_iters,
        converged=final["converged"],
        match_ratio=final["match_ratio"],
        overlap_ratio=final["overlap"],
        residual=final["resid"],
        eigenvalues=_where(have_A, w6, loc.eigenvalues6),
        condition_number=torch.where(
            have_A, aw.amax(-1) / torch.clamp(aw.amin(-1), min=1e-30), loc.condition_number
        ),
        localizability_rot=loc.localizability_rot,
        localizability_trans=loc.localizability_trans,
        degenerate=degenerate,
        aborted=final["aborted"],
        covariance=cov,
        match_row_saturation=final["row_sat"],
    )


def icp_single(reading: PointBatch, ref: ICPReference, init_T: torch.Tensor, cfg: ICPConfig) -> ICPResult:
    """Register one reading (``xyz [N, 3]``): :func:`icp_batch` with B = 1."""
    batch = PointBatch(
        xyz=reading.xyz[None], mask=reading.mask[None],
        extras={k: v[None] for k, v in reading.extras.items()},
    )
    res = icp_batch(batch, ref, init_T[None], cfg)
    return ICPResult(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def _problem(batch: PointBatch, b: int) -> PointBatch:
    return PointBatch(xyz=batch.xyz[b], mask=batch.mask[b],
                      extras={k: v[b] for k, v in batch.extras.items()})


def register_pair(reading: PointBatch, reference: PointBatch, init_T: torch.Tensor,
                  cfg: ICPConfig) -> ICPResult:
    """One-shot registration of a reading (``xyz [N, 3]``) against a
    reference cloud (``[M, 3]``) from ``init_T [4, 4]``: build the reference,
    then :func:`icp_single`."""
    return icp_single(reading, build_reference(reference, cfg, const_size=True), init_T, cfg)


def register_batch(readings: PointBatch, references: PointBatch, init_Ts: torch.Tensor,
                   cfg: ICPConfig) -> ICPResult:
    """B independent problems, a leading axis B on every input: reading b
    against reference b from ``init_Ts[b]``. Each problem builds its own
    reference and runs alone."""
    out = [
        icp_single(_problem(readings, b),
                   build_reference(_problem(references, b), cfg, const_size=True), init_Ts[b], cfg)
        for b in range(init_Ts.shape[0])
    ]
    return ICPResult(**{f.name: torch.stack([getattr(r, f.name) for r in out])
                        for f in dataclasses.fields(ICPResult)})


def register_hypotheses(reading: PointBatch, reference: PointBatch, init_Ts: torch.Tensor,
                        cfg: ICPConfig) -> ICPResult:
    """Multi-hypothesis registration: one reading (``xyz [N, 3]``) and one
    reference, ``init_Ts [H, 4, 4]`` seeds, run as one :func:`icp_batch` of
    H problems over the reading expanded (not copied) to ``[H, N, 3]``."""
    ref = build_reference(reference, cfg, const_size=True)
    H = init_Ts.shape[0]
    readings = PointBatch(
        xyz=reading.xyz.expand(H, *reading.xyz.shape),
        mask=reading.mask.expand(H, *reading.mask.shape),
        extras={k: v.expand(H, *v.shape) for k, v in reading.extras.items()},
    )
    return icp_batch(readings, ref, init_Ts, cfg)


class ICPSequence:
    """Persistent-reference registration: set a map once (the reference
    build), then register a stream of readings against it."""

    def __init__(self, cfg: ICPConfig):
        self.cfg = cfg
        self._ref: Optional[ICPReference] = None

    def has_map(self) -> bool:
        return self._ref is not None

    def set_map(self, reference: PointBatch) -> None:
        self._ref = build_reference(reference, self.cfg)

    def clear_map(self) -> None:
        self._ref = None

    def __call__(self, reading: PointBatch, init_T: Optional[torch.Tensor] = None) -> ICPResult:
        if self._ref is None:
            raise RuntimeError("ICPSequence: no map set (call set_map first)")
        if init_T is None:
            init_T = torch.eye(4, device=reading.device)
        return icp_single(reading, self._ref, init_T, self.cfg)

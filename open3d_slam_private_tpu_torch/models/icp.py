"""The batched, degeneracy-aware ICP chain and its entry points.

Twin of ``open3d_slam_private_tpu/models/icp.py`` for the 6-DoF
point-to-plane and GICP minimizers, with TrimmedDist weights and X-ICP
(degeneracy "none", "solution_remapping", the binary "optimized" method or
the ternary "equality_constraints" method, each with the
equality-constrained KKT solve where it locks directions). The chain takes
the JAX package's paths, picked by the config alone:

- the **candidate-cached rounds** (``candidate_refresh_every > 0`` with the
  grid or hash matcher): one selection per round (the cell list's row, or
  the hash grid's 8 buckets; the gather-select kernel K2 with
  ``gather_kernel=True``, or the rank-select kernel K4 on the rows read in
  place with ``select_kernel=True``, both at knn = 1), then in-round GN
  steps on the frozen pairs along one of three paths:

  - **fused** (``fused_kernel=True``, point-to-plane, X-ICP "none" or a
    decision frozen per round, histogram trimming or none): the fused
    pair-GN kernels K1 (knn = 1) or K3 (knn 2..8) each iteration;
  - **moment** (the default, ``fused_kernel=False``, and the chains the
    fused kernels do not cover, such as GICP or solution remapping): the
    pairs, weights (and GICP's precisions) frozen at round start, the
    ``moments`` kernel forms the system's moments once a round, and each
    iteration rebuilds ``A(T), b(T)`` from them; a round that converged on
    stale weights is followed by one that re-verifies;
  - **direct** (exact trimming, ``fast_trimming=False``, or the ternary
    method re-analysed every iteration, ``analysis_per_round=False``): each
    iteration re-gates the cached pairs by distance and solves as the
    per-iteration chain does;

- the **per-iteration chain** (libpointmatcher's reference-exact loop:
  ``candidate_refresh_every = 0``, or a brute matcher): every iteration
  re-matches (cell list, hash grid, brute KNN, or the brute 1-NN kernel K5 for
  ``matcher="brute_pallas"``), re-trims (exact nth-element or histogram) and
  solves.

The binary method detects at the first iteration of each GN loop (the
coarse loop and the fine loop each detect once); the ternary method
re-analyses every iteration, or once a cached round. GICP ignores the
degeneracy method except solution remapping on its moment path, as in the
JAX package. ``icp_batch`` runs B problems against one shared reference,
written out with a leading batch axis (the JAX package vmaps
``icp_single``): every problem carries its own ``done`` flag and the loops
run while any problem is active, updating only the active ones. The path is
chosen by the config alone, never by the device: on CPU tensors the
kernels' plain versions run. Every sum over a problem's pairs that reaches
a solve goes through ``normal_eq`` or ``moments``, which on the card sum
each problem in an order fixed by its own size, so a problem's result does
not depend on the batch it runs in.

User entry points, as in the JAX package: :func:`register_pair`,
:func:`register_batch`, :func:`register_hypotheses` and
:class:`ICPSequence`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch

from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.kernels.gather_select import (
    gather_select,
    match_result_from_selected,
)
from open3d_slam_private_tpu_torch.kernels.knn_brute import knn_brute
from open3d_slam_private_tpu_torch.kernels.moments import gicp_moments, pair_sums, point_to_plane_moments
from open3d_slam_private_tpu_torch.kernels.normal_eq import normal_eq
from open3d_slam_private_tpu_torch.kernels.pair_gn import pair_gn, pair_gn_k
from open3d_slam_private_tpu_torch.kernels.select import rank_select_table
from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig
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


_MINIMIZERS = ("point_to_plane", "gicp")
_METHODS = ("none", "solution_remapping", "optimized", "equality_constraints")


def check_config(cfg: ICPConfig) -> None:
    """Raise NotImplementedError naming the first field that selects a path
    outside the ported chains (see the module docstring), and ValueError
    where the JAX package raises one."""
    if cfg.minimizer not in _MINIMIZERS:
        raise NotImplementedError(f"ICPConfig.minimizer={cfg.minimizer!r} is not ported")
    required = dict(packed_payload=False, force_2d=False, force_4dof=False, anderson=False)
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
    if cfg.degeneracy.method not in _METHODS:
        raise NotImplementedError(
            f"DegeneracyConfig.method={cfg.degeneracy.method!r} is not ported"
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


def _moment_eligible(cfg: ICPConfig, has_normals: bool) -> bool:
    """The JAX chain's static moment-path eligibility (GICP with reading
    normals, or point-to-plane whose X-ICP input each iteration is just
    (A, b); histogram trimming or none). It also sets the round budget when
    the fused path takes the rounds."""
    method = cfg.degeneracy.method
    minimizer_ok = (cfg.minimizer == "gicp" and has_normals) or (
        cfg.minimizer == "point_to_plane"
        and (method in ("none", "solution_remapping", "optimized")
             or (method == "equality_constraints" and cfg.degeneracy.analysis_per_round))
    )
    return cfg.moment_cached and minimizer_ok and (cfg.trimmed_ratio is None or cfg.fast_trimming)


def _frozen_analysis(cfg: ICPConfig) -> bool:
    """Whether the cached rounds freeze the X-ICP decision: once a round
    (the ternary method with ``analysis_per_round``) or once a loop (the
    binary method, at its first iteration); point-to-plane only."""
    method = cfg.degeneracy.method
    return cfg.minimizer == "point_to_plane" and (
        method == "optimized"
        or (method == "equality_constraints" and cfg.degeneracy.analysis_per_round)
    )


def _round_path(cfg: ICPConfig, has_normals: bool) -> str:
    """The cached rounds' in-round path, "fused", "moment" or "direct", as
    the JAX chain chooses it (``fused_kernel=True`` takes the fused kernels
    on every device, as JAX does on its accelerator)."""
    moment_ok = _moment_eligible(cfg, has_normals)
    fused_ok = (
        cfg.fused_kernel
        and cfg.minimizer == "point_to_plane"
        and (cfg.degeneracy.method == "none" or _frozen_analysis(cfg))
        and (cfg.trimmed_ratio is None or cfg.fast_trimming)
    )
    if cfg.fused_kernel and not fused_ok and not moment_ok:
        warnings.warn(
            "fused_kernel=True but this chain is outside the fused pair-GN kernel's coverage "
            "(point-to-plane, 6-DoF, degeneracy none or frozen per round, histogram trimming); "
            "running the direct path",
            stacklevel=3,
        )
    return "fused" if fused_ok else "moment" if moment_ok else "direct"


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


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _analysis(A, b, src, res, w, cfg, fresh, prev):
    """The X-ICP decision on this system: the binary method's detection
    for the problems in ``fresh`` [B] (the others keep ``prev``), or the
    ternary method's analysis for every problem."""
    src_flat, mn, pm = _flat_pairs(src, res, w)
    if cfg.degeneracy.method == "optimized":
        return xicp.analyze_optimized(A, b, src_flat, mn, pm, cfg.degeneracy).select(fresh, prev)
    ddn = _dot3(src_flat - res.xyz.reshape(src_flat.shape), mn)
    return xicp.analyze_equality_constraints(A, b, src_flat, mn, ddn, pm, cfg.degeneracy)


def _solve(A, b, cfg: ICPConfig, loc, analyse):
    """The 6-DoF solve by degeneracy method -> (x, loc): solution remapping,
    the equality-constrained KKT solve on ``loc`` (or, when ``loc`` is None,
    on ``analyse()``), or the damped Cholesky solve."""
    method = cfg.degeneracy.method
    dev = A.device
    if method == "solution_remapping":
        return xicp.solve_with_solution_remapping(A, b, cfg.degeneracy)
    if method in ("optimized", "equality_constraints"):
        if loc is None:
            loc = analyse()
        return xicp.solve_with_equality_constraints(A, b, loc), loc
    return minimizers.solve_normal_equations_fast(A, b), xicp._identity_result(A.shape[:1], dev)


def _gn_update(reading: PointBatch, src, res: MatchResult, T, cfg: ICPConfig, denom,
               trim_limit=None, frozen_loc=None, prev_loc=None, fresh=None, fresh_any=None):
    """One GN step on matched pairs ``[B, N, k]`` at poses ``T`` (``src``:
    the reading moved by ``T``) -> (dT, loc, match ratio, overlap, resid,
    A). The X-ICP decision is ``frozen_loc`` when given, else the binary
    method detects for ``fresh`` problems (others keep ``prev_loc``) and
    the ternary method analyses this iteration. ``fresh_any``: whether any
    problem is fresh, when the caller knows it without reading the device
    (the static-trip loops); else it is read."""
    w = _weights(res, cfg, trim_limit=trim_limit)
    B, N, K = res.ids.shape
    if cfg.minimizer == "gicp":
        if reading.normals is None:
            raise ValueError("gicp minimizer requires reading normals")
        src_n = se3.apply_rotation(T, reading.normals)
        flat = lambda v: v[:, :, None, :].expand(B, N, K, 3).reshape(B, N * K, 3)  # noqa: E731
        terms = minimizers.gicp_pair_terms(flat(src), flat(src_n), res.xyz.reshape(B, N * K, 3),
                                           res.normals.reshape(B, N * K, 3), w.reshape(B, N * K),
                                           cfg.gicp_epsilon)
        A, b, resid = minimizers.gicp_system_from_sums(pair_sums(terms))
        x = minimizers.solve_normal_equations_fast(A, b)
        loc = xicp._identity_result((B,), T.device)
    else:
        A, b = normal_eq(src, res.xyz.contiguous(), res.normals.contiguous(), w)
        if frozen_loc is None and cfg.degeneracy.method == "optimized":
            if not (bool(fresh.any()) if fresh_any is None else fresh_any):
                frozen_loc = prev_loc
        x, loc = _solve(A, b, cfg, frozen_loc,
                        lambda: _analysis(A, b, src, res, w, cfg, fresh, prev_loc))
        r = _dot3(src[:, :, None, :] - res.xyz, res.normals)
        resid = torch.sqrt((w * r * r).sum((1, 2)) / torch.clamp(w.sum((1, 2)), min=1e-9))
    match_ratio = res.valid().sum((1, 2)).float() / denom
    overlap = (w > 0).sum((1, 2)).float() / denom
    return minimizers.delta_transform_from_x(x), loc, match_ratio, overlap, resid, A


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
        # Moment rounds: the next round re-verifies, on fresh weights, a
        # convergence reached on stale ones.
        revisit=torch.zeros(B, dtype=torch.bool, device=dev),
        row_sat=torch.zeros(B, device=dev),
        loc=xicp._identity_result((B,), dev),
    )


def _step(s: dict, active, T0, out, cfg: ICPConfig) -> dict:
    """``s`` advanced by one GN step's output where ``active`` [B]."""
    dT, loc, match_ratio, overlap, resid, A = out
    new = _advance(s, T0, dT, match_ratio, overlap, resid, A, cfg)
    s = {k: _where(active, new[k], v) if k in new else v for k, v in s.items()}
    s["loc"] = loc.select(active, s["loc"])
    return s


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


def _moment_system(reading: PointBatch, s: dict, res0: MatchResult, w0, cfg: ICPConfig):
    """The moment path's per-round work: the moments of the frozen pairs
    and weights (and, for GICP, the precisions at the round-start rotation)
    -> the per-iteration ``T -> (A, b, resid)``."""
    B, N, K = res0.ids.shape
    p0 = reading.xyz[:, :, None, :].expand(B, N, K, 3).reshape(B, N * K, 3)
    q = res0.xyz.reshape(B, N * K, 3).contiguous()
    n = res0.normals.reshape(B, N * K, 3).contiguous()
    w = w0.reshape(B, N * K).contiguous()
    if cfg.minimizer == "gicp":
        src_n0 = se3.apply_rotation(s["T"], reading.normals)
        src_n0 = src_n0[:, :, None, :].expand(B, N, K, 3).reshape(B, N * K, 3)
        mom = gicp_moments(p0.contiguous(), src_n0.contiguous(), q, n, w, cfg.gicp_epsilon)
        return lambda T: minimizers.gicp_system_from_moments(T, mom)
    mom = point_to_plane_moments(p0.contiguous(), q, n, w)
    return lambda T: minimizers.point_to_plane_system_from_moments(T, mom)


def _static_trips(path: str, R: int, max_iterations: int):
    """The static-trip mode's (rounds, in-round iterations of round r): as
    many as can hold an active problem. On the fused and direct paths a
    problem still active at round r has run exactly r * R iterations (done
    is final there); on the moment path at least r (each active round steps
    it once or more, and a revisit may end a round early)."""
    if path == "moment":
        return max_iterations, lambda r: min(R, max_iterations - r)
    return -(-max_iterations // R), lambda r: min(R, max_iterations - r * R)


def _run_cached_loop(reading: PointBatch, ref: ICPReference, T0: torch.Tensor, cfg: ICPConfig,
                     max_iterations: int, static_trip: bool = False) -> dict:
    """Candidate-cached GN rounds over ``[B, N]`` readings from ``T0 [B, 4, 4]``.

    ``static_trip``: run every round and iteration that could hold an active
    problem (:func:`_static_trips`), with no read of the device: the early
    exits become no-ops (a finished problem's state is frozen by the done
    masks) and the binary X-ICP detection runs in round 0, the only round
    with fresh problems. The result equals the early-exit run's bit for
    bit; a CUDA graph can capture it."""
    dev = T0.device
    B = T0.shape[0]
    R = cfg.candidate_refresh_every
    has_normals = reading.normals is not None
    path = _round_path(cfg, has_normals)
    rounds = max_iterations if _moment_eligible(cfg, has_normals) else -(-max_iterations // R)
    max_d2 = cfg.max_match_dist**2
    n_valid = torch.clamp(reading.count().float(), min=1.0)
    denom = n_valid * cfg.knn
    xyz = reading.xyz.contiguous()
    frozen = _frozen_analysis(cfg)
    optimized = cfg.degeneracy.method == "optimized"
    identity = xicp._identity_result((B,), dev)

    if static_trip:
        rounds, trips = _static_trips(path, R, max_iterations)
    else:
        trips = lambda r: R  # noqa: E731

    s = _init_state(T0, cfg)
    r = 0
    while r < rounds:
        round_active = ~s["done"] & (s["it"] < max_iterations)
        if not static_trip and not bool(round_active.any()):
            break
        src0 = se3.apply_transform(s["T"], xyz)
        res0, sat = _match_round(reading, ref, src0, cfg, n_valid)
        s["row_sat"] = torch.where(round_active, sat, s["row_sat"])
        valid0 = res0.valid()
        trim_limit = None
        if cfg.trimmed_ratio is not None and cfg.fast_trimming:
            trim_limit = trimmed_dist_limit(res0.dists, valid0, cfg.trimmed_ratio, max_d2)
        w0 = _weights(res0, cfg, trim_limit=trim_limit) if frozen or path == "moment" else None

        # The X-ICP decision frozen for the round: the binary method detects
        # in the first round of each loop (the reference detects on the
        # first iteration only) and later rounds reuse it; the ternary
        # method analyses each round on its fresh pairs.
        frozen_loc = None
        if frozen:
            fresh = round_active & (s["it"] == 0)
            frozen_loc = s["loc"]
            if not optimized or (r == 0 if static_trip else bool(fresh.any())):
                A0, b0 = normal_eq(src0, res0.xyz.contiguous(), res0.normals.contiguous(), w0)
                frozen_loc = _analysis(A0, b0, src0, res0, w0, cfg, fresh, s["loc"])

        T_round0 = s["T"]
        if path == "fused":
            if cfg.knn == 1:
                pairs = (res0.xyz[:, :, 0].contiguous(), res0.normals[:, :, 0].contiguous(),
                         valid0[:, :, 0].contiguous())
                kernel = pair_gn
            else:
                pairs = (res0.xyz.contiguous(), res0.normals.contiguous(), valid0.contiguous())
                kernel = pair_gn_k
            tau = trim_limit if trim_limit is not None else torch.full((B,), math.inf, device=dev)
            tau = tau.contiguous()

            def fused_step(T):
                A, b, sw, swr2, nok = kernel(xyz, *pairs, T, tau, max_d2)
                if frozen_loc is not None:
                    x, loc = xicp.solve_with_equality_constraints(A, b, frozen_loc), frozen_loc
                else:
                    x, loc = minimizers.solve_spd_unrolled(A, b), identity
                resid = torch.sqrt(swr2 / torch.clamp(sw, min=1e-9))
                return minimizers.delta_transform_from_x(x), loc, nok / denom, sw / denom, resid, A

            step = fused_step
        elif path == "moment":
            system = _moment_system(reading, s, res0, w0, cfg)
            frozen_mr = valid0.sum((1, 2)).float() / denom
            frozen_ov = (w0 > 0).sum((1, 2)).float() / denom

            def moment_step(T):
                A, b, resid = system(T)
                if cfg.degeneracy.method == "solution_remapping":
                    x, loc = xicp.solve_with_solution_remapping(A, b, cfg.degeneracy)
                elif frozen_loc is not None:
                    x, loc = xicp.solve_with_equality_constraints(A, b, frozen_loc), frozen_loc
                else:
                    x, loc = minimizers.solve_normal_equations_fast(A, b), identity
                return minimizers.delta_transform_from_x(x), loc, frozen_mr, frozen_ov, resid, A

            step = moment_step

            # Entering a re-verification round: prime the differential
            # checker's rings with the tolerances, so one fresh iteration
            # confirms a truly converged pose.
            prime = round_active & s["revisit"]
            s["drot"] = _where(prime, torch.full_like(s["drot"], cfg.min_diff_rot), s["drot"])
            s["dtrans"] = _where(prime, torch.full_like(s["dtrans"], cfg.min_diff_trans), s["dtrans"])
        else:

            def direct_step(T):
                src = se3.apply_transform(T, xyz)
                d = src[:, :, None, :] - res0.xyz
                d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
                invalid = ~valid0 | (d2 > max_d2)
                res = MatchResult(dists=torch.where(invalid, INF, d2),
                                  ids=torch.where(invalid, INVALID_ID, res0.ids),
                                  xyz=res0.xyz, normals=res0.normals)
                return _gn_update(reading, src, res, T, cfg, denom, trim_limit=trim_limit,
                                  frozen_loc=frozen_loc, prev_loc=identity,
                                  fresh=torch.ones(B, dtype=torch.bool, device=dev), fresh_any=True)

            step = direct_step
        i = 0
        while i < trips(r):
            active = round_active & ~s["done"] & (s["it"] < max_iterations)
            if not static_trip and not bool(active.any()):
                break
            s = _step(s, active, T0, step(s["T"]), cfg)
            i += 1
        if path == "moment":
            # Weights were frozen at the round-start pose: a round that
            # converged after moving beyond the tolerances did so on stale
            # weights, so the next round re-matches and re-verifies.
            dr = se3.rotation_angular_distance(s["T"][:, :3, :3], T_round0[:, :3, :3])
            dt = torch.linalg.vector_norm(s["T"][:, :3, 3] - T_round0[:, :3, 3], dim=-1)
            stale = (dr > cfg.moment_revisit_scale * cfg.min_diff_rot) | (
                dt > cfg.moment_revisit_scale * cfg.min_diff_trans
            )
            revisit = round_active & stale & s["converged"] & (s["it"] < max_iterations)
            s["done"] = s["done"] & ~revisit
            s["converged"] = s["converged"] & ~revisit
            s["revisit"] = revisit
        r += 1
    return s


def _run_iter_loop(reading: PointBatch, ref: ICPReference, T0: torch.Tensor, cfg: ICPConfig,
                   max_iterations: int, static_trip: bool = False) -> dict:
    """The per-iteration chain (match -> weights -> normal equations ->
    solve every iteration) over ``[B, N]`` readings from ``T0 [B, 4, 4]``.
    ``static_trip``: ``max_iterations`` iterations under the done masks, no
    read of the device (the first is the only one with fresh problems)."""
    n_valid = torch.clamp(reading.count().float(), min=1.0)
    denom = n_valid * cfg.knn
    ref_padded = ref.cloud.padded_xyz() if cfg.matcher.startswith("brute") else None

    s = _init_state(T0, cfg)
    i = 0
    while not static_trip or i < max_iterations:
        active = ~s["done"] & (s["it"] < max_iterations)
        if not static_trip and not bool(active.any()):
            break
        src = se3.apply_transform(s["T"], reading.xyz)
        res = _match(src, reading.mask, ref, cfg, ref_padded)
        out = _gn_update(reading, src, res, s["T"], cfg, denom, prev_loc=s["loc"],
                         fresh=active & (s["it"] == 0), fresh_any=(i == 0) if static_trip else None)
        s = _step(s, active, T0, out, cfg)
        i += 1
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
    readings: PointBatch, ref: ICPReference, init_T: torch.Tensor, cfg: ICPConfig,
    static_trip: bool = False,
) -> ICPResult:
    """Register ``B`` readings (``xyz [B, N, 3]``) against one reference from
    ``init_T [B, 4, 4]``. ``static_trip``: run every GN round and iteration
    that could hold an active problem, with no read of the device inside the
    loops (what a CUDA graph captures); the result is the default
    early-exit run's, bit for bit."""
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
            _strided(readings, cfg.coarse_stride), ref, T0, cfg, cfg.coarse_iterations,
            static_trip=static_trip,
        )
        T0 = cstate["T"]
        coarse_iters = cstate["it"]
    final = run_loop(readings, ref, T0, cfg, cfg.max_iterations, static_trip=static_trip)

    loc = final["loc"]
    degenerate = (loc.localizability_rot.amin(-1) < 0.5) | (loc.localizability_trans.amin(-1) < 0.5)
    # Spectral diagnostics + covariance from the final hessian, once.
    A = final["A"]
    w6, V6 = sym_eig(A)
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


def icp_single(reading: PointBatch, ref: ICPReference, init_T: torch.Tensor, cfg: ICPConfig,
               static_trip: bool = False) -> ICPResult:
    """Register one reading (``xyz [N, 3]``): :func:`icp_batch` with B = 1."""
    batch = PointBatch(
        xyz=reading.xyz[None], mask=reading.mask[None],
        extras={k: v[None] for k, v in reading.extras.items()},
    )
    res = icp_batch(batch, ref, init_T[None], cfg, static_trip=static_trip)
    return ICPResult(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def _problem(batch: PointBatch, b: int) -> PointBatch:
    return PointBatch(xyz=batch.xyz[b], mask=batch.mask[b],
                      extras={k: v[b] for k, v in batch.extras.items()})


def register_pair(reading: PointBatch, reference: PointBatch, init_T: torch.Tensor,
                  cfg: ICPConfig, static_trip: bool = False) -> ICPResult:
    """One-shot registration of a reading (``xyz [N, 3]``) against a
    reference cloud (``[M, 3]``) from ``init_T [4, 4]``: build the reference,
    then :func:`icp_single`."""
    return icp_single(reading, build_reference(reference, cfg, const_size=True), init_T, cfg,
                      static_trip=static_trip)


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

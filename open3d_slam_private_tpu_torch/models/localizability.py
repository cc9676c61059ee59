"""X-ICP degeneracy awareness: solution remapping, the binary Optimized
method, the ternary equality-constraints method and the
equality-constrained KKT solve.

Twin of ``open3d_slam_private_tpu/models/localizability.py``, batched over
a leading problem axis:

- ``solve_with_solution_remapping``: eigenvalue gating of the 6x6 system;
  directions below the threshold are projected out of the solution.
- ``analyze_optimized`` (binary): per direction of each 3x3 subspace
  (rotation, translation), localizable iff the summed alignment
  contributions reach ``enough_information_threshold`` or the strong ones
  reach ``insufficient_information_threshold``; the others are locked at 0.
- ``analyze_equality_constraints`` (ternary): localizable, partially
  localizable (a 3-DoF re-solve on the contributing pairs gives the
  constraint value) or not localizable.

Constrained directions become border rows of a 12x12 KKT system. The sums
over pairs go through ``kernels.moments.pair_sums`` and
``pair_sums_groups`` (on the card, in an order fixed by a problem's own
size; one launch for the alignment centre, one for both subspaces'
contribution sums and one for both ternary re-solves).
"""

from __future__ import annotations

import dataclasses

import torch

from open3d_slam_private_tpu_torch.kernels.moments import pair_sums, pair_sums_groups
from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig
from open3d_slam_private_tpu_torch.models.minimizers import (
    esum,
    solve_normal_equations,
    solve_symmetric_indefinite,
)
from open3d_slam_private_tpu_torch.ops.normals import eigh3x3


@dataclasses.dataclass(frozen=True)
class DegeneracyConfig:
    """Same fields and defaults as the JAX twin. ``method``: "none",
    "solution_remapping", "optimized" (binary, detected on a loop's first
    iteration) or "equality_constraints" (ternary, re-analysed every
    iteration, or once a cached round with ``analysis_per_round``)."""

    method: str = "none"
    solution_remapping_threshold: float = 150.0
    use_condition_number_threshold: bool = False
    high_information_threshold: float = 350.0
    enough_information_threshold: float = 150.0
    insufficient_information_threshold: float = 40.0
    weak_alignment_cos: float = 0.17364818  # cos(80 deg)
    strong_alignment_cos: float = 0.70710678  # cos(45 deg)
    analysis_per_round: bool = True


@dataclasses.dataclass(frozen=True)
class LocalizabilityResult:
    """Per-problem analysis, each field with the leading batch shape."""

    eigenvalues6: torch.Tensor  # [..., 6]
    condition_number: torch.Tensor  # [...]
    localizability_rot: torch.Tensor  # [..., 3] 1 = localizable
    localizability_trans: torch.Tensor  # [..., 3]
    rotation_eigenvectors: torch.Tensor  # [..., 3, 3] columns
    translation_eigenvectors: torch.Tensor  # [..., 3, 3]
    constraint_values_rot: torch.Tensor  # [..., 3]
    constraint_values_trans: torch.Tensor  # [..., 3]

    def select(self, mask: torch.Tensor, other: "LocalizabilityResult") -> "LocalizabilityResult":
        """Per problem: this result where ``mask [B]``, else ``other``."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
            out[f.name] = torch.where(m, a, b)
        return LocalizabilityResult(**out)


def _identity_result(batch_shape=(), device=None, dtype=torch.float32) -> LocalizabilityResult:
    def full(shape, v):
        return torch.full(tuple(batch_shape) + shape, v, dtype=dtype, device=device)

    eye = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
    return LocalizabilityResult(
        eigenvalues6=full((6,), 0.0),
        condition_number=full((), 1.0),
        localizability_rot=full((3,), 1.0),
        localizability_trans=full((3,), 1.0),
        rotation_eigenvectors=eye.clone(),
        translation_eigenvectors=eye.clone(),
        constraint_values_rot=full((3,), 0.0),
        constraint_values_trans=full((3,), 0.0),
    )


def solve_with_solution_remapping(A, b, cfg: DegeneracyConfig):
    """Unconstrained solve, then the directions whose eigenvalue is below
    the threshold (or the condition number) projected out -> (x [..., 6],
    LocalizabilityResult with the spectrum)."""
    w, V = sym_eig(A)
    aw = w.abs()
    cond = aw.amax(-1) / torch.clamp(aw.amin(-1), min=1e-30)
    if cfg.use_condition_number_threshold:
        thresh = cond[..., None]
    else:
        thresh = torch.full((), cfg.solution_remapping_threshold, dtype=A.dtype, device=A.device)
    keep = (w >= thresh).to(A.dtype)
    x = solve_normal_equations(A, b)
    P = esum("ik,jk->ij", V * keep[..., None, :], V)
    base = _identity_result(A.shape[:-2], A.device, A.dtype)
    return esum("ij,j->i", P, x), dataclasses.replace(base, eigenvalues6=w, condition_number=cond)


def _subspace_contributions(subspaces, point_mask, cfg: DegeneracyConfig, strict_weak: bool = False):
    """Contribution sums of each pair against the 3 eigenvector columns of
    each ``(align_vecs [..., P, 3], eigvecs [..., 3, 3])`` of ``subspaces``:
    for each, (combined [..., 3], high [..., 3], weak [..., P, 3], strong
    [..., P, 3]); every subspace's sums in one ``pair_sums_groups`` call.
    ``strict_weak``: the Optimized method gates the combined sum with a
    strict ``> weak cos`` where the ternary counter uses ``>=``."""
    terms, gates = [], []
    for align_vecs, eigvecs in subspaces:
        a = esum("pi,ik->pk", align_vecs, eigvecs).abs()
        a = torch.where(point_mask[..., None], a, 0.0)
        strong = a > cfg.strong_alignment_cos
        weak = a > cfg.weak_alignment_cos if strict_weak else a >= cfg.weak_alignment_cos
        terms += [torch.where(strong, a, 0.0), torch.where(weak, a, 0.0)]
        gates.append((weak, strong))
    sums = pair_sums_groups(*terms)
    return [(sums[2 * i + 1], sums[2 * i], weak, strong) for i, (weak, strong) in enumerate(gates)]


def _alignment_geometry(A, src_xyz, matched_normals, pair_mask):
    """Both detection families' setup: the 3x3 subspaces' eigenvectors
    (rotation, translation) and the per-pair rotation alignment vectors
    ``cross(p - center, n)``, normalised only where their norm is >= 1."""
    _, rot_V = eigh3x3(A[..., :3, :3])
    _, tr_V = eigh3x3(A[..., 3:, 3:])
    count = torch.clamp(pair_mask.sum(-1).to(A.dtype), min=1.0)
    center = pair_sums(torch.where(pair_mask[..., None], src_xyz, 0.0)) / count[..., None]
    crosses = torch.linalg.cross(src_xyz - center[..., None, :], matched_normals)
    cnorm = torch.linalg.vector_norm(crosses, dim=-1, keepdim=True)
    crosses = torch.where(cnorm >= 1.0, crosses / torch.clamp(cnorm, min=1e-30), crosses)
    return rot_V, tr_V, crosses


def analyze_optimized(A, b, src_xyz, matched_normals, pair_mask, cfg: DegeneracyConfig):
    """Binary localizability detection (kOptimizedEqualityConstraints) for
    ``A [..., 6, 6]``, pairs ``src_xyz / matched_normals [..., P, 3]`` and
    ``pair_mask [..., P]``."""
    rot_V, tr_V, crosses = _alignment_geometry(A, src_xyz, matched_normals, pair_mask)
    (comb_r, high_r, _, _), (comb_t, high_t, _, _) = _subspace_contributions(
        ((crosses, rot_V), (matched_normals, tr_V)), pair_mask, cfg, strict_weak=True)

    def localizable(comb, high):
        return (comb >= cfg.enough_information_threshold) | (
            high >= cfg.insufficient_information_threshold
        )

    base = _identity_result(A.shape[:-2], A.device, A.dtype)
    return dataclasses.replace(
        base,
        localizability_rot=localizable(comb_r, high_r).to(A.dtype),
        localizability_trans=localizable(comb_t, high_t).to(A.dtype),
        rotation_eigenvectors=rot_V,
        translation_eigenvectors=tr_V,
    )


def _constraint_terms(sel_w, basis, deltas_dot_n):
    """The per-pair terms of the 3-DoF re-solve on each direction's selected
    pairs: ``sel_w [..., P, 3]`` (0/1 per direction) -> ``[..., P, 36]``
    (per direction, the 9 entries of its A and the 3 of its b)."""
    sb = sel_w[..., :, :, None] * basis[..., :, None, :]  # [..., P, dir, i]
    a3 = sb[..., :, None] * basis[..., None, None, :]  # [..., P, dir, i, j]
    b3 = -(sb * deltas_dot_n[..., None, None])
    lead = sel_w.shape[:-1]
    return torch.cat([a3.reshape(lead + (3, 9)), b3], -1).reshape(lead + (36,))


def _constraint_values(sums, eigvecs):
    """The re-solves of :func:`_constraint_terms`' sums ``[..., 36]``,
    projected on each direction -> ``[..., 3]``."""
    sums = sums.reshape(sums.shape[:-1] + (3, 12))
    A3 = sums[..., :9].reshape(sums.shape[:-1] + (3, 3))
    x3 = solve_normal_equations(A3, sums[..., 9:])  # [..., dir, 3]
    return esum("ik,ki->k", eigvecs, x3)


def analyze_equality_constraints(A, b, src_xyz, matched_normals, deltas_dot_n, pair_mask,
                                 cfg: DegeneracyConfig):
    """Ternary localizability detection (kEqualityConstraints) for
    ``A [..., 6, 6]``, pairs ``src_xyz / matched_normals [..., P, 3]``, their
    ``(p - q) . n`` residuals ``deltas_dot_n [..., P]`` and ``pair_mask``.
    Per direction: localizable (``combined >= high`` threshold or
    ``high >= enough``), else mixed (``combined >= enough``: the weakly
    contributing pairs re-solve), else high-partial (``high >=
    insufficient``: the strongly contributing pairs re-solve), else locked
    at 0."""
    rot_V, tr_V, crosses = _alignment_geometry(A, src_xyz, matched_normals, pair_mask)
    (comb_r, high_r, weak_r, strong_r), (comb_t, high_t, weak_t, strong_t) = _subspace_contributions(
        ((crosses, rot_V), (matched_normals, tr_V)), pair_mask, cfg)

    def categorize(comb, high):
        loc = (comb >= cfg.high_information_threshold) | (high >= cfg.enough_information_threshold)
        mixed = ~loc & (comb >= cfg.enough_information_threshold)
        high_part = ~loc & ~mixed & (high >= cfg.insufficient_information_threshold)
        return loc, mixed, high_part

    def selection(mixed, high_part, weak, strong):
        sel = torch.where(mixed[..., None, :], weak.to(A.dtype),
                          torch.where(high_part[..., None, :], strong.to(A.dtype), 0.0))
        return sel * pair_mask[..., None].to(A.dtype)

    loc_r, mix_r, hi_r = categorize(comb_r, high_r)
    loc_t, mix_t, hi_t = categorize(comb_t, high_t)
    sums_r, sums_t = pair_sums_groups(
        _constraint_terms(selection(mix_r, hi_r, weak_r, strong_r), crosses, deltas_dot_n),
        _constraint_terms(selection(mix_t, hi_t, weak_t, strong_t), matched_normals, deltas_dot_n))
    cons_r, cons_t = _constraint_values(sums_r, rot_V), _constraint_values(sums_t, tr_V)
    base = _identity_result(A.shape[:-2], A.device, A.dtype)
    return dataclasses.replace(
        base,
        localizability_rot=loc_r.to(A.dtype),
        localizability_trans=loc_t.to(A.dtype),
        rotation_eigenvectors=rot_V,
        translation_eigenvectors=tr_V,
        constraint_values_rot=torch.where(mix_r | hi_r, cons_r, 0.0),
        constraint_values_trans=torch.where(mix_t | hi_t, cons_t, 0.0),
    )


def solve_with_equality_constraints(A, b, loc: LocalizabilityResult):
    """KKT solve ``[..., 12, 12]`` with ``v^T x = c`` rows for the
    constrained directions (rows of unconstrained ones are zero and stay
    inert under the min-norm pseudo-solve)."""
    con_rot = 1.0 - loc.localizability_rot
    con_tr = 1.0 - loc.localizability_trans
    lead = A.shape[:-2]
    C = A.new_zeros(lead + (6, 6))
    C[..., :3, :3] = (loc.rotation_eigenvectors * con_rot[..., None, :]).transpose(-1, -2)
    C[..., 3:, 3:] = (loc.translation_eigenvectors * con_tr[..., None, :]).transpose(-1, -2)
    d = torch.cat([loc.constraint_values_rot * con_rot, loc.constraint_values_trans * con_tr], -1)
    M = A.new_zeros(lead + (12, 12))
    M[..., :6, :6] = A
    M[..., :6, 6:] = C.transpose(-1, -2)
    M[..., 6:, :6] = C
    return solve_symmetric_indefinite(M, torch.cat([b, d], -1))[..., :6]

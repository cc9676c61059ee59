"""The yardstick of the kernels: the card's published peaks and the bytes
and operations each hand-written kernel of the port needs for a call, from
the shapes of the call's arguments (copied from ``chip_smoke.py``'s cost
arithmetic, so that a later change to the program cannot move it).

A call's bound is the larger of its bytes over the memory rate and its
operations over the compute rate of their type: each input byte read once,
each output byte written once, and only the operations the inputs need."""

from __future__ import annotations

import math
import re

# One H100 SXM (NVIDIA data sheet, dense rates, at its 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_FP64_FLOP_PER_S = 34e12

# Operations per pair of K1/K3: the transform (18), difference and squared
# distance (8), residual (5), cross product (9), the weighted columns (6),
# the 21 + 6 products of A and b, w r^2 (2) and the 31 sums.
PAIR_GN_FLOPS = 106
# Per pair of normal_eq: the difference (3) and residual (5), the cross
# product (9), the weighted columns (6), the 21 + 6 products and sums (54).
NORMAL_EQ_FLOPS = 77
# Per pair of the moments: a product and a sum for each of the 131
# (point-to-plane) or 147 (GICP) sums, and their shared factors.
MOMENTS_P2PL_FLOPS = 2 * 131 + 36
MOMENTS_GICP_FLOPS = 2 * 147 + 86
# Per candidate pair of K5: the dot product's 3 products and 2 sums, the
# -2 scaling and 2 sums.
D2_FLOPS = 8

# Each family's __global__ functions (their names as the profiler shows
# them, before any template arguments).
DEVICE_KERNELS = {
    "pair_gn": ("pair_gn_fused", "pair_gn_final"),
    "pair_gn_k": ("pair_gn_k_partial", "pair_gn_k_final"),
    "normal_eq": ("normal_eq_partial", "normal_eq_final"),
    "moments": ("moments_raw", "moments_raw_final", "moments_partial", "moments_final"),
    "sym_eig": ("sym_eig_kernel",),
    "knn_brute": ("knn_brute_pack", "knn_brute_kernel", "knn_brute_merge"),
    "gather_select": ("gather_select_count", "gather_select_scan", "gather_select_scatter",
                      "gather_select_rank"),
    "rank_select": ("rank_select_kernel",),
}


def kernel_family(name: str):
    """The family of a device event's name (``void f<...>(...)`` or ``f``),
    or None for a kernel that is not the port's own."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    base = re.split(r"[<(]", s, maxsplit=1)[0].strip().split("::")[-1]
    for fam, names in DEVICE_KERNELS.items():
        if base in names:
            return fam
    return None


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOP_PER_S) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def pair_gn(reading, pair_xyz, *rest) -> float:
    """K1 (``pair_xyz [B, N, 3]``) or K3 (``[B, N, K, 3]``): each point's
    reading, each pair's xyz, normal and valid byte read once, T and tau in,
    31 sums out."""
    N = int(reading.shape[-2])
    B = _numel(reading.shape[:-2])
    K = int(pair_xyz.shape[-2]) if pair_xyz.dim() == reading.dim() + 1 else 1
    nbytes = B * N * 12 + B * N * K * 25 + B * (64 + 4) + B * 31 * 4
    return bound_s(nbytes, B * N * K * PAIR_GN_FLOPS)


def normal_eq(src_xyz, ref_xyz, ref_normals, weights) -> float:
    B, N, K = (int(s) for s in weights.shape)
    nbytes = B * N * 12 + B * N * K * (12 + 12 + 4) + B * 42 * 4
    return bound_s(nbytes, B * N * K * NORMAL_EQ_FLOPS)


def point_to_plane_moments(p0, q, ref_normals, weights) -> float:
    B, P = (int(s) for s in weights.shape)
    return bound_s(B * P * (3 * 12 + 4) + B * 131 * 4, B * P * MOMENTS_P2PL_FLOPS)


def gicp_moments(p0, src_normals0, q, ref_normals, weights, *rest, **kw) -> float:
    B, P = (int(s) for s in weights.shape)
    return bound_s(B * P * (4 * 12 + 4) + B * 147 * 4, B * P * MOMENTS_GICP_FLOPS)


def pair_sums_groups(*terms) -> float:
    """Each term read once, one add per term, the sums written."""
    n = sum(_numel(t.shape) for t in terms)
    out = sum(_numel(t.shape[:-2]) * int(t.shape[-1]) for t in terms)
    return bound_s(4 * (n + out), n)


def sym_eig(A, *rest, **kw) -> float:
    """The matrices read and the values and vectors written; at least one
    Jacobi sweep: n (n - 1) / 2 rotations of ~15 operations for (c, s) and
    6 n for each of A's rows, A's columns and V's columns."""
    n = int(A.shape[-1])
    M = _numel(A.shape[:-2])
    b = A.element_size()
    flops = M * n * (n - 1) // 2 * (18 * n + 15)
    peak = PEAK_FP64_FLOP_PER_S if b == 8 else PEAK_FP32_FLOP_PER_S
    return bound_s(M * (2 * n * n + n) * b, flops, peak)


def knn_brute(query, ref) -> float:
    Q, M = int(query.shape[0]), int(ref.shape[0])
    return bound_s(Q * 12 + M * 12 + Q * 8, Q * M * D2_FLOPS)


# wrapper module (under the port's ``kernels``) -> {function: its cost}
WRAPPERS = {
    "pair_gn": {"pair_gn": pair_gn, "pair_gn_k": pair_gn},
    "normal_eq": {"normal_eq": normal_eq},
    "moments": {"point_to_plane_moments": point_to_plane_moments, "gicp_moments": gicp_moments,
                "pair_sums_groups": pair_sums_groups},
    "sym_eig": {"sym_eig": sym_eig},
    "knn_brute": {"knn_brute": knn_brute},
}

"""Normal equations, round-frozen moments and the small dense solves.

Twin of the pieces of ``open3d_slam_private_tpu/models/minimizers.py`` that
the ported chains run: point-to-plane and GICP normal equations, the
moment algebra of the cached rounds (``point_to_plane_moments`` /
``gicp_moments`` once a round, ``*_system_from_moments`` each iteration),
and the 6x6 solves. Every function takes leading batch dimensions.

The per-iteration algebra on small tensors (:func:`esum`) is elementwise
products and sums unrolled in a fixed order: no library call picks an
algorithm from the batch's shape, so a problem's bits do not depend on the
batch it runs in. The sums over pairs are the callers' (on the card, the
``moments`` kernel); the plain functions here sum with PyTorch.
"""

from __future__ import annotations

import math

import torch

from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.kernels.sym_eig import sym_eig


def point_to_plane_normal_equations_bc(src_xyz, ref_xyz, ref_normals, weights):
    """``src_xyz [..., N, 3]`` against matched ``ref_xyz / ref_normals
    [..., N, M, 3]`` with ``weights [..., N, M]`` -> ``(A [..., 6, 6],
    b [..., 6])`` with J = [p x n, n] and r = (p - q) . n."""
    p = src_xyz[..., None, :].expand_as(ref_normals)
    n = ref_normals
    cross = torch.linalg.cross(p, n)
    r = ((p - ref_xyz) * n).sum(-1)
    cols = torch.cat([cross, n], dim=-1)  # [..., N, M, 6]
    cols_w = cols * weights[..., None]
    A = torch.einsum("...nmi,...nmj->...ij", cols_w, cols)
    b = -torch.einsum("...nmi,...nm->...i", cols_w, r)
    return A, b


def solve_spd_unrolled(A: torch.Tensor, b: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """Damped Cholesky solve of small symmetric PSD systems ``[..., n, n]``,
    unrolled; trace-scaled Tikhonov keeps near-singular systems tame."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
    lam = damping * torch.clamp(tr, min=1e-12)
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    for i in range(n):
        a[i][i] = a[i][i] + lam
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve_normal_equations_fast(A: torch.Tensor, b: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """In-loop fast path: see :func:`solve_spd_unrolled`."""
    return solve_spd_unrolled(A, b, damping)


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor, rcond: float = 1e-7) -> torch.Tensor:
    """Minimum-norm solve of symmetric ``A x = b`` through eigh (``sym_eig``:
    a matrix's bits independent of its batch, and on the card no host read):
    eigenvalues below ``rcond * max |eig|`` are
    treated as zero."""
    w, V = sym_eig(A)
    aw = w.abs()
    cutoff = rcond * aw.amax(-1, keepdim=True)
    inv_w = torch.where(aw > cutoff, 1.0 / w, 0.0)
    return esum("ij,j->i", V, inv_w * esum("ji,j->i", V, b))


def solve_symmetric_indefinite(M: torch.Tensor, rhs: torch.Tensor, rcond: float = 1e-7) -> torch.Tensor:
    """Min-norm pseudo-solve of a symmetric indefinite (KKT) system, in
    float64. A locked direction that the normal equations constrain well
    (curvature a) gives the KKT matrix an eigenvalue near ``-1 / a``, of the
    cutoff's order, and float32 rounding of that order decides whether it
    survives: in float64 the solve is the exact one that the JAX twin's
    float32 solve approximates."""
    return solve_normal_equations(M.double(), rhs.double(), rcond).to(M.dtype)


def delta_transform_from_x(x: torch.Tensor) -> torch.Tensor:
    """Solved 6-DoF increment -> SE(3), with the atan axis-angle rotation."""
    return se3.rigid_from_axis_angle_atan(x)


# ---------------------------------------------------------------------------
# Small fixed-order contractions.
# ---------------------------------------------------------------------------


def esum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, ...)`` over small trailing axes, as broadcast
    products (left to right) and unrolled sums over each contracted label
    in turn: elementwise launches only, in an order fixed by the spec.
    Operands carry any leading batch axes before their labelled ones; a
    label repeated within one operand takes its diagonal."""
    ins, out = spec.split("->")
    ins = ins.split(",")
    contracted = [c for c in dict.fromkeys("".join(ins)) if c not in out]
    full = list(out) + contracted
    prod = None
    for op, lab in zip(ops, ins):
        lead = op.dim() - len(lab)
        lab = list(lab)
        for c in dict.fromkeys(lab):
            while lab.count(c) > 1:  # diagonal: drop both axes, append one
                i = lab.index(c)
                j = lab.index(c, i + 1)
                op = torch.diagonal(op, dim1=lead + i, dim2=lead + j)
                lab = [x for k, x in enumerate(lab) if k not in (i, j)] + [c]
        perm = [lab.index(c) for c in full if c in lab]
        x = op.permute(*range(lead), *[lead + k for k in perm])
        shape = list(op.shape[:lead]) + [op.shape[lead + lab.index(c)] if c in lab else 1 for c in full]
        x = x.reshape(shape)
        prod = x if prod is None else prod * x
    for _ in contracted:
        parts = prod.unbind(-1)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        prod = acc
    return prod


def _gen(like: torch.Tensor) -> torch.Tensor:
    """The skew map's generators ``[3, 3, 3]``: ``[p]_x = sum_d p_d G[d]``,
    made on the device (no host-to-device copy), zeros positive."""
    G = _hat(torch.eye(3, dtype=like.dtype, device=like.device))
    return torch.where(G != 0, G, torch.zeros_like(G))


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew matrices ``[..., 3] -> [..., 3, 3]``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
         torch.stack([-y, x, zero], -1)],
        dim=-2,
    )


def _inv3x3(S: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse ``[..., 3, 3]`` (adjugate over determinant;
    a determinant of magnitude 1e-20 or less divides by 1)."""
    a, b_, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b_ * B_ + c * C_
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1.0)
    adj = torch.stack(
        [
            torch.stack([A_, -(b_ * i - c * h), b_ * f - c * e], -1),
            torch.stack([B_, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C_, -(a * h - b_ * g), a * e - b_ * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _blocks(A_oo, A_ot, A_tt):
    """The 6x6 ``[[A_oo, A_ot], [A_ot^T, A_tt]]``."""
    top = torch.cat([A_oo, A_ot], -1)
    return torch.cat([top, torch.cat([A_ot.transpose(-1, -2), A_tt], -1)], -2)


def _gicp_precision(src_normals, ref_normals, epsilon: float):
    """GICP's per-pair ``M = (2 I - k (n_q n_q^T + n_p n_p^T))^-1``, k = 1 - eps."""
    k = 1.0 - epsilon
    eye = torch.eye(3, dtype=ref_normals.dtype, device=ref_normals.device)
    S = 2.0 * eye - k * (ref_normals[..., :, None] * ref_normals[..., None, :]
                         + src_normals[..., :, None] * src_normals[..., None, :])
    return _inv3x3(S)


# ---------------------------------------------------------------------------
# GICP, per iteration.
# ---------------------------------------------------------------------------

GICP_TERMS = 35  # A_oo 9, A_ot 9, A_tt 9, b 6, w |r|^2, w


def gicp_pair_terms(src_xyz, src_normals, ref_xyz, ref_normals, weights, epsilon: float = 1e-3):
    """Per-pair ``[..., P, 35]`` terms of the GICP normal equations (the
    JAX twin's ``gicp_normal_equations`` before its sums over pairs), with
    ``w |p - q|^2`` and ``w`` for the residual readout: elementwise
    arithmetic only. ``src_normals`` are the rotated reading normals."""
    M = _gicp_precision(src_normals, ref_normals, epsilon)
    r = src_xyz - ref_xyz
    nPx = -_hat(src_xyz)
    w = weights[..., None, None]
    MP = esum("ij,jk->ik", M, nPx)
    A_oo = esum("ji,jk->ik", nPx * w, MP)
    A_ot = esum("ji,jk->ik", nPx * w, M)
    A_tt = M * w
    Mr = esum("ij,j->i", M, r) * weights[..., None]
    b_o = -esum("ji,j->i", nPx, Mr)
    b_t = -Mr
    rr = (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) + r[..., 2] * r[..., 2]
    lead = A_oo.shape[:-2]
    return torch.cat([A_oo.reshape(lead + (9,)), A_ot.reshape(lead + (9,)), A_tt.reshape(lead + (9,)),
                      b_o, b_t, (weights * rr)[..., None], weights[..., None]], -1)


def gicp_system_from_sums(sums):
    """``[..., 35]`` pair sums of :func:`gicp_pair_terms` -> ``(A, b,
    resid)`` with ``resid`` the weighted RMS of ``|p - q|``."""
    lead = sums.shape[:-1]
    A = _blocks(sums[..., 0:9].reshape(lead + (3, 3)), sums[..., 9:18].reshape(lead + (3, 3)),
                sums[..., 18:27].reshape(lead + (3, 3)))
    resid = torch.sqrt(sums[..., 33] / torch.clamp(sums[..., 34], min=1e-9))
    return A, sums[..., 27:33], resid


def gicp_normal_equations(src_xyz, src_normals, ref_xyz, ref_normals, weights, epsilon: float = 1e-3):
    """Generalized-ICP (plane-to-plane) normal equations ``(A [..., 6, 6],
    b [..., 6])`` over pairs ``[..., P, 3]``: residual ``p - q`` weighted by
    ``M = (C_q + C_p)^-1`` with disk covariances ``C = I - (1 - eps) n n^T``;
    the sums over pairs in PyTorch."""
    terms = gicp_pair_terms(src_xyz, src_normals, ref_xyz, ref_normals, weights, epsilon)
    A, b, _ = gicp_system_from_sums(terms.sum(-2))
    return A, b


# ---------------------------------------------------------------------------
# Round-frozen moments.
# ---------------------------------------------------------------------------

# The moments' flat layout ``[..., S]`` (the ``moments`` kernel's output
# row): name, shape, in order.
P2PL_LAYOUT = (("N2", (3, 3, 3, 3)), ("N1", (3, 3, 3)), ("N0", (3, 3)), ("Q1", (3, 3)),
               ("Q0", (3,)), ("Q2", ()), ("n0", ()))
GICP_LAYOUT = (("S0", (3, 3)), ("S1", (3, 3, 3)), ("S2", (3, 3, 3, 3)), ("Y0", (3,)),
               ("Y1", (3, 3)), ("n0", ()), ("n1", (3,)), ("nq", (3,)), ("npp", ()), ("nqq", ()),
               ("C", (3, 3)))


def layout_size(layout) -> int:
    return sum(math.prod(shape) for _, shape in layout)


def pack_moments(mom: dict, layout) -> torch.Tensor:
    """Moments dict -> the flat ``[..., S]`` row."""
    lead = mom["n0"].shape
    return torch.cat([mom[name].reshape(lead + (math.prod(shape),)) for name, shape in layout], -1)


def unpack_moments(flat: torch.Tensor, layout) -> dict:
    """The flat ``[..., S]`` row -> moments dict (views)."""
    out, at = {}, 0
    lead = flat.shape[:-1]
    for name, shape in layout:
        size = math.prod(shape)
        out[name] = flat[..., at:at + size].reshape(lead + shape)
        at += size
    return out


def point_to_plane_moments(p0, q, ref_normals, weights) -> dict:
    """Round-frozen sufficient statistics of the point-to-plane system over
    pairs ``[..., P]`` (131 sums): with pairs, weights and normals frozen
    for a round, ``A(T)`` and ``b(T)`` are at most quadratic in
    ``p = R p0 + t``. ``p0``: reading points in the reading frame; ``q``,
    ``ref_normals``: matched reference points and normals; ``weights``.
    The JAX twin's einsums (the ``moments`` kernel's plain version)."""
    n, w = ref_normals, weights
    s = (n * q).sum(-1)
    ws = w * s
    return dict(
        N2=torch.einsum("...p,...pf,...pg,...pc,...ph->...fgch", w, p0, p0, n, n),
        N1=torch.einsum("...p,...pf,...pc,...ph->...fch", w, p0, n, n),
        N0=torch.einsum("...p,...pc,...ph->...ch", w, n, n),
        Q1=torch.einsum("...p,...pf,...pc->...fc", ws, p0, n),
        Q0=torch.einsum("...p,...pc->...c", ws, n),
        Q2=(ws * s).sum(-1),
        n0=w.sum(-1),
    )


def point_to_plane_system_from_moments(T, mom: dict):
    """Exact point-to-plane ``(A, b, resid)`` at poses ``T [..., 4, 4]``
    from round-frozen moments, with ``J = [p x n, n]`` and ``resid`` the
    weighted RMS of ``n . (p - q)``."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    G = _gen(R)
    N2, N1, N0 = mom["N2"], mom["N1"], mom["N0"]
    RN1 = esum("df,fch->dch", R, N1)
    M1 = RN1 + t[..., :, None, None] * N0[..., None, :, :]
    RRN2 = esum("df,eg,fgch->dech", R, R, N2)
    td = t[..., :, None, None, None]
    te = t[..., None, :, None, None]
    M2 = (RRN2 + td * RN1[..., None, :, :, :] + te * RN1[..., :, None, :, :]
          + (t[..., :, None] * t[..., None, :])[..., None, None] * N0[..., None, None, :, :])
    Q1p = esum("df,fc->dc", R, mom["Q1"]) + t[..., :, None] * mom["Q0"][..., None, :]

    A_ot = esum("dac,dcb->ab", G, M1)
    A_oo = esum("dac,ebh,dech->ab", G, G, M2)
    A = _blocks(A_oo, A_ot, N0)
    vec_np = esum("dac,dece->a", G, M2)
    vec_s = esum("dac,dc->a", G, Q1p)
    b = torch.cat([-(vec_np - vec_s), -(esum("eae->a", M1) - mom["Q0"])], -1)
    n0 = torch.clamp(mom["n0"], min=1e-9)
    snp2 = esum("eheh->", M2)
    ssnp = esum("ee->", Q1p)
    resid = torch.sqrt(torch.clamp(snp2 - 2.0 * ssnp + mom["Q2"], min=0.0) / n0)
    return A, b, resid


def gicp_moments(p0, src_normals0, q, ref_normals, weights, epsilon: float = 1e-3) -> dict:
    """Round-frozen sufficient statistics of the GICP system over pairs
    ``[..., P]`` (147 sums), with the per-pair precision ``M`` frozen at the
    round-start rotation (``src_normals0``: reading normals rotated by the
    round-start pose) and absorbed with the weight. The JAX twin's einsums
    (the ``moments`` kernel's plain version)."""
    M = _gicp_precision(src_normals0, ref_normals, epsilon) * weights[..., None, None]
    return gicp_moments_from_precision(p0, q, M, weights)


def gicp_moments_from_precision(p0, q, M, weights) -> dict:
    """:func:`gicp_moments` given the weighted precisions ``M [..., P, 3, 3]``."""
    w = weights
    Mq = torch.einsum("...pij,...pj->...pi", M, q)
    return dict(
        S0=M.sum(-3),
        S1=torch.einsum("...pd,...pab->...dab", p0, M),
        S2=torch.einsum("...pd,...pe,...pab->...deab", p0, p0, M),
        Y0=Mq.sum(-2),
        Y1=torch.einsum("...pd,...pa->...da", p0, Mq),
        n0=w.sum(-1),
        n1=torch.einsum("...p,...pa->...a", w, p0),
        nq=torch.einsum("...p,...pa->...a", w, q),
        npp=(w * (p0 * p0).sum(-1)).sum(-1),
        nqq=(w * (q * q).sum(-1)).sum(-1),
        C=torch.einsum("...p,...pa,...pb->...ab", w, q, p0),
    )


def gicp_system_from_moments(T, mom: dict):
    """Exact GICP ``(A, b, resid)`` at poses ``T [..., 4, 4]`` from
    round-frozen moments; ``resid`` is the weighted RMS of ``|p - q|``."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    G = _gen(R)
    S0, S1, S2, Y0, Y1 = mom["S0"], mom["S1"], mom["S2"], mom["Y0"], mom["Y1"]
    RS1 = esum("de,eab->dab", R, S1)
    W1 = RS1 + t[..., :, None, None] * S0[..., None, :, :]
    RRS2 = esum("df,eg,fgab->deab", R, R, S2)
    td = t[..., :, None, None, None]
    te = t[..., None, :, None, None]
    W2 = (RRS2 + td * RS1[..., None, :, :, :] + te * RS1[..., :, None, :, :]
          + (t[..., :, None] * t[..., None, :])[..., None, None] * S0[..., None, None, :, :])
    Z1 = esum("de,ea->da", R, Y1) + t[..., :, None] * Y0[..., None, :]

    A_ot = esum("dij,djk->ik", G, W1)
    A_oo = -esum("dij,dejk,ekl->il", G, W2, G)
    A = _blocks(A_oo, A_ot, S0)
    u = esum("bab->a", W1)
    v2 = esum("dbab->da", W2)
    b = torch.cat([-esum("dij,dj->i", G, v2 - Z1), -(u - Y0)], -1)

    n0 = torch.clamp(mom["n0"], min=1e-9)
    Rn1 = esum("ab,b->a", R, mom["n1"])
    spp = mom["npp"] + 2.0 * esum("a,a->", t, Rn1) + n0 * esum("a,a->", t, t)
    spq = esum("ab,ab->", mom["C"], R) + esum("a,a->", t, mom["nq"])
    r2 = spp - 2.0 * spq + mom["nqq"]
    resid = torch.sqrt(torch.clamp(r2, min=0.0) / n0)
    return A, b, resid

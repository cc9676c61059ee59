"""SE(3)/SO(3) math, batched over any leading dimensions.

Twin of ``open3d_slam_private_tpu/geometry/se3.py``: the same formulas, the
same Taylor guards at theta -> 0, the same quaternion route for the log map.

Conventions
-----------
- Homogeneous transforms are ``[..., 4, 4]`` float32, acting on column points.
- Twists are ``[..., 6]`` = ``[omega(3), v(3)]`` (rotation first), the 6-DoF
  solve layout of the point-to-plane minimizer.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat_so3(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``[..., 3]`` -> ``[..., 3, 3]``."""
    wx, wy, wz = omega.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, ``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat_so3(omega)
    return _eye3(omega) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w, x, y, z),
    w >= 0, by branch-free Shepperd selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., which, 4]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> axis-angle ``[..., 3]`` (quaternion route,
    stable near pi)."""
    q = quat_from_matrix(R)
    w = q[..., 0]
    xyz = q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(
        n < 1e-8, 2.0 / torch.clamp(w, min=1e-8), theta / torch.clamp(n, min=1e-12)
    )
    return xyz * scale[..., None]


def _v_matrix(omega: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3)."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    K = hat_so3(omega)
    return _eye3(omega) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def _v_matrix_inverse(omega: torch.Tensor) -> torch.Tensor:
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-12))
        / torch.clamp(theta2, min=_EPS),
    )
    K = hat_so3(omega)
    return _eye3(omega) - 0.5 * K + cot[..., None, None] * (K @ K)


def _rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def exp_se3(twist: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` = [omega, v] -> transform ``[..., 4, 4]``."""
    omega, v = twist[..., :3], twist[..., 3:]
    t = (_v_matrix(omega) @ v[..., None])[..., 0]
    return _rt_to_matrix(exp_so3(omega), t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """Transform ``[..., 4, 4]`` -> twist ``[..., 6]`` = [omega, v]."""
    omega = log_so3(T[..., :3, :3])
    v = (_v_matrix_inverse(omega) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([omega, v], dim=-1)


def rigid_from_axis_angle_atan(x: torch.Tensor) -> torch.Tensor:
    """SE(3) from a solved 6-vector with the point-to-plane minimizer's
    ``angle = atan(||omega||)`` rotation reconstruction."""
    omega, t = x[..., :3], x[..., 3:6]
    n = torch.linalg.vector_norm(omega, dim=-1)
    angle = torch.atan(n)
    axis = omega / torch.clamp(n, min=1e-12)[..., None]
    R = exp_so3(axis * angle[..., None])
    R = torch.where((n < 1e-12)[..., None, None], _eye3(x), R)
    return _rt_to_matrix(R, t)


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` to ``[..., N, 3]`` points (elementwise float32
    arithmetic, in the JAX twin's order)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = [
        R[..., None, i, 0] * x + R[..., None, i, 1] * y + R[..., None, i, 2] * z
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1) + t[..., None, :]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once to float32, as a fused
    multiply-add rounds it (the product is exact in float64): how XLA's CPU
    code generator contracts a multiply that feeds an add."""
    return (a.double() * b.double() + c.double()).float()


def apply_transform_fma(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """:func:`apply_transform` in the rounding XLA's CPU backend gives the
    JAX twin's submap insertion: each row ``fma(R_i2, z, fma(R_i0, x,
    R_i1 y)) + t_i``."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = [
        fma32(R[..., None, i, 2].expand_as(z), z, fma32(R[..., None, i, 0].expand_as(x), x, R[..., None, i, 1] * y))
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1) + t[..., None, :]


def apply_rotation(T: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """Rotate ``[..., N, 3]`` direction vectors by ``[..., 4, 4]``."""
    R = T[..., :3, :3]
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    rows = [
        R[..., None, i, 0] * x + R[..., None, i, 1] * y + R[..., None, i, 2] * z
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1)


def transform_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_matrix(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def quat_angular_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between unit quaternions (Eigen ``angularDistance``)."""
    dot = torch.abs((q1 * q2).sum(-1))
    return 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))


def rotation_angular_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle of R1^T R2, through quaternions as the differential checker does."""
    return quat_angular_distance(quat_from_matrix(R1), quat_from_matrix(R2))

"""Rigid motions in plain PyTorch: the exponential and logarithm of SE(3)
with twists ordered (omega, v), batched over leading axes."""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> the skew matrices ``[..., 3, 3]``."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def exp(twist: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` (omega, v) -> ``[..., 4, 4]``: Rodrigues' rotation and
    the left Jacobian applied to v, in half-angle forms (series below
    1e-2 rad), which keep their digits in float32."""
    w, v = twist[..., :3], twist[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th < 1e-2
    ths = torch.where(small, torch.ones_like(th), th)
    half = torch.sin(ths / 2) / ths
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, 2.0 * half * half)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - torch.sin(ths)) / (ths * ths * ths))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    T = torch.zeros(twist.shape[:-1] + (4, 4), dtype=twist.dtype, device=twist.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def log(T: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` -> ``[..., 6]`` (omega, v), for rotations below pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1.0) / 2.0
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1) / 2.0
    sin = torch.linalg.vector_norm(skew, dim=-1)
    th = torch.atan2(sin, torch.clamp(cos, -1.0, 1.0))
    small = th < 1e-2
    ths = torch.where(small, torch.ones_like(th), th)
    sins = torch.where(small, torch.ones_like(sin), sin)
    scale = torch.where(small, 1.0 + th * th / 6.0, ths / sins)
    w = skew * scale[..., None]
    # V^-1 = I - W / 2 + d W^2, d = (1 - (th / 2) cot(th / 2)) / th^2
    h = ths / 2
    d = torch.where(small, 1.0 / 12.0 + th * th / 720.0, (1.0 - h * torch.cos(h) / torch.sin(h)) / (ths * ths))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + d[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    Rt = R.transpose(-1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``T [4, 4]`` on points ``x [N, 3]``."""
    return x @ T[:3, :3].transpose(0, 1) + T[:3, 3]


def gap(A: torch.Tensor, B: torch.Tensor) -> tuple:
    """Translation (m) and rotation (rad) between two poses, in float64."""
    A, B = A.double(), B.double()
    d = inverse(A) @ B
    cos = ((d[0, 0] + d[1, 1] + d[2, 2]) - 1.0) / 2.0
    skew = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]]) / 2.0
    ang = torch.atan2(torch.linalg.vector_norm(skew), torch.clamp(cos, -1.0, 1.0))
    return float(torch.linalg.vector_norm(A[:3, 3] - B[:3, 3])), float(ang)

"""A plain pose-graph solve: Gauss-Newton on the relative-pose residuals
``log(T_ij^-1 T_i^-1 T_j)`` (each node perturbed on the right), their
Jacobians by central differences, a Huber weight on loop edges, node 0 held
by a strong prior, each step halved until it lowers the cost, run to
convergence. In the dtype of ``poses`` (the 6K x 6K solve lifted to
float64)."""

from __future__ import annotations

import torch

from reference import se3

_EPS = {torch.float64: 1e-6, torch.float32: 1e-3, torch.bfloat16: 3e-2}


def residuals(Pi: torch.Tensor, Pj: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    return se3.log(se3.inverse(meas) @ se3.inverse(Pi) @ Pj)


def solve(poses, ei, ej, meas, info, is_loop, huber: float, iterations: int = 50,
          prior: float = 1e6) -> torch.Tensor:
    """Optimise ``poses [K, 4, 4]`` over edges ``ei, ej [E]`` with measured
    ``i_T_j [E, 4, 4]``, information ``[E, 6, 6]`` and loop flags ->
    ``[K, 4, 4]``. A step that does not lower :func:`cost` is halved (up to
    ten times) before it is taken."""
    P = poses.clone()
    dt = P.dtype
    K = P.shape[0]
    eps = _EPS[dt]
    solve_dt = torch.float64
    info, meas = info.to(dt), meas.to(dt)
    f = cost(P, ei, ej, meas, info, is_loop, huber)
    for _ in range(iterations):
        r = residuals(P[ei], P[ej], meas)
        m = torch.sqrt(torch.clamp((r[:, :, None] * info * r[:, None, :]).sum((1, 2)), min=1e-12))
        w = torch.where(is_loop & (m > huber), huber / m, torch.ones_like(m))
        Ji = torch.zeros(r.shape + (6,), dtype=dt)
        Jj = torch.zeros_like(Ji)
        for a in range(6):
            d = torch.zeros(6, dtype=dt)
            d[a] = eps
            Ep, Em = se3.exp(d), se3.exp(-d)
            Ji[:, :, a] = (residuals(P[ei] @ Ep, P[ej], meas) - residuals(P[ei] @ Em, P[ej], meas)) / (2 * eps)
            Jj[:, :, a] = (residuals(P[ei], P[ej] @ Ep, meas) - residuals(P[ei], P[ej] @ Em, meas)) / (2 * eps)
        W = info * w[:, None, None]
        H = torch.zeros((K, K, 6, 6), dtype=dt)
        g = torch.zeros((K, 6), dtype=dt)
        for a, Ja in ((ei, Ji), (ej, Jj)):
            JW = Ja.transpose(1, 2) @ W
            g.index_add_(0, a, (JW @ r[:, :, None])[..., 0])
            for b, Jb in ((ei, Ji), (ej, Jj)):
                H.index_put_((a, b), JW @ Jb, accumulate=True)
        H = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K).to(solve_dt)
        H[:6, :6] += prior * torch.eye(6, dtype=solve_dt)
        H += 1e-6 * torch.eye(6 * K, dtype=solve_dt)  # a column the rounding emptied stays solvable
        dx = -torch.linalg.solve(H, g.reshape(-1).to(solve_dt))
        for _ in range(10):
            Q = P @ se3.exp(dx.reshape(K, 6).to(dt))
            fq = cost(Q, ei, ej, meas, info, is_loop, huber)
            if fq <= f:
                break
            dx = dx / 2
        else:
            break  # no step lowers the cost: a minimum to the rounding
        P, f = Q, fq
        if float(dx.abs().max()) < 1e-9:
            break
    return P


def cost(poses, ei, ej, meas, info, is_loop, huber: float) -> float:
    """The objective both solvers descend, in float64: each edge's squared
    Mahalanobis norm ``s``, a loop edge's through Huber's function
    (``s`` up to ``huber^2``, then ``2 huber sqrt(s) - huber^2``)."""
    P = poses.double()
    r = residuals(P[ei], P[ej], meas.double())
    s = (r[:, :, None] * info.double() * r[:, None, :]).sum((1, 2)).clamp(min=0.0)
    rho = torch.where(is_loop & (s > huber * huber), 2.0 * huber * torch.sqrt(s) - huber * huber, s)
    return float(rho.sum())

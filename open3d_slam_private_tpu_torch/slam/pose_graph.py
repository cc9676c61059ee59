"""Pose-graph optimisation: Gauss-Newton with Levenberg-Marquardt control.

Twin of ``open3d_slam_private_tpu/slam/pose_graph.py``:

- nodes: ``[K, 4, 4]`` submap poses with a validity mask; edges: (i, j,
  measured ``i_T_j``, 6x6 information, loop flag, validity), fixed
  capacities;
- residual of an edge ``log(T_meas^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)))``
  at xi = 0, its Jacobians by forward-mode differentiation
  (``torch.func.jacfwd``, as the twin's ``jax.jacfwd``, in float64);
- IRLS weights on loop edges (huber, dcs or none);
- the ``dense`` solver (the ``6K x 6K`` system, Cholesky) or ``pcg`` (6x6
  block-sparse normal equations, conjugate gradients with a block-Jacobi
  preconditioner); ``auto`` takes pcg from ``auto_pcg_nodes`` nodes on;
- gauge: node 0 and every inactive node held by a strong prior;
- the twin's deferred-reject LM loop and early exits, as host loops that
  read one scalar an iteration (the GN loop) and one a CG iteration.

The edge -> node sums run in a fixed order: each node's (or node pair's)
incident edges are listed once per solve, in edge order, and summed as a
gather and a reduction over that list. No atomics: two solves of one graph
on one device give the same bits.

Reproduced from the twin, not repaired: a rejected step re-evaluates the
best poses at the same cost, so once one step is rejected every later
iteration is rejected too (the damping only grows) until the iteration cap;
and the last accepted step is never evaluated, so the best evaluated poses
are returned (with ``iterations=1`` the input poses).

Not ported, refused by name: ``pcg_precond="tridiag"`` (the cyclic-reduction
chain preconditioner) and ``axis_name`` (edges sharded over devices).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.ops.grid_hash import run_ranks


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph."""

    poses: torch.Tensor  # [K, 4, 4]
    node_mask: torch.Tensor  # [K] bool
    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_T: torch.Tensor  # [E, 4, 4] measured i_T_j
    edge_info: torch.Tensor  # [E, 6, 6]
    edge_is_loop: torch.Tensor  # [E] bool
    edge_mask: torch.Tensor  # [E] bool


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """The JAX twin's fields and defaults."""

    iterations: int = 15
    damping: float = 1e-6  # LM lambda, scaled by the diagonal
    robust_kernel: str = "huber"  # on loop edges: "huber" | "dcs" | "none"
    huber_delta: float = 1.0
    gauge_weight: float = 1e6
    solver: str = "auto"  # "dense" | "pcg" | "auto" (pcg from auto_pcg_nodes on)
    auto_pcg_nodes: int = 128
    cg_iterations: int = 100
    cg_tol: float = 1e-5
    pcg_precond: str = "jacobi"  # "tridiag" is not ported
    # Early exits: relative cost decrease, RMS step, gradient drop below
    # gn_grad_tol of the first, gradient plateau; the gradient exits only
    # once the cost has coarsely plateaued (gn_rel_coarse). gn_rel_tol <= 0:
    # a fixed number of iterations.
    gn_rel_tol: float = 1e-4
    gn_step_tol: float = 1e-6
    gn_grad_tol: float = 1e-3
    gn_plateau_ratio: float = 0.5
    gn_rel_coarse: float = 1e-2


def check_config(cfg: PoseGraphConfig) -> None:
    """Raise naming a setting outside the ported path."""
    if cfg.pcg_precond == "tridiag":
        raise NotImplementedError(
            "PoseGraphConfig.pcg_precond='tridiag' (the cyclic-reduction chain preconditioner) "
            "is not ported; use 'jacobi'")
    if cfg.pcg_precond != "jacobi":
        raise ValueError(f"unknown pcg_precond {cfg.pcg_precond!r}")
    if cfg.robust_kernel not in ("huber", "dcs", "none"):
        raise ValueError(f"unknown robust kernel: {cfg.robust_kernel}")


def empty_graph(num_nodes: int, num_edges: int, dtype=torch.float32, device=None) -> PoseGraph:
    dev = resolve(device)
    return PoseGraph(
        poses=torch.eye(4, dtype=dtype, device=dev).expand(num_nodes, 4, 4).clone(),
        node_mask=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        edge_i=torch.zeros(num_edges, dtype=torch.int32, device=dev),
        edge_j=torch.zeros(num_edges, dtype=torch.int32, device=dev),
        edge_T=torch.eye(4, dtype=dtype, device=dev).expand(num_edges, 4, 4).clone(),
        edge_info=torch.eye(6, dtype=dtype, device=dev).expand(num_edges, 6, 6).clone(),
        edge_is_loop=torch.zeros(num_edges, dtype=torch.bool, device=dev),
        edge_mask=torch.zeros(num_edges, dtype=torch.bool, device=dev),
    )


def _edge_residual(T_i, T_j, T_meas, xi_i, xi_j):
    """r(xi) = log(T_meas^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)))."""
    Ti = T_i @ se3.exp_se3(xi_i)
    Tj = T_j @ se3.exp_se3(xi_j)
    rel = se3.transform_inverse(Ti) @ Tj
    return se3.log_se3(se3.transform_inverse(T_meas) @ rel)


def _one_edge_jacobians(T_i, T_j, T_meas):
    zero = torch.zeros(6, dtype=T_i.dtype, device=T_i.device)
    Ji = jacfwd(lambda a: _edge_residual(T_i, T_j, T_meas, a, zero))(zero)
    Jj = jacfwd(lambda b: _edge_residual(T_i, T_j, T_meas, zero, b))(zero)
    return Ji, Jj


_edge_jacobians = vmap(_one_edge_jacobians)


def _edge_terms(T_i, T_j, T_meas):
    """Residuals ``[E, 6]`` at xi = 0 (float32) and their Jacobians ``[E, 6,
    6]`` wrt xi_i and xi_j. The Jacobians are taken in float64 and rounded:
    forward-mode differentiation of a division by a Python number gives
    float64 tangents of float32 values."""
    zero = torch.zeros(T_i.shape[0], 6, dtype=T_i.dtype, device=T_i.device)
    r = _edge_residual(T_i, T_j, T_meas, zero, zero)
    Ji, Jj = _edge_jacobians(T_i.double(), T_j.double(), T_meas.double())
    return r, Ji.to(T_i.dtype), Jj.to(T_i.dtype)


def _mahalanobis2(r, info):
    """``r^T info r`` over the last axes: ``[E, 6]``, ``[E, 6, 6]`` -> ``[E]``."""
    return (r[..., :, None] * info * r[..., None, :]).sum((-1, -2))


def _robust_weight(r, info, is_loop, delta: float, kernel: str):
    """IRLS weight of each edge on its Mahalanobis norm: huber, dcs (Dynamic
    Covariance Scaling) or none on loop edges, 1 on the others."""
    if kernel == "none":
        return torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
    m2 = _mahalanobis2(r, info)
    if kernel == "huber":
        m = torch.sqrt(torch.clamp(m2, min=1e-12))
        w = torch.where(m <= delta, 1.0, delta / m)
    elif kernel == "dcs":
        d2 = delta * delta
        s = torch.clamp(2.0 * d2 / (d2 + m2), max=1.0)
        w = s * s
    else:
        raise ValueError(f"unknown robust kernel: {kernel}")
    return torch.where(is_loop, w, 1.0)


def _segments(seg: np.ndarray, keep: np.ndarray, num: int, device) -> torch.Tensor:
    """``[num, D]`` int64: each segment's member rows (``seg[r] == s`` and
    ``keep[r]``) in ascending row order, padded with ``len(seg)``, the row
    :func:`_segment_sum` pads with zeros."""
    rows = np.flatnonzero(keep)
    key = torch.as_tensor(seg[rows], dtype=torch.int64)
    sk, order = torch.sort(key, stable=True)
    rank = run_ranks(sk)
    D = int(rank.max()) + 1 if rows.size else 1
    table = torch.full((num, D), len(seg), dtype=torch.int64)
    table[sk, rank] = torch.as_tensor(rows, dtype=torch.int64)[order]
    return table.to(device)


def _segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``values [R, ...]`` over :func:`_segments`'s table."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[table].sum(1)


def optimize(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig(), axis_name=None,
             stats: Optional[dict] = None) -> PoseGraph:
    """Run GN/LM; returns the graph with the optimised poses. ``stats``, if
    given, receives ``gn_iterations`` and ``cg_iterations`` (a list, one
    count a GN iteration; empty for the dense solver)."""
    if axis_name is not None:
        raise NotImplementedError("pose_graph.optimize(axis_name=...) (edges sharded over devices) "
                                  "is not ported")
    check_config(cfg)
    K = graph.poses.shape[0]
    dev, dtype = graph.poses.device, graph.poses.dtype
    use_pcg = cfg.solver == "pcg" or (cfg.solver == "auto" and K >= cfg.auto_pcg_nodes)
    ei_h = graph.edge_i.cpu().numpy().astype(np.int64)
    ej_h = graph.edge_j.cpu().numpy().astype(np.int64)
    keep = graph.edge_mask.cpu().numpy()
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    # Rows [Hii | Hjj], [gi | gj] and the matvec's two halves sum per node.
    node_tab = _segments(np.concatenate([ei_h, ej_h]), np.concatenate([keep, keep]), K, dev)
    if not use_pcg:  # rows [Hii | Hij | Hji | Hjj] sum per node pair
        pair_tab = _segments(np.concatenate([ei_h * K + ei_h, ei_h * K + ej_h, ej_h * K + ei_h,
                                             ej_h * K + ej_h]), np.tile(keep, 4), K * K, dev)
    emask = graph.edge_mask.to(dtype)
    one = torch.ones((), dtype=dtype, device=dev)

    def edge_blocks(poses):
        r, Ji, Jj = _edge_terms(poses[ei], poses[ej], graph.edge_T)
        w = _robust_weight(r, graph.edge_info, graph.edge_is_loop, cfg.huber_delta,
                           cfg.robust_kernel) * emask
        Wi = graph.edge_info * w[:, None, None]
        JiW = Ji.transpose(1, 2) @ Wi
        JjW = Jj.transpose(1, 2) @ Wi
        gi = (JiW @ r[..., None])[..., 0]
        gj = (JjW @ r[..., None])[..., 0]
        cost = (w * _mahalanobis2(r, graph.edge_info)).sum()
        return JiW @ Ji, JiW @ Jj, JjW @ Jj, gi, gj, cost

    def diag_extra(D_diag, lam):
        """Gauge prior on node 0, inactive-node pinning and the LM damping:
        ``[K, 6]`` added to the diagonal."""
        gauge = torch.zeros((K, 6), dtype=dtype, device=dev)
        gauge[0] = cfg.gauge_weight
        inactive = (~graph.node_mask).to(dtype)[:, None] * cfg.gauge_weight
        return gauge + inactive + lam * (D_diag + 1.0)

    def gn_iter_dense(poses, lam, cg_counts):
        Hii, Hij, Hjj, gi, gj, cost = edge_blocks(poses)
        blocks = _segment_sum(torch.cat([Hii, Hij, Hij.transpose(1, 2), Hjj]), pair_tab)
        Hd = blocks.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        g = _segment_sum(torch.cat([gi, gj]), node_tab)
        ginf = g.abs().max()
        extra = diag_extra(torch.diagonal(Hd).reshape(K, 6), lam).reshape(-1)
        Hd = Hd + torch.diag_embed(extra)
        L = torch.linalg.cholesky(Hd)
        y = torch.linalg.solve_triangular(L, g.reshape(6 * K, 1), upper=False)
        dx = -torch.linalg.solve_triangular(L.transpose(0, 1), y, upper=True).reshape(K, 6)
        return poses @ se3.exp_se3(dx), cost, (dx * dx).sum(), ginf

    def gn_iter_pcg(poses, lam, cg_counts):
        Hii, Hij, Hjj, gi, gj, cost = edge_blocks(poses)
        D = _segment_sum(torch.cat([Hii, Hjj]), node_tab)
        g = _segment_sum(torch.cat([gi, gj]), node_tab)
        ginf = g.abs().max()
        d6 = torch.arange(6, device=dev)
        D = D + torch.diag_embed(diag_extra(D[:, d6, d6], lam))
        Minv = torch.linalg.inv(D)
        HijT = Hij.transpose(1, 2)

        def precond(v):
            return (Minv @ v[..., None])[..., 0]

        def matvec(x):
            off = _segment_sum(torch.cat([(Hij @ x[ej][..., None])[..., 0],
                                          (HijT @ x[ei][..., None])[..., 0]]), node_tab)
            return (D @ x[..., None])[..., 0] + off

        b = -g
        b2 = (b * b).sum()
        tol2 = (cfg.cg_tol ** 2) * b2
        x = torch.zeros((K, 6), dtype=dtype, device=dev)
        r, z = b, precond(b)
        p, rz, r2 = z, (b * z).sum(), b2
        i = 0
        while i < cfg.cg_iterations and bool(r2 > tol2):
            Ap = matvec(p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = (r * z).sum()
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz, r2 = rz_new, (r * r).sum()
            i += 1
        cg_counts.append(i)
        return poses @ se3.exp_se3(x), cost, (x * x).sum(), ginf

    gn_iter = gn_iter_pcg if use_pcg else gn_iter_dense
    n_dof = 6.0 * torch.clamp(graph.node_mask.to(dtype).sum(), min=1.0)
    damping = torch.full((), cfg.damping, dtype=dtype, device=dev)

    # The twin's deferred-reject LM step (see the module notes).
    cur = best = graph.poses
    cost_best = torch.full((), float("inf"), dtype=dtype, device=dev)
    lam, g0 = damping, torch.zeros((), dtype=dtype, device=dev)
    prev_ginf = torch.full((), float("inf"), dtype=dtype, device=dev)
    early_exit = cfg.gn_rel_tol > 0
    cg_counts: list = []
    it = 0
    while it < cfg.iterations:
        new_poses, cost_cur, step2, ginf = gn_iter(cur, lam, cg_counts)
        improved = cost_cur < cost_best
        best_n = torch.where(improved, cur, best)
        lam_n = torch.where(improved, torch.maximum(lam * 0.5, damping),
                            torch.clamp(lam * 8.0, max=1e5))
        cur_n = torch.where(improved, new_poses, best_n)
        if it == 0:
            g0 = torch.clamp(ginf, min=1e-20)
        rel = (cost_best - cost_cur).abs() / torch.clamp(cost_best.abs(), min=1e-20)
        coarse = rel < cfg.gn_rel_coarse
        done = improved & (
            (rel < cfg.gn_rel_tol)
            | (step2 / n_dof < cfg.gn_step_tol ** 2)
            | (coarse & (ginf < cfg.gn_grad_tol * g0) & (it > 0))
            | (coarse & (ginf < 0.05 * g0) & (ginf > cfg.gn_plateau_ratio * prev_ginf) & (it > 1))
        )
        cur, best, cost_best, lam, prev_ginf = cur_n, best_n, torch.minimum(cost_cur, cost_best), lam_n, ginf
        it += 1
        if early_exit and bool(done):
            break
    if stats is not None:
        stats["gn_iterations"] = it
        stats["cg_iterations"] = cg_counts
    poses = torch.where(torch.isfinite(cost_best), best, graph.poses)
    return dataclasses.replace(graph, poses=poses)


def chi2(graph: PoseGraph) -> torch.Tensor:
    """Total weighted squared error of the active edges (diagnostic)."""
    zero = torch.zeros((graph.edge_i.shape[0], 6), dtype=graph.poses.dtype, device=graph.poses.device)
    r = vmap(_edge_residual)(graph.poses[graph.edge_i.long()], graph.poses[graph.edge_j.long()],
                             graph.edge_T, zero, zero)
    return torch.where(graph.edge_mask, _mahalanobis2(r, graph.edge_info), 0.0).sum()


class PoseGraphBuilder:
    """Accumulates nodes and edges on the host, exports a PoseGraph."""

    def __init__(self, node_capacity: int = 128, edge_capacity: int = 512):
        self.K = node_capacity
        self.E = edge_capacity
        self.poses = np.tile(np.eye(4, dtype=np.float32), (node_capacity, 1, 1))
        self.node_count = 0
        self.edges = []

    def add_node(self, pose) -> int:
        if self.node_count >= self.K:
            raise ValueError("node capacity exceeded")
        self.poses[self.node_count] = np.asarray(pose, np.float32)
        self.node_count += 1
        return self.node_count - 1

    def add_edge(self, i: int, j: int, T_meas, info=None, is_loop=False) -> None:
        if len(self.edges) >= self.E:
            raise ValueError("edge capacity exceeded")
        info = np.eye(6, dtype=np.float32) if info is None else info
        self.edges.append((i, j, np.asarray(T_meas, np.float32), info, is_loop))

    def build(self, device=None) -> PoseGraph:
        dev = resolve(device)
        ei = np.zeros(self.E, np.int32)
        ej = np.zeros(self.E, np.int32)
        eT = np.tile(np.eye(4, dtype=np.float32), (self.E, 1, 1))
        einfo = np.tile(np.eye(6, dtype=np.float32), (self.E, 1, 1))
        eloop = np.zeros(self.E, bool)
        emask = np.zeros(self.E, bool)
        for n, (i, j, T, info, is_loop) in enumerate(self.edges):
            ei[n], ej[n], eT[n], einfo[n], eloop[n], emask[n] = i, j, T, info, is_loop, True
        nmask = np.zeros(self.K, bool)
        nmask[: self.node_count] = True
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return PoseGraph(poses=t(self.poses.copy()), node_mask=t(nmask), edge_i=t(ei), edge_j=t(ej),
                         edge_T=t(eT), edge_info=t(einfo), edge_is_loop=t(eloop), edge_mask=t(emask))

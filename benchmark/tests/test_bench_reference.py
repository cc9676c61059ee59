"""The plain reference on small cases checked by hand."""

import math

import pytest
import torch

import compare
from reference import icp, maps, pose_graph, se3


def test_exp_log_round_trip_and_gap():
    tw = torch.tensor([[0.1, -0.2, 0.3, 1.0, 2.0, -0.5], [1e-9, 0, 0, 0.1, 0, 0]], dtype=torch.float64)
    T = se3.exp(tw)
    assert torch.allclose(se3.log(T), tw, atol=1e-12)
    R = T[0, :3, :3]
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert torch.allclose(se3.inverse(T[0]) @ T[0], torch.eye(4, dtype=torch.float64), atol=1e-12)
    t, r = se3.gap(torch.eye(4), se3.exp(torch.tensor([0, 0, 0.05, 0.3, 0.4, 0.0], dtype=torch.float64)))
    assert r == pytest.approx(0.05, abs=1e-12) and t == pytest.approx(0.5 * math.sin(0.025) / 0.025, rel=1e-9)


def _box_room(n=6000, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g) * 10 - 5
    floor = torch.cat([u, torch.zeros(n, 1)], 1)
    wall1 = torch.stack([torch.full((n,), 5.0), u[:, 0], u[:, 1].abs()], 1)
    wall2 = torch.stack([u[:, 0], torch.full((n,), -5.0), u[:, 1].abs()], 1)
    wall3 = torch.stack([torch.full((n,), -4.0), u[:, 1], u[:, 0].abs() * 0.5], 1)
    return torch.cat([floor, wall1, wall2, wall3])


def test_point_to_plane_recovers_a_motion():
    ref = _box_room()
    T_true = se3.exp(torch.tensor([0.02, -0.01, 0.04, 0.15, -0.1, 0.05], dtype=torch.float64)).float()
    src = se3.apply(se3.inverse(T_true.double()), ref[::3].double()).float()
    T = icp.point_to_plane(src, ref, torch.eye(4), iterations=10, max_dist=1.0)
    t, r = se3.gap(T.double(), T_true.double())
    assert t < 1e-3 and r < 1e-4
    Tb = icp.point_to_plane(src.bfloat16(), ref.bfloat16(), torch.eye(4), iterations=10, max_dist=1.0)
    tb, _ = se3.gap(Tb.double(), T_true.double())
    assert tb > 3 * t  # the control's precision shows


def test_voxel_means_keep_the_nearest_bands_first():
    # Two voxels near the centre, one 40 m off (another band of 32 x 1 m).
    pts = torch.tensor([[0.2, 0.2, 0.2], [0.4, 0.6, 0.2], [1.5, 0.5, 0.5], [40.5, 0.5, 0.5]])
    keys, means = maps.voxel_means(pts, 1.0, capacity=2, center=(0.0, 0.0, 0.0))
    cells = maps.key_cells(keys)
    assert cells.tolist() == [[0, 0, 0], [1, 0, 0]]
    assert torch.allclose(means[0], torch.tensor([0.3, 0.4, 0.2]))
    keys, _ = maps.voxel_means(pts, 1.0, capacity=10)
    assert maps.key_cells(keys)[:, 0].tolist() == [0, 1, 40]
    # Negative coordinates floor down.
    assert maps.cells_of(torch.tensor([[-0.05, 0.0, 0.1]]), 0.1).tolist() == [[-1, 0, 1]]


def test_dense_map_counts_every_point():
    a = torch.tensor([[0.05, 0.05, 0.05], [0.06, 0.01, 0.02], [0.25, 0.0, 0.0]])
    b = torch.tensor([[0.07, 0.09, 0.01]])
    k, n, m = maps.dense_map([a, b], 0.1)
    assert n.tolist() == [3.0, 1.0]
    assert torch.allclose(m[0].float(), torch.tensor([0.06, 0.05, 0.08 / 3]), atol=1e-6)


def test_mismatch_share():
    k = torch.tensor([1, 2, 3, 4])
    m = torch.zeros(4, 3)
    assert compare._mismatch(k, m, k, m) == 0.0
    moved = m.clone()
    moved[1, 0] = 2e-3
    assert compare._mismatch(k, m, k, moved) == 0.25
    assert compare._mismatch(k, m, k[:2], m[:2]) == 0.5


def test_pose_graph_spreads_a_loop_error():
    """Four nodes on a square, odometry edges a little short, one loop edge:
    the solve closes the loop and holds node 0."""
    def T(x, y, yaw):
        return se3.exp(torch.tensor([0, 0, yaw, x, y, 0], dtype=torch.float64))

    step = T(0.95, 0, math.pi / 2)
    P = torch.stack([torch.eye(4, dtype=torch.float64)] + [torch.linalg.matrix_power(step, i) for i in (1, 2, 3)])
    ei, ej = torch.tensor([0, 1, 2, 0]), torch.tensor([1, 2, 3, 3])
    meas = torch.stack([step, step, step, T(0, 1.0, -math.pi / 2)])
    info = torch.eye(6, dtype=torch.float64).repeat(4, 1, 1) * 100
    loop = torch.tensor([False, False, False, True])
    out = pose_graph.solve(P, ei, ej, meas, info, loop, huber=5.0)
    assert torch.allclose(out[0], torch.eye(4, dtype=torch.float64), atol=1e-6)
    r = pose_graph.residuals(out[ei], out[ej], meas)
    r0 = pose_graph.residuals(P[ei], P[ej], meas)
    assert (r * r).sum() < 0.5 * (r0 * r0).sum()
    # The optimum: the gradient of the cost is zero (probe one node).
    def cost(Q):
        rr = pose_graph.residuals(Q[ei], Q[ej], meas)
        return float(torch.einsum("ea,eab,eb->", rr, info, rr))
    c = cost(out)
    for a in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[a] = 1e-4
        Q = out.clone()
        Q[2] = Q[2] @ se3.exp(d)
        assert cost(Q) >= c - 1e-6

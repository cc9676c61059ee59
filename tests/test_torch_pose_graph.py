"""The port's pose graph (``slam/pose_graph.py``) against the JAX package's
on the CPU, on the graphs of ``tests/test_pose_graph.py``: the dense and pcg
solvers, the three robust kernels, inactive-node pinning, ``auto``'s
choice, and the two reproduced faults of the twin's LM loop. Each case
builds one graph with the JAX builder, carries it over by ``interop``, and
holds the port's poses within 1e-5 m / 1e-5 rad of JAX's with the same
number of GN iterations. JAX's trip count is read from the final state of
its GN ``while_loop``, run eagerly (the unjitted ``optimize``, whose poses
equal the jitted ones)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu.slam import pose_graph as jpg
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import pose_graph as tpg
from tests.test_pose_graph import T_of, _loop_graph, relative

TOL = 1e-5


def jax_optimize(graph, **kw):
    """JAX's optimised poses and GN trip count."""
    finals = []
    run_loop = jax.lax.while_loop

    def recording(cond, body, init):
        out = run_loop(cond, body, init)
        finals.append(out)
        return out

    jax.lax.while_loop = recording
    try:
        out = jpg.optimize.__wrapped__(graph, jpg.PoseGraphConfig(**kw))
    finally:
        jax.lax.while_loop = run_loop
    gn = [int(s[4]) for s in finals if len(s) == 8]  # (cur, best, cost, lam, it, g0, ginf, done)
    return np.asarray(out.poses), (gn[0] if gn else kw.get("iterations", 15))


def port_optimize(graph, **kw):
    stats = {}
    out = tpg.optimize(interop.pose_graph(graph, "cpu"), tpg.PoseGraphConfig(**kw), stats=stats)
    return out.poses.numpy(), stats


def _rot_err(A, B):
    R = np.einsum("kji,kjl->kil", A[:, :3, :3].astype(np.float64), B[:, :3, :3].astype(np.float64))
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    return np.arctan2(np.linalg.norm(skew, axis=-1) / 2, (np.trace(R, axis1=1, axis2=2) - 1) / 2).max()


def assert_parity(graph, **kw):
    want, trips = jax_optimize(graph, **kw)
    got, stats = port_optimize(graph, **kw)
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() < TOL, np.abs(got - want).max()
    assert _rot_err(got, want) < TOL
    assert stats["gn_iterations"] == trips
    return want, got, stats


def _chain(n=5, twist=(0.01, 0, 0.05, 1, 0.1, 0)):
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        gt.append((gt[-1] @ T_of([twist[0] * i, *twist[1:]])).astype(np.float32))
    return gt


def test_builder_matches_jax():
    gt = _chain()
    jb, tb = jpg.PoseGraphBuilder(8, 16), tpg.PoseGraphBuilder(8, 16)
    for b in (jb, tb):
        for p in gt:
            b.add_node(p)
        for i in range(4):
            b.add_edge(i, i + 1, relative(gt[i], gt[i + 1]))
        b.add_edge(4, 0, np.eye(4), info=np.eye(6) * 3.0, is_loop=True)
    j, t = jb.build(), tb.build("cpu")
    for f in dataclasses.fields(tpg.PoseGraph):
        assert np.array_equal(np.asarray(getattr(j, f.name)), getattr(t, f.name).numpy()), f.name
    assert float(tpg.chi2(t)) == pytest.approx(float(jpg.chi2(j)), rel=1e-5)
    assert [f.name for f in dataclasses.fields(tpg.PoseGraphConfig)] == [
        f.name for f in dataclasses.fields(jpg.PoseGraphConfig)]
    assert dataclasses.asdict(tpg.PoseGraphConfig()) == dataclasses.asdict(jpg.PoseGraphConfig())


def test_perfect_measurements_stay_put():
    gt = _chain()
    b = jpg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
    for p in gt:
        b.add_node(p)
    for i in range(4):
        b.add_edge(i, i + 1, relative(gt[i], gt[i + 1]))
    _, got, _ = assert_parity(b.build(), iterations=10)
    np.testing.assert_allclose(got[:5], np.stack(gt), atol=1e-3)


def _bad_loop_graph():
    b = jpg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, 6):
        gt.append((gt[-1] @ T_of([0, 0, 0, 1, 0, 0])).astype(np.float32))
    for p in gt:
        b.add_node(p)
    for i in range(5):
        b.add_edge(i, i + 1, relative(gt[i], gt[i + 1]))
    b.add_edge(5, 0, np.eye(4, dtype=np.float32), is_loop=True)  # node 5 claimed at node 0
    return b.build()


@pytest.mark.parametrize("kernel", ["dcs", "huber", "none"])
def test_robust_kernels_on_bad_loop(kernel):
    _, got, _ = assert_parity(_bad_loop_graph(), iterations=15, huber_delta=0.5, robust_kernel=kernel)
    x5 = got[5][0, 3]
    if kernel == "dcs":
        assert x5 > 3.5  # rejected
    elif kernel == "huber":
        assert 2.5 < x5 < 4.9  # bounded influence


def test_huber_default_applies_genuine_drift_correction():
    b = jpg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
    anchors = []
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 4.0 * i + (0.8 if i == 3 else 0.0)
        anchors.append(T)
        b.add_node(T)
    for i in range(3):
        b.add_edge(i, i + 1, relative(anchors[i], anchors[i + 1]))
    T_rel = np.eye(4, dtype=np.float32)
    T_rel[0, 3] = 12.0
    b.add_edge(0, 3, T_rel, info=np.eye(6) * 50.0, is_loop=True)
    _, got, _ = assert_parity(b.build(), iterations=30)
    assert abs(got[3][0, 3] - 12.0) < 0.1


def test_inactive_nodes_pinned():
    b = jpg.PoseGraphBuilder(node_capacity=8, edge_capacity=8)
    b.add_node(np.eye(4))
    b.add_node(T_of([0, 0, 0, 1, 0, 0]))
    b.add_edge(0, 1, T_of([0, 0, 0, 1.1, 0, 0]))
    _, got, _ = assert_parity(b.build(), iterations=5)
    np.testing.assert_allclose(got[5], np.eye(4), atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_loop_graph_solvers(solver):
    graph, _, _ = _loop_graph(24, n_loops=2)
    kw = dict(iterations=12, solver=solver)
    if solver == "pcg":
        kw.update(cg_tol=1e-8, cg_iterations=400)
    _, got, stats = assert_parity(graph, **kw)
    assert float(tpg.chi2(dataclasses.replace(interop.pose_graph(graph, "cpu"), poses=torch.from_numpy(got)))) \
        < float(jpg.chi2(graph))
    assert (len(stats["cg_iterations"]) == stats["gn_iterations"]) == (solver == "pcg")


@pytest.mark.parametrize("auto_pcg_nodes", [4096, 1])
def test_auto_solver_selects_by_size(auto_pcg_nodes):
    graph, _, _ = _loop_graph(12)
    _, _, stats = assert_parity(graph, iterations=10, solver="auto", auto_pcg_nodes=auto_pcg_nodes)
    assert bool(stats["cg_iterations"]) == (auto_pcg_nodes == 1)


def test_lm_returns_the_last_evaluated_poses():
    """The twin's last step is never evaluated: with one iteration the
    input poses come back, though the step improves the cost."""
    graph, _, est = _loop_graph(12)
    want, got, stats = assert_parity(graph, iterations=1)
    assert np.array_equal(got, np.asarray(graph.poses)) and stats["gn_iterations"] == 1
    _, two, _ = assert_parity(graph, iterations=2)
    assert not np.array_equal(two, got)


def _deadlock_graph(seed=25):
    """A graph whose first GN step raises the cost (found by search)."""
    rng = np.random.default_rng(seed)
    b = jpg.PoseGraphBuilder(8, 16)
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, 5):
        poses.append(poses[-1] @ T_of(list(rng.normal(0, 0.3, 3)) + list(rng.normal(0, 1, 3))))
    for p in poses:
        b.add_node(p)
    for i in range(4):
        noise = T_of(list(rng.normal(0, 1.0, 3)) + list(rng.normal(0, 2, 3)))
        b.add_edge(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1] @ noise)
    b.add_edge(4, 0, T_of(list(rng.normal(0, 1.5, 3)) + list(rng.normal(0, 3, 3))), info=np.eye(6) * 10,
               is_loop=True)
    return b.build()


def test_lm_rejection_deadlock():
    """The twin's LM fault: after a rejected step every iteration
    re-evaluates the best poses at the same cost, is rejected too, and the
    loop runs to its cap with the damping growing; the input comes back."""
    graph = _deadlock_graph()
    want, got, stats = assert_parity(graph, iterations=10, solver="dense")
    assert stats["gn_iterations"] == 10
    assert np.array_equal(got, np.asarray(graph.poses))


def test_unported_settings_raise_by_name():
    graph = interop.pose_graph(_bad_loop_graph(), "cpu")
    with pytest.raises(NotImplementedError, match="tridiag"):
        tpg.optimize(graph, tpg.PoseGraphConfig(solver="pcg", pcg_precond="tridiag"))
    with pytest.raises(NotImplementedError, match="axis_name"):
        tpg.optimize(graph, tpg.PoseGraphConfig(), axis_name="edges")

"""The port's place recognition (``slam/place_recognition.py``), the submap
collection's finished queue and pose updates, and the pipeline's pose-graph
step against the JAX package's on the CPU. A JAX ``SubmapCollection`` is
filled along an out-and-back drive through ``tests/test_pipeline.py``'s
square-corridor world (scans of 2,000 points at known poses, banks of
4,096 points at 0.3 m, new submaps beyond 4 m), so that the way back makes
new submaps beside finished ones; ``interop`` carries it over. Held: the
gated candidates (equal), the finished queue (equal), pose updates
(anchors equal, clouds within 1e-5 m), the loop-closure constraints of the
last finished submap against its two nearest candidates (8 yaw seeds and
128 RANSAC hypotheses: the same accepted pairs, T within 1e-3 m / 1e-3 rad,
the ICP's stopping rule), and
``_optimize_pose_graph`` from the same constraints (anchors and the live
pose within 1e-4 m)."""

import dataclasses

import numpy as np
import pytest

from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import pipeline as jpipe
from open3d_slam_private_tpu.slam import place_recognition as jpr
from open3d_slam_private_tpu.slam import submap_collection as jsc
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from open3d_slam_private_tpu_torch.slam import place_recognition as tpr
from tests.test_pipeline import make_world, scan_at, small_config


def _pose(x, y, yaw):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:2, 3] = [x, y]
    return T


def out_and_back(n=11, step=1.0, lane=1.0):
    return [_pose(step * k, 0.0, 0.0) for k in range(n)] + [_pose(step * (n - 1 - k), lane, np.pi)
                                                            for k in range(n)]


SUBMAPS = jsc.SubmapCollectionConfig(submap_capacity=4096, submap_voxel_size=0.3, creation_radius=4.0,
                                     activation_radius=3.0, min_scans_before_switch=2)


def pr_config(max_candidates=4):
    """``small_config``'s place recognition (8 yaw seeds), cut to 128
    RANSAC hypotheses."""
    return dataclasses.replace(small_config(True).place_recognition, ransac_hypotheses=128,
                               max_candidates=max_candidates)


@pytest.fixture(scope="module")
def collection():
    world = make_world(np.random.default_rng(0))
    col = jsc.SubmapCollection(SUBMAPS)
    for i, T in enumerate(out_and_back()):
        col.insert_scan(jpc.from_points(scan_at(world, T, 2000, seed=i), capacity=2048), T, T)
    return col


def test_collection_carries_over_with_candidates(collection):
    port = interop.submap_collection(collection, device="cpu")
    assert len(port) == len(collection) >= 5
    finished = [i for i, e in enumerate(collection.submaps) if e.finished]
    assert len(finished) >= 4
    for cfg in (jpr.PlaceRecognitionConfig(), pr_config(),
                jpr.PlaceRecognitionConfig(max_candidates=None, min_adjacency_distance=3)):
        tcfg = interop.config(tpr.PlaceRecognitionConfig, cfg)
        for q in finished:
            assert tpr.candidate_pairs(port, q, tcfg) == jpr.candidate_pairs(collection, q, cfg)
    assert any(jpr.candidate_pairs(collection, q, pr_config()) for q in finished)


def test_finished_queue_and_pose_updates_match_jax(collection):
    import copy

    j = copy.deepcopy(collection)
    t = interop.submap_collection(j, device="cpu")
    popped = []
    while True:
        a, b = j.pop_finished(), t.pop_finished()
        assert a == b
        if a is None:
            break
        popped.append(a)
    assert popped == [i for i, e in enumerate(collection.submaps) if e.finished]
    rng = np.random.default_rng(1)
    increments = {}
    for i in (1, 3):
        T = _pose(*rng.normal(0, 0.3, 2), rng.normal(0, 0.05))
        T[2, 3] = 0.01
        increments[i] = T
    j.apply_pose_updates(increments)
    t.apply_pose_updates(increments)
    for ej, et in zip(j.submaps, t.submaps):
        assert np.array_equal(ej.anchor, et.anchor)
        m = np.asarray(ej.state.cloud.mask)
        assert np.array_equal(et.state.cloud.mask.numpy(), m)
        assert np.abs(et.state.cloud.xyz.numpy()[m] - np.asarray(ej.state.cloud.xyz)[m]).max() < 1e-5
        assert np.abs(et.state.pose.numpy() - np.asarray(ej.state.pose)).max() < 1e-6


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


@pytest.fixture(scope="module")
def constraints(collection):
    """The last finished submap's constraints against its two nearest
    candidates, in both packages."""
    cfg = pr_config(max_candidates=2)
    q = max(i for i, e in enumerate(collection.submaps) if e.finished)
    port = interop.submap_collection(collection, device="cpu")
    assert len(jpr.candidate_pairs(collection, q, cfg)) == 2
    return (jpr.build_loop_closure_constraints(collection, q, cfg=cfg),
            tpr.build_loop_closure_constraints(port, q, cfg=interop.config(tpr.PlaceRecognitionConfig, cfg)))


def test_loop_closure_constraints_match_jax(constraints):
    j, t = constraints
    assert len(j) >= 1
    assert [(c.source_idx, c.target_idx) for c in t] == [(c.source_idx, c.target_idx) for c in j]
    for cj, ct in zip(j, t):
        d = np.linalg.inv(cj.T_target_source) @ ct.T_target_source
        assert np.linalg.norm(d[:3, 3]) < 1e-3 and _rot_angle(d[:3, :3]) < 1e-3
        assert ct.overlap == pytest.approx(cj.overlap, abs=0.01)
        assert ct.residual == pytest.approx(cj.residual, abs=0.01)


def test_optimize_pose_graph_matches_jax(collection, constraints):
    """The pipeline's pose-graph step on the collection, from the same
    constraints (JAX's, carried over), with a live pose on the last submap."""
    import copy

    cfg = dataclasses.replace(small_config(True), submaps=SUBMAPS)
    jp = jpipe.SlamPipeline(cfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, cfg), device="cpu")
    jp.submaps = copy.deepcopy(collection)
    tp.submaps = interop.submap_collection(jp.submaps, device="cpu")
    jc = constraints[0]
    jp._loop_constraints = list(jc)
    tp._loop_constraints = interop.loop_constraints(jc)
    live = out_and_back()[-1]
    jp._map_pose, tp._map_pose = live.copy(), live.copy()
    jp._optimize_pose_graph()
    solve = tp._optimize_pose_graph()
    assert solve["increments"] > 0
    for ej, et in zip(jp.submaps.submaps, tp.submaps.submaps):
        assert np.abs(et.anchor[:3, 3] - ej.anchor[:3, 3]).max() < 1e-4
        assert _rot_angle(ej.anchor[:3, :3].T @ et.anchor[:3, :3]) < 1e-4
    assert np.abs(tp.pose[:3, 3] - jp.pose[:3, 3]).max() < 1e-4

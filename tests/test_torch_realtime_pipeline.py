"""The port's ``RealtimePipeline`` on the CPU (where it runs ``rt_step``
eagerly; on a card it replays CUDA graphs, ``tests/test_torch_cuda.py``):
the twins of ``tests/test_realtime.py``'s tests on the same drive and
config, held as the JAX package holds its own pipeline (the ATE class of
the offline harness, here the port's ``SlamPipeline``), and the refusals of
the unported paths."""

import numpy as np
import pytest

from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from open3d_slam_private_tpu_torch.slam import realtime as trt
from tests.test_realtime import ate, make_run, small_cfg


def _cfg(**submap_kw):
    return interop.config(tpipe.SlamConfig, small_cfg(**submap_kw))


def _scans(n_frames):
    scans, gts = make_run(n_frames=n_frames)
    return [interop.point_batch(s.xyz, s.mask) for s in scans], gts


def drive(cfg, scans, **kw):
    p = trt.RealtimePipeline(cfg, device="cpu", **kw)
    for i, s in enumerate(scans):
        p.process_scan(s, time=0.1 * i)
    p.finish()
    return p, p.trajectory()


@pytest.fixture(scope="module")
def drive10():
    """The 10-frame drive through the realtime pipeline polled every 4
    frames: the baseline the mode tests compare with."""
    cfg = _cfg()
    scans, gts = _scans(10)
    rt, traj = drive(cfg, scans, poll_every=4)
    return cfg, scans, gts, rt, traj


def test_realtime_matches_offline_trajectory(drive10):
    """Same scans through the port's offline ``SlamPipeline`` and the
    realtime pipeline polled every 4 frames: the same accuracy class (the
    realtime path differs only in poll-cadence lifecycle decisions)."""
    cfg, scans, gts, rt, traj = drive10
    offline = tpipe.SlamPipeline(cfg, device="cpu")
    poses = []
    for i, s in enumerate(scans):
        offline.process_scan(s, 0.1 * i)
        poses.append(offline.pose)
    assert traj.shape == (10, 4, 4)
    a_off, a_rt = ate(np.stack(poses), gts), ate(traj, gts)
    assert np.max(a_rt) < 0.8
    assert np.median(a_rt) < max(1.5 * np.median(a_off), 0.05)
    assert len(rt.submaps) >= 2 and rt.assembled_map().shape[0] > 0
    assert all(f.pose is not None for f in rt.frames)


def test_realtime_out_of_order_scan_skipped(drive10):
    cfg, scans, _, _, _ = drive10
    rt = trt.RealtimePipeline(cfg, poll_every=2, device="cpu")
    rt.process_scan(scans[0], time=0.0)
    rt.process_scan(scans[1], time=0.1)
    rt.process_scan(scans[2], time=0.05)  # out of order
    rt.process_scan(scans[3], time=0.2)
    rt.finish()
    assert rt.frames[2].out_of_order and not rt.frames[3].out_of_order
    assert rt.trajectory().shape == (4, 4, 4)
    # It carries the last polled pose: frame 1's stats were still pending.
    np.testing.assert_array_equal(rt.frames[2].pose, rt.frames[0].pose)


def test_chunked_mode_matches_single_step(drive10):
    """``chunk_size=4`` (one program a chunk, a padded last chunk of 2)
    against single steps."""
    cfg, scans, gts, _, one = drive10
    _, chunked = drive(cfg, scans, poll_every=4, chunk_size=4)
    assert chunked.shape == one.shape
    assert np.max(np.linalg.norm(one[:, :3, 3] - chunked[:, :3, 3], axis=-1)) < 0.05
    assert np.median(ate(chunked, gts)) < max(1.5 * np.median(ate(one, gts)), 0.05)


def test_packed_h2d_mode_matches_pytree(drive10):
    """The packed upload (~1.5 mm quantisation) tracks the pytree path in
    the accuracy class of the JAX test's bound."""
    cfg, scans, gts, _, py = drive10
    _, pk = drive(cfg, scans, poll_every=4, h2d_mode="packed")
    assert np.max(np.linalg.norm(py[:, :3, 3] - pk[:, :3, 3], axis=-1)) < 0.2
    assert np.median(ate(pk, gts)) < max(1.5 * np.median(ate(py, gts)), 0.05)


def test_sync_rebuild_mode_tracks_async(drive10):
    """``async_rebuild=False``: the rebuild is the step's own branch, armed
    by the host; same accuracy class as the async rebuild."""
    cfg, scans, gts, _, a = drive10
    _, s = drive(cfg, scans, poll_every=4, async_rebuild=False)
    assert np.median(ate(s, gts)) < max(1.5 * np.median(ate(a, gts)), 0.05)


def out_and_back(n=16, step=0.3):
    """Poses 2 m from the scene's centre, ``n // 2`` steps out along x and
    as many back, and their 1,024-point scans (``tests/test_realtime.py``'s
    scene and sampler)."""
    import jax.numpy as jnp

    from open3d_slam_private_tpu.geometry import se3
    from tests.test_realtime import sample, synth_scene

    scene = synth_scene(20000)
    T = np.eye(4)
    T[:3, 3] = [2.0, 0.0, 1.0]
    fwd = np.asarray(se3.exp_se3(jnp.asarray([0, 0, 0, step, 0, 0], jnp.float32)), np.float64)
    poses = []
    for i in range(n):
        poses.append(T.copy())
        T = T @ (fwd if i < n // 2 else np.linalg.inv(fwd))
    scans = [sample(scene, P, 1024, 100 + i) for i, P in enumerate(poses)]
    return [interop.point_batch(b.xyz, b.mask) for b in scans], np.stack(poses)


def test_realtime_reactivates_an_adjacent_submap():
    """Out and back with a 1 m creation radius: the lifecycle creates
    submaps on the way out and, on the way back, re-activates an adjacent
    finished one behind the overlap gate (its bank becomes the live bank)."""
    cfg = _cfg(creation_radius=1.0, activation_radius=1.5, min_scans_before_switch=2)
    scans, gts = out_and_back()
    rt = trt.RealtimePipeline(cfg, poll_every=1, device="cpu")
    seen = []
    for i, s in enumerate(scans):
        rt.process_scan(s, 0.1 * i)
        seen.append(rt.submaps.active_idx)
    rt.finish()
    left = {a for a, b in zip(seen, seen[1:]) if a != b}
    assert any(idx in left and idx < seen[k - 1] for k, idx in enumerate(seen) if k), seen
    assert np.max(ate(rt.trajectory(), gts)) < 0.8


def test_realtime_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="loop_closure_enabled"):
        trt.RealtimePipeline(tpipe.SlamConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="build_dense_map"):
        trt.RealtimePipeline(tpipe.SlamConfig(loop_closure_enabled=False, build_dense_map=True),
                             device="cpu")
    with pytest.raises(ValueError, match="h2d_mode"):
        trt.RealtimePipeline(_cfg(), h2d_mode="zip", device="cpu")

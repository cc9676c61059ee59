"""The port's real-time step (``slam/realtime.py``) against the JAX package's
on the CPU, and the ICP loops' static-trip mode that lets a CUDA graph hold
the step.

- ``rt_init`` + ``rt_step`` on the JAX test's ``small_cfg`` drive, both
  packages started from one state (``interop.rt_state_from_jax``): the
  stats vector's pose within 1e-4 m / 1e-4 rad of JAX's, its flags equal.
  JAX runs its Pallas pair-GN kernel in interpret mode (the odometry's
  ``fused_kernel=True``), with table sizes no other test traces.
- ``pack_scan_u16`` bit-equal to JAX's (both numpy), and the unpacked scan
  within the packing's quantisation.
- ``rt_step`` reads nothing back from the device: under a dispatch mode
  that records the operations that synchronise on a card, a step calls
  none but ``torch.linalg.eigh`` (``sym_eig``'s plain version; the kernel
  on the card).
- ``icp_batch(static_trip=True)`` equals the early-exit run bit for bit on
  the fused, moment and direct in-round paths and the per-iteration chain.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from open3d_slam_private_tpu.slam import realtime as jrt
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.geometry import se3 as tse3
from open3d_slam_private_tpu_torch.models import icp as ticp
from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig
from open3d_slam_private_tpu_torch.ops import grid_hash as tgh
from open3d_slam_private_tpu_torch.ops import normals as tnm
from open3d_slam_private_tpu_torch.ops import pointcloud as tpc
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe
from open3d_slam_private_tpu_torch.slam import realtime as trt
from tests.test_realtime import make_run, small_cfg
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

FLAGS = (trt.IDX_CONVERGED, trt.IDX_INSERTED, trt.IDX_DEGENERATE, trt.IDX_ODOM_OK,
         trt.IDX_USE_PRIOR, trt.IDX_REBUILT, trt.IDX_CARVED)


def parity_cfg():
    """``small_cfg`` with odometry and mapper tables no other test traces
    (JAX's jitted steps are cached per static config and per process, and
    this one must trace with the fused path on), and the mapper on the fused
    path as in the production config (``MapperConfig``): ``small_cfg``'s
    mapper takes the moment path, whose fixed point moves with the order of
    its float32 moment sums in the JAX package itself (ROADMAP queue 3)."""
    cfg = small_cfg()
    odo = dataclasses.replace(cfg.odometry, icp=dataclasses.replace(cfg.odometry.icp,
                                                                    grid_table_size=1 << 10))
    mapper = dataclasses.replace(cfg.mapper, icp=dataclasses.replace(
        cfg.mapper.icp, grid_table_size=1 << 11, fused_kernel=True))
    return dataclasses.replace(cfg, odometry=odo, mapper=mapper)


def _rot_angle(R):
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def assert_stats_close(got, want, what):
    d = np.linalg.inv(want[trt.IDX_POSE].reshape(4, 4).astype(np.float64)) @ \
        got[trt.IDX_POSE].reshape(4, 4).astype(np.float64)
    assert np.linalg.norm(d[:3, 3]) < 1e-4 and _rot_angle(d[:3, :3]) < 1e-4, (what, d)
    np.testing.assert_array_equal(got[list(FLAGS)], want[list(FLAGS)], err_msg=what)


def test_rt_step_matches_mapper_semantics():
    """Each step from one state, JAX's (``rt_init``'s, then its own steps'),
    handed to the port: the port's step from it against JAX's. (Stepping
    each package on its own state would compound the handful of KNN normals
    of near-degenerate neighbourhoods that differ between the packages,
    ROADMAP queue 3, through these sparse 1,024-point scans.)"""
    jcfg = parity_cfg()
    tcfg = interop.config(tpipe.SlamConfig, jcfg)
    scans, _ = make_run(n_frames=3)
    jstate = jrt.rt_init(scans[0], jnp.eye(4), jcfg)
    # The port's own rt_init builds the same bank.
    tinit = trt.rt_init(interop.point_batch(scans[0].xyz, scans[0].mask), torch.eye(4), tcfg)
    np.testing.assert_array_equal(tinit.bank.cloud.mask.numpy(), np.asarray(jstate.bank.cloud.mask))
    np.testing.assert_allclose(tinit.bank.cloud.xyz.numpy(), np.asarray(jstate.bank.cloud.xyz),
                               atol=1e-5)
    dt = 0.1
    for k in (1, 2):
        tstate = interop.rt_state_from_jax(jstate, device="cpu")
        scan = interop.point_batch(scans[k].xyz, scans[k].mask)
        # Without the rebuild branch (the pipeline's async rebuild): the same
        # step, the cadence not being due.
        _, again = trt.rt_step(tstate, scan, torch.tensor(dt), torch.eye(4), tcfg,
                               rebuild_branch=False)
        jstate, jstats = jrt.rt_step(jstate, scans[k], jnp.asarray(dt, jnp.float32), jnp.eye(4), jcfg)
        tstate, tstats = trt.rt_step(tstate, scan, torch.tensor(dt), torch.eye(4), tcfg)
        got, want = tstats.numpy(), np.asarray(jstats)
        assert np.all(np.isfinite(got))
        assert_stats_close(got, want, f"step {k}")
        assert got[trt.IDX_OCCUPANCY] > 0 and got[trt.IDX_INSERTED] > 0.5  # ~0.35 m >> 0.05 m
        assert int(tstate.scans_in_active) == int(jstate.scans_in_active) == k + 1
        assert torch.equal(again, tstats)


def test_pack_scan_u16_roundtrip():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-50, 50, (256, 3)).astype(np.float32)
    mask = rng.uniform(size=256) > 0.1
    times = rng.uniform(size=256).astype(np.float32)
    for t in (times, None):
        packed, header = trt.pack_scan_u16(xyz, mask, t)
        jpacked, jheader = jrt.pack_scan_u16(xyz, mask, t)
        np.testing.assert_array_equal(packed, jpacked)
        np.testing.assert_array_equal(header.view(np.int32), jheader.view(np.int32))
        b = trt._unpack_scan_u16(trt.packed_tensor(packed), torch.from_numpy(header), t is not None)
        np.testing.assert_array_equal(b.mask.numpy(), mask)
        err = np.abs(b.xyz.numpy()[mask] - xyz[mask])
        assert err.max() < 100.0 / 65535.0 * 1.01  # span / 65535
        if t is None:
            assert "times" not in b.extras
        else:
            assert np.abs(b.extras["times"].numpy()[mask, 0] - t[mask]).max() < 1.5 / 65534.0


_SYNCING = {"aten.lift_fresh.default", "aten._local_scalar_dense.default", "aten.nonzero.default",
            "aten.masked_select.default", "aten.is_nonzero.default", "aten._unique2.default",
            "aten.unique_consecutive.default", "aten.repeat_interleave.Tensor",
            "aten._linalg_eigh.default"}


class _Syncs(TorchDispatchMode):
    """Records the operations that read the device back on a card: scalar
    reads, data-dependent shapes (``nonzero``, boolean indexing), tensors
    made from host data, and ``eigh`` (which checks its ``info``)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name in _SYNCING:
            self.seen.add(name)
        if name.startswith(("aten.index.Tensor", "aten.index_put")) and len(args) > 1:
            if any(torch.is_tensor(i) and i.dtype == torch.bool for i in (args[1] or [])):
                self.seen.add(name + " (boolean)")
        return func(*args, **(kwargs or {}))


def test_rt_step_reads_nothing_back():
    """What a CUDA graph can capture: the static-trip step, after one warm-up
    step (the kernels' per-device caches), calls no operation that
    synchronises on a card but ``eigh``, which is ``sym_eig``'s plain
    version here and the ``sym_eig`` kernel on the card."""
    cfg = interop.config(tpipe.SlamConfig, parity_cfg())
    scans = [interop.point_batch(s.xyz, s.mask) for s in make_run(n_frames=3)[0]]
    state = trt.rt_init(scans[0], torch.eye(4), cfg)
    dt, ext = torch.tensor(0.1), torch.eye(4)
    state, _ = trt.rt_step(state, scans[1], dt, ext, cfg, static_trip=True)
    spy = _Syncs()
    with spy:
        trt.rt_step(state, scans[2], dt, ext, cfg, static_trip=True)
    assert spy.seen == {"aten._linalg_eigh.default"}
    spy = _Syncs()
    with spy:  # the early-exit loops read the done flags
        trt.rt_step(state, scans[2], dt, ext, cfg)
    assert "aten.is_nonzero.default" in spy.seen or "aten._local_scalar_dense.default" in spy.seen


def _room(rng, n):
    k = n // 5
    parts = [np.c_[rng.uniform(-6, 6, (k, 2)), rng.normal(0, 0.01, k)],
             np.c_[rng.uniform(-6, 6, k), np.full(k, 5.0), rng.uniform(0, 3, k)],
             np.c_[np.full(k, -5.0), rng.uniform(-6, 6, k), rng.uniform(0, 3, k)],
             np.c_[rng.uniform(-6, 6, k), -4.0 + 0.3 * np.sin(rng.uniform(0, 6, k)), rng.uniform(0, 3, k)],
             np.c_[np.full(n - 4 * k, 4.5), rng.uniform(-6, 6, n - 4 * k), rng.uniform(0, 3, n - 4 * k)]]
    return np.concatenate(parts).astype(np.float32)


def _with_normals(batch):
    grid = tgh.build_grid(batch.padded_xyz(), batch.mask, 1.0, 1 << 12, 32)
    return tnm.estimate_normals_grid(batch, grid, knn=8, max_dist=0.5)


OPT = DegeneracyConfig(method="optimized", enough_information_threshold=250.0,
                       insufficient_information_threshold=180.0)
_BASE = dict(max_match_dist=0.5, matcher="grid", grid_table_size=1 << 12, grid_bucket_cap=24,
             trimmed_ratio=0.9, max_iterations=15, candidate_refresh_every=5, fast_trimming=True,
             coarse_iterations=8, coarse_stride=4)
STATIC_PATHS = dict(
    fused=dict(fused_kernel=True, degeneracy=OPT),
    moment=dict(degeneracy=OPT),
    direct=dict(fast_trimming=False, max_iterations=40,
                degeneracy=DegeneracyConfig(method="equality_constraints")),
    per_iteration=dict(candidate_refresh_every=0, degeneracy=OPT),
)


@pytest.mark.parametrize("path", list(STATIC_PATHS))
def test_static_trip_matches_early_exit(path):
    """Three problems that converge at different iterations (and, on the
    moment path, revisit): every output of the static-trip run equals the
    early-exit run's bits."""
    rng = np.random.default_rng(0)
    cfg = ticp.ICPConfig(**{**_BASE, **STATIC_PATHS[path]})
    ref = ticp.build_reference(_with_normals(tpc.from_points(_room(rng, 3000))), cfg)
    one = _with_normals(tpc.from_points(_room(rng, 2000) + rng.normal(0, 0.01, (2000, 3)).astype(np.float32)))
    B = 3
    readings = tpc.PointBatch(xyz=one.xyz.expand(B, -1, -1), mask=one.mask.expand(B, -1),
                              extras={k: v.expand(B, -1, -1) for k, v in one.extras.items()})
    twists = ([0.01, -0.01, 0.02, 0.1, -0.05, 0.03], [0, 0, 0.001, 0.01, 0, 0],
              [0.03, 0.0, -0.03, -0.2, 0.15, 0.05])
    inits = torch.stack([tse3.exp_se3(torch.tensor(t, dtype=torch.float32)) for t in twists])
    want = ticp.icp_batch(readings, ref, inits, cfg)
    got = ticp.icp_batch(readings, ref, inits, cfg, static_trip=True)
    assert len(set(want.iterations.tolist())) > 1  # the problems finish apart
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


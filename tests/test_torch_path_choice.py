"""Which path the cached rounds take, pinned on a small mapper case.

The port runs K1 (here its plain version) for ``fused_kernel=True`` on every
device; the JAX package takes its fused Pallas kernel there only on a TPU or
with ``O3S_FUSED_INTERPRET=1`` (``tests/torch_jax_paths.py``), and its moment
path otherwise. With the flag the two packages agree at the parity
tolerance (1e-4 m / 1e-4 rad); without it JAX runs another algorithm, whose
gap to the port this test prints and never holds. Porting the moment path
is ROADMAP queue 1, item 2."""

import dataclasses

import numpy as np

from open3d_slam_private_tpu.models import minimizers as jmin
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import mapper as jmapper
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.kernels import pair_gn as tpg
from open3d_slam_private_tpu_torch.slam import mapper as tmapper
from tests.test_torch_mapper import _scene, _sequence
from tests.torch_jax_paths import FLAG

# Configurations no other test traces: JAX reads the flag when it traces a
# step, and caches its jitted steps per static config and per process. The
# second differs from the first only in a field its chain never reads
# (Anderson acceleration is off), so it takes its own trace.
_BASE = dataclasses.replace(jmapper.MapperConfig(), scan_capacity=2048, ref_capacity=4096,
                            submap_capacity=8192, reference_reinit_every=2)
FUSED = dataclasses.replace(_BASE, icp=dataclasses.replace(_BASE.icp, grid_table_size=1 << 10))
UNFLAGGED = dataclasses.replace(FUSED, icp=dataclasses.replace(FUSED.icp, anderson_max=26.0))


def _gap(a, b):
    d = np.linalg.inv(a) @ b
    skew = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.linalg.norm(d[:3, 3])), float(np.arctan2(np.linalg.norm(skew) / 2,
                                                             (np.trace(d[:3, :3]) - 1) / 2))


def _jax_poses(cfg, scans, odoms, monkeypatch, flag: bool):
    """The JAX mapper's poses, and how often its traces built the moment
    path's sums (``point_to_plane_moments``)."""
    if flag:
        monkeypatch.setenv(FLAG, "1")
    else:
        monkeypatch.delenv(FLAG, raising=False)
    calls, moments = [], jmin.point_to_plane_moments
    monkeypatch.setattr(jmin, "point_to_plane_moments", lambda *a, **k: calls.append(1) or moments(*a, **k))
    jm = jmapper.Mapper(cfg)
    poses = []
    for scan, odom in zip(scans, odoms):
        jm.add_scan(jpc.from_points(scan, capacity=8192), odom)
        poses.append(jm.pose)
    monkeypatch.setattr(jmin, "point_to_plane_moments", moments)
    return poses, len(calls)


def test_fused_kernel_path_choice(rng, monkeypatch):
    assert FUSED.icp.fused_kernel  # the production mapper config
    scene = _scene(rng)
    scans, odoms = _sequence(rng, scene)
    tm = tmapper.Mapper(interop.config(tmapper.MapperConfig, FUSED), device="cpu")
    k1_before = tpg.pair_gn.launches
    port = []
    for scan, odom in zip(scans, odoms):
        jb = jpc.from_points(scan, capacity=8192)
        tm.add_scan(interop.point_batch(jb.xyz, jb.mask), odom)
        port.append(tm.pose)
    assert tpg.pair_gn.launches == k1_before  # CPU tensors: K1's plain version, on the fused path

    fused, fused_moment_traces = _jax_poses(FUSED, scans, odoms, monkeypatch, flag=True)
    assert fused_moment_traces == 0
    for a, b in zip(fused, port):
        dt, dr = _gap(a, b)
        assert dt < 1e-4 and dr < 1e-4, (dt, dr)

    unflagged, moment_traces = _jax_poses(UNFLAGGED, scans, odoms, monkeypatch, flag=False)
    assert moment_traces > 0  # off a TPU without the flag, JAX takes the moment path
    gaps = [_gap(a, b) for a, b in zip(unflagged, port)]
    print("JAX's moment path against the port (m, rad), scan by scan:", gaps)

"""The port's submap and mapper against the JAX package at small capacities
(scan 2,048, reference 4,096, submap 8,192): poses within 1e-4 m and 1e-4
rad, the same inserted and degenerate flags; submap banks with equal masks
and xyz to 1e-5 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from open3d_slam_private_tpu.geometry import se3 as jse3
from open3d_slam_private_tpu.ops import pointcloud as jpc
from open3d_slam_private_tpu.slam import mapper as jmapper
from open3d_slam_private_tpu.slam import submap as jsubmap
from open3d_slam_private_tpu_torch import interop
from open3d_slam_private_tpu_torch.slam import mapper as tmapper
from open3d_slam_private_tpu_torch.slam import submap as tsubmap
from tests.torch_jax_paths import jax_fused_path  # noqa: F401  (JAX on its fused path)

# A configuration no other test traces: the JAX mapper's jitted steps are
# cached per static config, and this one must be traced with the fused path.
JCFG = dataclasses.replace(
    jmapper.MapperConfig(), scan_capacity=2048, ref_capacity=4096, submap_capacity=8192,
    reference_reinit_every=2,
)
JCFG = dataclasses.replace(JCFG, icp=dataclasses.replace(JCFG.icp, grid_table_size=1 << 12))


def _scene(rng, n=40000):
    floor = np.c_[rng.uniform(-15, 15, (n // 2, 2)), 0.02 * rng.normal(size=(n // 2, 1))]
    walls = []
    for i in range(4):
        m = (n - n // 2) // 4
        ang = np.pi / 2 * i + 0.3
        u = np.array([np.cos(ang), np.sin(ang)])
        t = rng.uniform(-10, 10, (m, 1))
        base = (6 + 2 * i) * u[None, :] + t * np.array([[-u[1], u[0]]])
        walls.append(np.c_[base, rng.uniform(0, 4, (m, 1))])
    return (np.vstack([floor] + walls) + 0.01 * rng.normal(size=(n, 3))).astype(np.float32)


def _sequence(rng, scene, k=3, n=6000):
    poses = []
    for i in range(k):
        T = np.asarray(jse3.exp_se3(jnp.asarray([0.0, 0.0, np.radians(1.0) * i, 0.2 * i, 0.02 * i, 1.0])),
                       np.float64)
        poses.append(T)
    scans = []
    for T in poses:
        pts = scene[rng.choice(len(scene), n, replace=False)] + 0.01 * rng.normal(size=(n, 3))
        Ti = np.linalg.inv(T)
        scans.append((pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
    odoms = [np.eye(4)]
    for i in range(1, k):
        noise = np.asarray(jse3.exp_se3(jnp.asarray(np.r_[rng.normal(0, 0.003, 3), rng.normal(0, 0.01, 3)])))
        odoms.append(np.linalg.inv(poses[i - 1]) @ poses[i] @ noise)
    return scans, odoms


def test_mapper_matches_jax(rng):
    scene = _scene(rng)
    scans, odoms = _sequence(rng, scene)
    jm = jmapper.Mapper(JCFG)
    tm = tmapper.Mapper(interop.config(tmapper.MapperConfig, JCFG), device="cpu")
    for scan, odom in zip(scans, odoms):
        jb = jpc.from_points(scan, capacity=8192)
        js = jm.add_scan(jb, odom)
        ts = tm.add_scan(interop.point_batch(jb.xyz, jb.mask), odom)
        assert ts["inserted"] == js["inserted"]
        assert ts["degenerate"] == js["degenerate"]
        d = np.linalg.inv(jm.pose) @ tm.pose
        assert np.linalg.norm(d[:3, 3]) < 1e-4
        skew = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
        assert np.arctan2(np.linalg.norm(skew) / 2, (np.trace(d[:3, :3]) - 1) / 2) < 1e-4
        if "iterations" in js:
            assert abs(ts["iterations"] - js["iterations"]) <= 1
    assert tm.map_points().shape == jm.map_points().shape


def test_insert_scan_and_map_reference(rng):
    scene = _scene(rng)
    scans, _ = _sequence(rng, scene, k=2)
    cfg = interop.config(tmapper.MapperConfig, JCFG)
    T = np.asarray(jse3.exp_se3(jnp.asarray([0.0, 0.0, 0.02, 0.3, -0.1, 0.0])), np.float32)
    jstate = jsubmap.create(8192)
    tstate = tsubmap.create(8192, device="cpu")
    for scan in scans:
        raw = jpc.from_points(scan, capacity=8192)
        jb = jmapper.process_scan_for_matching(raw, JCFG)
        tb = tmapper.process_scan_for_matching(interop.point_batch(raw.xyz, raw.mask), cfg)
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        np.testing.assert_allclose(tb.xyz.numpy(), np.asarray(jb.xyz), rtol=1e-5, atol=1e-5)
        jstate = jsubmap.insert_scan(jstate, jb, jnp.asarray(T), 0.15, 50.0)
        tstate = tsubmap.insert_scan(tstate, interop.point_batch(jb.xyz, jb.mask), torch.tensor(T), 0.15, 50.0)
        np.testing.assert_array_equal(tstate.cloud.mask.numpy(), np.asarray(jstate.cloud.mask))
        np.testing.assert_allclose(tstate.cloud.xyz.numpy(), np.asarray(jstate.cloud.xyz), rtol=1e-5, atol=1e-5)
        assert tstate.num_scans == int(jstate.num_scans)

    # The reference rebuild on the JAX bank: same patch, normals, table ids.
    center = np.array([0.3, -0.1, 0.0], np.float32)
    jref = jmapper.build_map_reference(jstate.cloud, jnp.asarray(center), JCFG)
    bank = interop.submap_state(jstate.cloud.xyz, jstate.cloud.mask, jstate.pose, jstate.num_scans)
    tref = tmapper.build_map_reference(bank.cloud, torch.tensor(center), cfg)
    np.testing.assert_array_equal(tref.cloud.mask.numpy(), np.asarray(jref.cloud.mask))
    np.testing.assert_allclose(tref.centroid.numpy(), np.asarray(jref.centroid), atol=1e-5)
    jn, tn = np.asarray(jref.cloud.normals), tref.cloud.normals.numpy()
    both = (np.abs(jn).sum(1) > 0) & (np.abs(tn).sum(1) > 0)
    dots = (jn * tn).sum(1)[both]
    assert np.mean(dots >= 1 - 1e-4) >= 0.99  # collinear neighbourhoods aside (ROADMAP queue 3)
    ids_j = np.asarray(jref.grid.table)[..., 3].view(np.int32)
    ids_t = tref.grid.table.numpy()[..., 3].view(np.int32)
    assert np.mean(ids_j == ids_t) >= 0.999

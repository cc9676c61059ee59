"""Where the pipeline parity test's data seeds part from the JAX package in
the mapper, on the CPU: the submap bank after an insertion and the map
reference's moment normals, bit for bit.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_mapper_parity.py                  # op table
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_mapper_parity.py --seed 3 \\
        --repairs eigh                                                                   # pipeline gaps

The op table runs both pipelines over the first scan of a data seed and
compares the submap bank after the insertion and the map reference's
moment normals: the port's own, and with the candidate repair below. The
second form runs ``tests/torch_parity_seed.py``'s steps with the chosen
repairs and prints the odometry's and the pipeline's pose gaps.

The port reproduces what XLA's CPU backend does in the insertion
(``se3.apply_transform_fma``: each row of ``R p + t`` as ``fma(R_i2, z,
fma(R_i0, x, R_i1 y)) + t_i``) and in ``grid_moments`` (the second moments
summed with an 8-lane fused multiply-add loop, the covariance as
``fma(-m_a, m_b, s_ab / count)``), read from its LLVM IR
(``--xla_dump_to``). The candidates left: ``eigh``
(``tests/torch_eigh_parity.py``'s ``eigh3x3``; alone, every seed's normals
equal JAX's on more rows, but data seed 0 parts by 1.2e-4 m at step 7);
``centroid`` (the cell matchers centred at XLA's windowed sum; alone, seed
3 parts by 1.69e-4 m at step 7); ``solve`` and ``compose`` (the unrolled
Cholesky solve and the GN step's ``dT @ T`` with XLA's fused multiply-adds:
with ``centroid``, ``register_pair`` on JAX's own preprocessed clouds
equals JAX's bit for bit). None is in the port: with all four, seeds 0,
1, 2 and 4 hold and seed 3 parts by 1.66e-4 m at step 7, in the mapper.

Two more candidates are bounds, not repairs: ``jax-undistort`` computes the
pipeline's twist (``log_se3``) and the undistortion with the JAX package
itself (what an emulation of glibc's ``sinf``/``cosf``/``atan2f``, which
XLA's CPU code calls, and of XLA's fusions could at best reach), and
``lapack-kkt`` solves the mapper's KKT system in float32 through LAPACK's
``ssyevd``, the routine JAX's CPU ``eigh`` calls (SciPy's binding; the
port's design solves it in float64). ``--trace`` prints, for each
odometry call, whether its inputs and outputs equal JAX's bit for bit;
``--jax-odometry`` hands the port's pipeline JAX's odometry pose, so that
only its mapper parts.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_mapper_parity.py --seed 3 \\
        --repairs centroid,solve,compose,eigh,jax-undistort,lapack-kkt --jax-odometry
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import torch_eigh_parity as tep  # noqa: E402  (sets the fused-path flag, JAX on the CPU)

from open3d_slam_private_tpu.ops import pointcloud as jpc  # noqa: E402
from open3d_slam_private_tpu.slam import pipeline as jpipe  # noqa: E402
from open3d_slam_private_tpu_torch import interop  # noqa: E402
from open3d_slam_private_tpu_torch.ops import normals as tnm  # noqa: E402
from open3d_slam_private_tpu_torch.slam import pipeline as tpipe  # noqa: E402


def _solve_fma(A, b, damping=1e-6):
    """``minimizers.solve_spd_unrolled`` as XLA's CPU backend rounds it in
    the jitted step (read from ``--xla_dump_to``): the trace times the
    float32 reciprocal of n, the damping added by a fused multiply-add, and
    every product of the Cholesky factorisation and of both substitutions
    fused into the subtraction it feeds."""
    from open3d_slam_private_tpu_torch.geometry.se3 import fma32

    n = A.shape[-1]
    tr = A[..., 0, 0]
    for i in range(1, n):
        tr = tr + A[..., i, i]
    m = torch.clamp(tr * torch.full_like(tr, 1.0 / n), min=1e-12)
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    for i in range(n):
        a[i][i] = fma32(m, torch.full_like(m, damping), a[i][i])
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            t = a[i][j]
            for k in range(j):
                t = fma32(-L[i][k], L[j][k], t)
            L[i][j] = torch.sqrt(torch.clamp(t, min=1e-30)) if i == j else t / L[j][j]
    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = fma32(-L[i][k], y[k], t)
        y[i] = t / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = fma32(-L[k][i], x[k], t)
        x[i] = t / L[i][i]
    return torch.stack(x, -1)


def _advance_fma(s, T0, dT, match_ratio, overlap, resid, A, cfg):
    """``icp._advance`` with ``dT @ T`` as XLA's CPU dot forms it: a fused
    multiply-add chain over k from 0."""
    from open3d_slam_private_tpu_torch.geometry import se3
    from open3d_slam_private_tpu_torch.geometry.se3 import fma32
    from open3d_slam_private_tpu_torch.models.icp import _where

    T = s["T"]
    T_new = dT[:, :, 0, None] * T[:, None, 0, :]
    for k in range(1, 4):
        T_new = fma32(dT[:, :, k, None], T[:, None, k, :], T_new)
    dr = se3.rotation_angular_distance(T_new[:, :3, :3], T[:, :3, :3])
    dt = torch.linalg.vector_norm(T_new[:, :3, 3] - T[:, :3, 3], dim=-1)
    drot = torch.cat([dr[:, None], s["drot"][:, :-1]], dim=1)
    dtrans = torch.cat([dt[:, None], s["dtrans"][:, :-1]], dim=1)
    converged = (drot.mean(1) < cfg.min_diff_rot) & (dtrans.mean(1) < cfg.min_diff_trans)
    tot_rot = se3.rotation_angular_distance(T_new[:, :3, :3], T0[:, :3, :3])
    tot_trans = torch.linalg.vector_norm(T_new[:, :3, 3] - T0[:, :3, 3], dim=-1)
    aborted = s["aborted"] | (tot_rot > cfg.max_rotation_norm) | (tot_trans > cfg.max_translation_norm)
    return dict(T=_where(aborted, T0, T_new), it=s["it"] + 1, done=converged | aborted, drot=drot,
                dtrans=dtrans, match_ratio=match_ratio, overlap=overlap, resid=resid,
                converged=converged & ~aborted, aborted=aborted, A=A)


def _jax_undistort() -> None:
    """The pipeline's twist and undistortion computed by the JAX package."""
    import jax.numpy as jnp

    from open3d_slam_private_tpu.geometry import se3 as jse3
    from open3d_slam_private_tpu.slam import motion_compensation as jmc
    from open3d_slam_private_tpu_torch.slam import pipeline as tpipe_mod

    def undistort_with_times(scan, twist, t_start, t_end):
        jb = jpc.PointBatch(xyz=jnp.asarray(scan.xyz.numpy()), mask=jnp.asarray(scan.mask.numpy()),
                            extras={k: jnp.asarray(v.numpy()) for k, v in scan.extras.items()})
        out = jmc.undistort_with_times(jb, jnp.asarray(twist.numpy()), t_start, t_end)
        return interop.point_batch(out.xyz, out.mask, dict(out.extras))

    tpipe_mod._log_se3 = lambda T: np.asarray(jse3.log_se3(jnp.asarray(T, jnp.float32)), np.float64)
    tpipe_mod.mc_mod.undistort_with_times = undistort_with_times


def _lapack_kkt(M, rhs, rcond=1e-7):
    """``solve_symmetric_indefinite`` as the JAX twin computes it: float32,
    the eigen-decomposition by LAPACK's ``ssyevd`` (lower), then
    ``V (w^+ (V^T b))``."""
    from scipy.linalg import lapack

    Mf = M.float().reshape(-1, *M.shape[-2:]).numpy()
    bf = rhs.float().reshape(-1, rhs.shape[-1]).numpy()
    out = np.empty_like(bf)
    for i in range(len(Mf)):
        w, V, _ = lapack.ssyevd(Mf[i], compute_v=1, lower=1)
        aw = np.abs(w)
        inv = np.where(aw > np.float32(rcond) * aw.max(), np.float32(1.0) / np.where(w == 0, 1, w), 0)
        out[i] = V @ (inv.astype(np.float32) * (V.T @ bf[i]))
    return torch.from_numpy(out.reshape(rhs.shape)).to(M.dtype)


def trace_odometry() -> list:
    """Record both packages' odometry preprocessing and registration calls;
    returns the list :func:`print_trace` reads."""
    from open3d_slam_private_tpu.slam import odometry as jodo
    from open3d_slam_private_tpu_torch.slam import odometry as todo

    calls = []
    jpre, tpre, jstep, tstep = jodo.preprocess, todo.preprocess, jodo.odometry_step, todo.odometry_step

    def jp(scan, *a, **k):
        out = jpre(scan, *a, **k)
        calls.append(["preprocess", (np.asarray(scan.xyz), np.asarray(out.xyz), np.asarray(out.normals))])
        return out

    def tp(scan, *a, **k):
        out = tpre(scan, *a, **k)
        next(c for c in calls if c[0] == "preprocess" and len(c) == 2).append(
            (scan.xyz.cpu().numpy(), out.xyz.numpy(), out.extras["normals"].numpy()))
        return out

    def js(prev, curr, init, cfg):
        out = jstep(prev, curr, init, cfg)
        calls.append(["register", (np.asarray(init), np.asarray(out.transform))])
        return out

    def ts(prev, curr, init, cfg):
        out = tstep(prev, curr, init, cfg)
        next(c for c in calls if c[0] == "register" and len(c) == 2).append(
            (init.numpy(), out.transform.numpy()))
        return out

    jodo.preprocess, todo.preprocess, jodo.odometry_step, todo.odometry_step = jp, tp, js, ts
    return calls


def print_trace(calls) -> None:
    def same(a, b):
        return bool(np.array_equal(a.view(np.int32), b.view(np.int32)))

    for i, (kind, j, t) in enumerate(c for c in calls if len(c) == 3):
        print(f"odometry {kind} {i}: input equal {same(j[0], t[0])}, output equal "
              f"{all(same(a, b) for a, b in zip(j[1:], t[1:]))}")


def use_repairs(names) -> None:
    """Wire the named candidate repairs into the port's modules (this
    process only): ``eigh`` (``tests/torch_eigh_parity.py``'s ``eigh3x3``),
    ``centroid`` (the cell matchers centred at XLA's windowed sum),
    ``solve`` (:func:`_solve_fma`), ``compose`` (:func:`_advance_fma`), and
    the bounds ``jax-undistort`` and ``lapack-kkt``."""
    from open3d_slam_private_tpu_torch.models import icp as ticp
    from open3d_slam_private_tpu_torch.models import minimizers as tmin
    from open3d_slam_private_tpu_torch.ops.pointcloud import masked_centroid

    if "eigh" in names:
        tnm._normals_from_neighbors = tep.normals_with_candidate
        tnm.eigh3x3 = lambda A: (lambda s: (s["evals"], s["vecs"]))(tep.steps(A))
    if "centroid" in names:
        build = ticp.build_reference

        def build_reference(reference, cfg, centroid=None, const_size=False):
            if centroid is None:
                centroid = masked_centroid(reference, xla_order=True)
            return build(reference, cfg, centroid=centroid, const_size=const_size)

        ticp.build_reference = build_reference
    if "solve" in names:
        tmin.solve_spd_unrolled = _solve_fma
    if "compose" in names:
        ticp._advance = _advance_fma
    if "jax-undistort" in names:
        _jax_undistort()
    if "lapack-kkt" in names:
        from open3d_slam_private_tpu_torch.models import localizability as tloc

        tloc.solve_symmetric_indefinite = _lapack_kkt


def _first_scan(seed):
    """Both pipelines after the test's IMU boot and the first scan of ``seed``."""
    from test_torch_odometry import scene
    from test_torch_pipeline import _config, distorted_scan

    rng = np.random.default_rng(seed)
    S = scene(rng)
    jcfg = _config()
    jp = jpipe.SlamPipeline(jcfg)
    tp = tpipe.SlamPipeline(interop.config(tpipe.SlamConfig, jcfg), device="cpu")
    g_body = np.array([0.0, 9.81 * np.sin(0.02), 9.81 * np.cos(0.02)])
    for k in range(10):
        acc = g_body + 0.01 * rng.normal(size=3)
        jp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
        tp.add_imu(-0.1 + 0.005 * k, acc, [0.0, 0.0, 0.0])
    pts, times = distorted_scan(S, 0, seed=0)
    jb = jpc.from_points(pts, capacity=4096, extras={"times": times[:, None]})
    jp.process_scan(jb, 0.0)
    tp.process_scan(interop.point_batch(jb.xyz, jb.mask, {"times": jb.extras["times"]}), 0.0)
    return jp, tp


def _rows_equal(a, b, mask) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((a.view(np.int32) == b.view(np.int32)).reshape(len(a), -1).all(1)[mask].mean())


def op_table(seed=2):
    """Share of rows bit-equal to JAX's after the first scan of ``seed``: the
    submap bank, and the map reference's normals (with the port's code,
    then with the candidate)."""
    from open3d_slam_private_tpu_torch.slam import mapper as tmapper

    jp, tp = _first_scan(seed)
    jc, tc = jp.submaps.active.state.cloud, tp.submaps.active.state.cloud
    m = np.asarray(jc.mask)
    print(f"| seed {seed}, after scan 0 | the port's code | with the candidate |\n|---|---|---|")
    print(f"| bank xyz | {100 * _rows_equal(jc.xyz, tc.xyz, m):.1f}% | |")
    # The reference rebuilt from JAX's own bank, so that only the normals differ.
    bank = interop.point_batch(jc.xyz, jc.mask)
    center = torch.tensor(jp.pose[:3, 3], dtype=torch.float32)  # the rebuild's center at scan 0
    tcfg = tp.cfg.mapper
    rm = np.asarray(jp._ref.cloud.mask)
    own = tmapper.build_map_reference(bank, center, tcfg).cloud.normals
    use_repairs(("eigh",))
    fixed = tmapper.build_map_reference(bank, center, tcfg).cloud.normals
    want = jp._ref.cloud.normals
    print(f"| reference normals on JAX's bank | {100 * _rows_equal(want, own, rm):.1f}% "
          f"| {100 * _rows_equal(want, fixed, rm):.1f}% (eigh) |")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, help="run tests/torch_parity_seed.py's 9 steps")
    ap.add_argument("--repairs", default="",
                    help="candidates to wire in, comma-separated: eigh, centroid, solve, compose, "
                         "jax-undistort, lapack-kkt")
    ap.add_argument("--trace", action="store_true", help="compare each odometry call's bits")
    ap.add_argument("--jax-odometry", action="store_true",
                    help="the port's pipeline takes JAX's odometry pose (only the mapper parts)")
    args = ap.parse_args()
    if args.seed is None:
        op_table()
        return
    import torch_parity_seed

    use_repairs(tuple(r for r in args.repairs.split(",") if r))
    calls = trace_odometry() if args.trace else None
    torch_parity_seed.main(args.seed, 9, odometry_from_jax=args.jax_odometry)
    if calls is not None:
        print_trace(calls)


if __name__ == "__main__":
    main()

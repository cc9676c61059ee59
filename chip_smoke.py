"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the eight CUDA libraries from ``open3d_slam_private_tpu_torch/csrc``
(one nvcc per source, all started together; sm_90a, into
``build/torch_kernels/``) and holds each kernel against its plain PyTorch
version at its main path's shapes, with its wrapper time (CUDA events), its
device time per launch (``torch.profiler`` device-side kernel events, per
``__global__`` function where a wrapper launches several), its bound (bytes
over the card's memory rate or operations over its FP32 rate, the larger)
and, where one PyTorch call computes the same function, that call's time. K1
and K3 are also held to bit-identical reruns, K1 also bit for bit to its
order model (``tests/pair_gn_model.py``) at the SLAM step's 1 x 16,384 and
1 x 4,096 and the headline's 8 x 65,536; K2 also meets its checks on
inputs that stress its grouping by row (one row, distinct rows, row indices
out of range, every query masked, an empty row), and K4's table entry is
held bit for bit on the same stresses in K4's contract; K5 is also held on a
map-scale near-tie set and timed at the relocalisation burst's 2,097,152 x
65,536, with its plan (queries a thread, reference splits); normal_eq (the
normal equations in an order fixed by a problem's size) is held against the
float64 einsum, to its order model (``tests/normal_eq_model.py``) and to
giving a problem the same bits alone as in its batch, at the detection's 8 x
65,536 x 8, the burst's 4,096 x 512 x 1 and the SLAM step's 1 x 16,384 x 1
and 1 x 4,096 x 1;
moments (the cached rounds' moment sums, point-to-plane and GICP, and the
raw pair sums of the X-ICP analysis) likewise, a problem alone against the
same problem in a batch of 64, and its raw entry at every shape the paths
launch (recorded on the realtime, evaluation and batch-independence paths)
bit-equal to its numpy model (``tests/moments_model.py``), timed against
each group's ``t.sum(-2)`` and the launch floor (an empty kernel alone and
inside a captured graph); sym_eig (the Jacobi eigensolver of the X-ICP
solves, which a CUDA graph can hold) on every shape the chain hands it (the
headline's KKT matrices at 1 and 8 x 12 x 12 float64, the diagnostics' 6 x 6
float32, the ternary analysis's 3 x 3 blocks) against ``torch.linalg.eigh``,
a matrix alone against inside a batch of 64, with its sweeps and its share
of the chain floor the kernel's probe times on the card.
Then it drives the port's
paths through their user entry points: the ``SlamPipeline`` (LiDAR odometry
-> mapper -> submap collection, loop closure off) over a 96-scan synthetic
drive of 28.5 m that crosses the 20 m submap creation radius; the
``RealtimePipeline`` on the same drive and configs (realtime-64k: one
captured CUDA graph a scan, paced and throughput, its first scans held bit
for bit to the eager ``rt_step``, its kernels counted inside the graph from
profiler device events, and each kernel's device time inside a profiled
step replay), and the ``SlamPipeline`` again in
the evaluation protocol's configuration (``tools/run_eval.py``: the
mapper's direct in-round path, exact trimming, with X-ICP's ternary
method); the ``Mapper``
over a 30-scan sequence; a batch of 8 scan-to-map registrations
(``icp_batch``) with the gather kernel off and on, at knn = 8 (K3), with
the rank-select kernel (K4's table entry; K4's rows entry, the Pallas
kernel's contract, is on no path and is only held and timed), on the moment
path and on the direct in-round path; the same batch with GICP on its
moment path (BASELINE config 3);
``register_pair`` on the reference-exact
per-iteration chain with the grid, brute and brute_pallas (K5) matchers; and
``register_hypotheses``, the relocalisation burst of 4,096 seeds, with the
grid and brute_pallas matchers (the timed K5 leg rerun with each K5 call
held against the plain version, on 64 seeds against the same chain
with K5's plain version, and its first 64 poses held to the 64-seed chain's
bits; where they part, ``tests/torch_batch_dependence.py`` names the first
operation that does); and the moment (binary and ternary X-ICP), GICP moment, direct and
per-iteration GICP chains with a problem's bits independent of its batch. Each
path runs with every launch count set to 0 just
before it and read just after; the pipeline's profiled scans also give K1's
device time per launch at the SLAM step's shapes. Data come from fixed numpy
seeds. Every phase prints a line; any failure raises and exits non-zero. The
last stdout line is ``{"ok": true, "device": {...}}``. Without a CUDA card
it exits non-zero before printing any result.

    python3 chip_smoke.py --side DIR

runs the phases that compare two checkouts, from the checkout at ``DIR``
(see :func:`compare_side`), and

    python3 chip_smoke.py --side DIR --sym-eig

times that checkout's sym_eig on the matrices the last full run saved
(:func:`sym_eig_side`), and

    python3 chip_smoke.py --side DIR --moments

its moments on the inputs the last full run saved (:func:`moments_side`),
and

    python3 chip_smoke.py --side DIR --k1-normal-eq

its K1 and normal_eq on the inputs the last full run saved
(:func:`k1_normal_eq_side`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SCENE_POINTS = 400_000
SITE_POINTS = 900_000
SCAN_POINTS = 65_536
MAPPER_SCANS = 30
PIPELINE_SCANS = 96
PIPELINE_STEP_M = 0.3
PROFILE_SCANS = 6
BATCH = 8
HYPOTHESES = 4096
SKELETON_POINTS = 512
KERNEL_MODULES = {  # library name -> wrapper module
    "pair_gn": "pair_gn", "gather_select": "gather_select", "pair_gn_k": "pair_gn",
    "rank_select": "select", "knn_brute": "knn_brute", "normal_eq": "normal_eq",
    "moments": "moments", "sym_eig": "sym_eig",
}
_GROUPED = ("gather_select_count", "gather_select_rowsum", "gather_select_scan",
            "gather_select_scatter", "gather_select_rank")
# The launch floor's empty kernel, a measurement aid on no path of the port.
LAUNCH_FLOOR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "launch_floor.cu")
DEVICE_KERNELS = {  # wrapper -> the __global__ functions it launches
    "pair_gn": ("pair_gn_fused", "pair_gn_final"),
    "gather_select": _GROUPED,
    "pair_gn_k": ("pair_gn_k_partial", "pair_gn_k_final"),
    "rank_select_rows": ("rank_select_kernel",),
    "rank_select_table": _GROUPED,
    "knn_brute": ("knn_brute_pack", "knn_brute_kernel", "knn_brute_merge"),
    "normal_eq": ("normal_eq_partial", "normal_eq_final"),
    "moments": ("moments_raw", "moments_partial", "moments_final"),
    "sym_eig": ("sym_eig_kernel",),
}
# Published peaks of one H100 SXM (NVIDIA data sheet, at a 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# FP64 outside the tensor cores (NVIDIA's H100 SXM data sheet): sym_eig's
# float64 Jacobi.
PEAK_FP64_FLOP_PER_S = 34e12
# Operations counted per pair of K1/K3: the transform (18), difference and
# squared distance (8), residual (5), cross product (9), the weighted
# columns (6), the 21 + 6 products of A and b, w r^2 (2) and the 31 sums.
PAIR_GN_FLOPS = 106
# Per candidate of K2/K4: 3 differences, 3 squares, 2 sums; per pair of K5:
# the 3 products and 2 sums of the dot, the -2 scaling and 2 sums.
D2_FLOPS = 8
# Per pair of normal_eq: the difference (3) and residual (5), the cross
# product (9), the weighted columns (6), the 21 + 6 products and sums of A
# and b (54).
NORMAL_EQ_FLOPS = 77
# Per pair of the moments, counted as float32 work: a product and a sum for
# each of the 131 (point-to-plane) or 147 (GICP) sums, and the shared
# factors (point-to-plane: s = n.q, p0 p0^T, w n n^T, w s n, w s^2: 36;
# GICP: the 3x3 system of the two normals, its adjugate inverse and
# weight, M q, w q, |p0|^2, |q|^2: 86).
MOMENTS_P2PL_FLOPS = 2 * 131 + 36
MOMENTS_GICP_FLOPS = 2 * 147 + 86


# ---------------------------------------------------------------------------
# Synthetic data (numpy, fixed seeds).
# ---------------------------------------------------------------------------


def synth_scene(n_ref, seed=0):
    """LiDAR-like scene: ground plane + building walls."""
    rng = np.random.default_rng(seed)
    n_floor = n_ref // 2
    n_rest = n_ref - n_floor
    floor = np.c_[rng.uniform(-40, 40, (n_floor, 2)), rng.normal(0, 0.02, (n_floor, 1))]
    walls = []
    for i in range(8):
        m = n_rest // 8
        ang = 2 * np.pi * i / 8
        d = rng.uniform(10, 35)
        u = np.array([np.cos(ang), np.sin(ang)])
        t = rng.uniform(-12, 12, (m, 1))
        h = rng.uniform(0, 6, (m, 1))
        base = d * u[None, :] + t * np.array([[-u[1], u[0]]])
        walls.append(np.c_[base, h])
    pts = np.vstack([floor] + walls).astype(np.float32)
    return pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01


def sample_scan(scene, n, T_inv, seed, sensor=(4.0, 2.0, 1.5), wedge_deg=240.0,
                max_range=45.0, noise=0.015, outlier_frac=0.03):
    """A partial, noisy reading with clutter, in the frame ``T_inv`` maps to."""
    rng = np.random.default_rng(seed)
    s = np.asarray(sensor, np.float32)
    rel = scene - s[None, :]
    az = np.degrees(np.arctan2(rel[:, 1], rel[:, 0]))
    r = np.linalg.norm(rel, axis=1)
    idx = np.flatnonzero((np.abs(az) <= wedge_deg / 2.0) & (r <= max_range))
    n_out = int(n * outlier_frac)
    sel = rng.choice(idx, size=n - n_out, replace=len(idx) < n - n_out)
    pts = scene[sel] + rng.normal(size=(n - n_out, 3)).astype(np.float32) * noise
    clutter = np.c_[
        rng.uniform(-20, 20, (n_out, 2)), rng.uniform(0.2, 3.0, (n_out, 1))
    ].astype(np.float32) + s[None, :] * np.array([1, 1, 0], np.float32)
    pts = np.vstack([pts, clutter]).astype(np.float32)
    R, t = np.asarray(T_inv)[:3, :3], np.asarray(T_inv)[:3, 3]
    return (pts @ R.T + t).astype(np.float32)


def exp_se3_np(twist):
    from open3d_slam_private_tpu_torch.geometry import se3

    return se3.exp_se3(torch.as_tensor(twist, dtype=torch.float64)).numpy()


def rot_angle(R):
    """Rotation angle of R; atan2 of the skew and symmetric parts stays exact
    for small angles of a float32 (not exactly orthonormal) matrix."""
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(np.linalg.norm(skew) / 2, (np.trace(R) - 1) / 2))


def cuda_ms(fn, reps=20, rounds=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build():
    """Build every kernel, one nvcc process per source, all at once."""
    import importlib

    from open3d_slam_private_tpu_torch.kernels import _build

    t = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_MODULES) + 1) as pool:
        floor = pool.submit(_build.build, "launch_floor", LAUNCH_FLOOR_SRC)
        libs = dict(zip(KERNEL_MODULES, pool.map(_build.build, KERNEL_MODULES)))
        libs["launch_floor"] = floor.result()
    for name, module in KERNEL_MODULES.items():
        mod = importlib.import_module(f"open3d_slam_private_tpu_torch.kernels.{module}")
        argtypes = mod._LAUNCH_K_ARGTYPES if name == "pair_gn_k" else mod._LAUNCH_ARGTYPES
        _build.load(name, argtypes)
    say("build", seconds=round(time.time() - t, 3), flags=" ".join(_build.NVCC_FLAGS),
        libs={k: str(v) for k, v in libs.items()})


def headline_setup(dev):
    """Map reference + 8 readings of the bench headline, on ``dev``."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig
    from open3d_slam_private_tpu_torch.ops import pointcloud as pc
    from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample
    from open3d_slam_private_tpu_torch.slam.mapper import MapperConfig, build_map_reference

    xicp_cfg = icp_mod.ICPConfig(
        knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 16,
        grid_bucket_cap=48, trimmed_ratio=0.9, minimizer="point_to_plane",
        max_iterations=10, min_diff_rot=1e-3, min_diff_trans=8e-3,
        coarse_iterations=20, coarse_stride=8, candidate_refresh_every=10,
        candidate_slack=0.25, fused_kernel=True, fast_trimming=True,
        degeneracy=DegeneracyConfig(
            method="optimized", enough_information_threshold=250.0,
            insufficient_information_threshold=180.0,
        ),
    )
    scene = synth_scene(SCENE_POINTS)
    submap = pc.from_points(scene, capacity=512 * 1024, device=dev)
    submap = voxel_downsample(submap, 0.15, capacity=131072,
                              priority_center=torch.zeros(3, device=dev))
    ref = build_map_reference(submap, torch.zeros(3, device=dev), MapperConfig(icp=xicp_cfg))
    T_trues, scans = [], []
    for i in range(BATCH):
        twist = np.array([0.01, -0.008, 0.012, 0.08, -0.05, 0.03]) * (1 + 0.1 * i)
        T_true = exp_se3_np(twist)
        scans.append(pc.from_points(
            sample_scan(scene, SCAN_POINTS, np.linalg.inv(T_true), seed=i),
            capacity=SCAN_POINTS, device=dev))
        T_trues.append(T_true)
    perturb = exp_se3_np([0.012, -0.008, 0.015, 0.06, 0.05, -0.06])
    init = torch.as_tensor(np.stack([T @ perturb for T in T_trues]), dtype=torch.float32, device=dev)
    # The reference cloud as a user holds it (uncentred, with its normals),
    # for the entry points that build their own reference.
    c = ref.cloud
    cloud = pc.PointBatch(xyz=torch.where(c.mask[:, None], c.xyz + ref.centroid, c.xyz),
                          mask=c.mask, extras=dict(c.extras))
    return dict(cfg=xicp_cfg, scene=scene, ref=ref, ref_cloud=cloud,
                readings=pc.stack(scans), init=init, T_trues=np.stack(T_trues))


def bound(nbytes, flops, peak_flops=PEAK_FP32_FLOP_PER_S):
    """The least time (ms) the card could take for a call: the bytes it must
    move over the memory rate, or its operations over the FP32 rate (or the
    rate ``peak_flops`` of their type), whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=int(nbytes), flops=int(flops))


def event_device_us(evt, self_time=True):
    """Device microseconds of a ``key_averages()`` entry (the attribute was
    renamed from ``cuda`` to ``device`` across PyTorch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_time
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        value = getattr(evt, name, None)
        if value:
            return float(value)
    return 0.0


def device_us_per_call(fn, kernels, reps=10):
    """Device microseconds per call of ``fn`` spent in the ``__global__``
    functions named in ``kernels``: their device-side events in a
    ``torch.profiler`` trace of ``reps`` calls (None if two traces hold
    none), and the same per function."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # the profiler now and then records no device event: one more session then
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        per = {k: sum(event_device_us(e) for e in avgs if k in e.key) / reps for k in kernels}
        total = sum(per.values())
        if total > 0:
            return total, per
    return None, per


def timed(name, fn, plain_fn, nbytes, flops, library_fn=None, plain_reps=20,
          peak_flops=PEAK_FP32_FLOP_PER_S):
    """Wrapper ms (CUDA events), plain ms, device us per launch (profiler),
    the bound and its share, and the library call's ms where there is one
    (one call after a warm-up: K5's takes seconds)."""
    device_us, per_kernel = device_us_per_call(fn, DEVICE_KERNELS[name])
    out = dict(ms=cuda_ms(fn),
               plain_ms=cuda_ms(plain_fn, reps=plain_reps, rounds=3 if plain_reps < 20 else 5),
               device_us=device_us, **bound(nbytes, flops, peak_flops))
    if len(per_kernel) > 1:
        out["device_us_by_kernel"] = per_kernel
    out["bound_share"] = (out["bound_ms"] * 1e3 / out["device_us"]) if out["device_us"] else None
    out["library_ms"] = cuda_ms(library_fn, reps=1, rounds=1) if library_fn is not None else None
    return out


def pair_gn_cost(B, N, K=1):
    """Bytes and operations of K1 (K = 1) or K3: each point's reading, each
    pair's xyz, normal and valid byte read once, T and tau, 31 sums out."""
    nbytes = B * N * 12 + B * N * K * 25 + B * (64 + 4) + B * 31 * 4
    return nbytes, B * N * K * PAIR_GN_FLOPS


def _check_pair_gn(args, name):
    """K1 or K3 against the float64 sum of the plain version's terms: the
    exact counts equal, the sums within 1e-5 of their magnitude; a second
    call gives the same bits; K1 also bit for bit against its order model
    (``tests/pair_gn_model.py``)."""
    from open3d_slam_private_tpu_torch.kernels import pair_gn as pgk

    B = args[0].shape[0]
    kernel = pgk.pair_gn if name == "pair_gn" else pgk.pair_gn_k
    plain = pgk.pair_gn_fp64 if name == "pair_gn" else pgk.pair_gn_k_plain
    got_parts = kernel(*args)
    got = torch.cat([x.reshape(B, -1) for x in got_parts], 1)
    again = torch.cat([x.reshape(B, -1) for x in kernel(*args)], 1)
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise RuntimeError(f"{name}: two calls on the same inputs gave different bits")
    want = torch.cat([x.reshape(B, -1) for x in plain(*args)], 1)
    terms = (pgk.terms if name == "pair_gn" else pgk.terms_k)(*args).double()
    ref64, scale = pgk.unpack(terms.sum(1)), pgk.unpack(terms.abs().sum(1))
    del terms
    torch.cuda.synchronize()
    worst = 0.0
    for k, (g, r, sc) in enumerate(zip(got_parts, ref64, scale)):
        if k in (2, 4):  # sum_w, n_ok: exact counts
            if not torch.equal(g.double(), r):
                raise RuntimeError(f"{name} output {k} is not exact: {g} vs {r}")
            continue
        worst = max(worst, float(((g.double() - r).abs() / (1e-5 * (sc + 1.0))).max()))
    if worst > 1.0:
        raise RuntimeError(f"{name} disagrees with the fp64 sum ({worst:.3g} x tolerance)")
    out = dict(worst_over_tolerance=worst, max_abs_err=float((got - want).abs().max()),
               max_abs_output=float(want.abs().max()), bit_identical_rerun=True)
    if name == "pair_gn":
        model = _tests_module("pair_gn_model").k1_model(*(a.cpu().numpy() if torch.is_tensor(a) else a
                                                          for a in args))
        if not np.array_equal(got.cpu().numpy().view(np.int32), model.view(np.int32)):
            raise RuntimeError("pair_gn differs from its order model (tests/pair_gn_model.py)")
        out["model_bit_equal"] = True
    return out


def _check_gather_select(table, h, q, m):
    """K2 against its plain version: ids agree on >= 99.99% of the queries,
    where they do not the distances tie within 1e-6, the agreeing rows'
    first 8 words are the same bits, occupancy agrees everywhere."""
    from open3d_slam_private_tpu_torch.kernels import gather_select as gsk

    got = gsk.gather_select(table, h, q, m)
    want = gsk.gather_select_plain(table, h, q, m)
    torch.cuda.synchronize()
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    same = gi[:, 3] == wi[:, 3]
    agree = float(same.float().mean())
    gd, wd = got[:, 7], want[:, 7]
    tie_ok = bool(((gd - wd).abs() <= 1e-6 * wd.abs())[~same].all())
    bits_ok = bool((gi[same][:, :8] == wi[same][:, :8]).all())
    occ_ok = bool((got[:, 8] == want[:, 8]).all())
    fin = same & torch.isfinite(wd)
    err = float((got[fin][:, :8] - want[fin][:, :8]).abs().max()) if bool(fin.any()) else 0.0
    if not (agree >= 0.9999 and tie_ok and bits_ok and occ_ok):
        raise RuntimeError(f"gather_select disagrees with its plain version: agree={agree} "
                           f"ties_ok={tie_ok} bits_ok={bits_ok} occupancy_ok={occ_ok}")
    return dict(id_agreement=agree, bitwise_rows=float((gi == wi).all(1).float().mean()),
                max_abs_err=err)


def grouped_select_bytes(h, m, cap, slot_bytes, winner_bytes):
    """The bytes K2 or K4's table entry must move in one call: ``slot_bytes``
    of every slot of each row an unmasked query touches (what ranking and
    occupancy read), the occupancy word (4 B) of every slot of a row only
    masked queries touch, and per query its row index, xyz and mask byte,
    ``winner_bytes`` of the winner's payload beyond those words, and its
    64-byte output row. Also the sector floor of reading each touched row
    whole (32 B a slot: a slot's words share its 32-byte sectors)."""
    rows_valid = int(torch.unique(h[m.bool()]).numel())
    rows_all = int(torch.unique(h).numel())
    n = h.shape[0]
    per_query = 4 + 12 + 1 + 64
    nbytes = rows_valid * cap * slot_bytes + (rows_all - rows_valid) * cap * 4 + n * (per_query + winner_bytes)
    floor_ms = bound(rows_all * cap * 32 + n * per_query, 0)["bound_ms"]
    return dict(bytes=nbytes, rows_touched=rows_all, sector_floor_ms=floor_ms)


def k2_row_sharing(h, table_size, run=256):
    """How K2's queries share rows: distinct rows per run of ``run``
    consecutive queries (mean, max), and queries per touched row (mean,
    p99, max). Counts only; ``python -c "import chip_smoke as c;
    c.headline_row_sharing()"`` gives them for the headline on the CPU."""
    hl = h.long()[(h >= 0) & (h < table_size)]
    per_row = torch.bincount(hl, minlength=table_size)
    touched = per_row[per_row > 0].double()
    runs = hl[: hl.numel() // run * run].reshape(-1, run).sort(dim=1).values
    distinct = 1 + (runs[:, 1:] != runs[:, :-1]).sum(1).double()
    return dict(rows_touched=int(touched.numel()), run=run,
                distinct_rows_per_run_mean=float(distinct.mean()),
                distinct_rows_per_run_max=int(distinct.max()),
                queries_per_row_mean=float(touched.mean()),
                queries_per_row_p99=float(torch.quantile(touched, 0.99)),
                queries_per_row_max=int(touched.max()))


def headline_row_sharing(dev=None):
    """:func:`k2_row_sharing` of the headline's K2 queries (the first
    round's, as ``phase_kernels`` forms them), on ``dev`` (default CPU)."""
    from open3d_slam_private_tpu_torch.geometry import se3
    from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod

    dev = torch.device("cpu") if dev is None else dev
    hs = headline_setup(dev)
    shift = torch.eye(4, device=dev)
    shift[:3, 3] = -hs["ref"].centroid
    src0 = se3.apply_transform((shift @ hs["init"]).contiguous(), hs["readings"].xyz)
    grid = hs["ref"].grid
    stats = k2_row_sharing(cell_mod.query_hash(grid, src0).reshape(-1), grid.table_size)
    say("k2_row_sharing", device=str(dev), queries=int(src0.shape[0] * src0.shape[1]), **stats)
    return stats


def stress_cases(table, h, q, m, by_coords=False):
    """Inputs that stress the grouping by row, built from the headline's:
    every query in one row (2,048 blocks' worth), the first T queries each
    in its own row, every query masked, half the queries in a row whose
    slots are all empty and, in K2's contract only, every 7th row index
    negative and every 7th (offset 3) past the table. An empty row has ids
    -1 in K2's contract and the padding payload (xyz 1e9) in K4's
    (``by_coords``), where a row index outside [0, T) is outside the
    contract."""
    from open3d_slam_private_tpu_torch.ops.grid_hash import empty_payload

    T, n = table.shape[0], h.shape[0]
    gen = torch.Generator(device=h.device).manual_seed(11)
    emptied = table.clone()
    if by_coords:
        emptied[int(h[0])] = empty_payload(table.shape[1], h.device)
    else:
        emptied.view(torch.int32)[int(h[0]), :, 3] = -1
    half = h.clone()
    half[: n // 2] = h[0]
    k = min(n, T)
    cases = {
        "one_row": (table, torch.full_like(h, int(h[0])), q, m),
        "distinct_rows": (table, torch.randperm(T, generator=gen, device=h.device)[:k].to(torch.int32),
                          q[:k].contiguous(), m[:k].contiguous()),
        "all_masked": (table, h, q, torch.zeros_like(m)),
        "empty_row": (emptied, half, q, m),
    }
    if not by_coords:
        oob = h.clone()
        oob[::7] = -1 - torch.arange(oob[::7].numel(), device=h.device, dtype=torch.int32)
        oob[3::7] = T + torch.arange(oob[3::7].numel(), device=h.device, dtype=torch.int32)
        cases["out_of_range"] = (table, oob, q, m)
    return cases


def phase_kernels(hs):
    """Each kernel against its plain version on one matching round of the
    headline batch (main-path shapes and data); K1 also at the SLAM step's
    shape (one problem of 16,384 points), its main path in this run."""
    from open3d_slam_private_tpu_torch.geometry import se3
    from open3d_slam_private_tpu_torch.kernels import gather_select as gsk
    from open3d_slam_private_tpu_torch.kernels import pair_gn as pgk
    from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod
    from open3d_slam_private_tpu_torch.ops.grid_hash import match_from_candidates
    from open3d_slam_private_tpu_torch.ops.outliers import trimmed_dist_limit

    ref, readings, cfg = hs["ref"], hs["readings"], hs["cfg"]
    B, N = readings.mask.shape
    dev = readings.xyz.device
    shift = torch.eye(4, device=dev)
    shift[:3, 3] = -ref.centroid
    T = (shift @ hs["init"]).contiguous()
    src0 = se3.apply_transform(T, readings.xyz)
    grid = ref.grid
    cap = grid.list_cap
    results = []

    # K2: gather + rank + select over B*N queries of the 2^16 x 48 table.
    h = cell_mod.query_hash(grid, src0).reshape(-1).contiguous()
    q = src0.reshape(-1, 3).contiguous()
    m = readings.mask.reshape(-1).contiguous()
    check = _check_gather_select(grid.table, h, q, m)
    adversarial = {name: _check_gather_select(*args)
                   for name, args in stress_cases(grid.table, h, q, m).items()}
    say("kernel_check", name="gather_select", **{k: v["id_agreement"] for k, v in adversarial.items()})
    # Bytes: a slot's xyz and id (rank and occupancy), the winner's normal.
    need = grouped_select_bytes(h, m, cap, slot_bytes=16, winner_bytes=12)
    sharing = k2_row_sharing(h, grid.table_size)
    k2 = timed("gather_select", lambda: gsk.gather_select(grid.table, h, q, m),
               lambda: gsk.gather_select_plain(grid.table, h, q, m),
               need["bytes"], int(m.sum()) * cap * D2_FLOPS)
    say("kernel", name="gather_select", queries=B * N, table=list(grid.table.shape),
        rows_touched=need["rows_touched"], sector_floor_ms=need["sector_floor_ms"],
        row_sharing=sharing, **check, **k2,
        adversarial_id_agreement={k: v["id_agreement"] for k, v in adversarial.items()})
    results.append(dict(
        name="gather_select", route="cuda",
        source="open3d_slam_private_tpu_torch/csrc/gather_select.cu",
        replaces="open3d_slam_private_tpu/kernels/gather_select_pallas.py:207",
        max_abs_err=check["max_abs_err"], **k2,
        adversarial_id_agreement={k: v["id_agreement"] for k, v in adversarial.items()}))

    # K1: one in-round GN linearisation on that round's pairs, at the
    # headline's 8 x 65,536 and at the SLAM step's 1 x 16,384 (odometry and
    # the mapper's fine rounds) and 1 x 4,096 (the coarse rounds, stride 4).
    rows, valid = cell_mod.gather_cell_candidates(grid, src0, readings.mask)
    res0 = match_from_candidates(rows, valid, src0, readings.mask, cfg.max_match_dist)
    del rows, valid
    tau = trimmed_dist_limit(res0.dists, res0.valid(), cfg.trimmed_ratio, cfg.max_match_dist**2)
    args8 = (readings.xyz.contiguous(), res0.xyz[:, :, 0].contiguous(),
             res0.normals[:, :, 0].contiguous(), res0.valid()[:, :, 0].contiguous(), T,
             tau.contiguous(), cfg.max_match_dist**2)
    n1 = 16384
    args1 = tuple(a[:1, :n1].contiguous() for a in args8[:4]) + (T[:1].contiguous(),
                                                                  tau[:1].contiguous(), args8[6])
    args4 = tuple(a[:1, :n1:4].contiguous() for a in args8[:4]) + args1[4:]
    k1 = {}
    k1_inputs = {"1x16384": args1, "1x4096": args4, "8x65536": args8}
    for shape, args in k1_inputs.items():
        check = _check_pair_gn(args, "pair_gn")
        k1[shape] = dict(**check, **timed("pair_gn", lambda a=args: pgk.pair_gn(*a),
                                          lambda a=args: pgk.pair_gn_plain(*a),
                                          *pair_gn_cost(*args[3].shape)))
        say("kernel", name="pair_gn", shape=shape, **k1[shape])
    main_k1 = {k: v for k, v in k1["1x16384"].items() if k not in ("worst_over_tolerance", "max_abs_output")}
    results.insert(0, dict(
        name="pair_gn", route="cuda", source="open3d_slam_private_tpu_torch/csrc/pair_gn.cu",
        replaces="open3d_slam_private_tpu/kernels/pair_gn_pallas.py:261", shape="1x16384",
        **main_k1, at_coarse_1x4096=k1["1x4096"], at_headline_8x65536=k1["8x65536"]))
    saved = {f"pair_gn {k}": [a.cpu() if torch.is_tensor(a) else a for a in v] for k, v in k1_inputs.items()}
    del args8, args1, args4, res0, k1_inputs

    results.append(_check_pair_gn_k(ref, readings, cfg, T, src0))
    results.append(_check_rank_select(grid, h, q, m))
    results.append(_check_rank_select_table(grid, h, q, m))
    results.append(_check_knn_brute(ref, src0))
    results.append(_check_normal_eq(ref, readings, cfg, src0, saved))
    os.makedirs(os.path.dirname(K1_NORMAL_EQ_INPUTS), exist_ok=True)
    torch.save(saved, K1_NORMAL_EQ_INPUTS)
    del saved
    results.append(_check_moments(hs, T, src0))
    results.append(_check_sym_eig(hs))
    return results


def _check_pair_gn_k(ref, readings, cfg, T, src0):
    """K3: one in-round GN linearisation on the headline batch matched at
    knn = 8 (B x N x 8 pairs)."""
    from open3d_slam_private_tpu_torch.kernels import pair_gn as pgk
    from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod
    from open3d_slam_private_tpu_torch.ops.grid_hash import match_from_candidates
    from open3d_slam_private_tpu_torch.ops.outliers import trimmed_dist_limit

    B, N = readings.mask.shape
    rows, valid = cell_mod.gather_cell_candidates(ref.grid, src0, readings.mask)
    res = match_from_candidates(rows, valid, src0, readings.mask, cfg.max_match_dist, 8)
    del rows, valid
    tau = trimmed_dist_limit(res.dists, res.valid(), cfg.trimmed_ratio, cfg.max_match_dist**2)
    args = (readings.xyz.contiguous(), res.xyz.contiguous(), res.normals.contiguous(),
            res.valid().contiguous(), T, tau.contiguous(), cfg.max_match_dist**2)
    check = _check_pair_gn(args, "pair_gn_k")
    t = timed("pair_gn_k", lambda: pgk.pair_gn_k(*args), lambda: pgk.pair_gn_k_plain(*args),
              *pair_gn_cost(B, N, 8), plain_reps=5)
    say("kernel", name="pair_gn_k", problems=B, points=N, pairs_per_point=8,
        valid_pairs=int(args[3].sum()), **check, **t)
    return dict(name="pair_gn_k", route="cuda",
                source="open3d_slam_private_tpu_torch/csrc/pair_gn_k.cu",
                replaces="open3d_slam_private_tpu/kernels/pair_gn_pallas.py:136",
                max_abs_err=check["max_abs_err"], **t)


def _check_rank_select(grid, h, q, m):
    """K4's rows entry, the Pallas kernel's contract: rank + select over the
    B x N query rows of the headline table, gathered beforehand. No path
    of the port launches it: the select leg reads the rows in place
    (:func:`_check_rank_select_table`)."""
    from open3d_slam_private_tpu_torch.kernels import select as selk

    rows = grid.table.reshape(grid.table_size, -1)[h.long()]
    got = selk.rank_select_rows(rows, q, m)
    want = selk.rank_select_rows_plain(rows, q, m)
    torch.cuda.synchronize()
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    agree = float((gi[:, 3] == wi[:, 3]).float().mean())
    bitwise = float((gi == wi).all(1).float().mean())
    err = float((got - want).abs().nan_to_num(0.0).max())
    if not (agree == 1.0 and bitwise == 1.0):
        raise RuntimeError(f"rank_select_rows disagrees with its plain version: id agreement "
                           f"{agree}, bitwise rows {bitwise}")
    # Bytes: the xyz of every slot of an unmasked query's row (the x alone
    # of a masked one's, for the occupancy), the winner's id and normal,
    # the query and its mask, 16 floats out. The sector floor is noted
    # beside it: each 32-byte slot of the [N, cap * 8] rows interleaves xyz
    # and id with the normal, and DRAM moves 32-byte sectors, so this layout
    # moves the whole tensor.
    n, cap, valid = rows.shape[0], grid.list_cap, int(m.sum())
    t = timed("rank_select_rows", lambda: selk.rank_select_rows(rows, q, m),
              lambda: selk.rank_select_rows_plain(rows, q, m),
              valid * cap * 12 + (n - valid) * cap * 4 + n * (16 + 12 + 1 + 64),
              valid * cap * D2_FLOPS, plain_reps=5)
    floor_ms = bound(n * (cap * 32 + 12 + 1 + 64), 0)["bound_ms"]
    # The rows' producer, the torch gather the parent's select leg ran
    # before K4's rows entry.
    gather_us = session_device_us(lambda: grid.table.reshape(grid.table_size, -1)[h.long()], reps=5)
    say("kernel", name="rank_select_rows", queries=n, table=list(grid.table.shape),
        id_agreement=agree, bitwise_rows=bitwise, max_abs_err=err, sector_floor_ms=floor_ms,
        producer_gather_device_us=gather_us, **t)
    return dict(name="rank_select_rows", route="cuda",
                source="open3d_slam_private_tpu_torch/csrc/rank_select.cu",
                replaces="open3d_slam_private_tpu/kernels/select_pallas.py:117",
                max_abs_err=err, producer_gather_device_us=gather_us, **t)


def session_device_us(fn, reps=10):
    """Device microseconds per call of ``fn``: every device-side event of
    a ``torch.profiler`` session of ``reps`` calls (None if the trace holds
    none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = profiled_device_ms(prof)[0]
    return None if ms is None else ms * 1e3 / reps


def _check_rank_select_table(grid, h, q, m):
    """K4's table entry: the headline round's queries against the cell list
    read in place, and :func:`stress_cases` in K4's contract, each held bit
    for bit against the plain version (the rows gathered, then K4's plain
    rank)."""
    from open3d_slam_private_tpu_torch.kernels import select as selk

    table = grid.table
    cap, n = table.shape[1], h.shape[0]
    cases = dict(headline=(table, h, q, m), **stress_cases(table, h, q, m, by_coords=True))
    bitwise, err = {}, 0.0
    for name, args in cases.items():
        got, want = selk.rank_select_table(*args), selk.rank_select_table_plain(*args)
        torch.cuda.synchronize()
        bitwise[name] = float((got.view(torch.int32) == want.view(torch.int32)).all(1).float().mean())
        if bitwise[name] != 1.0:
            raise RuntimeError(f"rank_select_table disagrees with its plain version on {name}: "
                               f"bitwise rows {bitwise[name]}")
        if name == "headline":
            err = float((got - want).abs().nan_to_num(0.0).max())
    del cases
    say("kernel_check", name="rank_select_table", **bitwise)
    # Bytes: a slot's xyz (rank; x is the occupancy), the winner's id and
    # normal.
    need = grouped_select_bytes(h, m, cap, slot_bytes=12, winner_bytes=16)
    t = timed("rank_select_table", lambda: selk.rank_select_table(table, h, q, m),
              lambda: selk.rank_select_table_plain(table, h, q, m),
              need["bytes"], int(m.sum()) * cap * D2_FLOPS, plain_reps=5)
    say("kernel", name="rank_select_table", queries=n, table=list(table.shape),
        rows_touched=need["rows_touched"], sector_floor_ms=need["sector_floor_ms"],
        bitwise_rows=bitwise, max_abs_err=err, **t)
    return dict(name="rank_select_table", route="cuda",
                source="open3d_slam_private_tpu_torch/csrc/gather_select.cu",
                replaces="open3d_slam_private_tpu/kernels/select_pallas.py:117",
                max_abs_err=err, bitwise_rows=bitwise, **t)


def _normal_eq_fp64(src, q, n, w):
    """The plain version's function in float64 (A, b) and the same sums of
    its terms' magnitudes (the scale of each entry)."""
    p = src.double()[:, :, None, :].expand(q.shape)
    nn = n.double()
    cols = torch.cat([torch.linalg.cross(p, nn), nn], -1)
    r = ((p - q.double()) * nn).sum(-1)
    cw = cols * w.double()[..., None]
    return (torch.einsum("bnki,bnkj->bij", cw, cols), -torch.einsum("bnki,bnk->bi", cw, r),
            torch.einsum("bnki,bnkj->bij", cw.abs(), cols.abs()),
            torch.einsum("bnki,bnk->bi", cw.abs(), r.abs()))


def _check_normal_eq(ref, readings, cfg, src0, saved=None):
    """normal_eq: the X-ICP detection's normal equations on the headline
    batch matched at knn = 8 (8 x 65,536 x 8 pairs, the round's frozen trim
    weights), at the relocalisation burst's 4,096 x 512 x 1 (the same
    pairs, knn = 1, four times over), and at the SLAM step's detections,
    1 x 16,384 x 1 (odometry and the mapper's fine rounds: the first
    problem's first 16,384 points, knn = 1) and 1 x 4,096 x 1 (the coarse
    rounds: every fourth of those). Held against the float64 einsum within
    1e-5 of each entry's scale and bit for bit against the order model
    (``tests/normal_eq_model.py``; the first problem of the detection
    shape, the first 64 of the burst); a rerun and each problem run alone
    (the first three as a batch of 1) give the same bits; timed against the
    plain float32 einsum (its two cuBLAS einsums alone are ``library_ms``).
    ``saved`` (a dict) takes each shape's inputs (CPU copies)."""
    from open3d_slam_private_tpu_torch.kernels import normal_eq as nek
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod
    from open3d_slam_private_tpu_torch.ops.grid_hash import match_from_candidates
    from open3d_slam_private_tpu_torch.ops.outliers import trimmed_dist_limit

    rows, valid = cell_mod.gather_cell_candidates(ref.grid, src0, readings.mask)
    res = match_from_candidates(rows, valid, src0, readings.mask, cfg.max_match_dist, 8)
    del rows, valid
    tau = trimmed_dist_limit(res.dists, res.valid(), cfg.trimmed_ratio, cfg.max_match_dist**2)
    w = icp_mod._weights(res, cfg, trim_limit=tau)
    knn8 = (src0.contiguous(), res.xyz.contiguous(), res.normals.contiguous(), w.contiguous())
    del res
    S = SKELETON_POINTS
    reps = HYPOTHESES * S // (src0.shape[0] * src0.shape[1])
    first = (knn8[0].reshape(-1, S, 3), knn8[1][:, :, 0].reshape(-1, S, 1, 3),
             knn8[2][:, :, 0].reshape(-1, S, 1, 3), knn8[3][:, :, 0].reshape(-1, S, 1))
    burst = tuple(x.repeat(reps, *([1] * (x.dim() - 1))).contiguous() for x in first)
    slam16 = (knn8[0][:1, :16384].contiguous(),) + tuple(x[:1, :16384, :1].contiguous() for x in knn8[1:])
    slam4 = tuple(x[:, ::4].contiguous() for x in slam16)
    model = _tests_module("normal_eq_model").ne_model
    out = {}
    for shape, args in (("8x65536x8", knn8), (f"{HYPOTHESES}x{SKELETON_POINTS}x1", burst),
                        ("1x16384x1", slam16), ("1x4096x1", slam4)):
        B, N, K = args[3].shape
        if saved is not None:
            saved[f"normal_eq {shape}"] = [x.cpu() for x in args]
        A, b = nek.normal_eq(*args)
        A2, b2 = nek.normal_eq(*args)
        alone = [nek.normal_eq(*(x[i:i + 1].contiguous() for x in args)) for i in range(min(3, B))]
        torch.cuda.synchronize()
        same = lambda x, y: torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
        if not (same(A, A2) and same(b, b2)):
            raise RuntimeError(f"normal_eq at {shape}: two calls gave different bits")
        if not all(same(A[i:i + 1], a) and same(b[i:i + 1], bb) for i, (a, bb) in enumerate(alone)):
            raise RuntimeError(f"normal_eq at {shape}: a problem alone differs from it in the batch")
        A64, b64, sA, sb = _normal_eq_fp64(*args)
        worst = max(float(((A.double() - A64).abs() / (1e-5 * (sA + 1.0))).max()),
                    float(((b.double() - b64).abs() / (1e-5 * (sb + 1.0))).max()))
        if worst > 1.0:
            raise RuntimeError(f"normal_eq at {shape} disagrees with the fp64 einsum "
                               f"({worst:.3g} x tolerance)")
        del A64, b64, sA, sb
        head = min(B, 1 if K > 1 else 64)
        want = model(*(x[:head].cpu().numpy() for x in args))
        got = torch.cat([A[:head].reshape(head, 36), b[:head]], 1).cpu().numpy()
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise RuntimeError(f"normal_eq at {shape} differs from its order model (tests/normal_eq_model.py)")
        pA, pb = nek.normal_eq_plain(*args)
        err = max(float((A - pA).abs().max()), float((b - pb).abs().max()))
        p = args[0][:, :, None, :].expand(args[1].shape)
        cols = torch.cat([torch.linalg.cross(p, args[2]), args[2]], -1)
        r = ((p - args[1]) * args[2]).sum(-1)
        cw = cols * args[3][..., None]

        def library(cw=cw, cols=cols, r=r):  # the plain version's two cuBLAS einsums alone
            return torch.einsum("...nmi,...nmj->...ij", cw, cols), torch.einsum("...nmi,...nm->...i", cw, r)

        # Bytes: each point, each pair's weight, the match and normal of a
        # weighted pair only (the kernel skips a pair of weight 0, which adds
        # nothing), A and b out; operations of the weighted pairs. The
        # sector floor of reading every pair's match and normal beside it.
        weighted = int((args[3] != 0).sum())
        t = timed("normal_eq", lambda a=args: nek.normal_eq(*a), lambda a=args: nek.normal_eq_plain(*a),
                  B * N * 12 + B * N * K * 4 + weighted * 24 + B * 42 * 4, weighted * NORMAL_EQ_FLOPS,
                  library_fn=library, plain_reps=5)
        del cols, r, cw
        floor_ms = bound(B * N * 12 + B * N * K * 28 + B * 42 * 4, 0)["bound_ms"]
        out[shape] = dict(worst_over_tolerance=worst, max_abs_err=err, weighted_pairs=weighted,
                          pairs=B * N * K, sector_floor_ms=floor_ms, bit_identical_rerun=True,
                          batch_independent=True, model_bit_equal_problems=head,
                          plan=list(nek.ne_plan(N * K)), **t)
        say("kernel", name="normal_eq", shape=shape, **out[shape])
    main = {k: v for k, v in out["8x65536x8"].items() if k != "worst_over_tolerance"}
    return dict(name="normal_eq", route="cuda", source="open3d_slam_private_tpu_torch/csrc/normal_eq.cu",
                replaces="open3d_slam_private_tpu/models/minimizers.py:65",
                replaces_note="an XLA computation of the JAX package, not a Pallas kernel",
                shape="8x65536x8", **main, at_burst=out[f"{HYPOTHESES}x{SKELETON_POINTS}x1"],
                at_slam_1x16384x1=out["1x16384x1"], at_slam_1x4096x1=out["1x4096x1"])


def gicp_readings(hs):
    """The headline's 8 readings with GICP's reading normals as the bench
    makes them (``bench.py:828-835``): a hash grid of each reading itself
    (cell 0.5 m, 2^16 x 32) and 8 neighbours within 0.5 m. Made once."""
    if "gicp_readings" not in hs:
        from open3d_slam_private_tpu_torch.ops import grid_hash
        from open3d_slam_private_tpu_torch.ops import normals as normals_mod
        from open3d_slam_private_tpu_torch.ops import pointcloud as pc

        r = hs["readings"]
        scans = []
        for b in range(r.xyz.shape[0]):
            s = pc.PointBatch(xyz=r.xyz[b], mask=r.mask[b])
            g = grid_hash.build_grid(s.padded_xyz(), s.mask, 0.5, 1 << 16, 32)
            scans.append(normals_mod.estimate_normals_grid(s, g, knn=8, max_dist=0.5))
        hs["gicp_readings"] = pc.stack(scans)
    return hs["gicp_readings"]


def _moments_fp64(kind, p0, q, n, w, ns=None, epsilon=1e-3):
    """The moments in float64 and the sums of their terms' magnitudes (each
    entry's scale), as flat ``[B, S]`` rows."""
    from open3d_slam_private_tpu_torch.models import minimizers as mn

    p0, q, n, w = p0.double(), q.double(), n.double(), w.double()
    if kind == "point_to_plane":
        layout = mn.P2PL_LAYOUT
        ref = mn.point_to_plane_moments(p0, q, n, w)
        scale = mn.point_to_plane_moments(p0.abs(), q.abs(), n.abs(), w.abs())
    else:
        layout = mn.GICP_LAYOUT
        M = mn._gicp_precision(ns.double(), n, epsilon) * w[..., None, None]
        ref = mn.gicp_moments_from_precision(p0, q, M, w)
        scale = mn.gicp_moments_from_precision(p0.abs(), q.abs(), M.abs(), w.abs())
    return mn.pack_moments(ref, layout), mn.pack_moments(scale, layout)


def _check_moments(hs, T, src0):
    """moments: the round-frozen sums of the moment path (point-to-plane,
    131) and of GICP (147), on the headline round's knn = 1 pairs and frozen
    trim weights (8 x 65,536), GICP with the readings' grid normals rotated
    by the round-start pose. Held against the float64 sums within 1e-5 of
    each entry's scale; a rerun gives the same bits, and so does each
    problem alone against the same problem inside a batch of 64 (the 8
    repeated). Timed against the plain version (the JAX twin's float32
    einsums), which is also the library call. Also a raw pair sum (the
    X-ICP analysis's 36 sums) against ``terms.sum``."""
    from open3d_slam_private_tpu_torch.geometry import se3
    from open3d_slam_private_tpu_torch.kernels import moments as mk
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.models import minimizers as mn
    from open3d_slam_private_tpu_torch.ops import cell_list as cell_mod
    from open3d_slam_private_tpu_torch.ops.grid_hash import match_from_candidates
    from open3d_slam_private_tpu_torch.ops.outliers import trimmed_dist_limit

    ref, readings, cfg = hs["ref"], hs["readings"], hs["cfg"]
    B, N = readings.mask.shape
    rows, valid = cell_mod.gather_cell_candidates(ref.grid, src0, readings.mask)
    res = match_from_candidates(rows, valid, src0, readings.mask, cfg.max_match_dist)
    del rows, valid
    tau = trimmed_dist_limit(res.dists, res.valid(), cfg.trimmed_ratio, cfg.max_match_dist**2)
    w = icp_mod._weights(res, cfg, trim_limit=tau)[:, :, 0].contiguous()
    p0 = readings.xyz.contiguous()
    q, n = res.xyz[:, :, 0].contiguous(), res.normals[:, :, 0].contiguous()
    ns = se3.apply_rotation(T, gicp_readings(hs).normals).contiguous()
    eps = cfg.gicp_epsilon
    hs["moments_structured"] = dict(p0=p0, q=q, n=n, ns=ns, w=w, epsilon=eps)
    same = lambda x, y: torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
    out = {}
    for kind in ("point_to_plane", "gicp"):
        if kind == "gicp":
            kernel = lambda *a: mk.gicp_moments(*a, epsilon=eps)  # noqa: E731
            plain = lambda *a: mn.gicp_moments(*a, epsilon=eps)  # noqa: E731
            args, layout, flops = (p0, ns, q, n, w), mn.GICP_LAYOUT, MOMENTS_GICP_FLOPS
            nbytes = B * N * 52
        else:
            kernel, plain = mk.point_to_plane_moments, mn.point_to_plane_moments
            args, layout, flops = (p0, q, n, w), mn.P2PL_LAYOUT, MOMENTS_P2PL_FLOPS
            nbytes = B * N * 40
        S = mn.layout_size(layout)
        got = mn.pack_moments(kernel(*args), layout)
        again = mn.pack_moments(kernel(*args), layout)
        big = tuple(x.repeat(8, *([1] * (x.dim() - 1))).contiguous() for x in args)
        in64 = mn.pack_moments(kernel(*big), layout)
        alone = [mn.pack_moments(kernel(*(x[i:i + 1].contiguous() for x in args)), layout)
                 for i in range(B)]
        torch.cuda.synchronize()
        if not same(got, again):
            raise RuntimeError(f"moments {kind}: two calls gave different bits")
        if not all(same(in64[i:i + 1], a) and same(in64[B + i:B + i + 1], a) for i, a in enumerate(alone)):
            raise RuntimeError(f"moments {kind}: a problem alone differs from it in a batch of 64")
        if not same(in64[:B], got):
            raise RuntimeError(f"moments {kind}: the batch of 8 differs from its rows in a batch of 64")
        ref64, scale = _moments_fp64(kind, p0, q, n, w, ns, eps)
        worst = float(((got.double() - ref64).abs() / (1e-5 * (scale + 1e-30))).max())
        if not worst <= 1.0:
            raise RuntimeError(f"moments {kind} disagrees with the fp64 sums ({worst:.3g} x tolerance)")
        want = mn.pack_moments(plain(*args), layout)
        err = float((got - want).abs().max())
        t = timed("moments", lambda a=args, k=kernel: k(*a), lambda a=args, p=plain: p(*a),
                  nbytes + B * S * 4, B * N * flops, library_fn=lambda a=args, p=plain: p(*a), plain_reps=5)
        out[kind] = dict(sums=S, worst_over_tolerance=worst, max_abs_err=err,
                         max_abs_output=float(want.abs().max()), bit_identical_rerun=True,
                         batch_independent=True, **t)
        say("kernel", name="moments", kind=kind, shape=f"{B}x{N}x1", **out[kind])
        del big, in64, ref64, scale
    # The raw pair sums (the X-ICP ternary analysis's 3-DoF systems).
    terms = torch.stack([w * q[..., i % 3] * n[..., (i // 3) % 3] for i in range(36)], -1).contiguous()
    raw, raw_again = mk.pair_sums(terms), mk.pair_sums(terms)
    raw_alone = mk.pair_sums(terms[:1].contiguous())
    ref_raw = terms.double().sum(1)
    raw_worst = float(((raw.double() - ref_raw).abs() / (1e-5 * (terms.double().abs().sum(1) + 1e-30))).max())
    if not (same(raw, raw_again) and same(raw[:1], raw_alone) and raw_worst <= 1.0):
        raise RuntimeError(f"moments raw pair sums: rerun {same(raw, raw_again)}, alone "
                           f"{same(raw[:1], raw_alone)}, {raw_worst:.3g} x tolerance")
    say("kernel_check", name="moments", kind="raw", sums=36, worst_over_tolerance=raw_worst)
    main = {k: v for k, v in out["point_to_plane"].items() if k != "worst_over_tolerance"}
    return dict(name="moments", route="cuda", source="open3d_slam_private_tpu_torch/csrc/moments.cu",
                replaces="open3d_slam_private_tpu/models/minimizers.py:179",
                replaces_note="XLA einsums of the JAX package (point_to_plane_moments; gicp_moments at "
                              "minimizers.py:255), not a Pallas kernel",
                shape=f"{B}x{N}x1", **main, gicp=out["gicp"])


SYM_EIG_USERS = ("minimizers", "localizability", "icp")  # modules that call sym_eig by name
SYM_EIG_INPUTS = "build/sym_eig_inputs.pt"  # the main run's matrices, for --side DIR --sym-eig


class record_calls:
    """Within it, the function ``name`` of each module in ``modules`` (the
    modules that call it by name) records into ``seen``, for each key of its
    first argument (``key(x)``), that key's first argument (a copy) and its
    calls."""

    def __init__(self, seen, name, modules, key):
        import importlib

        self.seen, self.name, self.key = seen, name, key
        self.mods = [importlib.import_module(f"open3d_slam_private_tpu_torch.models.{m}") for m in modules]

    def __enter__(self):
        fn = self.fn = getattr(self.mods[0], self.name)

        def record(x, *args, **kwargs):
            k = self.key(x)
            if k not in self.seen:
                self.seen[k] = dict(first=x.detach().clone(), calls=0)
            self.seen[k]["calls"] += 1
            return fn(x, *args, **kwargs)

        for m in self.mods:
            setattr(m, self.name, record)
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            setattr(m, self.name, self.fn)


def record_sym_eig(seen):
    """``sym_eig``'s inputs by (shape, type), in the modules that call it."""
    return record_calls(seen, "sym_eig", SYM_EIG_USERS,
                        lambda A: ("x".join(map(str, A.shape)), str(A.dtype).replace("torch.", "")))


def sym_eig_inputs(hs):
    """The matrices the chain hands ``sym_eig``, recorded from the headline
    batch: the first KKT solve's 12 x 12 float64 (8 problems; one of them is
    the SLAM step mapper's shape), the spectral diagnostics' 6 x 6 float32,
    and the ternary analysis's 3 x 3 blocks (``method="equality_constraints"``,
    ``[problem, direction, 3, 3]``), one problem's each. Returns
    ``{shape name: tensor}`` and the calls of each recorded (shape, type)."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod

    cfg = hs["cfg"]
    ternary = dataclasses.replace(cfg, degeneracy=dataclasses.replace(cfg.degeneracy, method="equality_constraints"))
    seen, seen_t = {}, {}
    with record_sym_eig(seen):
        icp_mod.icp_batch(hs["readings"], hs["ref"], hs["init"], cfg)
    with record_sym_eig(seen_t):
        icp_mod.icp_batch(hs["readings"], hs["ref"], hs["init"], ternary)
    kkt = seen[("8x12x12", "float64")]["first"]
    diag = seen[("8x6x6", "float32")]["first"]
    blocks = next(v["first"] for (shape, _), v in seen_t.items() if shape.endswith("x3x3x3"))
    inputs = {"1x12x12": kkt[:1].contiguous(), "8x12x12": kkt.contiguous(), "1x6x6": diag[:1].contiguous(),
              "1x3x3x3": blocks[:1].contiguous()}
    calls = {f"{k[0]} {k[1]}": v["calls"] for k, v in {**seen, **seen_t}.items()}
    return inputs, calls


def sym_eig_flops(sweeps: torch.Tensor, n: int) -> int:
    """Operations of the Jacobi sweeps the matrices took: each sweep rotates
    at most n (n - 1) / 2 pairs, each rotation ~15 operations for (c, s)
    and 6 n for each of A's rows, A's columns and V's columns."""
    return int(sweeps.sum()) * n * (n - 1) // 2 * (18 * n + 15)


def sym_eig_chain_floor(probe, n, sweeps):
    """The design's floor (us) for a matrix that took ``sweeps``: the
    probe's step chain times the steps of a sweep (n - 1, or n for an odd
    n) times the sweeps, plus one stop test's chain."""
    steps = n - 1 + (n & 1)
    return (probe["step"]["ns"] * steps * sweeps + probe["test"]["ns"]) / 1e3


def sym_eig_timings(inputs, probes=None):
    """``sym_eig`` on each recorded shape: held against ``torch.linalg.eigh``
    (eigenvalues and the rebuilt matrix within 1e-12 (float64) or 1e-5
    (float32) of the matrix's scale, the float64 pseudo-solve within 1e-7
    of the CPU's, fewer than 30 sweeps, each matrix's bits alone equal to
    its bits inside a batch of 64), then timed: device us a launch
    (profiler), wrapper ms (CUDA events) against the plain version
    (``sym_eig_plain``: one ``torch.linalg.eigh`` a matrix) and one batched
    ``torch.linalg.eigh`` call (library_ms), the roofline bound (bytes, or
    the rotations' operations at the type's rate) and, with ``probes``
    ({dtype: chain_probe}), the chain floor of the sweeps taken (the batch's
    matrices run side by side: its most sweeps)."""
    from open3d_slam_private_tpu_torch.kernels import sym_eig as sek
    from open3d_slam_private_tpu_torch.models import minimizers

    out = {}
    for shape, M in inputs.items():
        M = M.cuda()
        n, dtype = M.shape[-1], M.dtype
        f64 = dtype == torch.float64
        flat = M.reshape(-1, n, n)
        B = flat.shape[0]
        w, V, sweeps = sek.sym_eig(M, sweeps=True)
        wp, _ = torch.linalg.eigh(M)
        scale = M.abs().amax(dim=(-2, -1)).double() + 1e-300
        err = float((w - wp).abs().amax())
        rel = float(((w - wp).abs().amax(-1).double() / scale).amax())
        Vd, wd = V.double(), w.double()
        rebuilt = float(((Vd @ torch.diag_embed(wd) @ Vd.mT - M.double()).abs().amax(dim=(-2, -1)) / scale).amax())
        tol = 1e-12 if f64 else 1e-5
        solve_rel = None
        if f64:
            rhs = torch.linspace(-1.0, 1.0, n, dtype=dtype, device=M.device).expand(M.shape[:-1]).contiguous()
            x = minimizers.solve_normal_equations(M, rhs).cpu()
            xp = minimizers.solve_normal_equations(M.cpu(), rhs.cpu())
            solve_rel = float(((x - xp).abs() / (xp.abs().amax(-1, keepdim=True) + 1e-300)).amax())
        # The pseudo-solves of two float64 eigensolvers part by about the KKT
        # system's condition number times float64's epsilon.
        if not (rel <= tol and rebuilt <= tol and (solve_rel is None or solve_rel <= 1e-7)
                and int(sweeps.max()) < sek.MAX_SWEEPS):
            raise RuntimeError(f"sym_eig {shape} {dtype}: eigenvalues {rel}, rebuilt {rebuilt}, pseudo-solve "
                               f"{solve_rel}, sweeps {sweeps.tolist()}")
        big = flat.repeat(-(-64 // B), 1, 1)[:64].contiguous()
        wb, Vb = sek.sym_eig(big)
        w_flat, V_flat = w.reshape(-1, n), V.reshape(-1, n, n)
        alone = all(torch.equal(wb[i], w_flat[i]) and torch.equal(Vb[i], V_flat[i]) for i in range(B))
        if not alone:
            raise RuntimeError(f"sym_eig {shape}: a matrix's bits depend on its batch")
        size = 8 if f64 else 4
        nbytes = B * (2 * n * n + n) * size + B * 4
        t = timed("sym_eig", lambda m=M: sek.sym_eig(m), lambda m=M: sek.sym_eig_plain(m),
                  nbytes, sym_eig_flops(sweeps, n), library_fn=lambda m=M: torch.linalg.eigh(m),
                  peak_flops=PEAK_FP64_FLOP_PER_S if f64 else PEAK_FP32_FLOP_PER_S)
        row = dict(dtype=str(dtype).replace("torch.", ""), matrices=B, n=n, sweeps=sweeps.reshape(-1).tolist(),
                   max_abs_err=err, eig_rel_err=rel, rebuilt_rel_err=rebuilt, pseudo_solve_rel_err=solve_rel,
                   batch_independent_in_64=alone, **t)
        if probes is not None:
            floor = sym_eig_chain_floor(probes[dtype], n, int(sweeps.max()))
            row.update(chain_floor_us=floor, chain_floor_share=floor / t["device_us"] if t["device_us"] else None)
        out[shape] = row
    return out


def _check_sym_eig(hs):
    """sym_eig (the Jacobi eigensolver the realtime step's graph holds) on
    the chain's own matrices (:func:`sym_eig_inputs`) at each shape it
    hands the kernel, by :func:`sym_eig_timings`, with the chain floor from
    the kernel's probe (``kernels.sym_eig.chain_probe``, both types). The
    inputs are saved to ``SYM_EIG_INPUTS`` for ``--side DIR --sym-eig``,
    which times another checkout's kernel on them."""

    from open3d_slam_private_tpu_torch.kernels import sym_eig as sek

    inputs, calls = sym_eig_inputs(hs)
    os.makedirs(os.path.dirname(SYM_EIG_INPUTS), exist_ok=True)
    torch.save({k: v.cpu() for k, v in inputs.items()}, SYM_EIG_INPUTS)
    probes = {dt: sek.chain_probe(hs["init"].device, dt) for dt in (torch.float64, torch.float32)}
    say("kernel_probe", name="sym_eig", probe={str(k).replace("torch.", ""): v for k, v in probes.items()},
        headline_calls=calls)
    out = sym_eig_timings(inputs, probes)
    for shape, row in out.items():
        say("kernel", name="sym_eig", shape=shape, **row)
    main = out["1x12x12"]
    return dict(name="sym_eig", route="cuda", source="open3d_slam_private_tpu_torch/csrc/sym_eig.cu",
                replaces="open3d_slam_private_tpu/models/minimizers.py:441",
                replaces_note="jnp.linalg.eigh, an XLA computation of the JAX package, not a "
                              "Pallas kernel; the port's own kernel, so a CUDA graph can hold the solve",
                shape="1x12x12 float64", **main,
                **{f"at_{k}": v for k, v in out.items() if k != "1x12x12"})


def sym_eig_side(root):
    """``--side DIR --sym-eig``: the checkout at ``DIR``'s ``sym_eig`` on the
    main run's saved inputs (``SYM_EIG_INPUTS``), by this file's
    :func:`sym_eig_timings` (no chain floor: the probe may not exist there).
    Run it once per side, each in its own process, in one call to the card
    (parent, change, change, parent)."""

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import open3d_slam_private_tpu_torch

    phase_device()
    inputs = torch.load(SYM_EIG_INPUTS)
    out = sym_eig_timings(inputs)
    say("sym_eig_side", root=root, package=os.path.dirname(open3d_slam_private_tpu_torch.__file__),
        shapes={k: dict(device_us=v["device_us"], ms=v["ms"], plain_ms=v["plain_ms"],
                        library_ms=v["library_ms"], sweeps=v["sweeps"], eig_rel_err=v["eig_rel_err"])
                for k, v in out.items()})


def cdist_min(q, r, chunk=8192):
    """The library yardstick for K5, used nowhere in the port: per chunk of
    queries, ``torch.cdist`` on direct differences, then ``min`` (two calls).
    Returns (distance, id)."""
    outs = [torch.cdist(q[s:s + chunk], r, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
            for s in range(0, q.shape[0], chunk)]
    return torch.cat([o.values for o in outs]), torch.cat([o.indices for o in outs])


def ulps(a, b):
    """Units in the last place between two float32 tensors (their bit
    patterns in sign-magnitude order; inf against inf is 0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def near_ties(n_query, n_ref, seed=21, pad=0):
    """Map-scale near-ties in an 80 x 80 x 4 m box: half the queries at the
    midpoints of reference pairs 2 cm apart (both distances 1e-4 m^2, equal
    up to rounding), the rest uniform; the reference's last ``pad`` rows at
    the padding coordinate (1e9). Needs ``n_query <= n_ref - pad``."""
    rng = np.random.default_rng(seed)
    box = lambda n: np.c_[rng.uniform(-40, 40, (n, 2)), rng.uniform(0, 4, (n, 1))]
    r = box(n_ref)
    half = n_query // 2
    perm = rng.permutation(n_ref - pad)
    a, b = perm[:half], perm[half:2 * half]
    u = rng.normal(size=(half, 3))
    r[b] = r[a] + 0.02 * u / np.linalg.norm(u, axis=1, keepdims=True)
    r = r.astype(np.float32)
    r[n_ref - pad:] = 1e9
    q = np.r_[(r[a].astype(np.float64) + r[b]) / 2, box(n_query - half)].astype(np.float32)
    return q, r


def _held_knn_brute(got, want, what):
    """K5's ``(d2, ids)`` against its plain version's on the same inputs:
    ids equal, d2 within 1 ulp (the plain version rounds each fused
    multiply-add twice, float64 then float32). Raises where they part."""
    (d2, ids), (d2_p, ids_p) = got, want
    torch.cuda.synchronize()
    agree = float((ids == ids_p).float().mean())
    worst_ulps = int(ulps(d2, d2_p).max())
    out = dict(id_agreement=agree, max_d2_ulps=worst_ulps,
               d2_bit_equal=float((d2.view(torch.int32) == d2_p.view(torch.int32)).float().mean()),
               negative_d2=int((d2 < 0).sum()), max_abs_err=float((d2 - d2_p).abs().max()))
    if not (agree == 1.0 and worst_ulps <= 1):
        raise RuntimeError(f"knn_brute disagrees with its plain version on {what}: {out}")
    return out


def _hold_knn_brute(q, r, what):
    """One K5 call on ``q``, ``r`` held against the plain version."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as kbk

    d2, ids = kbk.knn_brute(q, r)
    return d2, ids, _held_knn_brute((d2, ids), kbk.knn_brute_plain(q, r), what)


def _check_knn_brute(ref, src0):
    """K5: one reading's points against the headline's reference cloud
    (65,536 x 65,536, register_pair's shape) and a near-tie set of the same
    size, each held against the plain version; timed there with the
    ``torch.cdist`` yardstick; and at the relocalisation burst's 2,097,152 x
    65,536 (the headline's 8 readings, 4 times over), held and timed."""
    from open3d_slam_private_tpu_torch.kernels import knn_brute as kbk

    q = src0[0].contiguous()
    refp = ref.cloud.padded_xyz().contiguous()
    nq, nr = q.shape[0], refp.shape[0]
    d2, ids, check = _hold_knn_brute(q, refp, "the headline")
    qt, rt = (torch.as_tensor(x, device=q.device) for x in near_ties(nq, nr))
    ties = _hold_knn_brute(qt, rt, "the near-tie set")[2]
    del qt, rt
    lib_d, lib_ids = cdist_min(q, refp)
    lib_agree = float((lib_ids.to(ids.dtype) == ids).float().mean())
    del lib_d, lib_ids
    # Bytes: each query and reference point read once, (d2, id) out.
    t = timed("knn_brute", lambda: kbk.knn_brute(q, refp), lambda: kbk.knn_brute_plain(q, refp),
              nq * 12 + nr * 12 + nq * 8, nq * nr * D2_FLOPS, library_fn=lambda: cdist_min(q, refp),
              plain_reps=5)
    plan = kbk.knn_brute_plan(nq, nr, q.device)
    say("kernel", name="knn_brute", queries=nq, reference=nr,
        reference_valid=int(ref.cloud.mask.sum()), plan=plan, near_ties=ties,
        library_id_agreement=lib_agree, **check, **t)

    # The burst's shape: every result held, the 524,288 distinct queries
    # against the plain version and their three repeats to the same bits.
    qu = src0.reshape(-1, 3).contiguous()
    qb, nu = qu.repeat(4, 1).contiguous(), qu.shape[0]
    nb = qb.shape[0]
    d2b, idsb = kbk.knn_brute(qb, refp)
    burst_check = _held_knn_brute((d2b[:nu], idsb[:nu]), kbk.knn_brute_plain(qu, refp),
                                  "the burst's shape")
    for k in range(1, nb // nu):
        part = slice(k * nu, (k + 1) * nu)
        if not (torch.equal(idsb[part], idsb[:nu])
                and torch.equal(d2b[part].view(torch.int32), d2b[:nu].view(torch.int32))):
            raise RuntimeError(f"knn_brute at the burst's shape: repeat {k} of the queries differs")
    del d2b, idsb, qu
    burst_us, _ = device_us_per_call(lambda: kbk.knn_brute(qb, refp), DEVICE_KERNELS["knn_brute"], reps=3)
    # The yardstick at this shape would take minutes: timed on a fixed 1/32
    # of the queries (the first 65,536) and scaled by 32.
    part = qb[: nb // 32].contiguous()
    lib_scaled = 32 * cuda_ms(lambda: cdist_min(part, refp), reps=1, rounds=1)
    burst = dict(queries=nb, reference=nr, plan=kbk.knn_brute_plan(nb, nr, q.device),
                 held=burst_check, device_us=burst_us, ms=cuda_ms(lambda: kbk.knn_brute(qb, refp), reps=3, rounds=3),
                 library_ms=lib_scaled, library_ms_scaled_from="1/32 of the queries, times 32",
                 **bound(nb * 12 + nr * 12 + nb * 8, nb * nr * D2_FLOPS))
    burst["bound_share"] = burst["bound_ms"] * 1e3 / burst_us if burst_us else None
    say("kernel", name="knn_brute", shape="burst", **burst)
    del qb, part
    return dict(name="knn_brute", route="cuda",
                source="open3d_slam_private_tpu_torch/csrc/knn_brute.cu",
                replaces="open3d_slam_private_tpu/kernels/knn_pallas.py:78",
                max_abs_err=check["max_abs_err"], max_d2_ulps=max(check["max_d2_ulps"], ties["max_d2_ulps"]),
                plan=plan, **t, at_burst=burst)


def phase_mapper(dev, cfg=None):
    """The Mapper (production defaults unless ``cfg``) over a 30-scan
    sequence; then one timed reference rebuild on the final submap. Returns
    the launch counts of the sequence."""
    from open3d_slam_private_tpu_torch.ops import pointcloud as pc
    from open3d_slam_private_tpu_torch.slam.mapper import Mapper, MapperConfig, build_map_reference

    scene = synth_scene(SCENE_POINTS)
    rng = np.random.default_rng(7)
    poses, p, yaw = [], np.array([-2.0, 0.0, 1.5]), 0.0
    for _ in range(MAPPER_SCANS):
        T = np.eye(4)
        T[:3, :3] = exp_se3_np([0, 0, yaw, 0, 0, 0])[:3, :3]
        T[:3, 3] = p
        poses.append(T)
        p = p + 0.2 * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        yaw += np.radians(1.0)
    scans = [
        pc.from_points(sample_scan(scene, SCAN_POINTS, np.linalg.inv(T), seed=100 + k,
                                   sensor=T[:3, 3]), capacity=SCAN_POINTS, device=dev)
        for k, T in enumerate(poses)
    ]
    mapper = Mapper(cfg or MapperConfig(), device=dev)
    reset_counts()
    est, scan_ms = [np.eye(4)], []
    for k, scan in enumerate(scans):
        odom = np.eye(4)
        if k:
            noise = np.r_[rng.normal(0, 0.003, 3), rng.normal(0, 0.012, 3)]
            odom = np.linalg.inv(poses[k - 1]) @ poses[k] @ exp_se3_np(noise)
        sync(dev)
        t = time.perf_counter()
        stats = mapper.add_scan(scan, odom)
        sync(dev)
        if k:
            scan_ms.append((time.perf_counter() - t) * 1e3)
            est.append(mapper.pose)
            if not np.isfinite(mapper.pose).all():
                raise RuntimeError(f"mapper pose {k} is not finite: {stats}")
    counts = read_counts()
    if counts["pair_gn"] <= 0:
        raise RuntimeError(f"the mapper ran without launching pair_gn: {counts}")
    center = torch.as_tensor(mapper.pose[:3, 3], dtype=torch.float32, device=dev)
    rebuild_ms = []
    for _ in range(3):
        sync(dev)
        t = time.perf_counter()
        build_map_reference(mapper.submap.cloud, center, mapper.cfg)
        sync(dev)
        rebuild_ms.append((time.perf_counter() - t) * 1e3)
    truth = [np.linalg.inv(poses[0]) @ T for T in poses]
    ate = np.array([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, truth)])[1:]
    p50, amax = float(np.median(ate)), float(ate.max())
    say("mapper", scans=MAPPER_SCANS, ate_p50_m=p50, ate_max_m=amax,
        scan_ms_p50=float(np.median(scan_ms)), scan_ms_p90=float(np.percentile(scan_ms, 90)),
        rebuild_ms=float(np.median(rebuild_ms)), launches=counts)
    if not (p50 <= 0.05 and amax <= 0.15):
        raise RuntimeError(f"mapper trajectory error too large: p50 {p50} m, max {amax} m")
    return counts


def synth_site(n, seed=3):
    """A 100 m x 60 m site for a drive along +x: ground plane, building
    fronts on both sides of the street and boxes (cars, kiosks) beside it."""
    rng = np.random.default_rng(seed)
    n_floor = n // 2
    parts = [np.c_[rng.uniform(-40, 60, (n_floor, 1)), rng.uniform(-30, 30, (n_floor, 1)),
                   rng.normal(0, 0.02, (n_floor, 1))]]
    fronts = [(x0, side * rng.uniform(9, 14)) for x0 in np.arange(-40, 60, 12.5) for side in (-1, 1)]
    boxes = [(rng.uniform(-35, 55), rng.choice([-1, 1]) * rng.uniform(5, 7)) for _ in range(24)]
    m = (n - n_floor) // (len(fronts) + len(boxes))
    for x0, y0 in fronts:  # a wall 11 m long, a few degrees off the street, 2-8 m tall
        ang = rng.uniform(-0.15, 0.15)
        t = rng.uniform(0, 11, (m, 1))
        parts.append(np.c_[x0 + t * np.cos(ang), y0 + t * np.sin(ang), rng.uniform(0, rng.uniform(2, 8), (m, 1))])
    for x0, y0 in boxes:  # the four sides of a 2-4 m box, 1.5-3 m tall, off the street
        w, d, hgt = rng.uniform(2, 4), rng.uniform(1.5, 2.5), rng.uniform(1.5, 3)
        u = rng.uniform(0, 2 * (w + d), m)
        x = np.where(u < w, u, np.where(u < w + d, w, np.where(u < 2 * w + d, 2 * w + d - u, 0.0)))
        y = np.where(u < w, 0.0, np.where(u < w + d, u - w, np.where(u < 2 * w + d, d, 2 * (w + d) - u)))
        parts.append(np.c_[x0 + x, y0 + np.sign(y0) * y, rng.uniform(0, hgt, m)])
    pts = np.vstack(parts).astype(np.float32)
    return pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01


def drive(n_scans, step):
    """Sensor poses 1.5 m above the ground, ``step`` m apart along the street,
    the heading swaying by at most 0.8 degrees a scan."""
    poses, p, yaw = [], np.array([-12.0, 0.0, 1.5]), 0.0
    for k in range(n_scans):
        T = np.eye(4)
        T[:3, :3] = exp_se3_np([0, 0, yaw, 0, 0, 0])[:3, :3]
        T[:3, 3] = p
        poses.append(T)
        p = p + step * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        yaw += np.radians(0.8) * np.sin(2 * np.pi * k / 48)
    return poses


def profiled_device_ms(prof):
    """Device milliseconds of a ``torch.profiler`` session (the self time of
    its device-side events: kernels, copies, sets; None if the trace holds
    none) and its four largest device items as (name, ms, count)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not dev:
        return None, []
    top = sorted(dev, key=event_device_us, reverse=True)[:4]
    return (sum(event_device_us(e) for e in dev) / 1e3,
            [(e.key[:60], event_device_us(e) / 1e3, e.count) for e in top])


class StageClock:
    """Wraps the pipeline's stage methods: host milliseconds of each stage
    of the current scan (synchronised at both ends) and every kernel's
    launches per stage. A stage named in ``profiled`` runs its next call inside a
    ``torch.profiler`` session of its own, whose device time is kept in
    ``device_ms``; sessions do not nest, so one scan profiles odometry and
    insertion, the next mapping (insertion inside). Mapping's own time is
    its total less insertion's."""

    STAGES = ("odometry", "mapping", "insertion")

    def __init__(self, pipe, dev):
        self.dev = dev
        self.scan_ms = {s: 0.0 for s in self.STAGES}
        self.launches = {s: {} for s in self.STAGES}
        self.profiled = set()
        self.device_ms = {s: [] for s in self.STAGES}
        self.top = {}
        self.k1_device_us, self.k1_profiled = 0.0, 0  # K1's events in the sessions
        self._wrap(pipe.odometry, "add_scan", "odometry")
        self._wrap(pipe, "_mapping_step", "mapping")
        self._wrap(pipe.submaps, "insert_scan", "insertion")

    def _wrap(self, obj, attr, stage):
        from torch.profiler import ProfilerActivity, profile

        fn = getattr(obj, attr)

        def run(*args, **kwargs):
            sync(self.dev)
            n0, t0 = read_counts(), time.perf_counter()
            if stage in self.profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = fn(*args, **kwargs)
                    sync(self.dev)
                ms, self.top[stage] = profiled_device_ms(prof)
                if ms is not None:
                    self.device_ms[stage].append(ms)
                for e in prof.key_averages():
                    if any(k in e.key for k in DEVICE_KERNELS["pair_gn"]):
                        self.k1_device_us += event_device_us(e)
                        self.k1_profiled += e.count if "pair_gn_fused" in e.key else 0
            else:
                out = fn(*args, **kwargs)
            sync(self.dev)
            self.scan_ms[stage] += (time.perf_counter() - t0) * 1e3
            for k, v in read_counts().items():
                self.launches[stage][k] = self.launches[stage].get(k, 0) + v - n0[k]
            return out

        setattr(obj, attr, run)

    def take(self):
        """This scan's stage times (mapping without insertion); reset."""
        ms = dict(self.scan_ms)
        ms["mapping"] -= ms["insertion"]
        self.scan_ms = {s: 0.0 for s in self.STAGES}
        return ms


def eval_slam_config(motion_compensation=False):
    """``tools/run_eval.py:192-228``'s SLAM configuration, the evaluation
    protocol's: odometry voxel 0.2 m within 40 m; the mapper's ICP on the
    cell list (2^14 x 64, 1.0 m, trim 0.85, 12 iterations, 8 coarse at
    stride 4, refresh 6, slack 0.25) with ``fused_kernel`` and
    ``fast_trimming`` left at False (exact trimming: the direct in-round
    path) and X-ICP's ternary method, its analysis frozen a round (its pair
    sums on the ``moments`` kernel); scan voxel 0.1 m, submap voxel 0.15 m, minimum
    movement 0.05 m; submaps of 2^17 points, creation radius 25 m,
    activation 27 m, no carving; loop closure off."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig
    from open3d_slam_private_tpu_torch.slam.mapper import MapperConfig
    from open3d_slam_private_tpu_torch.slam.odometry import OdometryConfig
    from open3d_slam_private_tpu_torch.slam.pipeline import MotionCompensationConfig, SlamConfig
    from open3d_slam_private_tpu_torch.slam.submap_collection import SubmapCollectionConfig

    icp_map = icp_mod.ICPConfig(
        knn=1, max_match_dist=1.0, matcher="grid", grid_table_size=1 << 14, grid_bucket_cap=64,
        trimmed_ratio=0.85, minimizer="point_to_plane", max_iterations=12, coarse_iterations=8,
        coarse_stride=4, candidate_refresh_every=6, candidate_slack=0.25,
        degeneracy=DegeneracyConfig(method="equality_constraints"),
    )
    return SlamConfig(
        odometry=OdometryConfig(voxel_size=0.2, max_range=40.0),
        mapper=MapperConfig(icp=icp_map, scan_voxel_size=0.1, submap_voxel_size=0.15,
                            min_movement_for_insertion=0.05),
        submaps=SubmapCollectionConfig(submap_capacity=1 << 17, submap_voxel_size=0.15,
                                       creation_radius=25.0, activation_radius=27.0, carve_every_n=0),
        motion_compensation=MotionCompensationConfig(enabled=motion_compensation, scan_duration=0.1),
        use_imu_attitude_init=False, loop_closure_enabled=False, use_external_odometry=False,
    )


PIPELINE_NEED = {"pipeline": dict(odometry=("pair_gn",), mapping=("pair_gn",)),
                 "pipeline-64k-eval": dict(odometry=("pair_gn",), mapping=("normal_eq", "moments"))}


def phase_pipeline(dev, cfg=None, cell="pipeline", min_submaps=2, ate_limits=(0.05, 0.15), record=None,
                   **note):
    """The online SLAM step through ``SlamPipeline.process_scan``: with the
    production configs (loop closure off) unless ``cfg``: LiDAR odometry
    (16,384 points, hash table 2^13 x 48), the mapper (65,536 raw -> 16,384
    scan points, reference 65,536) and submaps of 131,072 points at 0.15 m,
    over a drive of ``PIPELINE_SCANS`` scans of 65,536 raw points. The last
    ``PROFILE_SCANS`` scans run their stages under ``torch.profiler``
    (device time per stage, K1's device time per launch) and are left out of
    the timings. ``cell`` names the printed line and the kernels each stage
    must launch (``PIPELINE_NEED``); ``ate_limits`` the ATE p50 and max it
    must hold. With ``record`` (a dict), one more scan after the checks,
    neither timed nor counted, records the raw pair sums' shapes into it
    (:class:`record_raw_sums`). Returns the launch counts, K1's device
    microseconds per launch at the SLAM step's shapes and the scan's wall
    and device times."""
    from open3d_slam_private_tpu_torch.ops import pointcloud as pc
    from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig, SlamPipeline

    scene = synth_site(SITE_POINTS)
    poses = drive(PIPELINE_SCANS, PIPELINE_STEP_M)
    scans = [
        pc.from_points(sample_scan(scene, SCAN_POINTS, np.linalg.inv(T), seed=300 + k,
                                   sensor=T[:3, 3]), capacity=SCAN_POINTS, device=dev)
        for k, T in enumerate(poses)
    ]
    pipe = SlamPipeline(cfg or SlamConfig(loop_closure_enabled=False), device=dev)
    clock = StageClock(pipe, dev)
    n_timed = len(scans) - PROFILE_SCANS
    stage_ms, total_ms, est = [], [], []
    reset_counts()
    for k, scan in enumerate(scans):
        profiling = k >= n_timed
        if profiling:
            clock.profiled = {"odometry", "insertion"} if (k - n_timed) % 2 == 0 else {"mapping"}
        sync(dev)
        t = time.perf_counter()
        stats = pipe.process_scan(scan, 0.1 * k)
        sync(dev)
        if k and not profiling:  # the first scan only seeds the map
            total_ms.append((time.perf_counter() - t) * 1e3)
            stage_ms.append(clock.take())
        clock.take()
        est.append(pipe.pose)
        if not np.isfinite(pipe.pose).all():
            raise RuntimeError(f"pipeline pose {k} is not finite: {stats}")
    counts = read_counts()

    truth = [np.linalg.inv(poses[0]) @ T for T in poses]
    ate = np.array([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, truth)])[1:]
    p50, amax = float(np.median(ate)), float(ate.max())
    walls = {s: [m[s] for m in stage_ms] for s in StageClock.STAGES}
    dev_ms = {s: float(np.mean(v)) if v else None for s, v in clock.device_ms.items()}
    if dev_ms["mapping"] is not None and dev_ms["insertion"] is not None:
        dev_ms["mapping"] -= dev_ms["insertion"]
    profile_out = {}
    for s in StageClock.STAGES:
        wall = float(np.median(walls[s]))
        profile_out[s] = dict(wall_ms_p50=wall, device_ms=dev_ms[s], sessions=len(clock.device_ms[s]),
                              idle_share=1.0 - dev_ms[s] / wall if wall > 0 and dev_ms[s] is not None else None,
                              top_device_items=clock.top.get(s))
    scan_wall = float(np.median(total_ms))
    scan_dev = None if None in dev_ms.values() else sum(dev_ms.values())
    k1_us = clock.k1_device_us / clock.k1_profiled if clock.k1_profiled else None
    summary = dict(scan_ms_p50=scan_wall, scan_ms_p90=float(np.percentile(total_ms, 90)),
                   scan_device_ms=scan_dev, ate_p50_m=p50)
    say("pipeline", cell=cell, **note, ate_limits_m=list(ate_limits), scans=len(scans),
        raw_points=SCAN_POINTS, distance_m=PIPELINE_STEP_M * (len(scans) - 1),
        ate_p50_m=p50, ate_max_m=amax, submaps=len(pipe.submaps), active_submap=pipe.submaps.active_idx,
        scan_ms_p50=scan_wall, scan_ms_p90=float(np.percentile(total_ms, 90)),
        **{f"{s}_ms_p50": float(np.median(walls[s])) for s in StageClock.STAGES},
        **{f"{s}_ms_p90": float(np.percentile(walls[s], 90)) for s in StageClock.STAGES},
        launches_by_stage={k: {n: c for n, c in v.items() if c} for k, v in clock.launches.items()},
        launches=counts,
        profile=dict(scans=PROFILE_SCANS, stages=profile_out, scan_device_ms=scan_dev,
                     scan_idle_share=None if scan_dev is None else 1.0 - scan_dev / scan_wall,
                     pair_gn_profiled_launches=clock.k1_profiled, pair_gn_device_us_per_launch=k1_us))
    if not (p50 <= ate_limits[0] and amax <= ate_limits[1]):
        raise RuntimeError(f"{cell} trajectory error too large: p50 {p50} m, max {amax} m "
                           f"(limits {ate_limits})")
    if len(pipe.submaps) < min_submaps or pipe._ref_submap_idx != pipe.submaps.active_idx:
        raise RuntimeError(f"pipeline made {len(pipe.submaps)} submaps; the reference is on submap "
                           f"{pipe._ref_submap_idx}, the active one is {pipe.submaps.active_idx}")
    for stage, names in PIPELINE_NEED[cell].items():
        if any(clock.launches[stage].get(k, 0) <= 0 for k in names):
            raise RuntimeError(f"{cell}: the {stage} stage missed {names}: {clock.launches}")
    if record is not None:
        with record_raw_sums(record):
            pipe.process_scan(scans[-1], 0.1 * len(scans))
    return counts, k1_us, summary


REALTIME_MODES = (("paced", 1), ("throughput", 8))
REALTIME_CHECK_SCANS = 8
# realtime-64k's ATE limits (p50, max). The production limits (0.05 /
# 0.15 m) are not met here: the JAX package's RealtimePipeline reads 0.0555
# / 0.2042 m on this drive at poll_every=1 and 0.0478 / 0.1941 m at 8
# (tests/torch_realtime_drive.py jax, on the CPU), and these limits were set
# from those readings. Its lifecycle forces a new submap at 90% of the bank
# and seeds the new bank with up to half the old one, so the gate fires
# every ~7 scans; without the gate the port reads 0.017 / 0.089 m
# (tests/torch_realtime_drive.py port --variant no-force, on the card).
REALTIME_ATE_LIMITS = (0.08, 0.25)


def graph_kernel_nodes(graph):
    """Nodes and kernel nodes of a kept CUDA graph (``raw_cuda_graph``,
    read through libcuda's ``cuGraphGetNodes`` / ``cuGraphNodeGetType``)."""
    import ctypes

    raw = graph.raw_cuda_graph()
    cu = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {rc}")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(count))
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
    return dict(nodes=int(count.value), kernels=kinds.get(0, 0))  # CU_GRAPH_NODE_TYPE_KERNEL = 0


class ReplayClock:
    """CUDA events around every replay of a pipeline's graphs: the device
    milliseconds of the step, rebuild and seeding graphs (a graph runs
    back to back on the device, so its events time its device work)."""

    def __init__(self, graphs):
        self.events = {name: [] for name in ("step", "rebuild", "seed")}
        for name in self.events:
            graph = getattr(graphs, name)
            replay = graph.replay

            def timed_replay(replay=replay, name=name):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                replay()
                b.record()
                self.events[name].append((a, b))

            graph.replay = timed_replay

    def ms(self):
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


REALTIME_COUNTED = dict(pair_gn="pair_gn_fused", normal_eq="normal_eq_partial",
                       moments="moments_raw<", sym_eig="sym_eig_kernel")
# The throughput mode's poll block run under torch.profiler (scans
# 8 * REALTIME_PROFILED_BLOCK + 1 .. + 8): the device's busy time and idle
# share come from its trace, and the block is left out of the walls.
REALTIME_PROFILED_BLOCK = 5


def graph_kernels(graph, names, replays=3):
    """Launches of each kernel in ``names`` in one replay of ``graph``,
    from ``torch.profiler`` device events (a replay launches every kernel
    node the capture recorded). The profiler has lost an event of a
    25,000-kernel replay now and then, so each count is the largest of
    ``replays`` profiled replays. The replays write the graph's buffers:
    restore the state after them."""
    from torch.profiler import ProfilerActivity, profile

    best = {n: 0 for n in names}
    for _ in range(replays):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if event_device_us(e) > 0]
        for n in names:
            best[n] = max(best[n], sum(e.count for e in events if n in e.key))
    return best


def busy_ms(prof):
    """Milliseconds in which the device ran at least one kernel, copy or
    set of a ``torch.profiler`` session: the union of its device events'
    intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    total, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3, len(spans)


def phase_realtime(dev, slam_summary):
    """realtime-64k: ``RealtimePipeline`` (one captured CUDA graph a scan)
    on pipeline-64k's drive and production configs, paced (``poll_every=1``:
    a scan's wall time is its latency) and throughput (``poll_every=8``).
    Holds: the first ``REALTIME_CHECK_SCANS`` scans' stats from the graph
    bit-equal to the eager (early-exit) ``rt_step`` on the card from the same
    state; ATE within ``REALTIME_ATE_LIMITS``; at least 2 submaps; K1,
    normal_eq, moments and sym_eig launched inside the step graph.

    The path's launches: the wrappers count only what they launch eagerly
    (a call recorded into a graph launches nothing), so each kernel's
    launches in the timed runs are its launches in one replay of each graph
    (``torch.profiler`` device events, ``graph_kernels``) times that graph's
    replays in the runs, plus the wrappers' counts in the runs (counts set
    to 0 after the capture, the eager checks left out). Prints ms/scan
    p50/p90 next to ``SlamPipeline``'s from this run, the device's busy
    time a scan and its idle share (the trace of one profiled poll block of
    the throughput run), replays and kernel nodes a scan, the capture time,
    and the device time of the masked (already converged) iterations: the
    step graph's device time less the eager step's device kernel time on the
    same state and scan."""
    from torch.profiler import ProfilerActivity, profile

    from open3d_slam_private_tpu_torch.ops import pointcloud as pc
    from open3d_slam_private_tpu_torch.slam import realtime as rt
    from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig

    scene = synth_site(SITE_POINTS)
    poses = drive(PIPELINE_SCANS, PIPELINE_STEP_M)
    scans = [
        pc.from_points(sample_scan(scene, SCAN_POINTS, np.linalg.inv(T), seed=300 + k,
                                   sensor=T[:3, 3]), capacity=SCAN_POINTS, device=dev)
        for k, T in enumerate(poses)
    ]
    truth = [np.linalg.inv(poses[0]) @ T for T in poses]
    cfg = SlamConfig(loop_closure_enabled=False)
    graph_names = ("step", "rebuild", "seed")
    eager = {name: 0 for name in _counters()}
    per_replay, replays = {}, {name: 0 for name in graph_names}
    raw_sums, eager_sym_eig = {}, {}
    modes = {}
    for mode, poll in REALTIME_MODES:
        pipe = rt.RealtimePipeline(cfg, poll_every=poll, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        pipe.warmup(scans[0])
        sync(dev)
        capture_s = time.perf_counter() - t0
        nodes = {name: graph_kernel_nodes(getattr(pipe._graphs, name)) for name in graph_names}
        clock = ReplayClock(pipe._graphs)
        walls, bits, ends = [], [], []
        block = None
        prof = profile(activities=[ProfilerActivity.CUDA])
        profiled = range(poll * REALTIME_PROFILED_BLOCK + 1, poll * (REALTIME_PROFILED_BLOCK + 1) + 1) \
            if poll > 1 else range(0)
        sync(dev)
        reset_counts()
        t_run = time.perf_counter()
        for k, scan in enumerate(scans):
            check = mode == "paced" and 1 <= k <= REALTIME_CHECK_SCANS
            before = rt.tree_map(torch.clone, pipe._state) if check else None
            if k in profiled and k == profiled[0]:
                sync(dev)
                prof.start()
                block = time.perf_counter()
            if poll == 1:  # paced: a scan's wall from dispatch to its polled pose
                sync(dev)
            t = time.perf_counter()
            pipe.process_scan(scan, 0.1 * k)
            if poll == 1:
                sync(dev)
                if k:
                    walls.append((time.perf_counter() - t) * 1e3)
            if k in profiled and k == profiled[-1]:
                sync(dev)
                block = (time.perf_counter() - block) * 1e3
                prof.stop()
            ends.append(time.perf_counter())
            if check:  # the eager step's launches are not the path's
                held = read_counts()
                with record_raw_sums(raw_sums), record_sym_eig(eager_sym_eig):
                    _, eager_row = rt.rt_step(before, scan, torch.tensor(0.1, device=dev),
                                              torch.eye(4, device=dev), pipe.cfg, rebuild_branch=False)
                bits.append(bool(np.array_equal(eager_row.cpu().numpy(), pipe.frames[k].stats)))
                for name, fn in _counters().items():
                    fn.launches = held[name]
        pipe.finish()
        sync(dev)
        run_s = time.perf_counter() - t_run
        for name, c in read_counts().items():
            eager[name] += c
        replay_ms = clock.ms()
        for name in graph_names:
            replays[name] += len(replay_ms[name])
        est = pipe.trajectory()
        ate = np.array([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, truth)])[1:]
        n = len(scans) - 1
        if poll > 1:  # throughput: a scan's share of each poll block (poll ends the block)
            walls = [(ends[j + poll] - ends[j]) * 1e3 / poll for j in range(0, n - poll + 1, poll)
                     if j + 1 != profiled[0]]
        event_ms = sum(sum(v) for v in replay_ms.values()) / n
        row = dict(poll_every=poll, capture_s=capture_s, scans=len(scans),
                   ate_p50_m=float(np.median(ate)), ate_max_m=float(ate.max()), submaps=len(pipe.submaps),
                   scan_ms_p50=float(np.median(walls)), scan_ms_p90=float(np.percentile(walls, 90)),
                   scan_ms_mean=float(np.mean(walls)), run_ms_per_scan=run_s * 1e3 / n,
                   replay_event_ms_per_scan=event_ms,
                   step_graph_event_ms_p50=float(np.median(replay_ms["step"])),
                   rebuild_graph_event_ms_p50=float(np.median(replay_ms["rebuild"])) if replay_ms["rebuild"] else None,
                   replays=dict(step=len(replay_ms["step"]), rebuild=len(replay_ms["rebuild"]),
                                seed=len(replay_ms["seed"])),
                   replays_per_scan=pipe.graph_replays / n, graph_nodes=nodes)
        if poll > 1:
            busy, events = busy_ms(prof)
            row["profiled_block"] = dict(
                scans=[profiled[0], profiled[-1]], wall_ms_per_scan=block / poll,
                device_busy_ms_per_scan=busy / poll, device_events=events,
                idle_share=1.0 - busy / block,
                idle_share_vs_unprofiled_walls=1.0 - (busy / poll) / row["scan_ms_mean"])
        if bits:
            row["graph_vs_eager_bit_equal"] = bits
        modes[mode] = (row, pipe)
        # One profiled replay of each graph names its kernels (the replays
        # write the graphs' buffers, so the state is restored after them).
        g = pipe._graphs
        state0 = rt.tree_map(torch.clone, g.state)
        per_replay[mode] = {name: graph_kernels(getattr(g, name), REALTIME_COUNTED.values())
                            for name in graph_names}
        rt._copy_into(g.state, state0)
        for name in graph_names:
            for kernel, per in REALTIME_COUNTED.items():
                eager[kernel] += per_replay[mode][name][per] * len(replay_ms[name])
    counts = eager
    in_graph = {k: per_replay["paced"]["step"][v] for k, v in REALTIME_COUNTED.items()}

    # The masked iterations' device time: the step graph's device time less
    # the eager step's kernel time on the same state and scan.
    row, pipe = modes["paced"]
    g = pipe._graphs
    state0 = rt.tree_map(torch.clone, g.state)
    last = scans[-1]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.step.replay()
    b.record()
    sync(dev)
    graph_ms = a.elapsed_time(b)
    rt._copy_into(g.state, state0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.step.replay()
        sync(dev)
    replay_dev_ms, _ = profiled_device_ms(prof)
    step_kernels = kernels_by_key(prof, ("sym_eig_kernel", "pair_gn_fused", "normal_eq_", "moments_"))
    held = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rt.rt_step(state0, last, torch.tensor(0.1, device=dev), torch.eye(4, device=dev), pipe.cfg,
                   rebuild_branch=False)
        sync(dev)
    for name, fn in _counters().items():
        fn.launches = held[name]
    eager_ms, eager_top = profiled_device_ms(prof)
    masked = dict(graph_event_ms=graph_ms, eager_kernel_ms=eager_ms,
                  masked_iterations_ms=None if None in (replay_dev_ms, eager_ms) else replay_dev_ms - eager_ms,
                  profiled_replay_device_ms=replay_dev_ms, eager_top_device_items=eager_top,
                  iterations_this_scan=float(g.stats[0, rt.IDX_ITERATIONS]))
    out = {m: r for m, (r, _) in modes.items()}
    step_replays_per_scan = replays["step"] / (2 * (len(scans) - 1))
    sym_eig_us = sum(v["device_us"] for k, v in step_kernels.items() if "sym_eig_kernel" in k)
    say("realtime_step_kernels", cell="realtime-64k", profiled_step_replay=step_kernels,
        sym_eig_device_us_per_launch=sym_eig_us / max(1, sum(v["launches"] for k, v in step_kernels.items()
                                                         if "sym_eig_kernel" in k)),
        sym_eig_device_ms_per_scan=sym_eig_us / 1e3 * step_replays_per_scan,
        step_replays_per_scan=step_replays_per_scan,
        eager_sym_eig_calls={f"{k[0]} {k[1]}": v["calls"] for k, v in eager_sym_eig.items()})
    say("realtime", cell="realtime-64k", ate_limits_m=list(REALTIME_ATE_LIMITS), raw_points=SCAN_POINTS,
        distance_m=PIPELINE_STEP_M * (len(scans) - 1),
        depth=f"{PIPELINE_SCANS} scans, not cut", modes=out, launches_per_replay=per_replay,
        graph_replays=replays, masked=masked, launches=counts,
        slam_pipeline=dict(scan_ms_p50=slam_summary["scan_ms_p50"], scan_ms_p90=slam_summary["scan_ms_p90"],
                           scan_device_ms=slam_summary["scan_device_ms"], ate_p50_m=slam_summary["ate_p50_m"]))
    paced = out["paced"]
    if not all(paced.get("graph_vs_eager_bit_equal", [False])) or len(paced["graph_vs_eager_bit_equal"]) != REALTIME_CHECK_SCANS:
        raise RuntimeError(f"realtime-64k: graph replay differs from eager rt_step: {paced.get('graph_vs_eager_bit_equal')}")
    for m, r in out.items():
        if not (r["ate_p50_m"] <= REALTIME_ATE_LIMITS[0] and r["ate_max_m"] <= REALTIME_ATE_LIMITS[1]):
            raise RuntimeError(f"realtime-64k {m}: ATE p50 {r['ate_p50_m']} m, max {r['ate_max_m']} m")
        if r["submaps"] < 2:
            raise RuntimeError(f"realtime-64k {m}: {r['submaps']} submaps")
    missing = [k for k, c in in_graph.items() if c <= 0]
    if missing:
        raise RuntimeError(f"realtime-64k: {missing} did not launch inside the step graph: {in_graph}")
    return counts, in_graph, dict(step_replay_kernels=step_kernels, raw_sums=raw_sums)


def kernels_by_key(prof, names):
    """Launches and device us of each ``__global__`` instantiation whose
    name holds one of ``names``, in a ``torch.profiler`` session."""
    out = {}
    for e in prof.key_averages():
        us = event_device_us(e)
        if us > 0 and any(n in e.key for n in names):
            out[e.key[:80]] = dict(launches=e.count, device_us=us, us_per_launch=us / e.count)
    return out


def _tests_module(name):
    """``tests/<name>.py`` of this checkout, loaded by its path (a ``tests``
    package elsewhere on the path may shadow the directory)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class record_raw_sums:
    """Within it, ``pair_sums`` and ``pair_sums_groups`` as the models call
    them (``localizability``, ``icp``) record into ``seen``, for each tuple
    of their terms' shapes (``"1x16384x3+1x16384x3"``), the first call's
    terms (copies) and the calls."""

    MODULES = ("localizability", "icp")

    def __init__(self, seen):
        import importlib

        self.seen = seen
        self.mods = [importlib.import_module(f"open3d_slam_private_tpu_torch.models.{m}") for m in self.MODULES]
        self.saved = []

    def _wrap(self, fn):
        def record(*terms):
            k = "+".join("x".join(map(str, t.shape)) for t in terms)
            if k not in self.seen:
                self.seen[k] = dict(first=[t.detach().clone() for t in terms], calls=0)
            self.seen[k]["calls"] += 1
            return fn(*terms)
        return record

    def __enter__(self):
        for m in self.mods:
            for name in ("pair_sums", "pair_sums_groups"):
                if hasattr(m, name):
                    self.saved.append((m, name, getattr(m, name)))
                    setattr(m, name, self._wrap(getattr(m, name)))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def graph_us(fn, calls=20):
    """Microseconds a call of ``fn`` inside a captured CUDA graph of
    ``calls`` calls: CUDA events around its replays over ``calls`` (a call's
    share of the graph's time, the gaps between its nodes included), as the
    realtime step runs it."""
    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    us = cuda_ms(graph.replay, reps=10) * 1e3 / calls
    del graph
    return us


def launch_floor(dev, nodes=100):
    """The launch floor: the device microseconds of an empty kernel (one
    block of 32 threads, ``LAUNCH_FLOOR_SRC``) launched alone
    (``torch.profiler`` device events), and inside a captured CUDA graph of
    ``nodes`` of them (the profiler's per-kernel device time, and
    :func:`graph_us`: a node's share of a graph's time)."""
    import ctypes

    from open3d_slam_private_tpu_torch.kernels import _build

    lib = _build.load("launch_floor", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], src=LAUNCH_FLOOR_SRC)

    def empty(count):
        rc = lib.launch_floor_launch(count, 1, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(lib, "launch_floor", rc)

    eager_us, _ = device_us_per_call(lambda: empty(1), ("launch_floor_empty",), reps=50)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        empty(1)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        empty(nodes)
    graph_kernel_us, _ = device_us_per_call(graph.replay, ("launch_floor_empty",), reps=5)
    floor = dict(us=eager_us, in_graph_kernel_us=graph_kernel_us / nodes if graph_kernel_us else None,
                 in_graph_node_us=graph_us(lambda: empty(1), calls=nodes), graph_nodes=nodes)
    say("launch_floor", name="launch_floor_empty", source="tools/launch_floor.cu", **floor)
    return floor


def raw_sums_timings(raw_sums, floor, steps=None, keys=None):
    """``moments``' raw entry at each terms shape recorded (``record_raw_sums``;
    ``keys``: those only): held bit for bit to its numpy model
    (``tests/moments_model.py``), to a rerun and to each problem's bits
    inside a batch of 64, and within 1e-5 of the terms' magnitude of the
    float64 sum, then timed against each group's ``t.sum(-2)`` (its
    plain version, one call a group, which is also the library call): us a
    call inside a captured graph (:func:`graph_us`, as the realtime step
    runs it) and wrapper ms, with its byte bound (the terms read once, the
    sums written once) and the launch floor's share (``floor``,
    :func:`launch_floor`, in a graph against in a graph). The device us of
    both come from a fresh process (:func:`fresh_device_us`). With
    ``steps``, the calls a step (recorded calls over ``steps``)."""
    from open3d_slam_private_tpu_torch.kernels import moments as mk

    raw_model = _tests_module("moments_model").raw_model
    bits = lambda x, y: torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))  # noqa: E731
    rows = {}
    for shape, rec in raw_sums.items():
        if keys is not None and shape not in keys:
            continue
        terms = [t.contiguous() for t in rec["first"]]
        flats = [t.reshape((-1,) + t.shape[-2:]) for t in terms]
        got = [g.reshape(f.shape[0], -1) for g, f in zip(mk.pair_sums_groups(*terms), flats)]
        worst = max(float(((g.double() - f.double().sum(-2)).abs() / (1e-5 * (f.double().abs().sum(-2) + 1e-30))).max())
                    for g, f in zip(got, flats))
        model_bits = all(bits(g, torch.from_numpy(raw_model(f.cpu().numpy())).to(g.device)) for g, f in zip(got, flats))
        rerun = all(bits(g, a.reshape(g.shape)) for g, a in zip(got, mk.pair_sums_groups(*terms)))
        # Each problem inside a batch of 64 (the problems repeated).
        reps = -(-64 // flats[0].shape[0])
        in64 = mk.pair_sums_groups(*(f.repeat(reps, 1, 1)[:64].contiguous() for f in flats))
        alone = all(bits(g, b64[:g.shape[0]]) for g, b64 in zip(got, in64))
        if not (worst <= 1.0 and model_bits and rerun and alone):
            raise RuntimeError(f"pair_sums {shape}: {worst:.3g} x tolerance, model bits {model_bits}, rerun "
                               f"{rerun}, in a batch of 64 {alone}")
        numel = sum(t.numel() for t in terms)
        out_numel = sum(t.numel() // t.shape[-2] for t in terms)
        plain = lambda x=terms: [t.sum(-2) for t in x]  # noqa: E731
        t = timed("moments", lambda x=terms: mk.pair_sums_groups(*x), plain, numel * 4 + out_numel * 4, numel,
                  library_fn=plain)
        P = terms[0].shape[-2]
        in_graph = graph_us(lambda x=terms: mk.pair_sums_groups(*x))
        rows[shape] = dict(columns=[x.shape[-1] for x in terms], plan=list(mk.raw_plan(P)),
                           calls_recorded=rec["calls"], worst_over_tolerance=worst, model_bit_equal=model_bits,
                           bit_identical_rerun=rerun, batch_independent_in_64=alone,
                           graph_us=in_graph,
                           library_graph_us=graph_us(plain), launch_floor_in_graph_us=floor["in_graph_node_us"],
                           launch_floor_share=floor["in_graph_node_us"] / in_graph,
                           bound_share_in_graph=t["bound_ms"] * 1e3 / in_graph, **t)
        if steps:
            rows[shape]["calls_per_step"] = rec["calls"] / steps
    return rows


MOMENTS_INPUTS = "build/moments_inputs.pt"  # the raw and structured inputs, for --side DIR --moments


def moments_timings(dev, sources, structured):
    """The raw entry at the shapes the paths in ``sources`` ({path:
    (recorded raw sums, keys to time or None, steps or None)}) launched, by
    :func:`raw_sums_timings`; saves their inputs and the structured
    entries' (``structured``, from ``_check_moments``) to
    ``MOMENTS_INPUTS`` for ``--side DIR --moments``."""

    raw, rows = {}, {}
    floor = launch_floor(dev)
    for path, (seen, keys, steps) in sources.items():
        for shape, rec in seen.items():
            if keys is None or shape in keys:
                raw[shape] = [t.cpu() for t in rec["first"]]
        rows[path] = raw_sums_timings(seen, floor, steps=steps, keys=keys)
    os.makedirs(os.path.dirname(MOMENTS_INPUTS), exist_ok=True)
    torch.save(dict(raw=raw, structured={k: v.cpu() if torch.is_tensor(v) else v
                                         for k, v in structured.items()}), MOMENTS_INPUTS)
    fresh = fresh_device_us()
    for path, shapes in rows.items():
        for shape, row in shapes.items():
            got = fresh[shape]
            row.update(device_us=got["device_us"], device_us_by_kernel=got["device_us_by_kernel"],
                       library_device_us=got["library_device_us"], device_us_from="fresh process",
                       bound_share=row["bound_ms"] * 1e3 / got["device_us"] if got["device_us"] else None)
        say("moments_raw_sums", path=path, shapes=shapes)
    return dict(launch_floor=floor, **rows)


def fresh_device_us():
    """The raw entry's and its library call's device us a call at each
    shape saved in ``MOMENTS_INPUTS``, from ``chip_smoke.py --side <this
    checkout> --moments`` run as a child process. The profiler of the
    smoke's own process, after the realtime phase, recorded no device
    event for these calls (cause not found); a fresh process records them.
    A shape recorded on two paths is timed on the last path's terms."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", root, "--moments"],
                          capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith('{"phase": "moments_side"')]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"moments side process failed (rc {proc.returncode}):\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return lines[0]["shapes"]


def most_called(seen):
    """Of recorded raw sums, the most-called shape of each signature (the
    groups' column counts)."""
    best = {}
    for shape, rec in seen.items():
        sig = "+".join(str(t.shape[-1]) for t in rec["first"])
        if sig not in best or rec["calls"] > seen[best[sig]]["calls"]:
            best[sig] = shape
    return set(best.values())


def moments_side(root):
    """``--side DIR --moments``: the checkout at ``DIR``'s ``moments`` on the
    main run's saved inputs (``MOMENTS_INPUTS``): device us a call (the
    ``moments`` ``__global__`` functions in a profiled session) and wrapper
    ms, each raw shape also inside a captured graph (:func:`graph_us`),
    through ``pair_sums_groups`` where the checkout has it, else
    ``pair_sums`` a group (its path's calls for the same sums), with each
    group's ``t.sum(-2)``'s device us beside it; and the structured entries
    at 8 x 65,536. The main run calls it on its own checkout
    (:func:`fresh_device_us`); to compare, run it once per side, each in
    its own process, in one call to the card (parent, change, change,
    parent)."""

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import open3d_slam_private_tpu_torch
    from open3d_slam_private_tpu_torch.kernels import moments as mk

    phase_device()
    saved = torch.load(MOMENTS_INPUTS)
    dev = torch.device("cuda", 0)
    out = {}
    for shape, terms in saved["raw"].items():
        terms = [t.to(dev) for t in terms]
        if hasattr(mk, "pair_sums_groups"):
            fn = lambda x=terms: mk.pair_sums_groups(*x)  # noqa: E731
        else:
            fn = lambda x=terms: [mk.pair_sums(t) for t in x]  # noqa: E731
        us, per = device_us_per_call(fn, DEVICE_KERNELS["moments"])
        out[shape] = dict(device_us=us, device_us_by_kernel=per, graph_us=graph_us(fn), ms=cuda_ms(fn),
                          library_device_us=session_device_us(lambda x=terms: [t.sum(-2) for t in x]))
    st = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in saved["structured"].items()}
    for kind, fn in (("point_to_plane", lambda: mk.point_to_plane_moments(st["p0"], st["q"], st["n"], st["w"])),
                     ("gicp", lambda: mk.gicp_moments(st["p0"], st["ns"], st["q"], st["n"], st["w"],
                                                      epsilon=st["epsilon"]))):
        us, per = device_us_per_call(fn, DEVICE_KERNELS["moments"])
        out[kind] = dict(device_us=us, device_us_by_kernel=per, ms=cuda_ms(fn))
    say("moments_side", root=root, package=os.path.dirname(open3d_slam_private_tpu_torch.__file__), shapes=out)


K1_NORMAL_EQ_INPUTS = "build/k1_normal_eq_inputs.pt"  # the kernel phase's inputs, for --k1-normal-eq


def k1_normal_eq_side(root):
    """``--side DIR --k1-normal-eq``: the checkout at ``DIR``'s K1 and
    normal_eq on the main run's saved inputs (``K1_NORMAL_EQ_INPUTS``: K1 at
    1 x 16,384, 1 x 4,096 and 8 x 65,536, normal_eq at 8 x 65,536 x 8,
    4,096 x 512 x 1, 1 x 16,384 x 1 and 1 x 4,096 x 1): device us a call
    (the wrapper's ``__global__`` functions in a profiled session), us a
    call inside a captured CUDA graph of 20 (:func:`graph_us`) and wrapper
    ms, with the launch floor (:func:`launch_floor`) of the same process. To
    compare, run it once per side, each in its own process, in one call to
    the card after a full run (parent, change, change, parent)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import open3d_slam_private_tpu_torch
    from open3d_slam_private_tpu_torch.kernels import normal_eq as nek
    from open3d_slam_private_tpu_torch.kernels import pair_gn as pgk

    phase_device()
    dev = torch.device("cuda", 0)
    saved = torch.load(K1_NORMAL_EQ_INPUTS)
    floor = launch_floor(dev)
    out = {}
    for key, args in saved.items():
        kernel, _ = key.split()
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        fn = (lambda a=args: pgk.pair_gn(*a)) if kernel == "pair_gn" else (lambda a=args: nek.normal_eq(*a))
        us, per = device_us_per_call(fn, DEVICE_KERNELS[kernel])
        out[key] = dict(device_us=us, device_us_by_kernel=per, graph_us=graph_us(fn), ms=cuda_ms(fn))
    say("k1_normal_eq_side", root=root, package=os.path.dirname(open3d_slam_private_tpu_torch.__file__),
        launch_floor=floor, shapes=out)


def _counters():
    from open3d_slam_private_tpu_torch.kernels import (
        gather_select,
        knn_brute,
        moments,
        normal_eq,
        pair_gn,
        select,
    )

    from open3d_slam_private_tpu_torch.kernels import sym_eig

    return dict(pair_gn=pair_gn.pair_gn, gather_select=gather_select.gather_select,
                pair_gn_k=pair_gn.pair_gn_k, rank_select_rows=select.rank_select_rows,
                rank_select_table=select.rank_select_table, knn_brute=knn_brute.knn_brute,
                normal_eq=normal_eq.normal_eq, moments=moments.moments, sym_eig=sym_eig.sym_eig)


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def pose_errors(T, T_true):
    """Translation (m) and rotation (rad) errors of ``[B, 4, 4]`` poses."""
    T = T.double().cpu().numpy().reshape(-1, 4, 4)
    T_true = np.asarray(T_true, np.float64).reshape(-1, 4, 4)
    terr = [float(np.linalg.norm(a[:3, 3] - b[:3, 3])) for a, b in zip(T, T_true)]
    rerr = [rot_angle(a[:3, :3].T @ b[:3, :3]) for a, b in zip(T, T_true)]
    return terr, rerr


def phase_headline(hs):
    """Bench headline: B=8 scan-to-map registrations on the cached rounds,
    with the gather kernel off and on, at knn = 8 (K3 instead of K1), with
    the rank-select kernel (K4's table entry), on the moment path
    (``fused_kernel=False``, the JAX chain's default: the ``moments`` kernel
    once a round) and on the direct in-round path (the light chain, no
    X-ICP, with exact trimming). Each leg's X-ICP detection goes through
    normal_eq. Returns each leg's launch counts."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod

    dev = hs["init"].device
    light = dataclasses.replace(hs["cfg"].degeneracy, method="none")
    legs = dict(rerank=dict(), gather=dict(gather_kernel=True), knn8=dict(knn=8),
                select=dict(select_kernel=True), moment=dict(fused_kernel=False),
                direct=dict(fast_trimming=False, degeneracy=light))
    need = dict(rerank=("pair_gn", "normal_eq"), gather=("pair_gn", "gather_select", "normal_eq"),
                knn8=("pair_gn_k", "normal_eq"), select=("pair_gn", "rank_select_table", "normal_eq"),
                moment=("moments", "normal_eq"), direct=("normal_eq",))
    never = dict(knn8=("pair_gn",), select=("rank_select_rows", "gather_select"),
                 moment=("pair_gn", "pair_gn_k"), direct=("pair_gn", "pair_gn_k", "moments"))
    counts = {}
    for leg, change in legs.items():
        cfg = dataclasses.replace(hs["cfg"], **change)

        def run():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = icp_mod.icp_batch(hs["readings"], hs["ref"], hs["init"], cfg)
            return out, [str(c.message) for c in caught]

        run()
        sync(dev)
        reset_counts()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            res, warned = run()
            sync(dev)
            times.append(time.perf_counter() - t)
        counts[leg] = read_counts()
        terr, rerr = pose_errors(res.transform, hs["T_trues"])
        sec = float(np.median(times))
        say("headline", leg=leg, config={k: getattr(v, "method", v) for k, v in change.items()}, batch=BATCH,
            points=SCAN_POINTS, reg_per_s=BATCH / sec, batch_ms=sec * 1e3, batch_ms_runs=[t * 1e3 for t in times],
            mean_iterations=float(res.iterations.float().mean()),
            row_saturation=float(res.match_row_saturation.mean()),
            max_trans_err_m=max(terr), max_rot_err_rad=max(rerr), launches=counts[leg],
            warnings=sorted(set(warned)))
        if not (np.isfinite(terr).all() and max(terr) <= 0.02 and max(rerr) <= 0.01):
            raise RuntimeError(f"headline {leg} registration error: trans {terr} rot {rerr}")
        if any(counts[leg][k] <= 0 for k in need[leg]):
            raise RuntimeError(f"headline {leg} missed a kernel: {counts[leg]}")
        if any(counts[leg][k] != 0 for k in never.get(leg, ())):
            raise RuntimeError(f"headline {leg} ran a kernel of another leg: {counts[leg]}")
    return counts


def phase_gicp(hs):
    """BASELINE config 3, as ``bench.py:820-836`` runs it: B=8 scan-to-map
    GICP registrations of the headline's readings (with their grid normals,
    :func:`gicp_readings`) against the headline's 0.15 m submap, the light
    chain with ``minimizer="gicp"`` and ``fused_kernel=False`` (the GICP
    moment path: the ``moments`` kernel's 147 sums once a round). Three
    timed runs, one profiled (device time, idle share). Returns the launch
    counts."""
    from torch.profiler import ProfilerActivity, profile

    from open3d_slam_private_tpu_torch.models import icp as icp_mod

    dev = hs["init"].device
    readings = gicp_readings(hs)
    cfg = dataclasses.replace(hs["cfg"], degeneracy=dataclasses.replace(hs["cfg"].degeneracy, method="none"),
                              minimizer="gicp", fused_kernel=False)

    def run():
        return icp_mod.icp_batch(readings, hs["ref"], hs["init"], cfg)

    run()
    sync(dev)
    reset_counts()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        res = run()
        sync(dev)
        times.append(time.perf_counter() - t)
    counts = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        sync(dev)
        wall = time.perf_counter() - t
    device_ms, top = profiled_device_ms(prof)
    terr, rerr = pose_errors(res.transform, hs["T_trues"])
    sec = float(np.median(times))
    say("gicp", cell="gicp-b8", batch=BATCH, points=SCAN_POINTS, reg_per_s=BATCH / sec, batch_ms=sec * 1e3,
        batch_ms_runs=[t * 1e3 for t in times], profiled_wall_ms=wall * 1e3, device_ms=device_ms,
        idle_share=None if device_ms is None else 1.0 - device_ms / (wall * 1e3), top_device_items=top,
        mean_iterations=float(res.iterations.float().mean()), max_trans_err_m=max(terr),
        max_rot_err_rad=max(rerr), moments_launches=counts["moments"], launches=counts)
    if not (np.isfinite(terr).all() and max(terr) <= 0.02 and max(rerr) <= 0.01):
        raise RuntimeError(f"gicp-b8 registration error: trans {terr} rot {rerr}")
    if counts["moments"] <= 0 or counts["pair_gn"] != 0:
        raise RuntimeError(f"gicp-b8 launches: {counts}")
    return counts


def phase_batch_independence(hs):
    """The chains this slice added, each problem's bits independent of its
    batch: ``register_hypotheses`` of a 1,024-point reading (with grid
    normals) with 64 seeds against the headline's reference cloud, and the
    same first 4 seeds as a batch of 4, must give the same transforms bit
    for bit. Chains: the moment path with the binary method and with the
    ternary method (analysis per round), the GICP moment path, the direct
    in-round path (exact trimming) and the per-iteration chain with GICP."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.models.localizability import DegeneracyConfig
    from open3d_slam_private_tpu_torch.ops import pointcloud as pc

    dev = hs["init"].device
    g = gicp_readings(hs)
    reading = pc.PointBatch(xyz=g.xyz[0, ::64].contiguous(), mask=g.mask[0, ::64].contiguous(),
                            extras={"normals": g.normals[0, ::64].contiguous()})
    rngb = np.random.default_rng(9)
    twists = np.c_[rngb.uniform(-0.05, 0.05, (64, 3)), rngb.uniform(-0.5, 0.5, (64, 3))]
    seeds = torch.as_tensor(exp_se3_np(twists), dtype=torch.float32, device=dev) @ hs["init"][0]
    base = dataclasses.replace(hs["cfg"], fused_kernel=False, coarse_iterations=0, max_iterations=12,
                               candidate_refresh_every=4)
    none = DegeneracyConfig()
    chains = {
        "moment-optimized": base,
        "moment-ternary": dataclasses.replace(base, degeneracy=DegeneracyConfig(method="equality_constraints")),
        "moment-gicp": dataclasses.replace(base, minimizer="gicp", degeneracy=none),
        "direct": dataclasses.replace(base, fast_trimming=False, degeneracy=none),
        "iter-gicp": dataclasses.replace(base, minimizer="gicp", degeneracy=none, candidate_refresh_every=0),
    }
    out = {}
    for name, cfg in chains.items():
        reset_counts()
        big = icp_mod.register_hypotheses(reading, hs["ref_cloud"], seeds, cfg).transform[:4]
        small = icp_mod.register_hypotheses(reading, hs["ref_cloud"], seeds[:4].contiguous(), cfg).transform
        sync(dev)
        equal = torch.equal(big.contiguous().view(torch.int32), small.contiguous().view(torch.int32))
        out[name] = dict(bit_equal=equal, finite=bool(torch.isfinite(big).all()),
                         max_trans_diff_m=float((big[:, :3, 3] - small[:, :3, 3]).norm(dim=-1).max()),
                         launches={k: v for k, v in read_counts().items() if v})
    say("batch_independence", seeds=64, compared=4, points=int(reading.mask.sum()), chains=out)
    bad = [k for k, v in out.items() if not (v["bit_equal"] and v["finite"])]
    if bad:
        raise RuntimeError(f"batch independence: chains {bad} part between a batch of 64 and of 4")
    return out


def phase_register_pair(hs):
    """``register_pair`` of one 65,536-point reading against the headline's
    reference cloud on the reference-exact per-iteration chain (exact
    trimming), with the grid, brute and brute_pallas (K5) matchers."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch

    dev = hs["init"].device
    base = icp_mod.ICPConfig(knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 16,
                             grid_bucket_cap=48, trimmed_ratio=0.9, max_iterations=30)
    r = hs["readings"]
    reading = PointBatch(xyz=r.xyz[0], mask=r.mask[0])
    out = {}
    for matcher in ("grid", "brute", "brute_pallas"):
        cfg = dataclasses.replace(base, matcher=matcher)
        sync(dev)
        reset_counts()
        t = time.perf_counter()
        res = icp_mod.register_pair(reading, hs["ref_cloud"], hs["init"][0], cfg)
        sync(dev)
        sec = time.perf_counter() - t
        counts = read_counts()
        (terr,), (rerr,) = pose_errors(res.transform, hs["T_trues"][0])
        out[matcher] = (res.transform.double().cpu(), counts)
        say("register_pair", matcher=matcher, points=SCAN_POINTS,
            reference_points=int(hs["ref_cloud"].mask.sum()), ms=sec * 1e3,
            iterations=int(res.iterations), converged=bool(res.converged),
            trans_err_m=terr, rot_err_rad=rerr, launches=counts)
        if not (np.isfinite(terr) and terr <= 0.02 and rerr <= 0.01):
            raise RuntimeError(f"register_pair {matcher} error: trans {terr} rot {rerr}")
    if out["brute_pallas"][1]["knn_brute"] <= 0:
        raise RuntimeError(f"register_pair brute_pallas missed K5: {out['brute_pallas'][1]}")
    (dt,), (dr,) = pose_errors(out["brute_pallas"][0], out["brute"][0].numpy())
    say("register_pair_k5_vs_brute", trans_diff_m=dt, rot_diff_rad=dr)
    if not (dt <= 1e-4 and dr <= 1e-4):
        raise RuntimeError(f"brute_pallas and brute disagree: {dt} m, {dr} rad")
    return {m: counts for m, (_, counts) in out.items()}


def _hold_hypotheses_k5(icp_mod, skel, ref_cloud, seeds, cfg, T):
    """The burst's K5 leg, checked. (1) The timed 4,096-seed leg again, each
    K5 call held against the plain version on its own inputs (the first
    call on all its queries, the others on their first 65,536), and its
    poses compared with the timed run's bits. (2) The chain on the first 64
    seeds with the kernel and with K5's plain version in its place, held to
    each other (1e-4 m / rad). (3) The timed leg's first 64 poses against
    the 64-seed chain's: a problem's result must not depend on the batch it
    runs in, so the caller holds them to 0.0 m. The "brute" matcher clamps
    the expansion at 0 as the JAX package's does and K5 does not, so the
    caller reports, not holds, its distance from the 64-seed chain."""
    from open3d_slam_private_tpu_torch.kernels.knn_brute import knn_brute_plain

    kernel, calls = icp_mod.knn_brute, []

    def held(q, r):
        d2, ids = kernel(q, r)
        sub = slice(None) if not calls else slice(0, 65536)
        calls.append(dict(queries=int(q[sub].shape[0]), **_held_knn_brute(
            (d2[sub], ids[sub]), knn_brute_plain(q[sub], r), f"hypotheses K5 call {len(calls)}")))
        return d2, ids

    icp_mod.knn_brute = held
    try:
        again = icp_mod.register_hypotheses(skel, ref_cloud, seeds, cfg).transform
    finally:
        icp_mod.knn_brute = kernel
    (at, _) = pose_errors(T, again.double().cpu().numpy())
    few = icp_mod.register_hypotheses(skel, ref_cloud, seeds[:64], cfg).transform
    icp_mod.knn_brute = knn_brute_plain
    try:
        plain = icp_mod.register_hypotheses(skel, ref_cloud, seeds[:64], cfg).transform
    finally:
        icp_mod.knn_brute = kernel
    (dt, dr) = pose_errors(few, plain.double().cpu().numpy())
    (st, _) = pose_errors(T[:64], few.double().cpu().numpy())
    if not (max(dt) <= 1e-4 and max(dr) <= 1e-4):
        raise RuntimeError(f"hypotheses brute_pallas vs its plain chain: {max(dt)} m, {max(dr)} rad")
    return dict(k5_calls_held=len(calls), k5_queries_held=[c["queries"] for c in calls],
                k5_max_d2_ulps=max(c["max_d2_ulps"] for c in calls),
                rerun_bit_identical=bool(torch.equal(again.view(torch.int32), T.view(torch.int32))),
                rerun_max_trans_diff_m=max(at), max_trans_diff_m=max(dt), max_rot_diff_rad=max(dr),
                batch_4096_vs_64_max_trans_diff_m=max(st),
                batch_4096_vs_64_seeds_beyond_0_1_mm=int(np.sum(np.asarray(st) > 1e-4)), few=few)


def hypotheses_setup(hs):
    """The relocalisation burst's inputs: one 512-point skeleton scan of the
    headline's scene, 4,096 seeds (+-0.1 rad, +-2 m) around the truth (the
    identity) and the light chain's config (no coarse stage, no candidate
    caching, no degeneracy handling). Returns (skeleton, seeds, config)."""
    from open3d_slam_private_tpu_torch.ops import pointcloud as pc

    dev = hs["init"].device
    hyp_cfg = dataclasses.replace(
        hs["cfg"], degeneracy=dataclasses.replace(hs["cfg"].degeneracy, method="none"),
        coarse_iterations=0, candidate_refresh_every=0, max_iterations=12,
    )
    skel = pc.from_points(sample_scan(hs["scene"], SKELETON_POINTS, np.eye(4), seed=99),
                          capacity=SKELETON_POINTS, device=dev)
    rngh = np.random.default_rng(5)
    twists = np.c_[rngh.uniform(-0.1, 0.1, (HYPOTHESES, 3)), rngh.uniform(-2, 2, (HYPOTHESES, 3))]
    seeds = torch.as_tensor(exp_se3_np(twists), dtype=torch.float32, device=dev)
    return skel, seeds, hyp_cfg


def phase_hypotheses(hs):
    """The relocalisation burst (``register_hypotheses``) of
    :func:`hypotheses_setup` against the headline's reference cloud; a grid
    leg and a brute_pallas (K5) leg, checked by :func:`_hold_hypotheses_k5`.
    Returns each leg's launch counts."""
    from open3d_slam_private_tpu_torch.models import icp as icp_mod

    dev = hs["init"].device
    skel, seeds, hyp_cfg = hypotheses_setup(hs)
    out = {}
    for matcher in ("grid", "brute_pallas"):
        cfg = dataclasses.replace(hyp_cfg, matcher=matcher)
        sync(dev)
        reset_counts()
        t = time.perf_counter()
        res = icp_mod.register_hypotheses(skel, hs["ref_cloud"], seeds, cfg)
        sync(dev)
        sec = time.perf_counter() - t
        counts = out[matcher] = read_counts()
        T = res.transform
        if not bool(torch.isfinite(T).all()):
            raise RuntimeError(f"hypotheses {matcher}: non-finite poses")
        terr, rerr = pose_errors(T, np.broadcast_to(np.eye(4), (HYPOTHESES, 4, 4)))
        within = float(np.mean(np.asarray(terr) <= 0.05))
        say("hypotheses", matcher=matcher, seeds=HYPOTHESES, points=SKELETON_POINTS,
            queries_per_iteration=HYPOTHESES * SKELETON_POINTS, seconds=sec,
            hypotheses_per_s=HYPOTHESES / sec, share_within_5cm=within,
            mean_iterations=float(res.iterations.float().mean()), launches=counts)
        if matcher == "brute_pallas":
            if counts["knn_brute"] <= 0:
                raise RuntimeError(f"hypotheses brute_pallas missed K5: {counts}")
            out_k5 = _hold_hypotheses_k5(icp_mod, skel, hs["ref_cloud"], seeds, cfg, T)
            brute = icp_mod.register_hypotheses(skel, hs["ref_cloud"], seeds[:64],
                                                dataclasses.replace(hyp_cfg, matcher="brute"))
            (bt, _) = pose_errors(out_k5.pop("few"), brute.transform.double().cpu().numpy())
            say("hypotheses_k5_vs_plain", seeds=int(min(64, HYPOTHESES)), **out_k5,
                vs_brute_expansion_max_trans_diff_m=max(bt),
                vs_brute_expansion_seeds_beyond_0_1_mm=int(np.sum(np.asarray(bt) > 1e-4)))
            if out_k5["batch_4096_vs_64_max_trans_diff_m"] != 0.0:
                raise RuntimeError("hypotheses brute_pallas: a seed's pose depends on the batch size "
                                   f"({out_k5['batch_4096_vs_64_max_trans_diff_m']} m); "
                                   "python3 tests/torch_batch_dependence.py names the first op that parts")
    return out


def compare_side(root):
    """The phases that compare two checkouts, run from the checkout at
    ``root`` with that checkout's own ``chip_smoke.py`` and package: the
    kernel checks, ``register_pair`` three times, a ``torch.profiler``
    session around one ``register_pair`` brute_pallas call and around one
    run of the headline's select and knn = 8 legs (host wall against device
    time), and the relocalisation burst. Run it once per side, each in its
    own process, all in one call to the card, e.g. parent, change, change,
    parent::

        python3 chip_smoke.py --side build/parent; python3 chip_smoke.py --side .
    """
    import importlib.util

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("side_smoke", os.path.join(root, "chip_smoke.py"))
    side = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(side)
    side.say("side", root=root)
    side.phase_device()
    side.phase_build()
    hs = side.headline_setup(torch.device("cuda", 0))
    side.phase_kernels(hs)
    for _ in range(3):
        side.phase_register_pair(hs)

    from open3d_slam_private_tpu_torch.models import icp as icp_mod
    from open3d_slam_private_tpu_torch.ops.pointcloud import PointBatch

    def profiled(what, fn, **kv):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        device_ms, top = profiled_device_ms(prof)
        items = sum(e.count for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA)
        side.say(what, profiled_wall_ms=wall * 1e3, device_ms=device_ms, device_items=items,
                 top_device_items=top, **kv)

    base = icp_mod.ICPConfig(knn=1, max_match_dist=0.5, matcher="brute_pallas", grid_table_size=1 << 16,
                             grid_bucket_cap=48, trimmed_ratio=0.9, max_iterations=30)
    r = hs["readings"]
    reading = PointBatch(xyz=r.xyz[0], mask=r.mask[0])
    profiled("register_pair_profile",
             lambda: icp_mod.register_pair(reading, hs["ref_cloud"], hs["init"][0], base),
             matcher="brute_pallas")
    for leg, change in (("select", dict(select_kernel=True)), ("knn8", dict(knn=8))):
        cfg = dataclasses.replace(hs["cfg"], **change)
        profiled("headline_profile", lambda c=cfg: icp_mod.icp_batch(r, hs["ref"], hs["init"], c),
                 leg=leg, config=change)
    side.phase_hypotheses(hs)


def main():
    import open3d_slam_private_tpu_torch  # noqa: F401  (fails outside the repo)

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    hs = headline_setup(dev)
    kernels = phase_kernels(hs)
    # Each path's launch counts: set to 0 just before it, read just after.
    pipeline_counts, k1_pipeline_us, slam_summary = phase_pipeline(dev)
    realtime_counts, realtime_in_graph, realtime_kernels = phase_realtime(dev, slam_summary)
    # The smoke's drive takes each scan at one instant (``sample_scan``), so
    # the evaluation configuration runs with motion compensation off. Its
    # ATE limit is the JAX package's own accuracy in this configuration on
    # this drive (tests/torch_eval_drive.py, on the CPU: p50 0.0639 m, max
    # 0.1242 m), above the production configuration's 0.05 m.
    eval_raw, independence_raw = {}, {}
    eval_counts, _, _ = phase_pipeline(
        dev, eval_slam_config(motion_compensation=False), cell="pipeline-64k-eval", min_submaps=1,
        ate_limits=(0.08, 0.15), record=eval_raw,
        motion_compensation="off: the drive's scans are each taken at one instant",
        depth=f"{PIPELINE_SCANS} scans, not cut")
    paths = dict(pipeline=pipeline_counts, realtime=realtime_counts, pipeline_eval=eval_counts,
                 mapper=phase_mapper(dev))
    paths.update({f"headline_{leg}": c for leg, c in phase_headline(hs).items()})
    paths["gicp_b8"] = phase_gicp(hs)
    paths.update({f"register_pair_{m}": c for m, c in phase_register_pair(hs).items()})
    paths.update({f"hypotheses_{m}": c for m, c in phase_hypotheses(hs).items()})
    with record_raw_sums(independence_raw):
        phase_batch_independence(hs)
    raw_rows = moments_timings(dev, dict(
        realtime=(realtime_kernels["raw_sums"], None, REALTIME_CHECK_SCANS),
        pipeline_eval=(eval_raw, most_called(eval_raw), None),
        batch_independence=(independence_raw, most_called(independence_raw), None)), hs["moments_structured"])
    # K4's rows entry carries the Pallas kernel's contract and lies on no
    # path: the select leg reads the rows in place (K4's table entry). Its
    # launches are those of every path, 0 (the select leg checks it).
    main_path = dict(pair_gn="pipeline", gather_select="headline_gather", pair_gn_k="headline_knn8",
                     rank_select_rows=None, rank_select_table="headline_select",
                     knn_brute="register_pair_brute_pallas", normal_eq="headline_knn8",
                     moments="headline_moment", sym_eig="realtime")
    for k in kernels:
        path = main_path[k["name"]]
        k["launches"] = paths[path][k["name"]] if path else sum(c[k["name"]] for c in paths.values())
        k["launches_path"] = path
        if path and k["launches"] <= 0:
            raise RuntimeError(f"{k['name']} was not launched on its path {path}")
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items() if c[k["name"]]}
        if k["name"] == "pair_gn":
            k["device_us_per_launch_in_pipeline"] = k1_pipeline_us
        if k["name"] in realtime_in_graph:  # from the graphs' profiled replays
            k["launches_per_step_replay"] = realtime_in_graph[k["name"]]
            k["in_step_replay"] = {key: v for key, v in realtime_kernels["step_replay_kernels"].items()
                                   if REALTIME_COUNTED[k["name"]].split("_partial")[0] in key}
        if k["name"] == "moments":
            k["at_raw_shapes"] = raw_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":

    if sys.argv[1:2] == ["--side"] and sys.argv[3:4] == ["--sym-eig"]:
        sym_eig_side(sys.argv[2])
    elif sys.argv[1:2] == ["--side"] and sys.argv[3:4] == ["--moments"]:
        moments_side(sys.argv[2])
    elif sys.argv[1:2] == ["--side"] and sys.argv[3:4] == ["--k1-normal-eq"]:
        k1_normal_eq_side(sys.argv[2])
    elif sys.argv[1:2] == ["--side"]:
        compare_side(sys.argv[2])
    else:
        main()

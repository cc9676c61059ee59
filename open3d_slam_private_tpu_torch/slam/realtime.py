"""The real-time SLAM step: one device program a scan, stats read back at a
poll cadence.

Twin of ``open3d_slam_private_tpu/slam/realtime.py`` with loop closure and
the dense map off. :func:`rt_step` runs the whole per-scan step on the
device over device-resident state (:class:`RtState`): undistortion,
odometry with its fitness gate, scan-to-map X-ICP with the return to the
prior, the insertion gate, carving and insertion, and a packed stats vector.
Every decision the offline :class:`~.pipeline.SlamPipeline` takes on the
host is a device-side select here (``torch.where`` over both branches, where
JAX has ``lax.cond``): so the insertion (and carving, when on) runs every
scan and its result is kept only when the gate passes (the insertion is
about 5 ms of device time a scan at the production sizes on an H100,
``PERF.md`` section 5). The reference
rebuild is the one branch the host can decide without reading the device:
under ``async_rebuild`` it is its own program at the host's cadence, and the
step holds no rebuild at all.

:class:`RealtimePipeline` is the host front end. On the CPU it runs
:func:`rt_step` eagerly. On a CUDA card :meth:`RealtimePipeline.warmup`
captures three CUDA graphs over static buffers: the step (or a chunk of
steps), the reference rebuild and the seeding of a fresh submap bank; a scan
is copied into the step's static input and the step graph replayed, its
stats copied into a ring of device rows that :meth:`RealtimePipeline.poll`
fetches in one copy. Nothing reads the device between dispatch and poll
(the ICP loops run in their static-trip mode: every round and iteration
that could hold an active problem, under the done masks). A failed capture
raises; there is no eager path on the card.

Not ported, and refused by name (``pipeline.check_config``): loop closure
(the worker thread, place recognition, the pose graph and its increments)
and the dense map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from open3d_slam_private_tpu_torch.device import resolve
from open3d_slam_private_tpu_torch.geometry import se3
from open3d_slam_private_tpu_torch.models import icp as icp_mod
from open3d_slam_private_tpu_torch.models.minimizers import esum
from open3d_slam_private_tpu_torch.ops import pointcloud as pc
from open3d_slam_private_tpu_torch.ops.grid_hash import _sq3, f32, recip
from open3d_slam_private_tpu_torch.ops.voxel import voxel_downsample
from open3d_slam_private_tpu_torch.slam import motion_compensation as mc_mod
from open3d_slam_private_tpu_torch.slam import odometry as odo_mod
from open3d_slam_private_tpu_torch.slam import submap as submap_mod
from open3d_slam_private_tpu_torch.slam.imu import ImuBuffer
from open3d_slam_private_tpu_torch.slam.mapper import build_map_reference, process_scan_for_matching
from open3d_slam_private_tpu_torch.slam.pipeline import SlamConfig, check_config
from open3d_slam_private_tpu_torch.slam.submap_collection import SubmapCollection, SubmapEntry

# The packed per-frame stats vector (float32), as in the JAX twin.
IDX_POSE = slice(0, 16)  # row-major 4x4 map -> sensor pose
IDX_CONVERGED = 16
IDX_INSERTED = 17
IDX_DEGENERATE = 18
IDX_OVERLAP = 19
IDX_ITERATIONS = 20
IDX_OCCUPANCY = 21  # valid points in the active bank after this step
IDX_ODOM_OK = 22  # odometry fitness gate passed
IDX_USE_PRIOR = 23  # registration rejected -> odometry prior kept
IDX_RESIDUAL = 24
IDX_ROW_SAT = 25  # matcher candidate-row saturation
IDX_REBUILT = 26  # reference rebuild ran this step
IDX_CARVED = 27
STATS_LEN = 28


@dataclasses.dataclass(frozen=True)
class RtState:
    """Device-resident per-scan SLAM state of fixed shapes (the JAX twin's
    without the dense map, which is not ported). ``bank.num_scans`` is a
    host count in the port and the step leaves it alone
    (``scans_in_active`` counts the insertions on the device)."""

    odom_prev: pc.PointBatch  # previous preprocessed scan (odometry reference)
    last_motion: torch.Tensor  # [4, 4] last scan-to-scan odometry motion
    map_pose: torch.Tensor  # [4, 4] map -> range sensor (latest registered)
    ref: icp_mod.ICPReference  # active scan-to-map reference
    scans_since_reinit: torch.Tensor  # int32 []
    last_insert_pos: torch.Tensor  # [3]
    bank: submap_mod.SubmapState  # the active submap bank
    scans_in_active: torch.Tensor  # int32 [] (carve cadence counter)


# ---------------------------------------------------------------------------
# State trees: the dataclasses of the state, walked field by field.
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the tensors of same-structured trees (dataclasses, dicts,
    tensors); other leaves (ints, None, floats) come from the first."""
    first = trees[0]
    if torch.is_tensor(first):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return first


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _select(flag: torch.Tensor, a, b):
    """Tree ``a`` where the 0-d bool ``flag``, else ``b`` (a device select of
    every leaf: both branches were computed)."""
    return tree_map(lambda x, y: torch.where(flag, x, y), a, b)


def _copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same-shaped leaf of ``dst``."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 4 x 4 matrices as elementwise sums in a fixed order (no
    library call picks an algorithm)."""
    return esum("ij,jk->ik", a, b)


# ---------------------------------------------------------------------------
# The device step.
# ---------------------------------------------------------------------------


def _empty_odom_prev(cfg: SlamConfig, device) -> pc.PointBatch:
    cap = cfg.odometry.max_points if not cfg.use_external_odometry else 8
    b = pc.from_points(torch.zeros((0, 3), device=device), capacity=cap)
    # The odometry preprocess adds normals; keep the structure the same.
    return b.with_extras(normals=torch.zeros((cap, 3), device=device))


def rt_init(scan: pc.PointBatch, map_pose: torch.Tensor, cfg: SlamConfig) -> RtState:
    """First-scan initialisation on the scan's device: insert into a fresh
    bank, build the registration reference, seed the odometry state."""
    dev = scan.device
    mcfg = cfg.mapper
    map_pose = map_pose.to(device=dev, dtype=torch.float32)
    proc = process_scan_for_matching(scan, mcfg)
    bank = submap_mod.create(cfg.submaps.submap_capacity, device=dev)
    bank = submap_mod.insert_scan(bank, proc, map_pose, cfg.submaps.submap_voxel_size,
                                  cfg.submaps.submap_crop_radius)
    ref = build_map_reference(bank.cloud, map_pose[:3, 3], mcfg)
    if cfg.use_external_odometry:
        odom_prev = _empty_odom_prev(cfg, dev)
    else:
        odom_prev = odo_mod.preprocess(scan, cfg.odometry)
    return RtState(
        odom_prev=odom_prev,
        last_motion=torch.eye(4, device=dev),
        map_pose=map_pose.clone(),
        ref=ref,
        scans_since_reinit=torch.zeros((), dtype=torch.int32, device=dev),
        last_insert_pos=map_pose[:3, 3].clone(),
        bank=bank,
        scans_in_active=torch.ones((), dtype=torch.int32, device=dev),
    )


def rt_step(state: RtState, scan: pc.PointBatch, dt: torch.Tensor, ext_motion: torch.Tensor,
            cfg: SlamConfig, static_trip: bool = False, rebuild_branch: bool = True):
    """One SLAM step on the device -> ``(new_state, stats [STATS_LEN])``.

    ``dt`` (0-d) and ``ext_motion`` ([4, 4]) are tensors on the state's
    device. The host decisions of ``SlamPipeline.process_scan`` become
    selects: the odometry fitness gate, the return to the prior on a
    non-finite or degenerate-and-disjoint registration, the min-movement
    insertion gate and the carve cadence; both branches run. The reference
    rebuild at the cadence (``reference_reinit_every``) is a select too, or,
    with ``rebuild_branch=False`` (a caller that rebuilds on its own, as
    ``RealtimePipeline`` under ``async_rebuild``), absent. ``static_trip``:
    the ICP loops run without reading the device (a CUDA graph's mode; the
    same bits)."""
    ocfg, mcfg, mc = cfg.odometry, cfg.mapper, cfg.motion_compensation
    dev = state.map_pose.device

    if mc.enabled:
        twist = se3.log_se3(state.last_motion) * (f32(mc.scan_duration, dev) / torch.clamp(dt, min=1e-6))
        if mc.use_times_channel and "times" in scan.extras:
            t = scan.extras["times"][..., 0]
            t_min = torch.where(scan.mask, t, torch.inf).amin()
            t_max = torch.where(scan.mask, t, -torch.inf).amax()
            phases = torch.clamp((t - t_min) / torch.clamp(t_max - t_min, min=1e-9), 0.0, 1.0)
            scan = mc_mod.undistort(scan, twist, phases)
        else:
            scan = mc_mod.undistort_with_azimuth(scan, twist, mc.clockwise)

    if cfg.use_external_odometry:
        motion = ext_motion
        odom_prev = state.odom_prev
        odom_ok = torch.ones((), dtype=torch.bool, device=dev)
    else:
        odom_proc = odo_mod.preprocess(scan, ocfg)
        odo = icp_mod.register_pair(odom_proc, state.odom_prev, state.last_motion, ocfg.icp,
                                    static_trip=static_trip)
        odom_ok = (odo.overlap_ratio >= ocfg.min_fitness) & torch.isfinite(odo.transform).all()
        motion = torch.where(odom_ok, odo.transform, state.last_motion)
        odom_prev = odom_proc

    proc = process_scan_for_matching(scan, mcfg)
    guess = _mm(state.map_pose, motion)
    if rebuild_branch:
        rebuild = state.scans_since_reinit >= mcfg.reference_reinit_every
        ref = _select(rebuild, build_map_reference(state.bank.cloud, guess[:3, 3], mcfg), state.ref)
        scans_since_reinit = torch.where(rebuild, 1, state.scans_since_reinit + 1).to(torch.int32)
    else:
        rebuild = torch.zeros((), dtype=torch.bool, device=dev)
        ref = state.ref
        scans_since_reinit = state.scans_since_reinit + 1

    res = icp_mod.icp_single(proc, ref, guess, mcfg.icp, static_trip=static_trip)
    finite = torch.isfinite(res.transform).all()
    use_prior = ~finite | (res.degenerate & (res.overlap_ratio < 0.05))
    new_pose = torch.where(use_prior, guess, res.transform)

    moved = torch.linalg.vector_norm(new_pose[:3, 3] - state.last_insert_pos) >= mcfg.min_movement_for_insertion
    insert = moved & ~use_prior
    scfg = cfg.submaps
    bank = state.bank
    carved = torch.zeros((), dtype=torch.bool, device=dev)
    if scfg.carve_every_n > 0:
        n = scfg.carve_every_n
        carved = insert & (state.scans_in_active > 0) & (state.scans_in_active % n == 0)
        cut = submap_mod.carve(bank, scan, new_pose, angle_tol=scfg.carve_angle_tol,
                               range_margin=scfg.carve_range_margin)
        bank = dataclasses.replace(bank, cloud=_select(carved, cut.cloud, bank.cloud))
    grown = submap_mod.insert_scan(bank, proc, new_pose, scfg.submap_voxel_size,
                                   scfg.submap_crop_radius)
    bank = dataclasses.replace(bank, cloud=_select(insert, grown.cloud, bank.cloud))
    last_insert_pos = torch.where(insert, new_pose[:3, 3], state.last_insert_pos)
    scans_in_active = state.scans_in_active + insert.to(torch.int32)
    occupancy = bank.cloud.mask.sum().float()

    flags = [res.converged, insert, res.degenerate, res.overlap_ratio, res.iterations, occupancy,
             odom_ok, use_prior, res.residual, res.match_row_saturation, rebuild, carved]
    stats = torch.cat([new_pose.reshape(-1), torch.stack([x.float() for x in flags])])
    new_state = RtState(
        odom_prev=odom_prev,
        last_motion=motion,
        map_pose=new_pose,
        ref=ref,
        scans_since_reinit=scans_since_reinit,
        last_insert_pos=last_insert_pos,
        bank=bank,
        scans_in_active=scans_in_active,
    )
    return new_state, stats


def rt_step_chunk(state: RtState, scans: pc.PointBatch, dts: torch.Tensor, ext_motions: torch.Tensor,
                  cfg: SlamConfig, static_trip: bool = False, rebuild_branch: bool = True):
    """K sequential :func:`rt_step`\\ s over stacked scans ``[K, N, ...]``,
    ``dts [K]`` and ``ext_motions [K, 4, 4]`` -> ``(state, stats [K,
    STATS_LEN])``: one stats buffer for the chunk."""
    rows = []
    for k in range(dts.shape[0]):
        scan = pc.PointBatch(xyz=scans.xyz[k], mask=scans.mask[k],
                             extras={n: v[k] for n, v in scans.extras.items()})
        state, stats = rt_step(state, scan, dts[k], ext_motions[k], cfg, static_trip=static_trip,
                               rebuild_branch=rebuild_branch)
        rows.append(stats)
    return state, torch.stack(rows)


# ---------------------------------------------------------------------------
# The packed scan upload: one [N, 4] uint16 array (x, y, z quantised over the
# scan's box, ~1.5 mm at 100 m; the sweep phase in 16 bits, 0xFFFF marks an
# invalid point) and an 8-float header, 8 bytes a point.
# ---------------------------------------------------------------------------


def pack_scan_u16(scan_xyz: np.ndarray, mask: np.ndarray, times: Optional[np.ndarray]) -> tuple:
    """Host-side packing -> (packed [N, 4] uint16, header [8] float32)."""
    xyz = np.asarray(scan_xyz, np.float32)
    m = np.asarray(mask, bool)
    n = xyz.shape[0]
    if m.any():
        lo = xyz[m].min(axis=0)
        hi = xyz[m].max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    span = np.maximum(hi - lo, 1e-6)
    q = np.zeros((n, 4), np.uint16)
    qf = np.clip((xyz - lo) / span * 65535.0 + 0.5, 0, 65535)
    q[:, :3] = qf.astype(np.uint16)
    if times is not None:
        t = np.clip(np.asarray(times, np.float32).reshape(n), 0.0, 1.0)
        q[:, 3] = np.minimum((t * 65534.0 + 0.5).astype(np.uint32), 65534).astype(np.uint16)
    q[~m, 3] = 0xFFFF
    header = np.zeros(8, np.float32)
    header[:3] = lo
    header[3:6] = span
    header[6] = 1.0 if times is not None else 0.0
    return q, header


def packed_tensor(packed: np.ndarray, device=None) -> torch.Tensor:
    """A packed ``[N, 4]`` uint16 array as the int16 tensor of the same bits
    (PyTorch's uint16 has few operations)."""
    return torch.from_numpy(np.ascontiguousarray(packed).view(np.int16)).to(device)


def _unpack_scan_u16(packed: torch.Tensor, header: torch.Tensor, has_times: bool) -> pc.PointBatch:
    """The packed scan (int16 or uint16 bits, ``[N, 4]``) -> PointBatch. The
    divisions by 65535 and 65534 are multiplies by their float32
    reciprocals, as in the JAX twin's jitted step (``grid_hash.recip``)."""
    if packed.dtype == torch.uint16:
        packed = packed.view(torch.int16)
    u = packed.to(torch.int32) & 0xFFFF
    q = u.float()
    lo, span = header[:3], header[3:6]
    dev = packed.device
    xyz = q[:, :3] * recip(f32(65535.0, dev)) * span[None, :] + lo[None, :]
    mask = u[:, 3] != 0xFFFF
    xyz = torch.where(mask[:, None], xyz, pc.PAD_COORD)
    extras = {}
    if has_times:
        extras["times"] = q[:, 3:4] * recip(f32(65534.0, dev))
    return pc.PointBatch(xyz=xyz, mask=mask, extras=extras)


def rt_step_packed(state: RtState, packed: torch.Tensor, header: torch.Tensor, dt: torch.Tensor,
                   ext_motion: torch.Tensor, cfg: SlamConfig, has_times: bool = True,
                   static_trip: bool = False, rebuild_branch: bool = True):
    """:func:`rt_step` over a packed scan (one upload)."""
    scan = _unpack_scan_u16(packed, header, has_times)
    return rt_step(state, scan, dt, ext_motion, cfg, static_trip=static_trip,
                   rebuild_branch=rebuild_branch)


def _seed_bank(old: submap_mod.SubmapState, center: torch.Tensor, voxel_size, crop_radius,
               capacity: int) -> submap_mod.SubmapState:
    """A fresh bank seeded with the old bank's patch around ``center`` (the
    overlap region a new submap starts from), at most half the bank: a
    near-full seed would trip the force-new gate at once."""
    dev = center.device
    d2 = _sq3(old.cloud.xyz - center)
    r = f32(crop_radius, dev)
    patch = pc.PointBatch(xyz=old.cloud.xyz, mask=old.cloud.mask & (d2 <= r * r))
    seed = voxel_downsample(patch, voxel_size, capacity=capacity // 2, priority_center=center)
    rest = capacity - capacity // 2
    cloud = pc.PointBatch(
        xyz=torch.cat([seed.xyz, torch.full((rest, 3), pc.PAD_COORD, device=dev)]),
        mask=torch.cat([seed.mask, torch.zeros(rest, dtype=torch.bool, device=dev)]),
    )
    return submap_mod.SubmapState(cloud=cloud, pose=torch.eye(4, device=dev), num_scans=0)


# ---------------------------------------------------------------------------
# The host front end.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrameRecord:
    """Host-side per-frame record, filled in as stats are polled."""

    time: float
    pose: Optional[np.ndarray] = None  # [4, 4] registered pose (after poll)
    inserted: bool = False
    converged: bool = False
    degenerate: bool = False
    out_of_order: bool = False
    submap_idx: int = 0  # the active submap at dispatch
    stats: Optional[np.ndarray] = None  # the step's stats row [STATS_LEN] (after poll)


class _Graphs:
    """The CUDA graphs of one pipeline and their static buffers: the state,
    the step's inputs (the chunk size's scans a replay, 1 by default), its
    stats, the rebuild and the bank seeding."""

    def __init__(self, pipe: "RealtimePipeline", example: pc.PointBatch):
        dev, cfg = pipe.device, pipe.cfg
        K = pipe.chunk_size
        self.has_times = "times" in example.extras
        N = example.capacity
        # Static inputs; host scans are staged through pinned rows.
        if pipe.h2d_mode == "packed":
            self.packed = torch.zeros((K, N, 4), dtype=torch.int16, device=dev)
            self.header = torch.zeros((K, 8), device=dev)
            self.header[:, 3:6] = 1.0
        else:
            extras = {"times": torch.zeros((K, N, 1), device=dev)} if self.has_times else {}
            self.scans = pc.PointBatch(xyz=torch.full((K, N, 3), pc.PAD_COORD, device=dev),
                                       mask=torch.zeros((K, N), dtype=torch.bool, device=dev),
                                       extras=extras)
        self.misc = torch.zeros((K, 17), device=dev)  # dt, then the external motion
        self.misc[:, 1:] = torch.eye(4, device=dev).reshape(-1)
        self.center = torch.zeros(3, device=dev)
        # A throwaway state of the real shapes: the captures read and write it.
        self.state = tree_map(torch.clone, rt_init(example.to(dev), torch.eye(4, device=dev), cfg))
        self.stats = torch.zeros((K, STATS_LEN), device=dev)
        self.seed_out = tree_map(torch.clone, self.state.bank)
        rebuild_branch = not pipe.async_rebuild

        def step():
            st = self.state
            rows = []
            for k in range(K):
                dt, ext = self.misc[k, 0], self.misc[k, 1:].reshape(4, 4)
                if pipe.h2d_mode == "packed":
                    st, row = rt_step_packed(st, self.packed[k], self.header[k], dt, ext, cfg,
                                             has_times=self.has_times, static_trip=True,
                                             rebuild_branch=rebuild_branch)
                else:
                    scan = pc.PointBatch(xyz=self.scans.xyz[k], mask=self.scans.mask[k],
                                         extras={n: v[k] for n, v in self.scans.extras.items()})
                    st, row = rt_step(st, scan, dt, ext, cfg, static_trip=True,
                                      rebuild_branch=rebuild_branch)
                rows.append(row)
            _copy_into(self.state, st)
            self.stats.copy_(torch.stack(rows))

        def rebuild():
            st = self.state
            ref = build_map_reference(st.bank.cloud, st.map_pose[:3, 3], cfg.mapper)
            _copy_into(st.ref, ref)
            st.scans_since_reinit.zero_()

        def seed():
            out = _seed_bank(self.state.bank, self.center, cfg.submaps.submap_voxel_size,
                             cfg.mapper.map_patch_radius, cfg.submaps.submap_capacity)
            _copy_into(self.seed_out, out)

        self.step, self.rebuild, self.seed = (self._capture(fn) for fn in (step, rebuild, seed))

    @staticmethod
    def _capture(fn) -> torch.cuda.CUDAGraph:
        """Warm ``fn`` up eagerly on a side stream (library handles, kernel
        builds, the kernels' scratch), then capture it. Raises if the
        capture fails."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        # The captured graph is kept (``raw_cuda_graph``: its nodes can be
        # counted) and instantiated at once.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        graph.instantiate()
        return graph


class RealtimePipeline:
    """Host front end over :func:`rt_step` on ``device`` (default: the CUDA
    card; see :func:`device.resolve`).

    Usage::

        rt = RealtimePipeline(cfg, poll_every=8)
        for scan, t in stream:
            rt.process_scan(scan, t)     # dispatch, no read of the device
        rt.finish()                      # drain the stats
        traj = rt.trajectory()           # [F, 4, 4] per-frame poses

    ``poll_every=1`` is the paced mode (one stats fetch a scan);
    larger values amortise the fetch. ``chunk_size`` steps run as one
    program. ``h2d_mode="packed"`` uploads a scan as 8 bytes a point.
    ``async_rebuild``: the reference rebuild is its own program at the
    host's cadence, and the step program holds none. On a card the first
    scan (or :meth:`warmup`) captures the CUDA graphs."""

    def __init__(self, cfg: Optional[SlamConfig] = None, poll_every: int = 8,
                 h2d_mode: str = "pytree", chunk_size: int = 1, async_rebuild: bool = True,
                 device=None):
        if h2d_mode not in ("pytree", "packed"):
            raise ValueError(f"h2d_mode must be 'pytree' or 'packed', got {h2d_mode!r}")
        if chunk_size > 1 and h2d_mode == "packed":
            raise ValueError("chunk_size > 1 currently requires h2d_mode='pytree'")
        self.cfg = cfg or SlamConfig()
        check_config(self.cfg)
        self.device = resolve(device)
        self.async_rebuild = bool(async_rebuild)
        self.h2d_mode = h2d_mode
        self.chunk_size = max(1, int(chunk_size))
        self.poll_every = max(1, int(poll_every))
        self.submaps = SubmapCollection(self.cfg.submaps, device=self.device)
        self.frames: List[FrameRecord] = []
        self.imu_buffer = ImuBuffer()
        self._attitude_initialized = False
        self._state: Optional[RtState] = None
        self._graphs: Optional[_Graphs] = None
        self._frames_since_rebuild = 1
        self._chunk_buf: List[tuple] = []  # (scan, dt, ext, frame index)
        self._pending: list = []  # (stats rows on the device, frame indices)
        self._ring: Optional[torch.Tensor] = None  # device stats rows awaiting a poll
        self._ring_used = 0
        self._staging: list = []  # pinned host rows for the step's inputs
        self._staging_next = 0
        self._last_time: Optional[float] = None
        self._last_scan: Optional[pc.PointBatch] = None
        self._prev_ext_pose: Optional[np.ndarray] = None
        self._initial_pose = np.eye(4)
        self._last_polled_pose = np.eye(4)
        self._last_polled_fidx = -1
        self._last_switch_frame = -(10**9)
        self._frames_done = 0
        self.graph_replays = 0

    # ------------------------------------------------------------------
    # Ingestion.
    # ------------------------------------------------------------------

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def warmup(self, example_scan: pc.PointBatch) -> None:
        """On a card: capture the step, rebuild and seeding graphs over
        static buffers shaped by ``example_scan`` (a throwaway state; the
        first real scan re-initialises it). Raises if a capture fails. On the
        CPU there is nothing to prepare."""
        if not self.graphed or self._graphs is not None:
            return
        self._capacity = example_scan.capacity
        self._graphs = _Graphs(self, example_scan)
        g = self._graphs
        K = self.chunk_size
        slots = -(-self.poll_every // K) + 1
        self._ring = torch.zeros((slots, K, STATS_LEN), device=self.device)
        self._staging = [self._stage_rows(g) for _ in range(slots + 1)]

    def _stage_rows(self, g: _Graphs) -> dict:
        """One pinned host copy of the step's inputs, with the event of its
        last upload."""
        pin = dict(pin_memory=True)
        if self.h2d_mode == "packed":
            rows = dict(packed=torch.zeros(g.packed.shape, dtype=torch.int16, **pin),
                        header=torch.zeros(g.header.shape, **pin))
        else:
            rows = dict(xyz=torch.zeros(g.scans.xyz.shape, **pin),
                        mask=torch.zeros(g.scans.mask.shape, dtype=torch.bool, **pin))
            if g.has_times:
                rows["times"] = torch.zeros(g.scans.extras["times"].shape, **pin)
        rows["misc"] = torch.zeros(g.misc.shape, **pin)
        rows["event"] = None
        return rows

    def add_imu(self, time: float, acc, gyro) -> None:
        self.imu_buffer.push(time, acc, gyro)

    def set_initial_transform(self, T: np.ndarray) -> None:
        self._initial_pose = np.asarray(T, np.float64).copy()

    @property
    def pose(self) -> np.ndarray:
        """Latest polled pose (may lag the device by < poll_every frames)."""
        return self._last_polled_pose.copy()

    def process_scan(self, scan: pc.PointBatch, time: float,
                     external_odom_pose: Optional[np.ndarray] = None) -> None:
        """Dispatch one scan. Reads nothing back from the device except at
        the poll cadence (and on the first scan's initialisation)."""
        cfg = self.cfg
        rec = FrameRecord(time=time)
        # An out-of-order scan is not registered: it carries the last polled
        # pose and is skipped.
        if self._last_time is not None and time <= self._last_time:
            rec.out_of_order = True
            rec.pose = self._last_polled_pose.copy()
            rec.submap_idx = self.submaps.active_idx
            self.frames.append(rec)
            return

        self._last_scan = scan
        if self._state is None:
            self._initialize(scan, rec, time, external_odom_pose)
            return

        dt = time - self._last_time
        if cfg.use_external_odometry and external_odom_pose is not None:
            ext = np.asarray(external_odom_pose, np.float64)
            prev = self._prev_ext_pose if self._prev_ext_pose is not None else ext
            ext_motion = np.linalg.inv(prev) @ ext
            self._prev_ext_pose = ext
        else:
            ext_motion = np.eye(4)
        rec.submap_idx = self.submaps.active_idx
        self.frames.append(rec)
        self._last_time = time
        self._frames_done += 1
        self._chunk_buf.append((scan, dt, ext_motion, len(self.frames) - 1))
        if len(self._chunk_buf) >= self.chunk_size:
            self._dispatch()

    def _initialize(self, scan, rec, time, external_odom_pose) -> None:
        cfg = self.cfg
        if (cfg.use_imu_attitude_init and not self._attitude_initialized
                and len(self.imu_buffer) >= 2 and np.allclose(self._initial_pose[:3, :3], np.eye(3))):
            try:
                R_wb, _ = self.imu_buffer.estimate_attitude(t_end=time)
                self._initial_pose = self._initial_pose.copy()
                self._initial_pose[:3, :3] = R_wb
                self._attitude_initialized = True
            except ValueError:
                pass
        pose = torch.as_tensor(self._initial_pose, dtype=torch.float32, device=self.device)
        state = rt_init(scan.to(self.device), pose, self.cfg)
        if self.graphed:
            self.warmup(scan)
            _copy_into(self._graphs.state, state)
            state = self._graphs.state
        self._state = state
        self._frames_since_rebuild = 1
        self.submaps.submaps.append(SubmapEntry(state=state.bank, anchor=self._initial_pose.copy(),
                                                parent=None))
        self.submaps.active_idx = 0
        rec.pose = self._initial_pose.copy()
        rec.inserted = rec.converged = True
        self._last_polled_pose = self._initial_pose.copy()
        self.frames.append(rec)
        self._last_time = time
        if external_odom_pose is not None:
            self._prev_ext_pose = np.asarray(external_odom_pose, np.float64)
        self._frames_done += 1

    def _dispatch(self) -> None:
        """Run the buffered frames (one, or a chunk) as one device program.
        A short chunk is padded with the last scan at dt ~ 0 (it registers in
        place, below the movement gate)."""
        if not self._chunk_buf:
            return
        buf, self._chunk_buf = self._chunk_buf, []
        n_real = len(buf)
        while len(buf) < self.chunk_size:
            buf.append((buf[-1][0], 1e-4, np.eye(4), -1))
        if self.graphed:
            rows = self._replay(buf)
        else:
            rows = self._step_eager(buf)
        self._pending.append((rows, [b[3] for b in buf[:n_real]]))
        self._frames_since_rebuild += n_real
        if self.async_rebuild and self._frames_since_rebuild >= self.cfg.mapper.reference_reinit_every:
            self._launch_rebuild()
        if sum(len(idx) for _, idx in self._pending) >= self.poll_every:
            self.poll()

    def _step_eager(self, buf) -> torch.Tensor:
        dev, cfg = self.device, self.cfg
        rb = not self.async_rebuild
        rows = []
        for scan, dt, ext, _ in buf:
            dt_t = torch.tensor(float(dt), dtype=torch.float32, device=dev)
            ext_t = torch.as_tensor(ext, dtype=torch.float32, device=dev)
            if self.h2d_mode == "packed":
                times = np.asarray(scan.extras["times"].cpu())[..., 0] if "times" in scan.extras else None
                packed, header = pack_scan_u16(scan.xyz.cpu().numpy(), scan.mask.cpu().numpy(), times)
                self._state, row = rt_step_packed(
                    self._state, packed_tensor(packed, dev), torch.from_numpy(header).to(dev), dt_t,
                    ext_t, cfg, has_times=times is not None, rebuild_branch=rb)
            else:
                self._state, row = rt_step(self._state, scan.to(dev), dt_t, ext_t, cfg,
                                           rebuild_branch=rb)
            rows.append(row)
        self.submaps.active.state = self._state.bank
        return torch.stack(rows)

    def _replay(self, buf) -> torch.Tensor:
        """Stage the frames' inputs in pinned rows, upload them into the step
        graph's static inputs, replay, and copy the stats into the ring."""
        g = self._graphs
        st = self._staging[self._staging_next]
        self._staging_next = (self._staging_next + 1) % len(self._staging)
        if st["event"] is not None:
            st["event"].synchronize()  # the rows' last upload is done
        on_card = set()
        for k, (scan, dt, ext, _) in enumerate(buf):
            if scan.capacity != self._capacity:
                raise ValueError(f"RealtimePipeline: a scan of capacity {scan.capacity}; the graphs "
                                 f"were captured for {self._capacity}")
            if self.h2d_mode == "packed":
                times = np.asarray(scan.extras["times"].cpu())[..., 0] if "times" in scan.extras else None
                packed, header = pack_scan_u16(scan.xyz.cpu().numpy(), scan.mask.cpu().numpy(), times)
                st["packed"][k].copy_(torch.from_numpy(packed.view(np.int16)))
                st["header"][k].copy_(torch.from_numpy(header))
            elif scan.device.type == "cuda":  # already on the card: copied there
                g.scans.xyz[k].copy_(scan.xyz)
                g.scans.mask[k].copy_(scan.mask)
                if g.has_times:
                    g.scans.extras["times"][k].copy_(scan.extras["times"])
                on_card.add(k)
            else:
                st["xyz"][k].copy_(scan.xyz)
                st["mask"][k].copy_(scan.mask)
                if g.has_times:
                    st["times"][k].copy_(scan.extras["times"])
            st["misc"][k, 0] = float(dt)
            st["misc"][k, 1:] = torch.as_tensor(np.asarray(ext, np.float32).reshape(-1))
        if self.h2d_mode == "packed":
            g.packed.copy_(st["packed"], non_blocking=True)
            g.header.copy_(st["header"], non_blocking=True)
        else:
            for k in range(len(buf)):
                if k in on_card:
                    continue
                g.scans.xyz[k].copy_(st["xyz"][k], non_blocking=True)
                g.scans.mask[k].copy_(st["mask"][k], non_blocking=True)
                if g.has_times:
                    g.scans.extras["times"][k].copy_(st["times"][k], non_blocking=True)
        g.misc.copy_(st["misc"], non_blocking=True)
        st["event"] = torch.cuda.Event()
        st["event"].record()
        g.step.replay()
        self.graph_replays += 1
        slot = self._ring[self._ring_used]
        self._ring_used += 1
        slot.copy_(g.stats)
        return slot

    def _launch_rebuild(self) -> None:
        """Refresh the registration reference. Under ``async_rebuild`` the
        rebuild is its own program (the rebuild graph on a card); else the
        step's rebuild branch is armed."""
        if not self.async_rebuild:
            if self.graphed:
                self._state.scans_since_reinit.fill_(10**6)
            else:
                self._state = dataclasses.replace(
                    self._state, scans_since_reinit=torch.full_like(self._state.scans_since_reinit, 10**6))
            return
        if self.graphed:
            self._graphs.rebuild.replay()
            self.graph_replays += 1
        else:
            st = self._state
            ref = build_map_reference(st.bank.cloud, st.map_pose[:3, 3], self.cfg.mapper)
            self._state = dataclasses.replace(st, ref=ref,
                                              scans_since_reinit=torch.zeros_like(st.scans_since_reinit))
        self._frames_since_rebuild = 0

    # ------------------------------------------------------------------
    # Deferred stats and the submap lifecycle.
    # ------------------------------------------------------------------

    def poll(self) -> None:
        """Fetch every pending stats row in one copy and run the host
        bookkeeping they gate: trajectory, submap switching."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        if self.graphed:
            stacked = self._ring[:self._ring_used].cpu().numpy()  # one blocking fetch
            self._ring_used = 0
        else:
            stacked = torch.stack([rows for rows, _ in pending]).cpu().numpy()
        rows_meta = [(stacked[c, k], fidx) for c, (_, idxs) in enumerate(pending)
                     for k, fidx in enumerate(idxs)]
        for row, fidx in rows_meta:
            rec = self.frames[fidx]
            rec.stats = row.copy()
            rec.pose = row[IDX_POSE].reshape(4, 4).astype(np.float64)
            rec.inserted = bool(row[IDX_INSERTED] > 0.5)
            rec.converged = bool(row[IDX_CONVERGED] > 0.5)
            rec.degenerate = bool(row[IDX_DEGENERATE] > 0.5)
        last_row, last_fidx = rows_meta[-1]
        self._last_polled_fidx = last_fidx
        self._last_polled_pose = self.frames[last_fidx].pose.copy()
        self._maybe_switch_submap(self._last_polled_pose, float(last_row[IDX_OCCUPANCY]))

    def _set_bank(self, bank: submap_mod.SubmapState) -> None:
        """Make ``bank`` the active bank of the live state (on a card, copied
        into the static one) and restart its insertion count."""
        if self.graphed:
            _copy_into(self._state.bank.cloud, bank.cloud)
            self._state.scans_in_active.zero_()
        else:
            self._state = dataclasses.replace(self._state, bank=bank,
                                              scans_in_active=torch.zeros_like(self._state.scans_in_active))
        self.submaps.active.state = self._state.bank

    def _maybe_switch_submap(self, pose: np.ndarray, occupancy: float) -> None:
        """Host submap lifecycle from polled stats (creation, re-activation
        behind the adjacency and overlap gates, force-new at saturation),
        evaluated at the poll cadence."""
        cfg = self.cfg.submaps
        cur = self.submaps.active_idx
        entry = self.submaps.submaps[cur]
        entry.state = self._state.bank
        pos = pose[:3, 3]
        d_cur = np.linalg.norm(entry.anchor[:3, 3] - pos)
        max_pts = cfg.max_num_points if cfg.max_num_points is not None else int(0.9 * cfg.submap_capacity)
        force_new = occupancy >= max_pts
        young = self._frames_done - self._last_switch_frame < cfg.min_scans_before_switch
        if (not force_new) and (young or d_cur <= cfg.creation_radius):
            return
        best, best_d = -1, np.inf
        if not force_new:
            for i, e in enumerate(self.submaps.submaps):
                if i == cur:
                    continue
                d = np.linalg.norm(e.anchor[:3, 3] - pos)
                if d < best_d:
                    best, best_d = i, d
        last_scan = None if self._last_scan is None else self._last_scan.to(self.device)
        if (best >= 0 and best_d <= cfg.activation_radius
                and self.submaps.adjacency.is_adjacent(cur, best)
                and self.submaps._switch_consistent(last_scan, pose, best)):
            target = self.submaps.submaps[best].state
            self._finish_active(cur)
            self.submaps.active_idx = best
            self._set_bank(target)
            self._launch_rebuild()
            self._last_switch_frame = self._frames_done
            return
        if force_new or d_cur > cfg.creation_radius:
            # Seed the fresh bank with the old bank's local patch before the
            # old one is finished.
            center = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
            if self.graphed:
                self._graphs.center.copy_(center)
                self._graphs.seed.replay()
                self.graph_replays += 1
                seeded = self._graphs.seed_out
            else:
                seeded = _seed_bank(self._state.bank, center, cfg.submap_voxel_size,
                                    self.cfg.mapper.map_patch_radius, cfg.submap_capacity)
            self._finish_active(cur)
            new_idx = self._create_submap(pose, parent=cur)
            self.submaps.active_idx = new_idx
            self._set_bank(seeded)
            self._launch_rebuild()
            self._last_switch_frame = self._frames_done

    def _create_submap(self, pose: np.ndarray, parent: Optional[int]) -> int:
        entry = SubmapEntry(state=submap_mod.create(self.cfg.submaps.submap_capacity, device=self.device),
                            anchor=np.asarray(pose, np.float64).copy(), parent=parent)
        self.submaps.submaps.append(entry)
        idx = len(self.submaps.submaps) - 1
        if parent is not None:
            self.submaps.adjacency.add_edge(parent, idx)
        return idx

    def _finish_active(self, idx: int) -> None:
        """Mark submap ``idx`` finished, keeping its bank: on a card a copy,
        since the live bank's buffers are the graphs' and move on."""
        e = self.submaps.submaps[idx]
        e.state = tree_map(torch.clone, self._state.bank) if self.graphed else self._state.bank
        e.finished = True

    # ------------------------------------------------------------------
    # Shutdown and export.
    # ------------------------------------------------------------------

    def finish(self) -> None:
        """Dispatch a partial chunk (padded), drain the pending stats."""
        self._dispatch()
        self.poll()
        if self.submaps.submaps:
            self.submaps.active.state = self._state.bank

    def trajectory(self) -> np.ndarray:
        """[F, 4, 4] per-frame registered poses (out-of-order frames carry
        the last known pose). Call :meth:`finish` or :meth:`poll` first."""
        out = []
        last = self._initial_pose
        for rec in self.frames:
            if rec.pose is not None:
                last = rec.pose
            out.append(last)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    def assembled_map(self) -> np.ndarray:
        if self.submaps.submaps:
            self.submaps.active.state = self._state.bank
        return self.submaps.map_points()

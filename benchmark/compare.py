"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``reference/``), each number beside its limit
(``limits/<cell>.json``).

- ``pose_gap_m`` / ``pose_gap_rad``: the step's poses (odometry, then the
  scan-to-map X-ICP). For scans drawn from the seed among those polled,
  the reference registers the scan as it was at its stamp onto the three
  scans before it, each placed at the pose the step reported for it,
  starting from the step's pose, in the map's frame; the number is the
  widest gap, over the sampled scans, between that pose and where the
  reference settles (``pose_gap_median_m``, the median, is reported).
- ``submap_mismatch``: what the step inserted into the submap. For scans
  drawn from the seed, the live bank is copied before and after the step;
  the reference undistorts the scan (with the step's last motion), filters
  it and inserts it at the reported pose into the bank before; the number
  is the widest share of voxels whose means part by more than a millimetre.
- ``dense_mismatch``: the dense map. The reference sums every inserted scan
  (undistorted with the step's last motion, at its reported pose) into
  0.1 m voxels; the number is the share of voxels (of the larger of the
  two maps) missing from the map or whose count or mean (beyond a
  millimetre) differs from the reference's.
- ``loop_gap_m``: each loop constraint accepted in the window; the
  reference registers the finished submap's bank onto its target's, in the
  map's frame, from the constraint; the widest gap, in the anchors' frames.
- ``solve_left``: each pose-graph solve in the window, solved again by
  the reference from the same graph and start; the objective both descend
  is evaluated at the start, the program's answer and the reference's, and
  the number is the largest share of the reference's decrease that a
  program's answer left undone (``solve_gap_m``, the widest node gap
  between the two answers, is reported: the objective, robust on loop
  edges, can have more than one minimum).

The reference follows the step from the program's own state where the
step reads it: the bank before a sampled scan, the last motion that
undistorts a scan, the graph a solve was given.
"""

from __future__ import annotations

import numpy as np
import torch

import world
from reference import icp, maps, pose_graph, se3

MEAN_TOL_M = 1e-3


def _rng(seed: int, tag: int):
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, tag])


def _on(dev, x, dtype=torch.float64):
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _undistorted(run, k: int, fed: torch.Tensor) -> torch.Tensor:
    """Scan ``k`` as the step undistorted it (float64): with the motion the
    step held after scan ``k - 1`` (none for the first two)."""
    mc = run.cfg.motion_compensation
    if not mc.enabled or k == 0:
        return fed.double()
    motion = run.motions[k - 1].double().to(fed.device)
    return maps.undistort(fed.double(), motion, run.spec.traffic["scan_period_s"], mc.scan_duration)


def _fed(run, k: int, dev) -> torch.Tensor:
    return run.host_xyz[k].to(dev)


def pose_samples(run) -> list:
    """Scans polled after the warm-up whose three predecessors were polled
    in the same frame (no loop-closure increment applied at the dispatch
    of the last three)."""
    last = min(run.last_dispatched, run.poses.shape[0] - 1)
    ok = []
    for k in range(max(run.warmup, 3), last + 1):
        ks = range(k - 3, k + 1)
        if any(np.isnan(run.poses[j]).any() for j in ks):
            continue
        if any(j in run.moved_at for j in (k - 2, k - 1, k)):
            continue
        ok.append(k)
    n = run.spec.traffic["check"]["pose_samples"]
    pick = _rng(run.seed, 11).choice(len(ok), size=min(n, len(ok)), replace=False)
    return sorted(ok[i] for i in pick)


def pose_gaps(run, control=False, dev=None) -> list:
    """``[(k, metres, radians, dx, dy, dz)]`` for the sampled scans (the
    gap's translation in the sensor's frame): the step's pose
    against the reference's (``control``: the reference in bfloat16 in the
    step's place)."""
    dev = dev or run.dev
    c = run.spec.traffic["check"]
    out = []
    for k in pose_samples(run):
        _, still = world.make_scan(run.scene, k)
        still = still.to(dev)
        near = (still * still).sum(-1) <= c["source_range_m"] ** 2
        src = still[near]
        pick = torch.as_tensor(_rng(run.seed, 1000 + k).choice(src.shape[0], size=min(c["source_points"],
                                                                                    src.shape[0]), replace=False))
        src = src[pick.to(dev)]
        Pk = _on(dev, run.poses[k])
        tgt = []
        for j in (k - 1, k - 2, k - 3):
            _, sj = world.make_scan(run.scene, j)
            sj = sj.to(dev)
            sj = sj[(sj * sj).sum(-1) <= c["target_range_m"] ** 2]
            tgt.append(se3.apply(_on(dev, run.poses[j]), sj.double()))
        tgt = torch.cat(tgt)  # float64, the map's frame

        def register(dtype):
            return icp.point_to_plane(src.to(dtype), tgt.to(dtype), Pk.float(), iterations=c["icp_iterations"])

        T = register(torch.float32)
        try:
            got = Pk if not control else register(torch.bfloat16)
        except torch.linalg.LinAlgError:  # the control broke down: it has failed
            out.append((k, float("inf"), float("inf"), 0.0, 0.0, 0.0))
            continue
        t, r = se3.gap(got.double(), T.double())
        d = (se3.inverse(got.double()) @ T.double())[:3, 3]  # in the sensor's frame: x ahead
        out.append((k, t, r, *(float(v) for v in d)))
    return out


def insert_cases(run) -> list:
    """Sampled scans whose step neither switched submap, nor carved, nor
    took a loop-closure increment, and were polled."""
    out = []
    for k, s in sorted(run.snaps.items()):
        if "after" not in s or k >= run.poses.shape[0] or np.isnan(run.poses[k]).any():
            continue
        if (s["submaps"], s["active"]) != (s["submaps_after"], s["active_after"]) or k in run.moved_at:
            continue
        if run.carved[k]:
            continue
        out.append(k)
    return out


def _mismatch(exp_keys, exp_means, got_keys, got_means) -> float:
    """Share of voxels (of the larger set) not matched by key and mean."""
    if exp_keys.numel() == 0 and got_keys.numel() == 0:
        return 0.0
    pos = torch.searchsorted(exp_keys, got_keys).clamp(max=max(exp_keys.numel() - 1, 0))
    same = (exp_keys.numel() > 0) & (exp_keys[pos] == got_keys)
    close = (exp_means[pos].double() - got_means.double()).norm(dim=-1) <= MEAN_TOL_M
    matched = int((same & close).sum())
    return 1.0 - matched / max(exp_keys.numel(), got_keys.numel())


def submap_mismatch(run, control=False, dev=None) -> list:
    """``[(k, share)]`` for the sampled inserts (``control``: the
    reference's insert in bfloat16 in the step's place)."""
    dev = dev or run.dev
    m, s = run.cfg.mapper, run.cfg.submaps
    out = []
    for k in insert_cases(run):
        snap = run.snaps[k]
        before, after = (xyz[m].to(dev) for xyz, m in (snap["before"], snap["after"]))
        P = _on(dev, run.poses[k])
        if run.inserted[k]:
            scan = _undistorted(run, k, _fed(run, k, dev))
            def insert(dtype):
                proc = maps.scan_for_matching(scan, m.scan_crop_radius, m.scan_voxel_size, m.scan_capacity, dtype)
                return maps.submap_insert(before, proc, P, s.submap_voxel_size, s.submap_crop_radius,
                                          s.submap_capacity, dtype)

            keys, means = insert(torch.float32)
            if control:
                _, after = insert(torch.bfloat16)
        else:
            keys = maps.cell_keys(maps.cells_of(before, s.submap_voxel_size))
            order = torch.argsort(keys)
            keys, means = keys[order], before[order]
        got = maps.cell_keys(maps.cells_of(after.float(), s.submap_voxel_size))
        out.append((k, _mismatch(keys, means, got, after)))
    return out


def dense_reference(run, dtype=torch.float64, dev=None):
    dev = dev or run.dev
    voxel = run.cfg.dense_map_voxel
    chunks = []
    last = min(run.last_dispatched, run.poses.shape[0] - 1)
    for k in range(last + 1):
        if not run.inserted[k] or np.isnan(run.poses[k]).any():
            continue
        fed = _fed(run, k, dev)
        pts = _undistorted(run, k, fed) if k > 0 else fed.double()
        chunks.append(se3.apply(_on(dev, run.poses[k]), pts).float())
    return maps.dense_map(chunks, voxel, dtype)


def program_dense(run, dev=None):
    d = run.dense
    occ = d["count"] > 0
    hi, lo = d["key_hi"][occ].long(), d["key_lo"][occ].long()
    x = hi >> 10
    y = ((hi & 0x3FF) << 10) | (lo >> 20)
    z = lo & 0xFFFFF
    cells = torch.stack([x, y, z], -1) - (1 << 19)
    keys = maps.cell_keys(cells)
    cnt = d["count"][occ].double()
    means = d["sum_xyz"][occ].double() / cnt[:, None]
    return keys, cnt, means


def dense_mismatch(run, control=False, dev=None) -> tuple:
    """``(share, info)``: voxels of the map not matching the reference
    (``control``: the reference's sums in bfloat16 in the map's place)."""
    rk, rn, rm = dense_reference(run, torch.float64, dev)
    gk, gn, gm = dense_reference(run, torch.bfloat16, dev) if control else program_dense(run, dev)
    pos = torch.searchsorted(rk, gk).clamp(max=rk.numel() - 1)
    same = rk[pos] == gk
    ok = same & (rn[pos] == gn) & ((rm[pos].double() - gm).norm(dim=-1) <= MEAN_TOL_M)
    share = 1.0 - int(ok.sum()) / max(1, gk.numel(), rk.numel())  # a voxel dropped counts
    return share, dict(map_voxels=int(gk.numel()), reference_voxels=int(rk.numel()),
                       dropped_voxels=int(rk.numel()) - int(same.sum()))


def loop_gaps(run, control=False, dev=None) -> list:
    dev = dev or run.dev
    c = run.spec.traffic["check"]
    t_close = run.t_window[2]
    out = []
    for i, rec in enumerate(run.constraints):
        if rec["t"] > t_close:
            continue
        ((src, src_m), a_src), ((tgt, tgt_m), a_tgt) = rec["src"], rec["tgt"]
        s, t = src[src_m].to(dev), tgt[tgt_m].to(dev)  # the banks, in the map's frame
        pick = torch.as_tensor(_rng(run.seed, 5000 + i).choice(s.shape[0], size=min(c["source_points"], s.shape[0]),
                                                             replace=False)).to(dev)
        A_s, A_t = _on(dev, a_src), _on(dev, a_tgt)
        T0 = _on(dev, rec["c"].T_target_source)
        W0 = A_t @ T0 @ se3.inverse(A_s)  # the constraint as a move of the source bank in the map

        def register(dtype):
            W = icp.point_to_plane(s[pick].to(dtype), t.to(dtype), W0.float(), iterations=c["icp_iterations"])
            return se3.inverse(A_t) @ W.double() @ A_s

        T = register(torch.float32)
        got = T0 if not control else register(torch.bfloat16)
        out.append(se3.gap(got, T))
    return out


def solve_checks(run, control=False) -> list:
    """One dict a pose-graph solve in the window: the objective
    (:func:`pose_graph.cost`) at the graph's start (``f_start``), at the
    program's answer (``f_got``; ``control``: the reference's solve in
    bfloat16) and at the reference's own solve from the same start
    (``f_ref``); ``left``, the share of the reference's decrease that the
    answer left undone; ``gap_m``, the widest node gap between the two."""
    t_close = run.t_window[2]
    out = []
    for rec in run.solves:
        if rec["t"] > t_close:
            continue
        g = rec["graph"]
        n = int(g["node_mask"].sum())
        e = g["edge_mask"]
        ei, ej = torch.as_tensor(g["edge_i"][e]).long(), torch.as_tensor(g["edge_j"][e]).long()
        meas, info = torch.as_tensor(g["edge_T"][e]).double(), torch.as_tensor(g["edge_info"][e]).double()
        loop = torch.as_tensor(g["edge_is_loop"][e])
        huber = rec["cfg"].huber_delta

        def solve(dtype):
            return pose_graph.solve(torch.as_tensor(g["poses"][:n]).to(dtype), ei, ej, meas.to(dtype),
                                    info.to(dtype), loop, huber, prior=rec["cfg"].gauge_weight).double()

        def f(P):
            return pose_graph.cost(torch.as_tensor(P), ei, ej, meas, info, loop, huber)

        P = solve(torch.float64)
        got = torch.as_tensor(rec["out"][:n])
        if control:
            try:
                got = solve(torch.bfloat16)
            except torch.linalg.LinAlgError:  # the control broke down: it has failed
                got = torch.full_like(got, float("nan"))
        f0, f_ref, f_got = f(g["poses"][:n]), f(P), f(got)
        left = (f_got - f_ref) / max(f0 - f_ref, 1e-3 * f0, 1e-12)
        gap = float((P[:, :3, 3] - got[:, :3, 3]).norm(dim=-1).max())
        out.append(dict(nodes=n, edges=int(e.sum()), loops=int(loop.sum()), f_start=f0, f_ref=f_ref, f_got=f_got,
                        left=left if np.isfinite(f_got) else float("inf"),
                        gap_m=gap if np.isfinite(gap) else float("inf")))
    return out


def numbers(run, control=False, dev=None) -> tuple:
    """``({name: value}, details)`` of every number the cell's limits name
    (``control``: the control's readings, the reference in bfloat16 put in
    the program's place)."""
    want = set(run.spec.limits["limits"]) | set(run.spec.limits.get("report", []))
    vals, info = {}, {}
    if "pose_gap_m" in want:
        g = pose_gaps(run, control, dev)
        info["pose_samples"] = len(g)
        info["pose_gaps"] = [list(x) for x in g]
        if g:
            vals["pose_gap_m"] = max(x[1] for x in g)
            vals["pose_gap_median_m"] = float(np.median([x[1] for x in g]))
            vals["pose_gap_rad"] = max(x[2] for x in g)
    if "submap_mismatch" in want:
        g = submap_mismatch(run, control, dev)
        info["insert_samples"] = len(g)
        info["submap_mismatches"] = g
        if g:
            vals["submap_mismatch"] = max(v for _, v in g)
    if "dense_mismatch" in want and run.dense is not None:
        vals["dense_mismatch"], info["dense"] = dense_mismatch(run, control, dev)
    if "loop_gap_m" in want:
        g = loop_gaps(run, control, dev)
        info["constraints"] = len(g)
        info["loop_gaps"] = g
        if g:
            vals["loop_gap_m"] = max(t for t, _ in g)
    if want & {"solve_left", "solve_gap_m"}:
        g = solve_checks(run, control)
        info["solves"] = len(g)
        info["solve_checks"] = g
        if g:
            vals["solve_left"] = max(x["left"] for x in g)
            vals["solve_gap_m"] = max(x["gap_m"] for x in g)
    return vals, info


def judge(vals: dict, limits: dict, minimum: dict) -> tuple:
    """``(correct, lines)``: every limited number present and within its
    limit, and at least ``minimum[name]`` samples behind it."""
    ok = True
    rows = {}
    for name, lim in limits.items():
        v = vals.get(name)
        good = v is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        rows[name] = {"value": None if v is None else float(v), "limit": lim}
    for name, (have, need) in minimum.items():
        good = have >= need
        ok &= bool(good)
        rows[name] = {"value": have, "limit": need}
    return ok, rows

"""The one traffic generator: a street world, a drive through it and the
LiDAR scans taken along the drive, all made on a device from a seed.

A traffic mix (``traffic/<name>.json``) gives the parameters: the drive's
shape and length, the sensor model, and the world's density per metre of
street. The same seed gives the same world, drive and scans; every scan has
a generator of its own, so one scan can be made again alone.

The world is ``chip_smoke.synth_site``'s street (ground, building fronts on
both sides, boxes beside the street) laid out along the whole drive at that
site's density per metre; the scan is ``chip_smoke.sample_scan``'s (a
wedge of the points in range, Gaussian noise, clutter in the air), turned
with the sensor. With ``sweep`` each point is seen at its own instant of a
clockwise sweep that ends at the scan's stamp (the sensor moving at the
drive's speed), as a spinning LiDAR reads it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from reference import se3

_SEED_MIX = 0x9E3779B97F4A7C15


def mix_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed and ``parts``."""
    h = (int(seed) * 6364136223846793005 + 1442695040888963407) & ((1 << 64) - 1)
    for p in parts:
        h = ((h ^ (int(p) + 1)) * _SEED_MIX) & ((1 << 64) - 1)
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def generator(device, seed: int, *parts: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, *parts))
    return g


# ---------------------------------------------------------------------------
# The drive.
# ---------------------------------------------------------------------------


def _pose(x: float, y: float, z: float, yaw: float) -> np.ndarray:
    T = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = (x, y, z)
    return T


def drive_poses(d: dict, n_scans: int) -> np.ndarray:
    """``[n_scans, 4, 4]`` sensor poses (map -> sensor, x ahead) along +x.

    ``d["kind"]``: ``"street"`` runs along the street; ``"out_and_back"``
    runs ``out_scans`` out, turns left over ``turn_scans`` (the heading
    eased through half a turn, the speed set so that the turn ends
    ``lane_m`` to the left) and comes back on that lane. On the straight
    legs the heading sways as ``A sin(2 pi k / period)``, A chosen so that it
    moves by at most ``sway_deg_per_scan`` a scan."""
    step, z = d["step_m"], d["sensor_height_m"]
    period = d["sway_period_scans"]
    amp = math.radians(d["sway_deg_per_scan"]) * period / (2 * math.pi)

    def leg(p, base_yaw, n, k0=0):
        out = []
        for k in range(n):
            yaw = base_yaw + amp * math.sin(2 * math.pi * (k + k0) / period)
            out.append(_pose(p[0], p[1], z, yaw))
            p = (p[0] + step * math.cos(yaw), p[1] + step * math.sin(yaw))
        return out, p

    if d["kind"] == "street":
        poses, _ = leg((0.0, 0.0), 0.0, n_scans)
        return np.stack(poses)
    if d["kind"] != "out_and_back":
        raise ValueError(f"unknown drive kind {d['kind']!r}")
    n_out, n_turn = d["out_scans"], d["turn_scans"]
    poses, p = leg((0.0, 0.0), 0.0, min(n_out, n_scans))
    if len(poses) < n_scans:
        yaw0 = amp * math.sin(2 * math.pi * n_out / period)
        turn = np.pi * (1 - np.cos(np.pi * np.arange(1, n_turn + 1) / n_turn)) / 2
        mid = np.concatenate([[0.0], turn[:-1]]) / 2 + turn / 2
        s_turn = d["lane_m"] / float(np.sum(np.sin(mid)))
        for a, m in zip(turn, mid):
            p = (p[0] + s_turn * math.cos(yaw0 + m), p[1] + s_turn * math.sin(yaw0 + m))
            poses.append(_pose(p[0], p[1], z, yaw0 + a))
        back, _ = leg(p, yaw0 + math.pi, max(0, n_scans - len(poses)))
        poses.extend(back)
    return np.stack(poses[:n_scans])


# ---------------------------------------------------------------------------
# The world.
# ---------------------------------------------------------------------------


def make_world(w: dict, x0: float, x1: float, center_y: float, device, seed: int) -> torch.Tensor:
    """Points ``[M, 3]`` of a street from ``x0`` to ``x1`` (sorted by x):
    ground over ``half_width_m`` each side of ``center_y``, a building front
    every ``front_every_m`` on each side, ``boxes_per_m`` boxes beside the
    street, ``points_per_object`` points a front or box."""
    g = generator(device, seed, 0)
    L = x1 - x0
    f32 = dict(device=device, dtype=torch.float32)

    def U(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, **f32)

    n_floor = int(round(w["floor_points_per_m"] * L))
    hw = w["half_width_m"]
    parts = [torch.stack([U(x0, x1, n_floor), U(center_y - hw, center_y + hw, n_floor),
                          torch.randn(n_floor, generator=g, **f32) * w["ground_sigma_m"]], -1)]
    m = w["points_per_object"]
    starts = torch.arange(x0, x1, w["front_every_m"], **f32)
    fx = starts.repeat_interleave(2)
    side = torch.tensor([-1.0, 1.0], **f32).repeat(starts.numel())
    nf = fx.numel()
    fy = center_y + side * U(*w["front_setback_m"], nf)
    ang = U(-w["front_angle_rad"], w["front_angle_rad"], nf)
    top = U(*w["front_height_m"], nf)
    t = U(0.0, w["front_length_m"], nf, m)
    parts.append(torch.stack([fx[:, None] + t * torch.cos(ang)[:, None], fy[:, None] + t * torch.sin(ang)[:, None],
                              U(0.0, 1.0, nf, m) * top[:, None]], -1).reshape(-1, 3))
    nb = int(round(w["boxes_per_m"] * L))
    bx = U(x0, x1, nb)
    bside = torch.where(U(0.0, 1.0, nb) < 0.5, -1.0, 1.0)
    by = center_y + bside * U(*w["box_setback_m"], nb)
    bw, bd, bh = U(*w["box_width_m"], nb), U(*w["box_depth_m"], nb), U(*w["box_height_m"], nb)
    u = U(0.0, 1.0, nb, m) * (2 * (bw + bd))[:, None]
    W, D = bw[:, None], bd[:, None]
    x = torch.where(u < W, u, torch.where(u < W + D, W, torch.where(u < 2 * W + D, 2 * W + D - u, 0.0)))
    y = torch.where(u < W, 0.0, torch.where(u < W + D, u - W, torch.where(u < 2 * W + D, D, 2 * (W + D) - u)))
    parts.append(torch.stack([bx[:, None] + x, by[:, None] + bside[:, None] * y,
                              U(0.0, 1.0, nb, m) * bh[:, None]], -1).reshape(-1, 3))
    pts = torch.cat(parts)
    pts = pts + torch.randn(pts.shape, generator=g, **f32) * w["surface_sigma_m"]
    return pts[torch.argsort(pts[:, 0])].contiguous()


# ---------------------------------------------------------------------------
# Scans.
# ---------------------------------------------------------------------------


@dataclass
class Scene:
    """A run's world and drive on ``device``."""

    world: torch.Tensor  # [M, 3] sorted by x
    poses: np.ndarray  # [S, 4, 4] float64, map -> sensor
    sensor: dict
    seed: int

    def __post_init__(self):
        self.xs = self.world[:, 0].contiguous()

    @property
    def n_scans(self) -> int:
        return self.poses.shape[0]


def make_scene(traffic: dict, n_scans: int, device, seed: int) -> Scene:
    poses = drive_poses(traffic["drive"], n_scans)
    margin = traffic["world"]["margin_m"]
    x0 = float(poses[:, 0, 3].min()) - margin
    x1 = float(poses[:, 0, 3].max()) + margin
    world = make_world(traffic["world"], x0, x1, traffic["world"]["center_y_m"], device, seed)
    return Scene(world=world, poses=poses, sensor=traffic["sensor"], seed=seed)


def sweep_twist(scene: Scene, k: int) -> torch.Tensor:
    """The body motion over scan ``k``'s sweep (float64, (omega, v)): from
    the previous stamp to this one (scan 0 takes scan 1's)."""
    a, b = (k - 1, k) if k > 0 else (0, 1)
    rel = np.linalg.inv(scene.poses[a]) @ scene.poses[b]
    return se3.log(torch.as_tensor(rel, dtype=torch.float64))


def clockwise_phase(xyz: torch.Tensor) -> torch.Tensor:
    """A point's instant in a clockwise sweep that starts behind the sensor
    (azimuth -pi) and ends there: 0 at the start, 1 at the stamp."""
    az = torch.atan2(xyz[:, 1], xyz[:, 0])
    return 1.0 - (az + math.pi) / (2.0 * math.pi)


def make_scan(scene: Scene, k: int):
    """Scan ``k`` -> ``(fed, still)``, ``[N, 3]`` float32 each on the
    world's device: ``still`` is every point as seen from the pose at the
    stamp; ``fed`` is what the sensor gives (``still`` itself, or, with
    ``sweep``, each point moved to where the sweep saw it)."""
    s = scene.sensor
    dev = scene.world.device
    g = generator(dev, scene.seed, 1, k)
    T = torch.as_tensor(scene.poses[k], dtype=torch.float32, device=dev)
    pos = T[:3, 3]
    R = s["max_range_m"]
    xs = scene.xs
    lo = int(torch.searchsorted(xs, pos[0:1] - R)[0])
    hi = int(torch.searchsorted(xs, pos[0:1] + R)[0])
    cand = scene.world[lo:hi]
    local = (cand - pos) @ T[:3, :3]
    az = torch.rad2deg(torch.atan2(local[:, 1], local[:, 0]))
    keep = (az.abs() <= s["wedge_deg"] / 2.0) & ((local * local).sum(-1) <= R * R)
    idx = torch.nonzero(keep)[:, 0]
    n = s["points"]
    n_out = int(n * s["clutter_share"])
    n_in = n - n_out
    if idx.numel() >= n_in:
        pick = idx[torch.randperm(idx.numel(), generator=g, device=dev)[:n_in]]
    else:
        pick = idx[torch.randint(idx.numel(), (n_in,), generator=g, device=dev)]
    pts = local[pick]
    c = s["clutter_half_m"]
    clutter_w = torch.stack([
        pos[0] + (torch.rand(n_out, generator=g, device=dev) * 2 - 1) * c,
        pos[1] + (torch.rand(n_out, generator=g, device=dev) * 2 - 1) * c,
        s["clutter_z_m"][0] + torch.rand(n_out, generator=g, device=dev) * (s["clutter_z_m"][1] - s["clutter_z_m"][0]),
    ], -1)
    still = torch.cat([pts, (clutter_w - pos) @ T[:3, :3]])
    still = still + torch.randn(still.shape, generator=g, device=dev) * s["noise_m"]
    if not s["sweep"]:
        return still, still
    phase = clockwise_phase(still).double()
    M = se3.exp((1.0 - phase)[:, None] * sweep_twist(scene, k).to(dev)[None, :])
    fed = (M[:, :3, :3] @ still.double()[:, :, None])[..., 0] + M[:, :3, 3]
    return fed.float(), still

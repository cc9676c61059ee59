"""A numpy model of K1's summation order
(``open3d_slam_private_tpu_torch/csrc/pair_gn.cu``), on both routes of
``kernels.pair_gn.k1_plan`` (one thread block cluster up to 16,384 points a
problem, a second kernel beyond).

Each point's 30 terms are formed as the kernel forms them: every product and
sum of float32 values rounded on its own, in the kernel's order (the
transform row by row, d2, the residual, the cross product). A point adds its
21 products of ``J^T J``, its 6 of ``-J r``, 1 to ``sum w`` and ``r^2`` where
its weight is 1, and 1 to ``n ok`` where it is valid and within
``max_d2``. The order: the problem's tiles (256 points up to 16,384 points,
512 beyond: one a thread of a block) cut into the plan's G chunks, one block
a chunk; thread t of a block adds point t of each of its tiles in tile
order, from 0; a butterfly over each warp's 32 lanes (lanes 16 apart, then
8, 4, 2, 1); the block's warps in order from 0; the chunks in order from
0. It uses float32 additions only, as the kernel does, so the
kernel gives its bits exactly (the card tests and the smoke hold it so).

    python tests/pair_gn_model.py

prints the model's worst error against the float64 sum at the SLAM step's
and the headline's shapes, in units of the 1e-5-of-scale tolerance.
"""

from __future__ import annotations

import numpy as np

from open3d_slam_private_tpu_torch.kernels.pair_gn import K1_OUT, k1_plan, k1_tile

_TRIU = [(a, b) for a in range(6) for b in range(a, 6)]
_F = np.float32


def _tree32(v):
    """The butterfly over axis -2 of 32 lanes: pairs of lanes 16 apart, then
    8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off, :] + v[..., off:2 * off, :]
    return v[..., 0, :]


def k1_terms(reading, pair_xyz, pair_normals, valid, T, tau, max_d2):
    """``[B, N, 30]`` float32: each point's 21 upper-triangle products of
    ``J^T J``, 6 of ``-J r``, ``w``, ``w r^2`` (0 where its weight is 0) and
    ``ok``, rounded as the kernel rounds them."""
    p, q, n = (np.asarray(x, _F) for x in (reading, pair_xyz, pair_normals))
    T, tau = np.asarray(T, _F), np.asarray(tau, _F)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    s = [((T[:, None, i, 0] * x + T[:, None, i, 1] * y) + T[:, None, i, 2] * z) + T[:, None, i, 3]
         for i in range(3)]
    d = [s[i] - q[..., i] for i in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    ok = np.asarray(valid).astype(bool) & (d2 <= _F(max_d2))
    w = ok & (d2 <= tau[:, None])
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    r = (d[0] * nx + d[1] * ny) + d[2] * nz
    c = [s[1] * nz - s[2] * ny, s[2] * nx - s[0] * nz, s[0] * ny - s[1] * nx, nx, ny, nz]
    vals = [c[a] * c[e] for a, e in _TRIU] + [-(c[a] * r) for a in range(6)]
    vals += [np.ones_like(r), r * r]
    out = np.where(w[..., None], np.stack(vals, -1), _F(0))
    return np.concatenate([out, ok[..., None].astype(_F)], -1).astype(_F)


def order_sum(terms) -> np.ndarray:
    """``[B, N, 30]`` float32 terms -> ``[B, 30]`` summed in the kernel's
    order for N points a problem."""
    x = np.asarray(terms, _F)
    B, N, S = x.shape
    G, per_block, _ = k1_plan(N)
    threads = k1_tile(N)
    pad = np.zeros((B, G * per_block * threads, S), _F)
    pad[:, :N] = x
    tiles = pad.reshape(B, G, per_block, threads, S)
    lanes = np.zeros((B, G, threads, S), _F)
    for k in range(per_block):
        lanes = lanes + tiles[:, :, k]
    warps = _tree32(lanes.reshape(B, G, threads // 32, 32, S))  # [B, G, warps, S]
    block = np.zeros((B, G, S), _F)
    for w in range(threads // 32):
        block = block + warps[:, :, w]
    total = np.zeros((B, S), _F)
    for g in range(G):
        total = total + block[:, g]
    return total


def expand(sums) -> np.ndarray:
    """``[B, 30]`` -> the kernel's ``[B, 45]`` output: the full symmetric A
    (row-major), b, sum w, sum w r^2, n ok."""
    sums = np.asarray(sums, _F)
    idx = [0] * 36
    for s, (a, b) in enumerate(_TRIU):
        idx[6 * a + b] = idx[6 * b + a] = s
    out = np.concatenate([sums[:, idx], sums[:, 21:30]], -1)
    assert out.shape[1] == K1_OUT
    return out


def k1_model(reading, pair_xyz, pair_normals, valid, T, tau, max_d2) -> np.ndarray:
    """K1's ``[B, 45]`` output, bit for bit."""
    return expand(order_sum(k1_terms(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)))


def k1_fp64(reading, pair_xyz, pair_normals, valid, T, tau, max_d2):
    """The same terms summed in float64: ``([B, 45] sums, [B, 45] sums of
    the terms' magnitudes)``."""
    t = k1_terms(reading, pair_xyz, pair_normals, valid, T, tau, max_d2).astype(np.float64)
    return expand(t.sum(1)).astype(np.float64), expand(np.abs(t).sum(1)).astype(np.float64)


def pairs(rng, B, N, spread=3.0):
    """Random K1 inputs: points in a ``spread`` cube, pairs 0.1 away, unit
    normals, 80% valid, a small pose and a trim threshold a problem."""
    reading = rng.uniform(-spread, spread, size=(B, N, 3)).astype(_F)
    q = (reading + rng.normal(scale=0.1, size=(B, N, 3))).astype(_F)
    nrm = rng.normal(size=(B, N, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(_F)
    valid = rng.uniform(size=(B, N)) > 0.2
    T = np.tile(np.eye(4, dtype=_F), (B, 1, 1))
    ang = 0.02 * (np.arange(B) + 1)
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
    T[:, :3, 3] = [0.1, -0.05, 0.02]
    tau = rng.uniform(0.01, 0.05, B).astype(_F)
    return reading, q, nrm, valid, T, tau, 0.25


def worst_over_tolerance(got, ref, scale) -> float:
    """Worst ``|got - ref| / (1e-5 (scale + 1))`` (the card tests' bound)."""
    return float((np.abs(np.asarray(got, np.float64) - ref) / (1e-5 * (scale + 1.0))).max())


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    for B, N in ((1, 4096), (1, 16384), (1, 16411), (8, 65536)):
        args = pairs(rng, B, N)
        ref, scale = k1_fp64(*args)
        print(f"{B} x {N}: plan {k1_plan(N)}, worst {worst_over_tolerance(k1_model(*args), ref, scale):.3g}"
              " x tolerance")

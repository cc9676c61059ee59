"""A numpy model of the ``normal_eq`` kernel's summation order
(``open3d_slam_private_tpu_torch/csrc/normal_eq.cu``), on the three routes
of ``kernels.normal_eq.ne_plan``.

Each pair's 27 terms are formed as the kernel forms them: the difference,
the residual and the cross product in float32, each product and sum rounded
on its own; ``cw = c w`` in float32; then ``cw_a c_q`` (21) and ``-cw_a r``
(6) as float64 products, which are exact. A pair of weight 0 adds nothing.
The order, in float64 additions: lane l of a warp (up to 512 pairs a
problem) or of a block (one block a chunk: 128 lanes on the cluster route,
256 on the two-pass route) adds the pairs l, l + lanes, ... of its range in
order, from 0; a butterfly over each warp's 32 lanes (lanes 16 apart, then
8, 4, 2, 1); a block's warps in order from 0;
then the chunks: in order from 0 on the cluster route, and on the two-pass
route lane l adds chunks l, l + 32, ... in order from 0, then a butterfly
over the 32 lanes; one rounding to float32. The kernel fuses each product
into its add, which rounds as this model does because the products are
exact, so the kernel gives the model's bits (the card tests and the smoke
hold it so).

    python tests/normal_eq_model.py

prints the model's worst error against the exact (float64, magnitude-scaled)
sums on the paths' shapes, in units of the 1e-5-of-scale tolerance.
"""

from __future__ import annotations

import numpy as np

from open3d_slam_private_tpu_torch.kernels.normal_eq import (
    CLUSTER_LANES,
    LANES,
    N_OUT,
    ROUTE_CLUSTER,
    ROUTE_TWO_PASS,
    ROUTE_WARP,
    ne_plan,
)
_TRIU = [(a, b) for a in range(6) for b in range(a, 6)]
_F = np.float32


def _tree32(v):
    """The butterfly over axis -2 of 32 lanes: pairs of lanes 16 apart, then
    8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off, :] + v[..., off:2 * off, :]
    return v[..., 0, :]


def ne_terms(src, ref_xyz, ref_normals, weights) -> np.ndarray:
    """``[B, N K, 27]`` float64: each pair's 21 upper-triangle products of
    ``w J J^T`` and 6 of ``-w J r``, formed as the kernel forms them (0 where
    the weight is 0)."""
    q, n, w = (np.asarray(x, _F) for x in (ref_xyz, ref_normals, weights))
    B, N, K = w.shape
    p = np.broadcast_to(np.asarray(src, _F)[:, :, None, :], q.shape)
    d = [p[..., i] - q[..., i] for i in range(3)]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    r = (d[0] * nx + d[1] * ny) + d[2] * nz
    c = [p[..., 1] * nz - p[..., 2] * ny, p[..., 2] * nx - p[..., 0] * nz, p[..., 0] * ny - p[..., 1] * nx,
         nx, ny, nz]
    cw = [(ca * w).astype(np.float64) for ca in c]
    vals = [cw[a] * c[e].astype(np.float64) for a, e in _TRIU]
    vals += [-(cw[a] * r.astype(np.float64)) for a in range(6)]
    out = np.where((w != 0)[..., None], np.stack(vals, -1), 0.0)
    return out.reshape(B, N * K, 27)


def _lanes(x, lanes):
    """``[..., P, S]`` -> ``[..., lanes, S]``: lane l adds rows l, l + lanes,
    ... in order, from 0."""
    *lead, P, S = x.shape
    steps = -(-P // lanes)
    pad = np.zeros((*lead, steps * lanes, S))
    pad[..., :P, :] = x
    pad = pad.reshape(*lead, steps, lanes, S)
    acc = np.zeros((*lead, lanes, S))
    for k in range(steps):
        acc = acc + pad[..., k, :, :]
    return acc


def order_sum(terms) -> np.ndarray:
    """``[B, P, 27]`` float64 terms -> ``[B, 27]`` float32 in the kernel's
    order for P pairs a problem."""
    x = np.asarray(terms, np.float64)
    B, P, S = x.shape
    route, G, chunk = ne_plan(P)
    if route == ROUTE_WARP:
        return _tree32(_lanes(x, 32)).astype(_F)
    lanes = CLUSTER_LANES if route == ROUTE_CLUSTER else LANES
    pad = np.zeros((B, G * chunk, S))
    pad[:, :P] = x
    warps = _tree32(_lanes(pad.reshape(B, G, chunk, S), lanes).reshape(B, G, lanes // 32, 32, S))
    rows = np.zeros((B, G, S))
    for w in range(lanes // 32):
        rows = rows + warps[:, :, w]
    if route == ROUTE_CLUSTER:
        total = np.zeros((B, S))
        for g in range(G):
            total = total + rows[:, g]
        return total.astype(_F)
    assert route == ROUTE_TWO_PASS
    return _tree32(_lanes(rows, 32)).astype(_F)


def _full(sums) -> np.ndarray:
    """``[B, 27]`` -> ``[B, 42]``: the full symmetric A (row-major), then b."""
    idx = [0] * 36
    for s, (a, b) in enumerate(_TRIU):
        idx[6 * a + b] = idx[6 * b + a] = s
    out = np.concatenate([sums[:, idx], sums[:, 21:27]], -1)
    assert out.shape[1] == N_OUT
    return out


def ne_model(src, ref_xyz, ref_normals, weights) -> np.ndarray:
    """The kernel's ``[B, 42]`` float32 output, bit for bit."""
    return _full(order_sum(ne_terms(src, ref_xyz, ref_normals, weights)))


def ne_fp64(src, ref_xyz, ref_normals, weights):
    """The same terms summed in float64 in any order (``np.sum``): ``([B,
    42] sums, [B, 42] sums of the terms' magnitudes)``."""
    t = ne_terms(src, ref_xyz, ref_normals, weights)
    return _full(t.sum(1)), _full(np.abs(t).sum(1))


def inputs(rng, B, N, K, spread=5.0, keep=0.7):
    """Random normal_eq inputs: points in a ``spread`` cube, matches 0.05
    away, unit normals, a ``keep`` share of weight-1 pairs, the rest 0."""
    src = rng.uniform(-spread, spread, size=(B, N, 3)).astype(_F)
    q = (src[:, :, None, :] + rng.normal(scale=0.05, size=(B, N, K, 3))).astype(_F)
    nrm = rng.normal(size=(B, N, K, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(_F)
    w = (rng.uniform(size=(B, N, K)) < keep).astype(_F)
    return src, q, nrm, w


def worst_over_tolerance(got, ref, scale) -> float:
    """Worst ``|got - ref| / (1e-5 (scale + 1))`` (the card tests' bound)."""
    return float((np.abs(np.asarray(got, np.float64) - ref) / (1e-5 * (scale + 1.0))).max())


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    for B, N, K in ((1, 4096, 1), (1, 16384, 1), (64, 512, 1), (2, 65536, 8), (3, 5003, 1)):
        args = inputs(rng, B, N, K)
        ref, scale = ne_fp64(*args)
        print(f"{B} x {N} x {K}: plan {ne_plan(N * K)}, worst "
              f"{worst_over_tolerance(ne_model(*args), ref, scale):.3g} x tolerance")

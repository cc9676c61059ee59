"""A numpy model of the ``moments`` kernel's summation order
(``open3d_slam_private_tpu_torch/csrc/moments.cu``), route by route.

- :func:`raw_model`: the raw entry (``pair_sums`` / ``pair_sums_groups``),
  both routes of ``kernels.moments.raw_plan`` (one launch up to 16,384
  pairs, a second kernel beyond): in each chunk, 256 pair lanes each add
  their pairs in order from 0, an xor butterfly over each 32 lanes, the 8
  lane groups in order, then the chunks in order, rounded once to float32.
  It uses float64 additions only, as the kernel does, so the kernel gives
  its bits exactly (the card tests hold it so).
- :func:`structured_model`: the point-to-plane and GICP entries: in each
  4,096-pair chunk, 128 pair lanes of a sum's group add a_r(p) b_c(p) over
  their pairs l, l + 128, ...; a butterfly over each 32 lanes, the group's
  4 warps in order; then the final kernel's order over the chunks (lane l
  adds chunks l, l + 32, ... from 0, then a butterfly). The kernel fuses
  each product into its add (one rounding fewer), so this model shows the
  order, not the kernel's bits.

    python tests/moments_model.py

prints each route's worst error against the float64 sum, in units of the
1e-5-of-scale tolerance.
"""

from __future__ import annotations

import numpy as np

from open3d_slam_private_tpu_torch.kernels.moments import CHUNK, raw_plan


def _tree32(v):
    """The butterfly over the last-but-k axis of 32 lanes (axis -2): pairs
    of lanes 16 apart, then 8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off, :] + v[..., off:2 * off, :]
    return v[..., 0, :]


def raw_model(terms) -> np.ndarray:
    """``terms [B, P, S]`` -> ``[B, S]`` float32 in the raw entry's order
    (each column on its own: its bits depend on P alone)."""
    x = np.asarray(terms, np.float32).astype(np.float64)
    B, P, S = x.shape
    if P == 0:
        return np.zeros((B, S), np.float32)
    G, CH, _ = raw_plan(P)
    total = None
    for g in range(G):
        seg = x[:, g * CH:min(P, (g + 1) * CH)]
        lanes = np.zeros((B, 256, S))
        for k in range(0, seg.shape[1], 256):
            part = seg[:, k:k + 256]
            lanes[:, :part.shape[1]] += part
        h = _tree32(lanes.reshape(B, 8, 32, S))  # [B, 8, S]
        ct = h[:, 0]
        for i in range(1, 8):
            ct = ct + h[:, i]
        total = ct if total is None else total + ct
    return total.astype(np.float32)


def _factors(kind, p0, q, n, w, ns=None, epsilon=1e-3):
    """The kernel's per-pair factors a [..., P, 14] and b [..., P, 17] in
    float64, and each sum's (row, column) in the layout's order."""
    p, q, n, w = (np.asarray(v, np.float32).astype(np.float64) for v in (p0, q, n, w))
    one = np.ones_like(w)
    pp = p[..., :, None] * p[..., None, :]
    a = np.concatenate([one[..., None], p, pp.reshape(p.shape[:-1] + (9,)), (p * p).sum(-1, keepdims=True)], -1)
    if kind == "point_to_plane":
        s = (n * q).sum(-1)
        wn = w[..., None] * n
        b = np.concatenate([(wn[..., :, None] * n[..., None, :]).reshape(n.shape[:-1] + (9,)),
                            (w * s)[..., None] * n, (w * s * s)[..., None], w[..., None],
                            np.zeros(w.shape + (3,))], -1)
        slots = ([(r, c) for r in range(4, 13) for c in range(9)] + [(r, c) for r in range(1, 4) for c in range(9)]
                 + [(0, c) for c in range(9)] + [(r, c) for r in range(1, 4) for c in range(9, 12)]
                 + [(0, c) for c in range(9, 12)] + [(0, 12), (0, 13)])
    else:
        ns = np.asarray(ns, np.float32).astype(np.float64)
        k = 1.0 - epsilon
        Sm = 2.0 * np.eye(3) - k * (n[..., :, None] * n[..., None, :] + ns[..., :, None] * ns[..., None, :])
        M = np.linalg.inv(Sm) * w[..., None, None]  # unit normals: det(Sm) >= (2 - 2k)^3 > 0
        Mq = (M * q[..., None, :]).sum(-1)
        b = np.concatenate([M.reshape(M.shape[:-2] + (9,)), Mq, w[..., None], w[..., None] * q,
                            (w * (q * q).sum(-1))[..., None]], -1)
        slots = ([(0, c) for c in range(9)] + [(r, c) for r in range(1, 4) for c in range(9)]
                 + [(r, c) for r in range(4, 13) for c in range(9)] + [(0, c) for c in range(9, 12)]
                 + [(r, c) for r in range(1, 4) for c in range(9, 12)] + [(0, 12)]
                 + [(r, 12) for r in range(1, 4)] + [(0, c) for c in range(13, 16)] + [(13, 12), (0, 16)]
                 + [(r, c) for c in range(13, 16) for r in range(1, 4)])
    return a, b, slots


def structured_model(kind, p0, q, n, w, ns=None, epsilon=1e-3) -> np.ndarray:
    """Pairs ``[B, P, 3]``, weights ``[B, P]`` -> ``[B, S]`` float32 (131
    point-to-plane or 147 GICP sums, the layout's order) in the structured
    entry's order, each product rounded before its add."""
    a, b, slots = _factors(kind, p0, q, n, w, ns, epsilon)
    rows, cols = np.array([r for r, _ in slots]), np.array([c for _, c in slots])
    terms = a[..., rows] * b[..., cols]  # [B, P, S]
    B, P, S = terms.shape
    nchunks = -(-P // CHUNK)
    partial = np.zeros((B, nchunks, S))
    for c in range(nchunks):
        seg = terms[:, c * CHUNK:min(P, (c + 1) * CHUNK)]
        lanes = np.zeros((B, 128, S))
        for k in range(0, seg.shape[1], 128):
            part = seg[:, k:k + 128]
            lanes[:, :part.shape[1]] += part
        h = _tree32(lanes.reshape(B, 4, 32, S))  # [B, 4 warps, S]
        v = h[:, 0]
        for i in range(1, 4):
            v = v + h[:, i]
        partial[:, c] = v
    lanes = np.zeros((B, 32, S))
    for c in range(nchunks):
        lanes[:, c % 32] += partial[:, c]
    return _tree32(lanes).astype(np.float32)


def _main():
    rng = np.random.default_rng(0)
    for P in (1000, 16384, 40000):
        t = rng.normal(size=(2, P, 6)).astype(np.float32)
        err = np.abs(raw_model(t) - t.astype(np.float64).sum(1)) / (1e-5 * np.abs(t).astype(np.float64).sum(1))
        print(f"raw P={P} plan={raw_plan(P)}: {err.max():.3g} x tolerance")


if __name__ == "__main__":
    _main()

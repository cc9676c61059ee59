"""K5: streaming brute-force nearest neighbour (k = 1).

Replaces ``knn_bruteforce_pallas``
(``open3d_slam_private_tpu/kernels/knn_pallas.py:78``), the kernel behind
``ICPConfig(matcher="brute_pallas")``. The CUDA kernel is
``csrc/knn_brute.cu``; :func:`knn_brute_plain` is the same function in plain
PyTorch. :func:`knn_brute` runs the plain version for CPU tensors and the
kernel for CUDA tensors, with no fallback between them.

Contract: for each query ``q_i`` of ``query [Q, 3]`` the smallest
``d2_ij = (|q_i|^2 - 2 q_i.r_j) + |r_j|^2`` over the rows of ``ref [M, 3]``
and the lowest index attaining it, as the Pallas kernel forms it: the
squares and the dot are fused multiply-add chains in coordinate order
(``ops/knn.py`` ``sq_norms`` and ``expansion_sq_dists``, XLA's CPU
rounding), each step rounded once to float32, and there is no clamp, so a
distance may come out negative. The reference is the cloud's
``padded_xyz()``: padded rows sit at ``PAD_COORD`` (1e9), whose squared
distance (~1e18) never beats a real point's. With M = 0 every query gets
(inf, 0). A batch of readings passes its flattened ``[B * N, 3]`` queries
against the one shared reference. The plain version emulates each fused
multiply-add in float64 (two roundings, float64 then float32), the kernel
rounds once: the two may part by one unit in the last place in rare cases.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.ops.knn import INF, chunk_rows, expansion_sq_dists, sq_norms

_P, _I = ctypes.c_void_p, ctypes.c_int
# knn_brute_launch(query, ref, Q, M, splits, packed, part_d2, part_ids, d2,
#                  ids, stream)
_LAUNCH_ARGTYPES = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]


def knn_brute_plain(query, ref):
    """Plain PyTorch K5 -> ``(d2 [Q] float32, ids [Q] int32)``."""
    d2 = torch.full((query.shape[0],), INF, device=query.device)
    ids = torch.zeros((query.shape[0],), dtype=torch.int32, device=query.device)
    step = chunk_rows(ref.shape[0])
    q_sq, r_sq = sq_norms(query), sq_norms(ref)
    for s in range(0, query.shape[0] if ref.shape[0] else 0, step):
        e = expansion_sq_dists(query[s:s + step], ref, q_sq[s:s + step], r_sq, clamp=False)
        best, arg = e.min(-1)
        d2[s:s + step] = best
        ids[s:s + step] = arg.to(torch.int32)
    return d2, ids


def _lib():
    lib = _build.load("knn_brute", _LAUNCH_ARGTYPES)
    if lib.knn_brute_plan.argtypes is None:
        lib.knn_brute_plan.argtypes = [_I, _I, _P]
        lib.knn_brute_plan.restype = _I
    return lib


def knn_brute_plan(Q: int, M: int, device) -> dict:
    """The kernel's launch plan for ``Q`` queries against ``M`` points on a
    CUDA ``device``: ``qpt`` queries a thread, ``splits`` of the reference
    across blocks (from Q, M, the SM count and the kernel's occupancy), and
    ``packed_rows`` of the packed reference."""
    lib = _lib()
    plan = (ctypes.c_int32 * 3)()
    with torch.cuda.device(device):
        rc = lib.knn_brute_plan(Q, M, ctypes.addressof(plan))
    _build.check_launch(lib, "knn_brute", rc)
    return dict(qpt=plan[0], splits=plan[1], packed_rows=plan[2])


def knn_brute(query, ref):
    """K5 on ``query [Q, 3]`` and ``ref [M, 3]`` float32 -> ``(d2 [Q],
    ids [Q] int32)``. CPU tensors take :func:`knn_brute_plain`; CUDA tensors
    launch the kernel (counted in ``knn_brute.launches``) or raise."""
    dev = query.device
    if dev.type == "cpu":
        return knn_brute_plain(query, ref)
    if dev.type != "cuda":
        raise ValueError(f"knn_brute: unsupported device {dev}")
    Q, M = query.shape[0], ref.shape[0]
    _build.check_tensor("query", query, (Q, 3), (torch.float32,), dev)
    _build.check_tensor("ref", ref, (M, 3), (torch.float32,), dev)
    plan = knn_brute_plan(Q, M, dev)
    d2 = torch.empty((Q,), dtype=torch.float32, device=dev)
    ids = torch.empty((Q,), dtype=torch.int32, device=dev)
    packed = torch.empty((plan["packed_rows"], 4), dtype=torch.float32, device=dev)
    parts = plan["splits"] if plan["splits"] > 1 else 0
    part_d2 = torch.empty((parts, Q), dtype=torch.float32, device=dev)
    part_ids = torch.empty((parts, Q), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_brute_launch(query.data_ptr(), ref.data_ptr(), Q, M, plan["splits"],
                                  packed.data_ptr(), part_d2.data_ptr(), part_ids.data_ptr(),
                                  d2.data_ptr(), ids.data_ptr(), stream)
    _build.check_launch(lib, "knn_brute", rc)
    _build.count_launch(knn_brute)
    return d2, ids


knn_brute.launches = 0

"""The point-to-plane normal equations, summed in an order fixed by the
problem's own size.

No TPU kernel stands behind it: the JAX package forms these sums in XLA
(``open3d_slam_private_tpu/models/minimizers.py:65-88``). The port's plain
version is :func:`~open3d_slam_private_tpu_torch.models.minimizers.point_to_plane_normal_equations_bc`,
a float32 einsum; on the card cuBLAS picks that einsum's algorithm and its
split of the reduction from the whole shape, batch included, so a problem's
``A`` and ``b`` moved with the batch it ran in. The CUDA kernel
(``csrc/normal_eq.cu``) sums each problem in float64 in an order fixed by
its own N * K (:func:`ne_plan`): one warp a problem up to 512 pairs, one
thread block cluster up to 16,384 (both one launch), chunks of 8,192 pairs
and a second kernel beyond. :func:`normal_eq` runs the plain version for
CPU tensors and the kernel for CUDA tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.models.minimizers import point_to_plane_normal_equations_bc

N_OUT = 42  # the full 6 x 6 A, then b
WARP_ROUTE = 512  # pairs a problem, at most, summed by one warp (csrc/normal_eq.cu kWarpRoute)
CLUSTER_CHUNK = 256  # pairs a cluster block, at least
CLUSTER_LANES = 128  # pair lanes a cluster block (csrc/normal_eq.cu kClusterLanes)
LANES = 256  # pair lanes a block beyond one launch (kThreads)
MAX_CLUSTER = 16  # blocks a cluster (kMaxCluster; past 8 the non-portable size)
ONE_LAUNCH = 16384  # pairs a problem, at most, in one launch
CHUNK = 8192  # pairs a block beyond one launch
ROUTE_WARP, ROUTE_CLUSTER, ROUTE_TWO_PASS = 0, 1, 2
_P, _I = ctypes.c_void_p, ctypes.c_int
# normal_eq_launch(src, ref_xyz, ref_nrm, weights, B, N, K, route, G, chunk, partial, out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]

normal_eq_plain = point_to_plane_normal_equations_bc


def ne_plan(P: int) -> tuple[int, int, int]:
    """The kernel's route and chunks for ``P = N * K`` pairs a problem:
    ``(route, G, chunk)``. Up to ``WARP_ROUTE`` pairs one warp a problem
    (``G = 1``); up to ``ONE_LAUNCH`` pairs ``G = min(16, ceil(P / 256))``
    blocks of 128 lanes and ``ceil(P / G)`` pairs, one thread block cluster
    (1 x 16,384 x 1: 16 blocks of 1,024; 1 x 4,096 x 1: 16 of 256); beyond,
    chunks of ``CHUNK`` pairs and a second kernel. Chunk g holds the pairs
    ``[g chunk, min(P, (g + 1) chunk))``. A function of P alone, so a
    problem sums in the same order in any batch."""
    if P <= WARP_ROUTE:
        return ROUTE_WARP, 1, max(P, 1)
    if P <= ONE_LAUNCH:
        G = min(MAX_CLUSTER, -(-P // CLUSTER_CHUNK))
        return ROUTE_CLUSTER, G, -(-P // G)
    return ROUTE_TWO_PASS, -(-P // CHUNK), CHUNK


def normal_eq(src_xyz, ref_xyz, ref_normals, weights):
    """``src_xyz [B, N, 3]`` against matched ``ref_xyz / ref_normals
    [B, N, K, 3]`` with ``weights [B, N, K]`` (all float32) -> ``(A [B, 6, 6],
    b [B, 6])`` with J = [p x n, n] and r = (p - q) . n. CPU tensors take
    :func:`normal_eq_plain`; CUDA tensors launch the kernel (counted in
    ``normal_eq.launches``; ``normal_eq_partial``, and ``normal_eq_final``
    beyond ``ONE_LAUNCH`` pairs) or raise. A and b are views of one ``[B,
    42]`` tensor."""
    dev = src_xyz.device
    if dev.type == "cpu":
        return normal_eq_plain(src_xyz, ref_xyz, ref_normals, weights)
    if dev.type != "cuda":
        raise ValueError(f"normal_eq: unsupported device {dev}")
    if src_xyz.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"normal_eq: src {tuple(src_xyz.shape)}, weights {tuple(weights.shape)}; "
                         "expected [B, N, 3] and [B, N, K]")
    B, N, K = weights.shape
    if K < 1:
        raise ValueError("normal_eq: K must be at least 1")
    f32 = (torch.float32,)
    _build.check_tensor("src_xyz", src_xyz, (B, N, 3), f32, dev)
    _build.check_tensor("ref_xyz", ref_xyz, (B, N, K, 3), f32, dev)
    _build.check_tensor("ref_normals", ref_normals, (B, N, K, 3), f32, dev)
    _build.check_tensor("weights", weights, (B, N, K), f32, dev)
    if N * K >= 2**31:
        raise ValueError("normal_eq: 2^31 or more pairs a problem")
    route, G, chunk = ne_plan(N * K)
    # Beyond one launch the chunks' rows go through scratch of this call alone.
    partial = torch.empty(B * G * 32, dtype=torch.float64, device=dev) if route == ROUTE_TWO_PASS else None
    out = torch.empty((B, N_OUT), dtype=torch.float32, device=dev)
    lib = _build.load("normal_eq", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        rc = lib.normal_eq_launch(
            src_xyz.data_ptr(), ref_xyz.data_ptr(), ref_normals.data_ptr(), weights.data_ptr(),
            B, N, K, route, G, chunk, 0 if partial is None else partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(lib, "normal_eq", rc)
    _build.count_launch(normal_eq)
    return out.as_strided((B, 6, 6), (N_OUT, 6, 1)), out.as_strided((B, 6), (N_OUT, 1), 36)


normal_eq.launches = 0

"""The point-to-plane normal equations, summed in an order fixed by the
problem's own size.

No TPU kernel stands behind it: the JAX package forms these sums in XLA
(``open3d_slam_private_tpu/models/minimizers.py:65-88``). The port's plain
version is :func:`~open3d_slam_private_tpu_torch.models.minimizers.point_to_plane_normal_equations_bc`,
a float32 einsum; on the card cuBLAS picks that einsum's algorithm and its
split of the reduction from the whole shape, batch included, so a problem's
``A`` and ``b`` moved with the batch it ran in. The CUDA kernel
(``csrc/normal_eq.cu``) sums each problem in fixed chunks of 1,024 pairs
with float64 partials, then adds the chunks in order. :func:`normal_eq` runs
the plain version for CPU tensors and the kernel for CUDA tensors, with no
fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.models.minimizers import point_to_plane_normal_equations_bc

N_OUT = 42  # the full 6 x 6 A, then b
CHUNK = 1024  # pairs a block (csrc/normal_eq.cu kChunk)
_P, _I = ctypes.c_void_p, ctypes.c_int
# normal_eq_launch(src, ref_xyz, ref_nrm, weights, B, N, K, partial, out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P]

normal_eq_plain = point_to_plane_normal_equations_bc


def normal_eq(src_xyz, ref_xyz, ref_normals, weights):
    """``src_xyz [B, N, 3]`` against matched ``ref_xyz / ref_normals
    [B, N, K, 3]`` with ``weights [B, N, K]`` (all float32) -> ``(A [B, 6, 6],
    b [B, 6])`` with J = [p x n, n] and r = (p - q) . n. CPU tensors take
    :func:`normal_eq_plain`; CUDA tensors launch the kernel (counted in
    ``normal_eq.launches``; two ``__global__`` functions: partial, final) or
    raise. A and b are views of one ``[B, 42]`` tensor."""
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
    nchunks = -(-N * K // CHUNK)
    partial = torch.empty(max(B * nchunks * 32, 1), dtype=torch.float64, device=dev)
    out = torch.empty((B, N_OUT), dtype=torch.float32, device=dev)
    lib = _build.load("normal_eq", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        rc = lib.normal_eq_launch(
            src_xyz.data_ptr(), ref_xyz.data_ptr(), ref_normals.data_ptr(), weights.data_ptr(),
            B, N, K, partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(lib, "normal_eq", rc)
    _build.count_launch(normal_eq)
    return out.as_strided((B, 6, 6), (N_OUT, 6, 1)), out.as_strided((B, 6), (N_OUT, 1), 36)


normal_eq.launches = 0

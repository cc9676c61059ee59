"""Sums over each problem's pairs, in an order fixed by the problem's own
size: the round-frozen moments of the cached rounds, and the other pair
reductions of the ported chains.

No TPU kernel stands behind it: the JAX package forms these sums with XLA
einsums (``open3d_slam_private_tpu/models/minimizers.py:179-205`` and
``:255-297``). On the card an einsum or ``torch.sum`` over ``[B, P]`` picks
its algorithm and its split of the reduction from the whole shape, so a
problem's sums would move with its batch. The CUDA kernel
(``csrc/moments.cu``) sums each problem in fixed chunks of 1,024 pairs with
float64 partials, then adds the chunks in order. Three entry points share
it and its launch count (``moments.launches``):

- :func:`point_to_plane_moments` (131 sums) and :func:`gicp_moments` (147),
  whose plain versions are the JAX twin's einsums in
  ``models/minimizers.py``;
- :func:`pair_sums`, the sum over pairs of per-pair terms that PyTorch
  forms elementwise (the X-ICP analysis, GICP's per-iteration normal
  equations), whose plain version is ``terms.sum(-2)``.

Each runs the plain version for CPU tensors and the kernel for CUDA
tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.models import minimizers

KIND_P2PL, KIND_GICP, KIND_RAW = 0, 1, 2
CHUNK = 1024  # pairs a block (csrc/moments.cu kChunk)
MAX_SUMS = 160  # sums a launch, at most (kMaxSums)
P2PL_SUMS = minimizers.layout_size(minimizers.P2PL_LAYOUT)  # 131
GICP_SUMS = minimizers.layout_size(minimizers.GICP_LAYOUT)  # 147
_P, _I = ctypes.c_void_p, ctypes.c_int
# moments_launch(kind, p0, q, n, ns, w, terms, B, P, S, k, partial, out, stream)
_LAUNCH_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P, _P, _P]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def moments(kind: int, B: int, P: int, S: int, dev, p0=None, q=None, n=None, ns=None, w=None,
            terms=None, epsilon: float = 0.0) -> torch.Tensor:
    """One launch of the CUDA kernel -> ``[B, S]`` float32 sums (counted in
    ``moments.launches``; two ``__global__`` functions: the templated
    ``moments_partial`` and ``moments_final``). The inputs are checked by
    the entry points below."""
    if P >= 2**31:
        raise ValueError("moments: 2^31 or more pairs a problem")
    nchunks = -(-P // CHUNK)
    partial = torch.empty(max(B * nchunks * MAX_SUMS, 1), dtype=torch.float64, device=dev)
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    lib = _build.load("moments", _LAUNCH_ARGTYPES)
    with torch.cuda.device(dev):
        rc = lib.moments_launch(kind, _ptr(p0), _ptr(q), _ptr(n), _ptr(ns), _ptr(w), _ptr(terms),
                                B, P, S, 1.0 - epsilon, partial.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "moments", rc)
    _build.count_launch(moments)
    return out


moments.launches = 0


def _device(t: torch.Tensor, what: str) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_pairs(what, B, P, dev, **tensors):
    f32 = (torch.float32,)
    for name, t in tensors.items():
        shape = (B, P) if name == "weights" else (B, P, 3)
        _build.check_tensor(f"{what} {name}", t, shape, f32, dev)


def point_to_plane_moments(p0, q, ref_normals, weights) -> dict:
    """The point-to-plane moments (``minimizers.point_to_plane_moments``)
    of pairs ``[B, P, 3]`` with ``weights [B, P]``, as a dict of views of
    one ``[B, 131]`` row."""
    dev = _device(p0, "point_to_plane_moments")
    if dev.type == "cpu":
        return minimizers.point_to_plane_moments(p0, q, ref_normals, weights)
    B, P = weights.shape
    _check_pairs("point_to_plane_moments", B, P, dev, p0=p0, q=q, ref_normals=ref_normals,
                 weights=weights)
    out = moments(KIND_P2PL, B, P, P2PL_SUMS, dev, p0=p0, q=q, n=ref_normals, w=weights)
    return minimizers.unpack_moments(out, minimizers.P2PL_LAYOUT)


def gicp_moments(p0, src_normals0, q, ref_normals, weights, epsilon: float = 1e-3) -> dict:
    """The GICP moments (``minimizers.gicp_moments``) of pairs ``[B, P, 3]``
    with ``weights [B, P]``, as a dict of views of one ``[B, 147]`` row."""
    dev = _device(p0, "gicp_moments")
    if dev.type == "cpu":
        return minimizers.gicp_moments(p0, src_normals0, q, ref_normals, weights, epsilon)
    B, P = weights.shape
    _check_pairs("gicp_moments", B, P, dev, p0=p0, src_normals0=src_normals0, q=q,
                 ref_normals=ref_normals, weights=weights)
    out = moments(KIND_GICP, B, P, GICP_SUMS, dev, p0=p0, q=q, n=ref_normals, ns=src_normals0,
                  w=weights, epsilon=epsilon)
    return minimizers.unpack_moments(out, minimizers.GICP_LAYOUT)


def pair_sums(terms: torch.Tensor) -> torch.Tensor:
    """``terms [..., P, S]`` float32 -> their sum over pairs ``[..., S]``;
    on the card one launch per 160 columns."""
    dev = _device(terms, "pair_sums")
    if dev.type == "cpu":
        return terms.sum(-2)
    if terms.dtype != torch.float32 or terms.dim() < 2:
        raise ValueError(f"pair_sums: terms {terms.dtype} {tuple(terms.shape)}; expected float32 "
                         "[..., P, S]")
    lead, (P, S) = terms.shape[:-2], terms.shape[-2:]
    flat = terms.reshape((-1, P, S))
    B = flat.shape[0]
    outs = []
    for c in range(0, S, MAX_SUMS):
        cols = flat[..., c:c + MAX_SUMS].contiguous()
        outs.append(moments(KIND_RAW, B, P, cols.shape[-1], dev, terms=cols))
    return torch.cat(outs, -1).reshape(lead + (S,))

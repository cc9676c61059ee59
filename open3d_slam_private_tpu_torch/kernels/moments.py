"""Sums over each problem's pairs, in an order fixed by the problem's own
size: the round-frozen moments of the cached rounds, and the other pair
reductions of the ported chains.

No TPU kernel stands behind it: the JAX package forms these sums with XLA
einsums (``open3d_slam_private_tpu/models/minimizers.py:179-205`` and
``:255-297``). On the card an einsum or ``torch.sum`` over ``[B, P]`` picks
its algorithm and its split of the reduction from the whole shape, so a
problem's sums would move with its batch. The CUDA kernel
(``csrc/moments.cu``) sums each problem in float64 in an order fixed by its
own P, then rounds once to float32. Its entry points share its launch
count (``moments.launches``, one a wrapper launch):

- :func:`point_to_plane_moments` (131 sums) and :func:`gicp_moments` (147),
  whose plain versions are the JAX twin's einsums in
  ``models/minimizers.py``: chunks of 4,096 pairs a block, each sum formed
  by fused multiply-adds of per-pair factors held in registers;
- :func:`pair_sums` and :func:`pair_sums_groups`, the sum over pairs of
  per-pair terms that PyTorch forms elementwise (the X-ICP analysis, GICP's
  per-iteration normal equations), whose plain version is ``t.sum(-2)``
  for each group: one launch for up to 32 windows of 16 columns of any
  number of groups (by pointer), in the order of :func:`raw_plan`; a
  column's bits depend on P alone, not on its group, its position or the
  number of columns.

Each runs the plain version for CPU tensors and the kernel for CUDA
tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from open3d_slam_private_tpu_torch.kernels import _build
from open3d_slam_private_tpu_torch.models import minimizers

KIND_P2PL, KIND_GICP = 0, 1
CHUNK = 4096  # pairs a block of the structured entries (csrc/moments.cu kPairChunk)
PARTIAL_ROW = 160  # float64 values a structured chunk partial row (csrc/moments.cu kMaxSums)
RAW_WIDTH = 16  # columns a raw window (kRawWidth)
RAW_WINDOWS = 32  # windows a raw launch (kMaxWindows)
RAW_ONE_LAUNCH = 16384  # pairs a problem the raw entry sums in one launch
P2PL_SUMS = minimizers.layout_size(minimizers.P2PL_LAYOUT)  # 131
GICP_SUMS = minimizers.layout_size(minimizers.GICP_LAYOUT)  # 147
_P, _I = ctypes.c_void_p, ctypes.c_int
# moments_launch(kind, p0, q, n, ns, w, B, P, S, k, partial, out, stream)
_LAUNCH_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P, _P, _P]
# moments_raw_launch(n, terms, S, j_begin, j_end, col, B, P, G, CH, cluster, Stot, partial, out, stream)
_RAW_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _lib():
    lib = _build.load("moments", _LAUNCH_ARGTYPES)
    if lib.moments_raw_launch.argtypes is None:
        lib.moments_raw_launch.argtypes = _RAW_ARGTYPES
        lib.moments_raw_launch.restype = ctypes.c_int
    return lib


def raw_plan(P: int) -> tuple[int, int, bool]:
    """The raw entry's chunks for ``P`` pairs a problem: ``(G, CH, one
    launch)``. Up to ``RAW_ONE_LAUNCH`` pairs, ``G = min(8, ceil(P / 512))``
    chunks, one thread block cluster (one launch); beyond, ``ceil(P /
    2048)`` chunks and a second kernel for their totals. ``CH = ceil(P /
    G)``: chunk g holds the pairs ``[g CH, min(P, (g + 1) CH))``."""
    if P <= RAW_ONE_LAUNCH:
        G = max(1, min(8, -(-P // 512)))
        one = True
    else:
        G = -(-P // 2048)
        one = False
    return G, -(-P // G) if P else 1, one


def moments(kind: int, B: int, P: int, S: int, dev, p0=None, q=None, n=None, ns=None, w=None,
            epsilon: float = 0.0) -> torch.Tensor:
    """One launch of the structured kernel -> ``[B, S]`` float32 sums
    (counted in ``moments.launches``; two ``__global__`` functions: the
    templated ``moments_partial`` and ``moments_final``). The inputs are
    checked by the entry points below."""
    if P >= 2**31:
        raise ValueError("moments: 2^31 or more pairs a problem")
    nchunks = -(-P // CHUNK)
    partial = torch.empty(max(B * nchunks * PARTIAL_ROW, 1), dtype=torch.float64, device=dev)
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.moments_launch(kind, _ptr(p0), _ptr(q), _ptr(n), _ptr(ns), _ptr(w), B, P, S,
                                1.0 - epsilon, partial.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "moments", rc)
    _build.count_launch(moments)
    return out


moments.launches = 0


def _raw_launch(ranges, B: int, P: int, out: torch.Tensor) -> None:
    """One launch of the raw kernel over column ``ranges`` ``(terms [B, P,
    S], j_begin, j_end, out column)`` into ``out [B, Stot]`` (counted in
    ``moments.launches``; ``moments_raw``, and ``moments_raw_final`` beyond
    ``RAW_ONE_LAUNCH`` pairs)."""
    G, CH, one = raw_plan(P)
    windows = sum(-(-(e - b) // RAW_WIDTH) for _, b, e, _ in ranges)
    partial = None if one else torch.empty(max(B * windows * G * RAW_WIDTH, 1), dtype=torch.float64,
                                           device=out.device)
    n = len(ranges)
    ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
    lib = _lib()
    dev = out.device
    with torch.cuda.device(dev):
        rc = lib.moments_raw_launch(
            n, (ctypes.c_void_p * n)(*(t.data_ptr() for t, _, _, _ in ranges)),
            ints(t.shape[-1] for t, _, _, _ in ranges), ints(b for _, b, _, _ in ranges),
            ints(e for _, _, e, _ in ranges), ints(c for _, _, _, c in ranges), B, P, G, CH,
            int(one), out.shape[-1], _ptr(partial), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "moments", rc)
    _build.count_launch(moments)


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


def pair_sums_groups(*terms: torch.Tensor) -> tuple:
    """Groups ``terms [..., P, S_g]`` float32 (one shape but the last) ->
    the tuple of their sums over pairs ``[..., S_g]``. On the CPU each is
    ``t.sum(-2)``; on the card one launch sums up to 32 windows of 16
    columns of any of the groups, read in place, into one ``[B, sum S_g]``
    row (the results are views of it)."""
    if not terms:
        raise ValueError("pair_sums_groups: no terms")
    dev = _device(terms[0], "pair_sums")
    if dev.type == "cpu":
        return tuple(t.sum(-2) for t in terms)
    for t in terms:
        if t.dtype != torch.float32 or t.dim() < 2 or t.shape[:-1] != terms[0].shape[:-1] or t.device != dev:
            raise ValueError(f"pair_sums: terms {t.dtype} {tuple(t.shape)} on {t.device}; expected float32 "
                             f"{tuple(terms[0].shape[:-1])} + (S,) on {dev}")
    lead, P = terms[0].shape[:-2], terms[0].shape[-2]
    if P >= 2**31:
        raise ValueError("pair_sums: 2^31 or more pairs a problem")
    B = math.prod(lead)
    flats = [t.reshape((B, P, t.shape[-1])).contiguous() for t in terms]
    widths = [f.shape[-1] for f in flats]
    out = torch.empty((B, sum(widths)), dtype=torch.float32, device=dev)
    # Column ranges packed into launches of at most 32 windows of 16
    # columns, in the groups' order; a group that does not fit is split at a
    # window's edge.
    launch, windows, col = [], 0, 0
    for f, S in zip(flats, widths):
        j = 0
        while j < S:
            if windows == RAW_WINDOWS:
                _raw_launch(launch, B, P, out)
                launch, windows = [], 0
            e = min(S, j + (RAW_WINDOWS - windows) * RAW_WIDTH)
            launch.append((f, j, e, col))
            windows, col, j = windows + -(-(e - j) // RAW_WIDTH), col + e - j, e
    if launch:
        _raw_launch(launch, B, P, out)
    sums, col = [], 0
    for S in widths:
        sums.append(out[:, col:col + S].reshape(lead + (S,)))
        col += S
    return tuple(sums)


def pair_sums(terms: torch.Tensor) -> torch.Tensor:
    """``terms [..., P, S]`` float32 -> their sum over pairs ``[..., S]``
    (:func:`pair_sums_groups` of one group; on the card one launch per 512
    columns)."""
    return pair_sums_groups(terms)[0]

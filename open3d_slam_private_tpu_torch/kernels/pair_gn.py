"""K1 and K3: the fused pair-cached Gauss-Newton linearisation.

K1 (knn = 1) replaces ``pair_gn_step_folded``
(``open3d_slam_private_tpu/kernels/pair_gn_pallas.py:261``); its CUDA kernel
is ``csrc/pair_gn.cu`` (its output the full 6 x 6 A, b and the three sums,
unpacked as views; up to 16,384 points a problem one launch of one thread
block cluster, beyond a second kernel over a scratch the call allocates;
:func:`k1_plan`). K3 (K <= 8 pairs per point) replaces ``pair_gn_step``
(``pair_gn_pallas.py:136``); its CUDA kernel is ``csrc/pair_gn_k.cu``.
:func:`pair_gn_plain` and :func:`pair_gn_k_plain` are the same functions in
plain PyTorch. :func:`pair_gn` and :func:`pair_gn_k` run the plain version
for CPU tensors and the kernel for CUDA tensors, with no fallback between
them.

K1's plain version rounds as the JAX package's Pallas kernel does in
interpret mode on XLA's CPU backend (what its parity tests run), so the two
agree bit for bit: float32 arithmetic with fused multiply-adds where XLA's
code generator forms them, and float32 sums over the folded layout's
512-point tiles in XLA's order (:func:`folded_sum`). :func:`pair_gn_fp64`
sums the same function's float32 terms (:func:`terms`) in float64: the
reference the CUDA kernel is held to.

Per problem b and pair (i, k), with ``s = T_b p_i``, ``d2 = |s - q_ik|^2``,
``ok = valid_ik & d2 <= max_d2`` and ``w = ok & d2 <= tau_b``, they return
``A = sum w J^T J`` and ``b = -sum w J r`` for ``J = [s x n_ik, n_ik]``,
``r = (s - q_ik) . n_ik``, and ``sum w``, ``sum w r^2``, ``count ok``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from open3d_slam_private_tpu_torch.geometry.se3 import fma32
from open3d_slam_private_tpu_torch.kernels import _build

N_OUT = 31  # the plain version's and K3's sums: 21 upper-triangle A, b, sum w, sum w r^2, sum w, n ok
K1_OUT = 45  # K1's output row: the full 6 x 6 A, b, sum w, sum w r^2, n ok
_THREADS = 256
K1_TILE = 256  # points a K1 tile, one a thread of a block, up to K1_ONE_LAUNCH points (csrc/pair_gn.cu Block)
K1_WIDE_TILE = 512  # the same beyond
K1_MAX_TILES = 4  # tiles a K1 block (kMaxTiles)
K1_MAX_CLUSTER = 16  # blocks a K1 cluster (kMaxCluster; past 8 the non-portable size)
K1_ONE_LAUNCH = 16384  # points a problem, at most, in one launch
_K3_BLOCKS = 128  # K3's blocks per problem, at most
_P, _I = ctypes.c_void_p, ctypes.c_int
# pair_gn_launch(reading, pair_xyz, pair_nrm, valid, T, tau, max_d2, B, N,
#                G, tiles_per_block, cluster, partial, out, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P, _P, _P]
# pair_gn_k_launch(reading, pair_xyz, pair_nrm, valid, T, tau, max_d2, B, N, K,
#                  nblocks, partial, out, stream)
_LAUNCH_K_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _P, _P, _P]
_TRIU = [(a, b) for a in range(6) for b in range(a, 6)]


_SYM = [0] * 36
for _s, (_a, _b) in enumerate(_TRIU):
    _SYM[6 * _a + _b] = _SYM[6 * _b + _a] = _s
_SYM_ON: dict = {}  # device -> the index tensor above on that device


def unpack(out: torch.Tensor):
    """``[B, 31]`` sums -> (A [B, 6, 6], b [B, 6], sum_w, sum_wr2, n_ok)
    (an index gather builds A from its upper triangle)."""
    idx = _SYM_ON.get(out.device)
    if idx is None:
        if out.device.type == "cuda":
            _build.no_capture("pair_gn unpack")
        idx = _SYM_ON[out.device] = torch.tensor(_SYM, device=out.device)
    A = out[:, idx].reshape(-1, 6, 6)
    return A, out[:, 21:27], out[:, 27], out[:, 28], out[:, 30]


def terms(reading, pair_xyz, pair_normals, valid, T, tau, max_d2):
    """Per-point ``[B, N, 31]`` float32 terms whose sum over N is the output
    (the plain version's arithmetic, shared by its fp64 check)."""
    return _pair_terms(_transform(T, reading), pair_xyz, pair_normals, valid, tau, max_d2)


def terms_k(reading, pair_xyz, pair_normals, valid, T, tau, max_d2):
    """K3's per-pair ``[B, N * K, 31]`` float32 terms: each point's moved
    position paired with each of its K cached pairs ``[B, N, K, 3]``."""
    B, N, K = valid.shape
    s = _transform(T, reading)[:, :, None, :].expand(B, N, K, 3).reshape(B, N * K, 3)
    return _pair_terms(s, pair_xyz.reshape(B, N * K, 3), pair_normals.reshape(B, N * K, 3),
                       valid.reshape(B, N * K), tau, max_d2)


def _pair_terms(s, pair_xyz, pair_normals, valid, tau, max_d2):
    d = s - pair_xyz
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    ok = valid.bool() & (d2 <= max_d2)
    w = (ok & (d2 <= tau[:, None])).float()
    n = pair_normals
    r = (d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1]) + d[..., 2] * n[..., 2]
    cols = torch.cat([torch.linalg.cross(s, n), n], dim=-1)
    cw = cols * w[..., None]
    a_terms = torch.stack([cw[..., a] * cols[..., b] for a, b in _TRIU], dim=-1)
    b_terms = -(cw * r[..., None])
    return torch.cat(
        [a_terms, b_terms, w[..., None], (w * r * r)[..., None], w[..., None],
         ok.float()[..., None]],
        dim=-1,
    )


def _transform(T, p):
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    return ((R[..., 0] * x + R[..., 1] * y) + R[..., 2] * z) + t


def pair_gn_fp64(reading, pair_xyz, pair_normals, valid, T, tau, max_d2: float):
    """K1's function with float32 terms (:func:`terms`) and float64 sums,
    rounded to float32 once: the CUDA kernel's reference."""
    out = terms(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)
    return unpack(out.double().sum(1).float())


_FOLD, _TILE, _WINDOW = 8, 512, 32  # the Pallas kernel's sublanes, its tile, XLA's window


def folded_sum(terms_: torch.Tensor) -> torch.Tensor:
    """``[B, N, S]`` float32 -> ``[B, S]``, summed as the Pallas kernel's
    folded layout is summed in interpret mode on XLA's CPU backend: the N
    points padded to a multiple of 8 x 512 and folded into 8 rows of m
    (point ``s m + j`` at row s, column j); per 512-column tile, XLA sums
    windows of 8 rows x 32 columns (row by row, column by column, from 0),
    then the tile's 16 windows in order; the tiles are added in order."""
    B, N, S = terms_.shape
    npad = -(-N // (_FOLD * _TILE)) * _FOLD * _TILE
    m = npad // _FOLD
    padded = terms_.new_zeros(B, npad, S)
    padded[:, :N] = terms_
    x = padded.reshape(B, _FOLD, m // _TILE, _TILE // _WINDOW, _WINDOW, S)
    win = terms_.new_zeros(B, m // _TILE, _TILE // _WINDOW, S)
    for row in range(_FOLD):
        for col in range(_WINDOW):
            win = win + x[:, row, :, :, col]
    tiles = terms_.new_zeros(B, m // _TILE, S)
    for w in range(_TILE // _WINDOW):
        tiles = tiles + win[:, :, w]
    out = tiles[:, 0]
    for t in range(1, tiles.shape[1]):
        out = out + tiles[:, t]
    return out


def terms_xla(reading, pair_xyz, pair_normals, valid, T, tau, max_d2):
    """K1's per-point ``[B, N, 31]`` terms as XLA's CPU backend computes the
    Pallas kernel's body: each ``a * b + c`` of the source that its code
    generator contracts is one fused multiply-add (``s = fma(R_i2, z,
    fma(R_i0, x, R_i1 y)) + t_i``; ``d2``, ``r`` and the cross products
    likewise), the rest float32 operations in source order."""
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    x, y, z = reading.unbind(-1)
    sx, sy, sz = (fma32(R[..., i, 2], z, fma32(R[..., i, 0], x, R[..., i, 1] * y)) + t[..., i]
                  for i in range(3))
    qx, qy, qz = pair_xyz.unbind(-1)
    nx, ny, nz = pair_normals.unbind(-1)
    dx, dy, dz = sx - qx, sy - qy, sz - qz
    d2 = fma32(dz, dz, fma32(dx, dx, dy * dy))
    ok = valid.bool() & (d2 <= max_d2)
    w = (ok & (d2 <= tau[:, None])).float()
    r = fma32(dz, nz, fma32(dx, nx, dy * ny))
    cols = (fma32(sy, nz, -(sz * ny)), fma32(sz, nx, -(sx * nz)), fma32(sx, ny, -(sy * nx)),
            nx, ny, nz)
    vals = [(w * cols[a]) * cols[b] for a, b in _TRIU]
    for a in range(6):
        # XLA's fusion of the n_x column adds the residual's products in
        # another order before contracting them.
        ra = fma32(dz, nz, fma32(dy, ny, dx * nx)) if a == 3 else r
        vals.append(-((w * cols[a]) * ra))
    vals += [w, (w * r) * r, w, ok.float()]
    return torch.stack(vals, -1)


def pair_gn_plain(reading, pair_xyz, pair_normals, valid, T, tau, max_d2: float):
    """Plain PyTorch K1, rounded as the interpret-mode Pallas kernel on
    XLA's CPU backend: :func:`terms_xla` summed by :func:`folded_sum`."""
    return unpack(folded_sum(terms_xla(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)))


def num_blocks(N: int) -> int:
    """K3's blocks per problem: one point a thread up to 128 blocks. A
    function of the problem's size N alone, so a problem sums in the same
    order in any batch (at 8 x 65,536: 1,024 blocks in all)."""
    return max(1, min(math.ceil(N / _THREADS), _K3_BLOCKS))


def k1_plan(N: int) -> tuple[int, int, bool]:
    """K1's chunks for ``N`` points a problem: ``(G, tiles a block, one
    launch)``. The points are cut into tiles of one point a thread of a
    block (``K1_TILE``, 256, up to ``K1_ONE_LAUNCH`` points; ``K1_WIDE_TILE``,
    512, beyond), the tiles into G chunks of ``tiles a block``, one block a
    chunk: chunk g holds tiles ``[g t, min(tiles, (g + 1) t))``. Up to
    ``K1_ONE_LAUNCH`` points the G <= 16 blocks are one thread block
    cluster (one launch: 1 x 16,384 is 16 blocks of 4 tiles, 1 x 4,096 16
    blocks of 1); beyond, chunks of 4 tiles and a second kernel. A function
    of N alone, so a problem sums in the same order in any batch."""
    if N <= K1_ONE_LAUNCH:
        tiles = -(-N // K1_TILE)
        per_block = max(1, -(-tiles // K1_MAX_CLUSTER))
        return max(1, -(-tiles // per_block)), per_block, True
    return -(-N // (K1_WIDE_TILE * K1_MAX_TILES)), K1_MAX_TILES, False


def k1_tile(N: int) -> int:
    """Points a tile (threads a block) of K1 at N points a problem."""
    return K1_TILE if N <= K1_ONE_LAUNCH else K1_WIDE_TILE


def unpack_k1(out: torch.Tensor):
    """K1's fresh ``[B, 45]`` rows -> views (A [B, 6, 6], b [B, 6], sum_w,
    sum_wr2, n_ok); no copy, no launch (``as_strided``: the cheapest view on
    the host)."""
    B, view = out.shape[0], out.as_strided
    return (view((B, 6, 6), (K1_OUT, 6, 1)), view((B, 6), (K1_OUT, 1), 36),
            view((B,), (K1_OUT,), 42), view((B,), (K1_OUT,), 43), view((B,), (K1_OUT,), 44))


_F32 = torch.float32


def _k1_args_ok(dev, reading, pair_xyz, pair_normals, valid, T, tau) -> bool:
    """One pass of cheap checks; the caller re-checks one by one to name
    what is wrong."""
    B, N = reading.shape[0], reading.shape[1]
    shape = reading.shape
    return (
        reading.dim() == 3 and shape[2] == 3 and pair_xyz.shape == shape
        and pair_normals.shape == shape and valid.shape == shape[:2] and T.shape == (B, 4, 4)
        and tau.shape == (B,)
        and reading.dtype is _F32 and pair_xyz.dtype is _F32 and pair_normals.dtype is _F32
        and T.dtype is _F32 and tau.dtype is _F32
        and (valid.dtype is torch.bool or valid.dtype is torch.uint8)
        and pair_xyz.device == dev and pair_normals.device == dev and valid.device == dev
        and T.device == dev and tau.device == dev
        and reading.is_contiguous() and pair_xyz.is_contiguous() and pair_normals.is_contiguous()
        and valid.is_contiguous() and T.is_contiguous() and tau.is_contiguous()
    )


def pair_gn(reading, pair_xyz, pair_normals, valid, T, tau, max_d2: float):
    """K1 on ``reading / pair_xyz / pair_normals [B, N, 3]`` float32,
    ``valid [B, N]`` bool or uint8, ``T [B, 4, 4]``, ``tau [B]`` float32 and
    a scalar ``max_d2`` -> ``(A [B, 6, 6], b [B, 6], sum_w [B], sum_wr2 [B],
    n_ok [B])`` (views of one ``[B, 45]`` tensor). CPU tensors take
    :func:`pair_gn_plain`; CUDA tensors launch the kernel (counted in
    ``pair_gn.launches``; ``pair_gn_fused``, and ``pair_gn_final`` beyond
    ``K1_ONE_LAUNCH`` points) or raise."""
    dev = reading.device
    if dev.type == "cpu":
        return pair_gn_plain(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)
    if dev.type != "cuda":
        raise ValueError(f"pair_gn: unsupported device {dev}")
    B, N = reading.shape[0], reading.shape[1]
    if not _k1_args_ok(dev, reading, pair_xyz, pair_normals, valid, T, tau):
        f32 = (_F32,)
        _build.check_tensor("reading", reading, (B, N, 3), f32, dev)
        _build.check_tensor("pair_xyz", pair_xyz, (B, N, 3), f32, dev)
        _build.check_tensor("pair_normals", pair_normals, (B, N, 3), f32, dev)
        _build.check_tensor("valid", valid, (B, N), (torch.bool, torch.uint8), dev)
        _build.check_tensor("T", T, (B, 4, 4), f32, dev)
        _build.check_tensor("tau", tau, (B,), f32, dev)
    G, per_block, one = k1_plan(N)
    # Beyond one cluster the chunks' rows go through scratch of this call
    # alone (inside a capture, from the graph's own pool).
    partial = None if one else torch.empty(B * G * 32, dtype=_F32, device=dev)
    out = torch.empty((B, K1_OUT), dtype=_F32, device=dev)
    lib = _build.load("pair_gn", _LAUNCH_ARGTYPES)
    args = (reading.data_ptr(), pair_xyz.data_ptr(), pair_normals.data_ptr(), valid.data_ptr(),
            T.data_ptr(), tau.data_ptr(), float(max_d2), B, N, G, per_block, int(one),
            0 if partial is None else partial.data_ptr(), out.data_ptr())
    if dev.index == torch.cuda.current_device():
        rc = lib.pair_gn_launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = lib.pair_gn_launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check_launch(lib, "pair_gn", rc)
    _build.count_launch(pair_gn)
    return unpack_k1(out)


pair_gn.launches = 0


def pair_gn_k_plain(reading, pair_xyz, pair_normals, valid, T, tau, max_d2: float):
    """Plain PyTorch K3: float32 terms, float64 sums, float32 result."""
    out = terms_k(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)
    return unpack(out.double().sum(1).float())


def pair_gn_k(reading, pair_xyz, pair_normals, valid, T, tau, max_d2: float):
    """K3 on ``reading [B, N, 3]``, ``pair_xyz / pair_normals [B, N, K, 3]``
    float32 (K <= 8), ``valid [B, N, K]`` bool or uint8, ``T [B, 4, 4]``,
    ``tau [B]`` float32 and a scalar ``max_d2`` -> the five outputs of
    :func:`pair_gn` summed over every point's K pairs. CPU tensors take
    :func:`pair_gn_k_plain`; CUDA tensors launch the kernel (counted in
    ``pair_gn_k.launches``) or raise."""
    dev = reading.device
    if dev.type == "cpu":
        return pair_gn_k_plain(reading, pair_xyz, pair_normals, valid, T, tau, max_d2)
    if dev.type != "cuda":
        raise ValueError(f"pair_gn_k: unsupported device {dev}")
    B, N = reading.shape[0], reading.shape[1]
    K = valid.shape[-1]
    if not 1 <= K <= 8:
        raise ValueError(f"pair_gn_k: K={K} pairs per point, expected 1..8")
    f32 = (torch.float32,)
    _build.check_tensor("reading", reading, (B, N, 3), f32, dev)
    _build.check_tensor("pair_xyz", pair_xyz, (B, N, K, 3), f32, dev)
    _build.check_tensor("pair_normals", pair_normals, (B, N, K, 3), f32, dev)
    _build.check_tensor("valid", valid, (B, N, K), (torch.bool, torch.uint8), dev)
    _build.check_tensor("T", T, (B, 4, 4), f32, dev)
    _build.check_tensor("tau", tau, (B,), f32, dev)
    nblocks = num_blocks(N)
    partial = torch.empty((B, nblocks, N_OUT), dtype=torch.float32, device=dev)
    out = torch.empty((B, N_OUT), dtype=torch.float32, device=dev)
    lib = _build.load("pair_gn_k", _LAUNCH_K_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pair_gn_k_launch(
            reading.data_ptr(), pair_xyz.data_ptr(), pair_normals.data_ptr(),
            valid.view(torch.uint8).data_ptr(), T.data_ptr(), tau.data_ptr(),
            float(max_d2), B, N, K, nblocks, partial.data_ptr(), out.data_ptr(), stream,
        )
    _build.check_launch(lib, "pair_gn_k", rc)
    _build.count_launch(pair_gn_k)
    return unpack(out)


pair_gn_k.launches = 0

"""Batched eigen-decomposition of small symmetric matrices that a CUDA graph
can hold.

No TPU kernel stands behind it: the JAX package calls ``jnp.linalg.eigh``
(the KKT pseudo-solve and the minimum-norm solves of
``open3d_slam_private_tpu/models/minimizers.py`` and ``localizability.py``,
and ``icp.py``'s spectral diagnostics). On the card
``torch.linalg.eigh`` reads its ``info`` back on the host, so a step that
calls it cannot be captured, and cuSOLVER's batched solver picks its method
from the whole batch. The CUDA kernel (``csrc/sym_eig.cu``) runs cyclic
Jacobi in round-robin order, one warp a matrix with A and V in registers
and n a template parameter, until a test of every pair finds nothing left
to rotate: no host read, no allocation, and an order of operations fixed by
the matrix alone. It is a latency chain (see the source note for its bytes
and operations); :func:`chain_probe` times one step's chain on the card.

:func:`sym_eig_plain` is ``torch.linalg.eigh`` one matrix a call (so a
matrix's bits do not depend on its batch there either). :func:`sym_eig`
runs the plain version for CPU tensors and the kernel for CUDA tensors, with
no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from open3d_slam_private_tpu_torch.kernels import _build

MAX_N = 16  # csrc/sym_eig.cu kMaxN
MAX_SWEEPS = 30  # kMaxSweeps

_P, _I = ctypes.c_void_p, ctypes.c_int
# sym_eig_launch(A, w, V, sweeps, B, n, is_double, stream)
_LAUNCH_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _P]
# sym_eig_probe_launch(is_double, mode, iters, out, stream)
_PROBE_ARGTYPES = [_I, _I, _I, _P, _P]


def sym_eig_plain(A: torch.Tensor):
    """``torch.linalg.eigh`` of ``[..., n, n]``, one matrix a call."""
    n = A.shape[-1]
    flat = A.reshape(-1, n, n)
    if flat.shape[0] == 0:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(flat[i:i + 1]) for i in range(flat.shape[0])]
    w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    return w, torch.cat([p[1] for p in parts]).reshape(A.shape)


def sym_eig(A: torch.Tensor, sweeps: bool = False):
    """Symmetric ``A [..., n, n]`` (float32 or float64, n <= 16) ->
    ``(w [..., n] ascending, V [..., n, n] with the eigenvectors as
    columns)``, as ``torch.linalg.eigh``. CPU tensors take
    :func:`sym_eig_plain`; CUDA tensors launch the kernel (counted in
    ``sym_eig.launches``) or raise. ``sweeps=True`` (CUDA only) also
    returns the Jacobi sweeps each matrix took, ``[...]`` int32."""
    dev = A.device
    if dev.type == "cpu":
        if sweeps:
            raise ValueError("sym_eig: sweeps are counted by the CUDA kernel only")
        return sym_eig_plain(A)
    if dev.type != "cuda":
        raise ValueError(f"sym_eig: unsupported device {dev}")
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"sym_eig: shape {tuple(A.shape)}, expected [..., n, n] with n <= {MAX_N}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eig: dtype {A.dtype}, expected float32 or float64")
    lead = A.shape[:-2]
    flat = A.reshape(-1, n, n).contiguous()
    B = flat.shape[0]
    w = torch.empty((B, n), dtype=A.dtype, device=dev)
    V = torch.empty((B, n, n), dtype=A.dtype, device=dev)
    count = torch.empty(B if sweeps else 0, dtype=torch.int32, device=dev)
    if B:
        lib = _build.load("sym_eig", _LAUNCH_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.sym_eig_launch(flat.data_ptr(), w.data_ptr(), V.data_ptr(),
                                    count.data_ptr() if sweeps else None, B, n,
                                    int(A.dtype == torch.float64),
                                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(lib, "sym_eig", rc)
        _build.count_launch(sym_eig)
    out = (w.reshape(lead + (n,)), V.reshape(A.shape))
    return out + (count.reshape(lead),) if sweeps else out


sym_eig.launches = 0


def chain_probe(device, dtype=torch.float64, iters: int = 20000):
    """The kernel's floor, timed on the card by ``sym_eig_chain_probe``
    (one warp): ``iters`` rotation steps' dependent chains alone (the
    block's shuffle, the rotation, the broadcast of (c, s), the update's
    FMAs), then ``iters`` stop tests' (a diagonal's shuffle, the test, the
    vote). Returns ``{"step": {...}, "test": {...}}``, each with cycles
    (``clock64``) and ns (the global timer) per iteration. Not a launch of
    the path: ``sym_eig.launches`` does not count it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"chain_probe: needs a CUDA device, got {device}")
    lib = _build.load("sym_eig", _LAUNCH_ARGTYPES)
    fn = lib.sym_eig_probe_launch
    fn.argtypes, fn.restype = _PROBE_ARGTYPES, ctypes.c_int
    out = {}
    with torch.cuda.device(device):
        for mode, name in ((0, "step"), (1, "test")):
            buf = torch.zeros(3, dtype=torch.int64, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(2):  # the first launch warms the module up
                rc = fn(int(dtype == torch.float64), mode, iters, buf.data_ptr(), stream)
                _build.check_launch(lib, "sym_eig", rc)
            cycles, ns, _ = buf.tolist()
            out[name] = dict(cycles=cycles / iters, ns=ns / iters, iters=iters)
    return out

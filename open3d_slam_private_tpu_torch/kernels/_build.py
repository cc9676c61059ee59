"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so csrc/<name>.cu

then loaded with ``ctypes``. ``<hash>`` covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header is never
served by a stale library. The build directory
sits at the repository root and is git-ignored. A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc``
    on ``PATH``; raises RuntimeError when neither exists."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels of "
        "open3d_slam_private_tpu_torch cannot be built"
    )


def build(name: str, src=None) -> Path:
    """Compile ``csrc/<name>.cu`` (or the source ``src``) if not already
    built -> library path."""
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str, launch_argtypes, src=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of ``src``), built on
    first use, with
    ``<name>_launch(*launch_argtypes) -> int`` and
    ``<name>_error_string(int) -> char*`` typed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, src)))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = launch_argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}: {msg}")


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` for a kernel launched now. A call made
    while the stream captures a CUDA graph records a node and launches
    nothing, so it is not counted: a graph's launches are its replays',
    read from the profiler's device events."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        fn.launches += 1


def no_capture(what: str) -> None:
    """Raise if the current stream is capturing a CUDA graph: called before
    a kernel's per-device scratch grows. A graph holds the scratch by
    address, so it must have its final size before the capture (the
    capture's eager warm-up run sizes it) and never be reallocated while a
    graph holds it."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what}: the per-device scratch would grow inside a CUDA graph capture; run the "
            "same call once before capturing"
        )


def check_tensor(name, t, shape, dtypes, device) -> None:
    """Raise ValueError unless ``t`` is on ``device``, of one of ``dtypes``,
    of ``shape`` and contiguous (what a kernel's raw pointer assumes)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

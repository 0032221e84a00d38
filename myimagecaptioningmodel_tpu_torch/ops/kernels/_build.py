"""Build and load the CUDA kernels of ``csrc/`` at first use.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The library
lands in the package's ``build/`` directory under a name keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one is
reused. A machine with a CUDA device but no ``nvcc`` is an error: there is no
fallback to the plain versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# dtype codes of csrc/common.cuh (int8 only for vocab tables)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run, None if the library was reused
ptxas_log = ""

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "capk_vocab_argmax_nblocks": [_I],
    "capk_vocab_argmax": [_I, _I, _I, _I] + [_VP] * 8,
    "capk_topk_head": [_I] * 5 + [_VP] * 12,
    "capk_fused_step": [_I] * 5 + [_VP] * 22,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        f"{CSRC_DIR} cannot be built"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcapk_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    global build_seconds, ptxas_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    ptxas_log = proc.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dt: torch.dtype) -> int:
    if dt not in DTYPE_CODES:
        raise TypeError(f"kernels take float32, bfloat16 or int8, got {dt}")
    return DTYPE_CODES[dt]


def require(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    """Validate a kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

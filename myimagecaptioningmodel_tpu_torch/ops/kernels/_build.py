"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# dtype codes of csrc/common.cuh (int8: vocab tables; kernels D and E take
# int8 layer weights and memory through their own flags)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run, None if the library was reused
ptxas_log = ""

_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PI, _PVP = ctypes.POINTER(_I), ctypes.POINTER(_VP)
_SIGNATURES = {
    "capk_vocab_argmax_nblocks": [_I],
    "capk_vocab_argmax_vocab_tile": [_I],
    "capk_vocab_argmax": [_I, _I, _I, _I] + [_VP] * 9,
    "capk_topk_head_vocab_tile": [],
    "capk_topk_head": [_I] * 5 + [_VP] * 13,
    "capk_fused_step": [_PI, _PVP, _VP],
    "capk_lstm_greedy_decode": [_PI, _PVP, _VP, _PI],
    "capk_lstm_product": [_PI, _PVP, _VP],
    "capk_lstm_product_splits": [_I] * 4,
    "capk_matmul_stats_row_tile": [],
    "capk_matmul_stats_partial_rows": [_I] * 4,
    "capk_matmul_stats": [_I] * 4 + [_VP] * 5 + [_I] + [_VP] * 3,
    "capk_fused_greedy_decode": [_PI, _PVP, _VP, _PI],
    "capk_fused_beam_decode": [_PI, _PVP, _VP, _PI],
    "capk_stream_product": [_PI, _PVP, _VP],
    "capk_stream_product_splits": [_I, _I, _I],
    "capk_tile_stats": [_VP, _I, _I, _VP, _VP],
    "capk_fused_irb_splits": [_PI],
    "capk_fused_irb": [_PI, _PVP, _VP],
    "capk_attn_scores": [_I] * 5 + [_VP] * 6,
    "capk_attn_scores_bwd": [_I] * 5 + [_VP] * 4 + [_I, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _VP],
    "capk_attn_scores_bwd_scratch_rows": [_I, _I, _I],
    "capk_attn_tanh_bf16": [_VP, _VP, _I, _VP],
    "capk_bn_partial_rows": [_I] * 4,
    "capk_bn_stats": [_I] * 5 + [_VP, _VP, _I, _VP, _VP, _VP],
    "capk_bn_apply": [_I] * 4 + [_VP] * 3 + [_D, _VP, _VP, _I] + [_VP] * 4,
    "capk_bn_grad_sums": [_I] * 4 + [_VP] * 6 + [_I, _D, _VP, _I, _VP, _VP, _VP],
    "capk_bn_dx": [_I] * 4 + [_VP] * 8 + [_D, _I, _I, _VP, _VP],
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


def _run(procs, what: str) -> str:
    """Wait for every process; raise with the failures' output."""
    logs, failed = [], []
    for name, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError(f"nvcc failed to {what}:\n" + "\n".join(failed))
    return "".join(logs)


def _compile(target: Path) -> None:
    global build_seconds, ptxas_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):  # one nvcc per source, in parallel
            obj = os.path.join(work, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        log = _run(procs, "compile")
        tmp = os.path.join(work, "lib.so")
        link = subprocess.Popen([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _run([("link", link)], "link")
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    ptxas_log = log


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

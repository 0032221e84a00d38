"""The native (C++) batch converter of the input pipeline, loaded with ctypes;
port of ``myimagecaptioningmodel_tpu/native``.

``feeder.cpp`` (a copy of the JAX package's) turns float16/float32/uint8 CHW
shard rows into float32 NHWC batches in threads. It is compiled with ``g++``
at first use into the package's ``build/native/`` directory, under a name
keyed by a hash of the source and flags (``.gitignore`` lists ``build/``).
A converter that was asked for and cannot be built or loaded raises: no
call gives way to numpy quietly. The numpy version of each conversion stays
beside it as its plain version (``*_plain``), which the tests hold it
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "feeder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join([CXX] + CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfeeder-{key[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The converter library, built at first use; raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
            try:
                out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"building the native converter failed: {e}") from e
            if out.returncode != 0:
                raise RuntimeError(f"building the native converter failed ({' '.join(cmd)}):\n"
                                   f"{out.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        conv = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
        lib.convert_f16chw_to_f32nhwc.argtypes = conv
        lib.convert_f32chw_to_f32nhwc.argtypes = conv
        lib.convert_u8chw_to_f32nhwc.argtypes = conv + [ctypes.c_void_p] * 2
        for fn in (lib.convert_f16chw_to_f32nhwc, lib.convert_f32chw_to_f32nhwc,
                   lib.convert_u8chw_to_f32nhwc):
            fn.restype = None
        _lib = lib
        return lib


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else min(os.cpu_count() or 1, 8)


def convert_chw_to_nhwc_f32(batch: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """[N,C,H,W] float16/float32 -> [N,H,W,C] float32 in native threads."""
    if batch.ndim != 4:
        raise ValueError(f"rows [N, C, H, W] expected, got shape {batch.shape}")
    fns = {np.dtype(np.float16): "convert_f16chw_to_f32nhwc",
           np.dtype(np.float32): "convert_f32chw_to_f32nhwc"}
    if batch.dtype not in fns:
        raise TypeError(f"the native converter takes float16 or float32 rows, not {batch.dtype}")
    n, c, h, w = batch.shape
    src = np.ascontiguousarray(batch)
    dst = np.empty((n, h, w, c), np.float32)
    getattr(get_lib(), fns[batch.dtype])(
        src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        n, c, h, w, _threads(nthreads))
    return dst


def convert_u8chw_to_f32nhwc(batch: np.ndarray, mean, std, nthreads: int = 0) -> np.ndarray:
    """Raw uint8 [N,C,H,W] shard rows -> normalized float32 [N,H,W,C]: the
    /255 and per-channel mean/std fused into the transpose pass through
    per-channel tables."""
    if batch.ndim != 4 or batch.dtype != np.uint8:
        raise ValueError(f"uint8 rows [N, C, H, W] expected, got {batch.dtype} {batch.shape}")
    n, c, h, w = batch.shape
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = np.ascontiguousarray(1.0 / (255.0 * std), np.float32)
    bias = np.ascontiguousarray(-mean / std, np.float32)
    src = np.ascontiguousarray(batch)
    dst = np.empty((n, h, w, c), np.float32)
    get_lib().convert_u8chw_to_f32nhwc(
        src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        n, c, h, w, _threads(nthreads),
        scale.ctypes.data_as(ctypes.c_void_p), bias.ctypes.data_as(ctypes.c_void_p))
    return dst


def convert_chw_to_nhwc_f32_plain(batch: np.ndarray) -> np.ndarray:
    """numpy version of ``convert_chw_to_nhwc_f32``."""
    return np.ascontiguousarray(batch.astype(np.float32).transpose(0, 2, 3, 1))


def convert_u8chw_to_f32nhwc_plain(batch: np.ndarray, mean, std) -> np.ndarray:
    """numpy version of ``convert_u8chw_to_f32nhwc`` (``normalize_uint8_chw``
    then the transpose)."""
    from myimagecaptioningmodel_tpu_torch.data.image import normalize_uint8_chw

    return np.ascontiguousarray(normalize_uint8_chw(batch, mean, std).transpose(0, 2, 3, 1))

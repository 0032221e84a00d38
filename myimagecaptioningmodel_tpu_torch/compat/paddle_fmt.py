"""PaddlePaddle 1.x LoDTensor persistables file format, stand-alone; the
port's own copy of ``myimagecaptioningmodel_tpu/compat/paddle_fmt.py``
(numpy and ``struct`` only), so that the port imports nothing of the JAX
package.

The reference checkpoints with ``fluid.io.save_persistables`` (reference
train.py:73), which writes ONE binary file per variable, named after the
variable, serialized by Paddle's ``SerializeToStream``:

    uint32   LoDTensor version (0)
    uint64   lod_level
    per level: uint64 byte-size, then that many bytes of size_t offsets
    uint32   Tensor version (0)
    int32    N = byte-size of a VarType.TensorDesc protobuf
    N bytes  TensorDesc { required Type data_type = 1; repeated int64 dims = 2; }
    raw      numel * itemsize bytes of row-major data

Parameters are plain (lod_level == 0) tensors. The TensorDesc proto is tiny,
so it is parsed/emitted by hand here — no protobuf or paddle dependency.
The writer exists so tests (and users without the original tooling) can
fabricate persistables directories; the reader is the import path.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# VarType.Type enum values (paddle framework.proto)
_DTYPES: Dict[int, np.dtype] = {
    0: np.dtype(np.bool_),
    1: np.dtype(np.int16),
    2: np.dtype(np.int32),
    3: np.dtype(np.int64),
    4: np.dtype(np.float16),
    5: np.dtype(np.float32),
    6: np.dtype(np.float64),
    20: np.dtype(np.uint8),
    21: np.dtype(np.int8),
}
_CODES = {v: k for k, v in _DTYPES.items()}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_tensor_desc(buf: bytes) -> Tuple[int, List[int]]:
    """-> (data_type code, dims). Handles packed and unpacked dims."""
    pos = 0
    data_type = 5
    dims: List[int] = []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if field == 1 and wire == 0:  # data_type
            data_type, pos = _read_varint(buf, pos)
        elif field == 2 and wire == 0:  # one dim (proto2 unpacked)
            d, pos = _read_varint(buf, pos)
            dims.append(d)
        elif field == 2 and wire == 2:  # packed dims
            size, pos = _read_varint(buf, pos)
            end = pos + size
            while pos < end:
                d, pos = _read_varint(buf, pos)
                dims.append(d)
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            pos += size
        else:
            raise ValueError(f"unsupported wire type {wire} in TensorDesc")
    return data_type, dims


def _emit_tensor_desc(code: int, dims: Tuple[int, ...]) -> bytes:
    out = bytearray()
    out += b"\x08" + _write_varint(code)  # field 1, varint
    for d in dims:  # field 2, unpacked varints (paddle's proto2 layout)
        out += b"\x10" + _write_varint(int(d))
    return bytes(out)


def read_lod_tensor(path: str) -> np.ndarray:
    """Load one persistables file -> numpy array (row-major, native shape)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def u32() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<I", data, pos)
        pos += 4
        return v

    def u64() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        return v

    version = u32()
    if version != 0:
        raise ValueError(f"{path}: unsupported LoDTensor version {version}")
    lod_level = u64()
    for _ in range(lod_level):  # parameters have no LoD; skip if present
        nbytes = u64()
        pos += nbytes
    tversion = u32()
    if tversion != 0:
        raise ValueError(f"{path}: unsupported Tensor version {tversion}")
    desc_size = u32()
    code, dims = _parse_tensor_desc(data[pos : pos + desc_size])
    pos += desc_size
    if code not in _DTYPES:
        raise ValueError(f"{path}: unsupported data_type code {code}")
    dtype = _DTYPES[code]
    numel = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(data, dtype, count=numel, offset=pos)
    return arr.reshape(dims).copy()


def write_lod_tensor(path: str, arr: np.ndarray) -> None:
    """Write one array as a Paddle persistables file (lod_level 0)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _CODES:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    desc = _emit_tensor_desc(_CODES[arr.dtype], arr.shape)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 0))  # LoDTensor version
        f.write(struct.pack("<Q", 0))  # lod_level
        f.write(struct.pack("<I", 0))  # Tensor version
        f.write(struct.pack("<I", len(desc)))
        f.write(desc)
        f.write(arr.tobytes())


def read_persistables_dir(
    dirname: str, skipped: "list | None" = None
) -> Dict[str, np.ndarray]:
    """Load every parseable LoDTensor file in a ``save_persistables`` dir.

    Files that are not LoDTensors — a ``__model__`` program desc from
    ``save_inference_model``, stray metadata — are skipped (collected into
    ``skipped`` when given) rather than aborting the whole import."""
    out: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(dirname)):
        path = os.path.join(dirname, name)
        if not os.path.isfile(path):
            continue
        if name == "__model__":  # program desc, never a tensor
            if skipped is not None:
                skipped.append(name)
            continue
        try:
            out[name] = read_lod_tensor(path)
        except (ValueError, struct.error, IndexError):
            if skipped is not None:
                skipped.append(name)
    return out


def write_persistables_dir(dirname: str, tensors: Dict[str, np.ndarray]) -> None:
    os.makedirs(dirname, exist_ok=True)
    for name, arr in tensors.items():
        write_lod_tensor(os.path.join(dirname, name), arr)

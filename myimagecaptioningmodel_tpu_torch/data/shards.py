"""Image shard storage the card can read; the counterpart of
``myimagecaptioningmodel_tpu/data/hdf5.py``.

The JAX package stores rows in HDF5 files (gzip by default); the machine
the port trains on has no h5py. A port shard set is plain ``.npy`` files:

- shards named ``{name}.npy`` (single) or ``{name}_{K}.npy`` (K = 0, 1,
  ...), each an array ``[n, 3, H, W]`` of float16 (normalized rows, the
  reference contract), float32 or uint8 (raw resized pixels, normalized at
  feed time), at most ``max_size`` rows each, opened with
  ``np.load(mmap_mode="r")``: a batch is one gather from the page cache, and
  no thread pool or decompression stands between the disk and the feeder;
- ``{name}.json`` beside them: what the HDF5 dataset attrs hold
  (``storage_dtype``, ``normalized``, ``image_mean``, ``image_std``) plus
  ``codec: "none"``;
- ``name2idx.json`` mapping image filename -> global row index (found at
  ``cfg.data.h5_name2idx``, the shards under ``cfg.data.h5_path``: the
  config's names are kept, no field is added).

Trade-off: rows are stored uncompressed. At AI_Challenger's scale, 210k
images of 3x224x224, that is about 63 GB in float16 and 32 GB in uint8,
against the gzip HDF5 set's smaller files; ``storage_dtype="uint8"`` is the
compact choice (and ships a quarter of float32's bytes to the card with
``train.device_convert``).

``gen_shards`` decodes JPEGs with PIL (so it runs where PIL is installed);
``ShardBuilder`` takes numpy rows, so a corpus can be written without PIL;
``convert_jax_shards`` turns a JAX HDF5 shard set into port shards (h5py
imported inside).
"""

from __future__ import annotations

import json
import os
import re
import struct
import time
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SHARD = re.compile(r"^(.*?)_([0-9]+)\.npy$")
_HEADER_BYTES = 128  # fixed .npy header: rewritten in place with the final row count
STORAGE_DTYPES = ("float16", "float32", "uint8")


def _npy_header(shape: Sequence[int], dtype) -> bytes:
    """A version 1.0 ``.npy`` header padded to ``_HEADER_BYTES``."""
    d = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)), "fortran_order": False,
         "shape": tuple(int(s) for s in shape)}
    body = repr(d).encode("latin1")
    n = _HEADER_BYTES - 10
    if len(body) + 1 > n:
        raise ValueError(f"shape {shape} does not fit a {_HEADER_BYTES}-byte header")
    return b"\x93NUMPY\x01\x00" + struct.pack("<H", n) + body + b" " * (n - len(body) - 1) + b"\n"


def _shard_files(dirpath: str) -> Tuple[List[str], set]:
    """-> (shard file names in index order, their indices) of one directory,
    which must hold one shard family."""
    files = os.listdir(dirpath)
    matched = [n for n in files if _SHARD.match(n)]
    if not matched:
        matched = [n for n in files if n.endswith(".npy")
                   and os.path.exists(os.path.join(dirpath, n[:-4] + ".json"))]
        if len(matched) > 1:
            raise ValueError(f"multiple datasets found under {dirpath}")
        if not matched:
            raise FileNotFoundError(f"no .npy shards found under {dirpath}")
        return matched, set()
    bases = {_SHARD.match(n).group(1) for n in matched}
    if len(bases) > 1:
        raise ValueError(f"multiple datasets found under {dirpath}")
    matched.sort(key=lambda n: int(_SHARD.match(n).group(2)))
    return matched, {int(_SHARD.match(n).group(2)) for n in matched}


def _meta_path(shard_path: str) -> str:
    d, n = os.path.split(shard_path)
    m = _SHARD.match(n)
    return os.path.join(d, (m.group(1) if m else n[:-4]) + ".json")


class ShardManager:
    """Random-access reader over the shards of one or more directories."""

    def __init__(self) -> None:
        self._rows: List[np.ndarray] = []  # memory-mapped [n, 3, H, W] per shard
        self._cum_lens: List[int] = []
        self._meta: Dict[str, object] = {}
        self._name2idx: Optional[Dict[str, int]] = None

    def load_name2idx(self, file_path: str) -> None:
        with open(file_path, "r", encoding="utf-8") as f:
            self._name2idx = json.load(f)

    def load_database(self, db_path) -> None:
        """Map every shard under one or more directories: directories in the
        given order, shards by index within each (as ``Hdf5Manager`` orders
        them, which warns where two directories' indices overlap: the
        reference interleaves such sets by global index)."""
        self.close()
        paths = [db_path] if isinstance(db_path, str) else list(db_path)
        shards, indices_by_dir = [], []
        for dirpath in paths:
            names, indices = _shard_files(dirpath)
            shards.extend(os.path.join(dirpath, n) for n in names)
            indices_by_dir.append(indices)
        if any(a & b for i, a in enumerate(indices_by_dir) for b in indices_by_dir[i + 1:]):
            warnings.warn(
                "multiple directories contain overlapping shard indices; row order "
                "here is per-directory, but the reference interleaves by global "
                "index — a legacy name2idx built by the reference may map names to "
                "wrong rows", stacklevel=2)
        total = 0
        for path in shards:
            rows = np.load(path, mmap_mode="r")
            self._rows.append(rows)
            total += rows.shape[0]
            self._cum_lens.append(total)
        with open(_meta_path(shards[0]), "r", encoding="utf-8") as f:
            self._meta = json.load(f)

    def __len__(self) -> int:
        return self._cum_lens[-1] if self._cum_lens else 0

    def _locate(self, index: int) -> Tuple[int, int]:
        prev = 0
        for i, cum in enumerate(self._cum_lens):
            if 0 <= index < cum:
                return i, index - prev
            prev = cum
        raise IndexError(index)

    def read_index(self, index: int) -> np.ndarray:
        """One row by global index (a copy)."""
        shard, row = self._locate(index)
        return np.array(self._rows[shard][row])

    def read(self, name: str) -> np.ndarray:
        """One row by filename via name2idx."""
        assert self._name2idx is not None, "call load_name2idx first"
        return self.read_index(self._name2idx[name])

    def read_batch_idx(self, indices: Sequence[int]) -> np.ndarray:
        """Rows by global index -> one stacked array: one gather per shard."""
        first = self._rows[0]
        out = np.empty((len(indices),) + first.shape[1:], first.dtype)
        where = np.array([self._locate(int(i)) for i in indices], np.int64).reshape(-1, 2)
        for shard in np.unique(where[:, 0]):
            pos = np.nonzero(where[:, 0] == shard)[0]
            out[pos] = self._rows[shard][where[pos, 1]]
        return out

    def read_batch(self, names: Sequence[str]) -> np.ndarray:
        assert self._name2idx is not None, "call load_name2idx first"
        return self.read_batch_idx([self._name2idx[n] for n in names])

    @property
    def storage_info(self) -> Dict[str, object]:
        """dtype/codec + the build's provenance: the keys and values of
        ``Hdf5Manager.storage_info``."""
        if not self._rows:
            return {}
        info: Dict[str, object] = {"dtype": str(self._rows[0].dtype), "codec": "none"}
        info.update({k: v for k, v in self._meta.items() if k != "codec"})
        return info

    def close(self) -> None:
        self._rows.clear()
        self._cum_lens.clear()
        self._meta = {}


class ShardBuilder:
    """Context-manager shard writer from numpy rows (the counterpart of
    ``DbBuilder``): at most ``max_size`` rows a shard, each file's header
    rewritten on close with the rows actually appended."""

    def __init__(self, output_path: str, name: str, shape: Sequence[int], max_size: int,
                 db_length: int, dtype: str = "float16",
                 attrs: Optional[Dict[str, object]] = None) -> None:
        if str(np.dtype(dtype)) not in STORAGE_DTYPES:
            raise ValueError(f"unknown storage dtype {dtype!r} ({'|'.join(STORAGE_DTYPES)})")
        self.output_path, self.name = output_path, name
        self.shape, self.dtype = tuple(int(s) for s in shape), np.dtype(dtype)
        self.max_length, self.db_length = int(max_size), int(db_length)
        self.attrs = {"codec": "none", **{k: _jsonable(v) for k, v in (attrs or {}).items()}}
        self.file_index = 0
        self.ptr_index = 0
        self._file = None

    def __enter__(self) -> "ShardBuilder":
        os.makedirs(self.output_path, exist_ok=True)
        with open(os.path.join(self.output_path, self.name + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.attrs, f)
        self._open_next()
        return self

    def _open_next(self) -> None:
        self._close_file()
        if self.max_length >= self.db_length:
            fname = self.name + ".npy"
        else:
            fname = f"{self.name}_{self.file_index}.npy"
            self.file_index += 1
        self._file = open(os.path.join(self.output_path, fname), "wb")
        self._file.write(_npy_header((0, *self.shape), self.dtype))
        self.ptr_index = 0

    def _close_file(self) -> None:
        if self._file is not None:
            self._file.seek(0)
            self._file.write(_npy_header((self.ptr_index, *self.shape), self.dtype))
            self._file.close()
            self._file = None

    def append(self, data: np.ndarray) -> None:
        self.append_rows(np.asarray(data)[None])

    def append_rows(self, rows: np.ndarray) -> None:
        """Rows [n, *shape], split across shards as needed."""
        if tuple(np.shape(rows)[1:]) != self.shape:
            raise ValueError(f"rows of shape {np.shape(rows)[1:]}, expected {self.shape}")
        rows = np.ascontiguousarray(rows, self.dtype)
        i = 0
        while i < len(rows):
            if self.ptr_index >= self.max_length:
                self._open_next()
            n = min(len(rows) - i, self.max_length - self.ptr_index)
            self._file.write(rows[i:i + n].tobytes())
            self.ptr_index += n
            i += n

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self._close_file()


def _jsonable(v):
    return v.tolist() if hasattr(v, "tolist") else v


def storage_attrs(storage_dtype: str, mean, std) -> Dict[str, object]:
    """The provenance ``gen_hdf5`` stamps, as ``storage_info`` reads it back
    (mean/std rounded to float32, as the HDF5 attrs store them)."""
    return {"storage_dtype": storage_dtype, "normalized": storage_dtype != "uint8",
            "image_mean": np.asarray(mean, np.float32).tolist(),
            "image_std": np.asarray(std, np.float32).tolist()}


def _decode_one(args) -> Optional[np.ndarray]:
    """Worker: decode one image to the storage dtype (``hdf5._decode_one``)."""
    from myimagecaptioningmodel_tpu_torch.data import image as image_mod

    path, shape, mean, std, storage_dtype = args
    try:
        img = image_mod.read_image(path)
        if storage_dtype == "uint8":
            return image_mod.resize_chw_uint8(img, shape)
        feat = image_mod.process_image(img, shape, mean, std)
    except Exception:
        return None
    if feat is None:
        return None
    return feat.astype(np.float16) if storage_dtype == "float16" else feat


def gen_shards(cfg=None, progress_every: int = 10000) -> Dict[str, object]:
    """Offline ingest: scan image dirs -> decode/normalize -> port shards and
    ``name2idx.json`` (``gen_hdf5``'s rows, order, skips and summary; the
    codec is always "none"). Decodes with PIL, in ``build_dataset.num_workers``
    processes when > 0."""
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    bd, dc = cfg.build_dataset, cfg.data
    begin = time.time()
    images: List[Tuple[str, str]] = []
    for image_path in bd.image_paths:
        names = sorted(n for n in os.listdir(image_path) if n.endswith(".jpg"))
        images.extend((n, os.path.join(image_path, n)) for n in names)
    shape = tuple(dc.image_shape)
    storage_dtype = getattr(bd, "storage_dtype", "float16")
    if storage_dtype not in STORAGE_DTYPES:
        raise ValueError(f"unknown storage_dtype {storage_dtype!r}")
    work = [(p, shape, dc.image_mean, dc.image_std, storage_dtype) for _n, p in images]
    builder = ShardBuilder(bd.output_path, "aic_flk", (3, *shape), bd.shard_max_size,
                           len(images), storage_dtype,
                           storage_attrs(storage_dtype, dc.image_mean, dc.image_std))

    def results() -> Iterable[Optional[np.ndarray]]:
        if bd.num_workers and bd.num_workers > 0:
            import multiprocessing as mp

            with mp.Pool(bd.num_workers) as pool:
                yield from pool.imap(_decode_one, work, chunksize=64)
        else:
            yield from map(_decode_one, work)

    name2idx: Dict[str, int] = {}
    skipped: List[str] = []
    with builder:
        for idx, ((name, _path), feat) in enumerate(zip(images, results())):
            if feat is None:
                skipped.append(name)
                continue
            name2idx[name] = len(name2idx)
            builder.append(feat)
            if progress_every and idx % progress_every == 0:
                print(f"gen_shards {idx}/{len(images)}")
    with open(os.path.join(bd.output_path, "name2idx.json"), "w") as f:
        json.dump(name2idx, f)
    elapsed = time.time() - begin
    return {"images": len(name2idx), "skipped": skipped, "seconds": elapsed,
            "images_per_sec": len(name2idx) / elapsed if elapsed > 0 else float("inf"),
            "storage_dtype": storage_dtype, "codec": "none"}


def convert_jax_shards(src_dirs, dst_dir: str) -> Dict[str, object]:
    """A JAX HDF5 shard set (``src_dirs``: one directory or several, read in
    ``Hdf5Manager``'s order) -> port shards in ``dst_dir`` with the same
    global row order, as many rows a shard as the source's largest, the
    same provenance attrs, and the source's ``name2idx.json`` copied beside
    them. Imports h5py: it runs where the JAX package's data tools do. ->
    {"rows", "shards"}."""
    import shutil

    import h5py

    dirs = [src_dirs] if isinstance(src_dirs, str) else list(src_dirs)
    files = []
    for d in dirs:
        names = [n for n in os.listdir(d) if re.match(r".*?\.hdf5_[0-9]+$", n)]
        if not names:
            names = [n for n in os.listdir(d) if n.endswith(".hdf5")]
        names.sort(key=lambda n: int((re.findall(r"\.hdf5_([0-9]+)$", n) or [-1])[0]))
        files.extend(os.path.join(d, n) for n in names)
    if not files:
        raise FileNotFoundError(f"no HDF5 shards under {dirs}")
    with h5py.File(files[0], "r") as f:
        d0 = f["data"]
        shape, dtype = d0.shape[1:], str(d0.dtype)
        attrs = {k: _jsonable(v) for k, v in d0.attrs.items()}
    lengths = []
    for path in files:
        with h5py.File(path, "r") as f:
            lengths.append(f["data"].shape[0])
    total = sum(lengths)
    builder = ShardBuilder(dst_dir, "aic_flk", shape, max(lengths), total, dtype, attrs)
    with builder:
        for path in files:
            with h5py.File(path, "r") as f:
                d = f["data"]
                for lo in range(0, d.shape[0], 256):
                    builder.append_rows(d[lo:lo + 256])
    for d in dirs:
        src = os.path.join(d, "name2idx.json")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(dst_dir, "name2idx.json"))
            break
    return {"rows": total, "shards": max(1, builder.file_index)}

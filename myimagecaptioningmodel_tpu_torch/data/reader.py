"""Online data readers matching reference reader.py:31-94; the counterpart of
``myimagecaptioningmodel_tpu/data/reader.py``, over port shards
(``data/shards.py``) instead of HDF5.

``DataReader.get_reader(batch_size, mode)`` returns a generator factory:
- mode='train': yields lists of ``(image CHW float32, caption int64[max_len])``
  samples, batched to ``batch_size`` (final partial batch flows through,
  like ``fluid.io.batch`` — SURVEY §2.2 quirk 6);
- mode='dev'/'test': yields lists of ``(image, [reference word lists])``.

With ``reader_threads > 0`` each batch is one gather from the memory-mapped
rows and comes pre-stacked as ``(imgs, caps)`` / ``(imgs, [refs...])``: the
same rows, captions and order as the serial stream. No thread pool is
needed for that (the JAX package's ``ParallelHdf5Reader`` inflates gzip
chunks in one; port shards are uncompressed), so the count of threads is
not used beyond switching the batch gather on.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from myimagecaptioningmodel_tpu_torch.data.shards import ShardManager

Sample = Tuple[np.ndarray, object]


def batched(reader: Callable[[], Iterator], batch_size: int) -> Callable[[], Iterator]:
    """Group a sample stream into lists of ``batch_size`` (keep the remainder)."""

    def gen():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

    return gen


def process_slice_batches(items, local_batch: int, index: int, count: int) -> list:
    """Multi-process feed sharding: the rows of every *global* batch
    (``local_batch * count`` samples) owned by process ``index``,
    concatenated in global-batch order; trailing partial global batches are
    dropped. Slicing each global batch (rather than block-splitting the
    epoch) keeps the global sample -> step assignment of a single-process
    run, so per-step losses match it."""
    gb = local_batch * count
    out = []
    for i in range(0, len(items) - gb + 1, gb):
        start = i + index * local_batch
        out.extend(items[start : start + local_batch])
    return out


def as_image_batch(batch) -> Tuple[np.ndarray, list]:
    """Normalize an eval reader item -> (imgs [B,C,H,W], refs list): the
    serial sample-list form (``[(img, refs), ...]``) and the pre-stacked
    tuple form of ``reader_threads > 0``."""
    if isinstance(batch, tuple):
        imgs, refs = batch
        return imgs, list(refs)
    imgs, refs = zip(*batch)
    return np.stack(imgs), list(refs)


def decode_and_score(reader_gen: Callable[[], Iterator], batch_size: int,
                     decode: Callable[[np.ndarray], object],
                     score: Callable[[np.ndarray, list, int], None],
                     shard: Optional[Tuple[int, int]] = None) -> int:
    """Decode every eval batch of ``reader_gen`` and score it -> batches.

    The final partial batch is padded with zero images to ``batch_size``, so
    one decode shape (one captured CUDA graph) serves every batch; ``score``
    gets the real rows only, as host ids ``[n, T]``, with their refs and
    ``n``, the batch's real rows. Software-pipelined: batch i+1's decode is
    queued on the card before the host scores batch i.

    ``shard=(index, count)`` (multi-process evaluation): every process reads
    the same global batches; ``decode`` gets this process's
    ``batch_size / count`` rows of the padded batch, and ``score`` the real
    rows among them (none, for a process whose rows are all padding) with
    their refs, and ``n`` of the whole batch."""
    lo, lb = 0, batch_size
    if shard is not None:
        index, count = shard
        if batch_size % count:
            raise ValueError(f"batch_size {batch_size} does not divide over {count} processes")
        lb = batch_size // count
        lo = index * lb
    scored = []

    def score_host(ids_dev, refs, n):
        valid = min(max(n - lo, 0), lb)
        score(ids_dev.cpu().numpy()[:valid], refs[lo:lo + valid], n)
        scored.append(n)

    pending = None
    for batch in reader_gen():
        imgs, refs = as_image_batch(batch)
        n = len(imgs)
        if n < batch_size:
            pad = np.zeros((batch_size - n, *imgs.shape[1:]), imgs.dtype)
            imgs = np.concatenate([imgs, pad])
        ids_dev = decode(imgs[lo:lo + lb])  # queued on the card
        if pending is not None:
            score_host(*pending)
        pending = (ids_dev, refs, n)
    if pending is not None:
        score_host(*pending)
    return len(scored)


class DataReader:
    """Reads port image shards + the .npy caption DBs of the offline build."""

    def __init__(self, cfg=None) -> None:
        from myimagecaptioningmodel_tpu_torch import config as config_mod

        self.cfg = cfg or config_mod.default
        self._shards: Optional[ShardManager] = None
        self._word2index: Optional[Dict[str, int]] = None
        self._index2word: Optional[Dict[int, str]] = None

    # ---- lazy artifact loading ---------------------------------------------

    def init_shards(self) -> None:
        self._shards = ShardManager()
        self._shards.load_database(list(self.cfg.data.h5_path))
        self._shards.load_name2idx(self.cfg.data.h5_name2idx)

    @property
    def shards(self) -> ShardManager:
        if self._shards is None:
            self.init_shards()
        return self._shards

    def _load_vocab(self) -> None:
        word_index, index_word = np.load(
            os.path.join(self.cfg.data.dict_path, "word_dict.npy"), allow_pickle=True
        )
        self._word2index = word_index
        self._index2word = {int(k): v for k, v in index_word.items()}

    @property
    def word_index(self) -> Dict[str, int]:
        if self._word2index is None:
            self._load_vocab()
        return self._word2index

    @property
    def index_word(self) -> Dict[int, str]:
        if self._index2word is None:
            self._load_vocab()
        return self._index2word

    @property
    def dataset_meta(self) -> Dict[str, object]:
        """Provenance written by the dataset build (``dataset_meta.json``
        next to word_dict.npy); empty for artifact sets without it."""
        path = os.path.join(self.cfg.data.dict_path, "dataset_meta.json")
        if not os.path.exists(path):
            return {}
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    # ---- readers -------------------------------------------------------------

    @property
    def storage_norm(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """(mean, std) to normalize raw uint8 rows with — from the shards'
        provenance when present, else the config."""
        info = self._shards.storage_info if self._shards is not None else {}
        mean = info.get("image_mean", self.cfg.data.image_mean)
        std = info.get("image_std", self.cfg.data.image_std)
        return tuple(mean), tuple(std)

    def get_reader(
        self,
        batch_size: Optional[int] = None,
        mode: str = "train",
        keep_float16: bool = False,
        shuffle_seed: Optional[int] = None,
        skip_samples: int = 0,
        reader_threads: int = 0,
        process_shard: Optional[Tuple[int, int]] = None,
        micro_batches: int = 1,
    ) -> Callable[[], Iterator[List[Sample]]]:
        """``keep_float16=True`` yields raw shard rows (float16 or uint8);
        the default is the reference contract of normalized float32 CHW
        samples (reader.py:45-47) for every storage dtype.

        ``shuffle_seed`` reshuffles the training sample order per reader
        instantiation; ``skip_samples`` drops the first K training samples
        without touching the image store (mid-epoch resume fast-forward);
        ``reader_threads > 0`` (requires ``batch_size``) yields pre-stacked
        batches, each one gather from the memory-mapped rows.

        ``process_shard=(index, count)`` (multi-process training, train
        only): ``batch_size`` is this process's LOCAL batch; it reads only
        its rows of each global batch of ``batch_size * count`` samples
        (``process_slice_batches``), after the shuffle and ``skip_samples``
        (both act on the global order: every process passes the same
        values); a trailing partial global batch is dropped.
        ``micro_batches=a`` slices each global batch's ``a`` microbatches
        instead, so that this process's k-th chunk of ``batch_size / a``
        rows is its share of the global batch's k-th microbatch, as a
        single-process step with gradient accumulation splits it."""
        if process_shard is not None and not batch_size:
            raise ValueError("process_shard requires batch_size")
        store = self.shards
        mean, std = self.storage_norm

        def finalize(arr: np.ndarray) -> np.ndarray:
            """raw row(s) -> the reference float32 contract."""
            if arr.dtype == np.uint8:
                from myimagecaptioningmodel_tpu_torch.data import image as image_mod

                return image_mod.normalize_uint8_chw(arr, mean, std)
            return arr.astype(np.float32)

        split = self._load_split(mode, shuffle_seed, skip_samples, process_shard, batch_size,
                                 micro_batches)
        if reader_threads and batch_size:
            return self._get_batch_reader(store, split, batch_size, mode, keep_float16,
                                          finalize)
        if keep_float16:
            read = store.read
        else:

            def read(name: str) -> np.ndarray:
                return finalize(store.read(name))

        if mode == "train":

            def reader() -> Iterator[Sample]:
                for name, cap in split:
                    yield read(name), np.asarray(cap, dtype=np.int64)

        else:
            files, files2cap = split

            def reader() -> Iterator[Sample]:
                for name in files:
                    yield read(name), files2cap[name]

        return batched(reader, batch_size) if batch_size else reader

    def _load_split(self, mode: str, shuffle_seed: Optional[int], skip_samples: int,
                    process_shard: Optional[Tuple[int, int]] = None,
                    local_batch: Optional[int] = None, micro_batches: int = 1):
        """One split's caption DB — the single source of ordering, shuffle
        and resume-skip semantics for the serial and the batch readers.

        train -> list of (name, padded caption ids); dev/test ->
        (names list, {name: [ref word-lists]})."""
        if mode not in ("train", "dev", "test"):
            raise ValueError(f"DataReader does not support mode {mode!r}")
        dict_path = self.cfg.data.dict_path
        if mode == "train":
            captions, _max_len = np.load(
                os.path.join(dict_path, "train_cap.npy"), allow_pickle=True
            )
            if shuffle_seed is not None:
                order = np.random.RandomState(shuffle_seed).permutation(len(captions))
                captions = [captions[i] for i in order]
            if skip_samples:
                captions = captions[skip_samples:]
            if process_shard is not None:
                index, count = process_shard
                if local_batch % micro_batches:
                    raise ValueError(f"local batch {local_batch} does not divide into "
                                     f"{micro_batches} microbatches")
                whole = len(captions) - len(captions) % (local_batch * count)
                captions = process_slice_batches(list(captions[:whole]),
                                                 local_batch // micro_batches, index, count)
            return captions
        if process_shard is not None:
            raise ValueError("process_shard is train-only; a multi-process dev/test "
                             "evaluation reads the global stream on every process and "
                             "decodes its own rows")
        fname = "dev_data.npy" if mode == "dev" else "eval_data.npy"
        return np.load(os.path.join(dict_path, fname), allow_pickle=True)

    @staticmethod
    def _get_batch_reader(store: ShardManager, split, batch_size: int, mode: str,
                          keep_raw: bool, finalize) -> Callable[[], Iterator]:
        """Batch-granular reader: one gather per batch (see get_reader)."""
        if mode == "train":
            captions = split

            def gen() -> Iterator:
                for i in range(0, len(captions), batch_size):
                    chunk = captions[i : i + batch_size]
                    imgs = store.read_batch([name for name, _cap in chunk])
                    if not keep_raw:
                        imgs = finalize(imgs)
                    yield imgs, np.stack([np.asarray(cap, np.int64) for _n, cap in chunk])

        else:
            files, files2cap = split

            def gen() -> Iterator:
                for i in range(0, len(files), batch_size):
                    chunk = list(files[i : i + batch_size])
                    imgs = store.read_batch(chunk)
                    if not keep_raw:
                        imgs = finalize(imgs)
                    yield imgs, [files2cap[name] for name in chunk]

        return gen

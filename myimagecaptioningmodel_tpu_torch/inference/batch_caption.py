"""Batch captioning: caption a directory of images at the card's rate; the
counterpart of ``myimagecaptioningmodel_tpu/inference/batch_caption.py``.

Two halves, as ``infer.caption_array`` and the server's ``prepare`` split
them:

- the host half (``caption_directory``) walks the directory (``IMAGE_EXTS``,
  sorted) and decodes and resizes the images with PIL on 4 host threads
  (PIL releases the interpreter lock);
- the device half (``caption_arrays``) takes ``(index, name, CHW float32
  array or None)`` items in any order and does everything after the
  decode: fixed batches of ``batch_size`` (the last one zero-padded, so one
  CUDA graph serves every decode of a shape), each image written once into
  its row of a pinned host buffer, one batch in flight (the next batch is
  queued on the card before the previous batch's ids are read back), and
  one record per image in path order: ``{"image", "ids", "caption"}``, or
  ``{"image", "error": "undecodable"}`` for an image PIL could not decode
  or that is not 3-channel.

Decoding goes through ``evaluation.evaluate.load_bundle``: the LSTM greedy
through kernel B with head A, its beam search through B and C, the
transformer through D (greedy) or E (beam), ``quantize`` through their int8
modes. It runs on the card unless ``device="cpu"`` is given.

    python -m myimagecaptioningmodel_tpu_torch.inference.batch_caption \\
        /path/to/images --out captions.jsonl [--batch 128] [--beam 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.data import image as image_mod
from myimagecaptioningmodel_tpu_torch.evaluation import metrics
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

Item = Tuple[int, str, Optional[np.ndarray]]  # (index, name, CHW float32 or None)


def list_images(image_dir: str) -> List[str]:
    """The directory's image paths (``IMAGE_EXTS``, any case), sorted."""
    return sorted(os.path.join(image_dir, n) for n in os.listdir(image_dir)
                  if n.lower().endswith(IMAGE_EXTS))


def decode_images(paths: List[str], cfg, n_threads: int = 4) -> Iterable[Item]:
    """Decode, resize and normalize ``paths`` with PIL on ``n_threads``
    host threads -> ``(index, path, CHW float32 or None)`` as each is done
    (None: PIL could not decode it, or it is not 3-channel), at most 512
    decoded images ahead of the consumer."""
    it = iter(enumerate(paths))
    lock = threading.Lock()
    out: "queue.Queue" = queue.Queue(maxsize=512)

    def work():
        while True:
            with lock:
                try:
                    idx, path = next(it)
                except StopIteration:
                    return
            try:
                arr = image_mod.process_image(image_mod.read_image(path), cfg.data.image_shape,
                                              cfg.data.image_mean, cfg.data.image_std)
            except Exception:  # any decode failure is this image's record
                arr = None
            out.put((idx, path, arr))

    threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for _ in paths:
        yield out.get()
    for t in threads:
        t.join()


def caption_arrays(cfg, items: Iterable[Item], model, decode, index_word,
                   batch_size: int = 128) -> List[dict]:
    """The device half: ``load_bundle``'s ``(model, decode)`` over the
    decoded ``items`` -> one record per item, in index order. Each image is
    written once, as NHWC, into its row of one of two host buffers (pinned
    for the card), which take turns: one fills while the other's batch is
    in flight."""
    dev = model.device
    results = {}
    pending = None  # (host ids, copy-done event, metas) of the batch in flight
    slots: List[np.ndarray] = []  # the two [batch_size, H, W, 3] buffers' numpy views
    fill, metas = 0, []  # the buffer being filled, and its rows' (index, name)

    def launch(host, metas):
        if len(metas) < batch_size:  # the padding rows of the last batch
            host[len(metas):] = 0
        ids = decode(model, torch.from_numpy(host).to(dev, non_blocking=True))
        done = None
        if dev.type == "cuda":  # the ids' copy back, queued behind this decode only
            out = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            out.copy_(ids, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            ids = out
        return ids, done, metas

    def collect(pending):
        ids, done, metas = pending
        if done is not None:  # also: this batch's buffer is free again
            done.synchronize()
        for (idx, name), row in zip(metas, ids.numpy()[: len(metas)].tolist()):
            words = metrics.filter_ids(row, index_word, cfg.data.stop_idx,
                                       cfg.data.padding_idx)
            results[idx] = {"image": os.path.basename(name), "ids": row,
                            "caption": metrics.words2sentence(words)}

    for idx, name, arr in items:
        if arr is None:
            results[idx] = {"image": os.path.basename(name), "error": "undecodable"}
            continue
        if not slots:
            shape = (batch_size, arr.shape[1], arr.shape[2], arr.shape[0])
            slots = [torch.empty(shape, dtype=torch.float32,
                                 pin_memory=dev.type == "cuda").numpy() for _ in range(2)]
        slots[fill][len(metas)] = arr.transpose(1, 2, 0)  # CHW -> HWC, in place
        metas.append((idx, name))
        if len(metas) == batch_size:
            launched = launch(slots[fill], metas)  # queued before the previous batch is read
            if pending is not None:
                collect(pending)
            pending, fill, metas = launched, 1 - fill, []
    if metas:
        launched = launch(slots[fill], metas)
        if pending is not None:
            collect(pending)
        pending = launched
    if pending is not None:
        collect(pending)
    return [results[i] for i in sorted(results)]


def caption_directory(
    cfg,
    image_dir: str,
    out_path: Optional[str] = None,
    batch_size: int = 128,
    beam_size: int = 0,
    bundle: str = "infer",
    quantize: bool = False,
    early_stop: bool = True,
    device=None,
) -> List[dict]:
    """-> one record per image of ``image_dir``, in path order (the
    undecodable ones too, ``{"image", "error"}``), each also a line of
    ``out_path`` (jsonl) when given."""
    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader

    model, _bcfg, _opts, decode = load_bundle(cfg, bundle, beam_size, quantize,
                                              early_stop=early_stop, device=device)
    index_word = DataReader(cfg).index_word
    paths = list_images(image_dir)
    begin = time.time()
    records = caption_arrays(cfg, decode_images(paths, cfg), model, decode, index_word,
                             batch_size)
    elapsed = time.time() - begin
    print(f"captioned {len(records)} images in {elapsed:.1f}s "
          f"({len(records) / max(elapsed, 1e-9):.1f} img/s)", file=sys.stderr)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            for r in records:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return records


def main(argv=None) -> None:
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("image_dir")
    ap.add_argument("--out", default=None, help="output jsonl path")
    ap.add_argument("--config", default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--beam", type=int, default=0)
    ap.add_argument("--bundle", default="infer")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 decoder weights (4x smaller serving footprint)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    caption_directory(cfg, args.image_dir, args.out, args.batch, args.beam, args.bundle,
                      args.quantize, device=args.device)


if __name__ == "__main__":
    main()

"""Offline dataset-build orchestration (reference preprocess/dataset_gen.py);
the counterpart of ``myimagecaptioningmodel_tpu/data/dataset_gen.py``.

Four stages, the same artifacts but the image shards (SURVEY §3.4):
1. ``gen_shards``    — JPEG decode/resize/normalize -> ``.npy`` shards
                       (data/shards.py; needs PIL);
2. ``word_seg``      — segment every caption, drop captions longer than
                       ``sentence_len_limit`` words, write ``temp/token`` +
                       ``temp/token.list``;
3. ``split_data``    — shuffle image names, 5% test / 5% dev / 90% train;
4. ``tokenizer.main``— vocab + caption DBs (data/tokenizer.py).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

from myimagecaptioningmodel_tpu_torch.data import shards as shards_mod
from myimagecaptioningmodel_tpu_torch.data import tokenizer as tokenizer_mod
from myimagecaptioningmodel_tpu_torch.data.segmenter import get_segmenter, segmenter_version


def update_dataset_meta(out_dir: str, **fields) -> Dict[str, object]:
    """Merge ``fields`` into ``<out_dir>/dataset_meta.json`` (provenance:
    which segmenter/version produced the vocab, plus tokenize stats — vocab
    ids silently depend on the segmenter, so the artifact set must say which
    one built it)."""
    path = os.path.join(out_dir, "dataset_meta.json")
    meta: Dict[str, object] = {}
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    meta.update(fields)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False, indent=1)
    return meta


def _temp_path(cfg) -> str:
    return os.path.join(cfg.build_dataset.output_path, "temp")


def word_seg(cfg=None, segmenter: str = "auto") -> Dict[str, object]:
    """Segment annotation captions into the reference token-file format.

    Input: an AI_Challenger-style JSON list of
    ``{"image_id": name, "caption": [str, ...]}`` records
    (reference dataset_gen.py:11-43). Captions segmenting to more than
    ``sentence_len_limit`` words are dropped.
    """
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    temp = _temp_path(cfg)
    os.makedirs(temp, exist_ok=True)

    seg_name, seg = get_segmenter(segmenter)
    limit = cfg.build_dataset.sentence_len_limit
    used_files: List[str] = []

    with open(os.path.join(temp, "token"), "w", encoding="utf-8") as out:
        with open(cfg.build_dataset.annotation_path, "r", encoding="utf-8") as rd:
            records = json.load(rd)
        for info in records:
            name = info["image_id"]
            used = False
            for i, cap in enumerate(info["caption"]):
                anno = cap.replace("\r", "").replace("\n", "").replace("、", "")
                cut = seg(anno)
                if len(cut) > limit:
                    continue
                used = True
                out.write("{}#{}\t{}\n".format(name, i, " ".join(cut)))
            if used:
                used_files.append(name)

    with open(os.path.join(temp, "token.list"), "w", encoding="utf-8") as f:
        f.writelines(name + "\n" for name in used_files)

    update_dataset_meta(
        cfg.build_dataset.output_path,
        segmenter=seg_name,
        segmenter_version=segmenter_version(seg_name),
    )
    return {"segmenter": seg_name, "images": len(used_files)}


def split_data(cfg=None, seed: int | None = None) -> Dict[str, int]:
    """Shuffle image names -> 5% test / 5% dev / 90% train split files."""
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    temp = _temp_path(cfg)

    names = set()
    with open(os.path.join(temp, "token"), "r", encoding="utf-8") as f:
        for line in f:
            names.add(line.split("#")[0])

    names = sorted(names)  # deterministic base order before the shuffle
    random.Random(seed).shuffle(names)

    test_len = int(0.05 * len(names))
    dev_len = int(0.05 * len(names))
    splits = {
        "test.txt": names[:test_len],
        "dev.txt": names[test_len : test_len + dev_len],
        "train.txt": names[test_len + dev_len :],
    }
    for fname, content in splits.items():
        with open(os.path.join(temp, fname), "w", encoding="utf-8") as f:
            f.writelines(n + "\n" for n in content)

    return {
        "test": test_len,
        "dev": dev_len,
        "train": len(names) - test_len - dev_len,
    }


def build_captions(cfg=None, segmenter: str = "auto", split_seed: int | None = None):
    """The three caption stages (no PIL): segment, split, tokenize."""
    return {
        "word_seg": word_seg(cfg, segmenter),
        "split": split_data(cfg, split_seed),
        "tokenize": tokenizer_mod.main(cfg),
    }


def build_all(cfg=None, segmenter: str = "auto", split_seed: int | None = None):
    """Run the full 4-stage offline pipeline; returns per-stage summaries."""
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    summary = {"gen_shards": shards_mod.gen_shards(cfg),
               **build_captions(cfg, segmenter, split_seed)}
    update_dataset_meta(
        cfg.build_dataset.output_path,
        storage_dtype=summary["gen_shards"]["storage_dtype"],
        codec=summary["gen_shards"]["codec"],
    )
    return summary

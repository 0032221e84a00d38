"""Offline dataset-build entry point of the port (the JAX package's
``dataset_gen.py``):

    python -m myimagecaptioningmodel_tpu_torch.dataset_gen [--config cfg.json]
        [--segmenter auto|pkuseg|jieba|space] [--split-seed N] [--captions-only]

Runs the four stages — JPEG -> ``.npy`` image shards (``data/shards.py``,
needs PIL), word segmentation, the train/dev/test split, vocabulary + caption
DBs — and prints per-stage summaries. ``--captions-only`` runs the three
caption stages alone (no PIL): on a machine without PIL, write the shards
with ``data.shards.ShardBuilder`` or convert a JAX set with
``convert_jax_shards``. The build runs on the host only, so it takes no
``--device``.
"""

import argparse
import pprint

from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.data import dataset_gen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--segmenter", default="auto", choices=["auto", "pkuseg", "jieba", "space"],
                    help="word segmenter ('auto' picks pkuseg > jieba > space; the "
                    "choice is recorded in dataset_meta.json)")
    ap.add_argument("--split-seed", type=int, default=None,
                    help="seed for the 5/5/90 test/dev/train split shuffle")
    ap.add_argument("--captions-only", action="store_true",
                    help="run the caption stages only (no image shards, no PIL)")
    args = ap.parse_args(argv)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    build = dataset_gen.build_captions if args.captions_only else dataset_gen.build_all
    pprint.pprint(build(cfg, segmenter=args.segmenter, split_seed=args.split_seed))


if __name__ == "__main__":
    main()

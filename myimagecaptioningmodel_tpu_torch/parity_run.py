"""Turnkey real-data parity run against the reference; the counterpart of
the JAX package's ``parity_run.py``, with the same stages, flags and report
keys.

Given the AI_Challenger dataset paths (and ideally pkuseg installed, so the
vocabulary matches the reference's published stats), this runs the
reference's workflow end to end with the port and writes one
``PARITY_REPORT.json``:

    1. the offline dataset build (``.npy`` image shards, segmentation, the
       split, vocabulary and caption DBs; ``data/dataset_gen.py``), skipped
       with ``--skip-build`` when the artifacts exist;
    2. training for ``train.max_epoch`` epochs (``training/loop.py``);
    3. offline BLEU-1..4 (+mean) and CIDEr-D on the dev AND test splits
       (``evaluation/evaluate.py``);
    4. optionally, the import of a REFERENCE PaddlePaddle checkpoint
       (``--reference-checkpoint <save_persistables dir>``,
       ``compat/paddle_import.py``), evaluated through the same metric path,
       and a diff of its captions against ours on the test split.

Usage:

    python -m myimagecaptioningmodel_tpu_torch.parity_run \\
        --images /data/ai_challenger/caption_train_images_20170902 \\
        --annotations /data/ai_challenger/caption_train_annotations_20170902.json \\
        --workdir /data/parity \\
        [--config overrides.json] [--epochs 10] \\
        [--reference-checkpoint /data/ref/save/checkpoint] \\
        [--skip-build] [--skip-train] [--report PARITY_REPORT.json] [--device cpu] \\
        [--distributed [--coordinator host:port --num-processes N --process-id I]]

It trains and decodes on one CUDA device unless ``--device`` names another;
without a card and without ``--device cpu`` it stops before any stage. The
build decodes JPEGs with PIL, which the card's machine lacks: there write
the image rows with ``data.shards.ShardBuilder`` (or ``convert_jax_shards``)
and the caption stages with ``dataset_gen --captions-only`` under
``<workdir>/dataset``, and pass ``--skip-build``. The multi-process flags
(or torchrun's environment) are ``train``'s: one process a GPU, data
parallel, ``train.batch_size`` the global batch; process 0 builds and
writes the report.

The report records which segmenter was used and compares the built
vocabulary against the reference's published stats (vocab 12295 / 8160 unk
types / max_len 35, ai_challenge_tokenizer.py:131), so a jieba or space
fallback shows as a parity caveat, not a silent divergence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# reference's published build stats (ai_challenge_tokenizer.py:131): the
# vocabulary parity bar when pkuseg is available
REFERENCE_VOCAB_STATS = {
    "vocab_size": 12295,
    "unk_word_types": 8160,
    "max_len": 35,
}


def log(msg: str) -> None:
    print(f"[parity_run] {msg}", file=sys.stderr, flush=True)


def build_config(args):
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.Config()
    ds = os.path.join(args.workdir, "dataset")
    overrides = {
        "build_dataset.output_path": ds,
        "build_dataset.h5_name2idx": os.path.join(ds, "name2idx.json"),
        "data.dict_path": ds,
        "data.h5_path": (ds,),
        "data.h5_name2idx": os.path.join(ds, "name2idx.json"),
        "train.checkpoint_path": os.path.join(args.workdir, "save"),
        "log.log_path": os.path.join(args.workdir, "log"),
    }
    if args.images:
        overrides["build_dataset.image_paths"] = (args.images,)
    if args.annotations:
        overrides["build_dataset.annotation_path"] = args.annotations
    if args.epochs is not None:
        overrides["train.max_epoch"] = args.epochs
    for path, value in overrides.items():
        cfg = config_mod.replace_nested(cfg, path, value)
    return cfg


def stage_build(cfg, args, report):
    from myimagecaptioningmodel_tpu_torch.data import dataset_gen

    meta_path = os.path.join(cfg.build_dataset.output_path, "dataset_meta.json")
    done_marker = os.path.join(cfg.build_dataset.output_path, "word2idx.json")
    if args.skip_build and os.path.exists(done_marker):
        log("build: skipped (artifacts present)")
        report["build"] = {"skipped": True}
        with open(meta_path, encoding="utf-8") as f:
            report["build"]["dataset_meta"] = json.load(f)
        return cfg
    try:
        import PIL  # noqa: F401  (the image stage decodes JPEGs with it)
    except ImportError as e:
        raise RuntimeError(
            "the dataset build decodes JPEGs with PIL, which is not installed here: write "
            "the image shards with data.shards.ShardBuilder (or convert_jax_shards) and the "
            "caption stages with `dataset_gen --captions-only` under "
            f"{cfg.build_dataset.output_path}, then rerun with --skip-build") from e
    t0 = time.time()
    summary = dataset_gen.build_all(cfg, segmenter=args.segmenter)
    tok = summary["tokenize"]
    built = {
        "seconds": round(time.time() - t0, 1),
        "segmenter": summary["word_seg"]["segmenter"],
        "images": summary["gen_shards"].get("images"),
        "vocab_size": tok["vocab_size"],
        "unk_word_types": tok.get("unk_word_types"),
        "max_len": tok["max_len"],
        "reference_stats": REFERENCE_VOCAB_STATS,
        "matches_reference_vocab": (
            tok["vocab_size"] == REFERENCE_VOCAB_STATS["vocab_size"]
            and tok.get("unk_word_types") == REFERENCE_VOCAB_STATS["unk_word_types"]
            and tok["max_len"] == REFERENCE_VOCAB_STATS["max_len"]
        ),
    }
    report["build"] = built
    log(f"build: vocab {built['vocab_size']} (ref {REFERENCE_VOCAB_STATS['vocab_size']}), "
        f"segmenter {built['segmenter']}, matches_reference_vocab="
        f"{built['matches_reference_vocab']}")
    return cfg


def sync_model_dims(cfg):
    """Pin the vocabulary and sentence dims from the build artifacts (like the
    reference, whose config hardcodes the published numbers)."""
    import numpy as np

    from myimagecaptioningmodel_tpu_torch import config as config_mod

    with open(os.path.join(cfg.data.dict_path, "word2idx.json"), encoding="utf-8") as f:
        vocab_size = len(json.load(f))
    db = np.load(os.path.join(cfg.data.dict_path, "train_cap.npy"), allow_pickle=True)
    max_len = int(db[1])
    cfg = config_mod.replace_nested(cfg, "model.decoder.vocab_size", vocab_size)
    cfg = config_mod.replace_nested(cfg, "model.decoder.sentence_length", max_len)
    if cfg.model.decoder.infer_max_length < max_len:
        cfg = config_mod.replace_nested(cfg, "model.decoder.infer_max_length", max_len)
    return cfg


def stage_train(cfg, args, report):
    from myimagecaptioningmodel_tpu_torch.training import loop

    t0 = time.time()
    result = loop.train(cfg, device=args.device)
    report["train"] = {
        "seconds": round(time.time() - t0, 1),
        "epochs": cfg.train.max_epoch,
        "final_step": result.get("final_step"),
        "last_epoch_loss": result.get("last_epoch_loss"),
        "best_bleu": result.get("best_bleu"),
    }
    log(f"train: {report['train']}")


def stage_evaluate(cfg, report, device=None, bundle="infer", key="evaluate"):
    from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as evaluate_mod

    out = {}
    for mode in ("dev", "test"):
        t0 = time.time()
        res = evaluate_mod.evaluate(cfg, bundle=bundle, mode=mode, device=device)
        out[mode] = {
            "bleu": [round(b, 5) for b in res["bleu"]],
            "cider": round(res["cider"], 5),
            "distinct_sentences": res.get("distinct_sentences"),
            "seconds": round(time.time() - t0, 1),
        }
        log(f"{key}[{bundle}] {mode}: bleu={out[mode]['bleu']} cider={out[mode]['cider']}")
    report[key] = out


def decode_captions(cfg, bundle, limit, device=None):
    """Greedy captions (as sentences) for the first ``limit`` test images."""
    from myimagecaptioningmodel_tpu_torch.data import reader as reader_mod
    from myimagecaptioningmodel_tpu_torch.evaluation import metrics
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    model, _bcfg, _opts, decode = load_bundle(cfg, bundle,
                                              device=distributed.default_device(device))
    dr = reader_mod.DataReader(cfg)
    out = []
    for batch in dr.get_reader(min(limit, cfg.train.batch_size), "test")():
        imgs, _refs = reader_mod.as_image_batch(batch)
        for row in decode(model, imgs).cpu().tolist():
            words = metrics.filter_ids(row, dr.index_word, cfg.data.stop_idx,
                                       cfg.data.padding_idx)
            out.append(metrics.words2sentence(words))
            if len(out) >= limit:
                return out
    return out


def stage_reference_import(cfg, args, report):
    from myimagecaptioningmodel_tpu_torch import config as config_mod
    from myimagecaptioningmodel_tpu_torch.compat import paddle_import
    from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions
    from myimagecaptioningmodel_tpu_torch.parallel import distributed
    from myimagecaptioningmodel_tpu_torch.training import checkpoint

    # parity_mode reproduces the reference's degenerate-attention captions
    cfg_ref = config_mod.replace_nested(cfg, "model.parity_mode", True)
    if distributed.is_main_process():  # one writer of the bundle
        opts = ModelOptions.from_config(cfg_ref)
        t0 = time.time()
        params, state, rep = paddle_import.import_persistables(args.reference_checkpoint, opts)
        bundle_dir = os.path.join(cfg.train.checkpoint_path, "infer_reference")
        checkpoint.export_inference_bundle(bundle_dir, params, state, cfg_ref,
                                           vocab_src_dir=cfg.data.dict_path)
        report["reference_import"] = {
            "seconds": round(time.time() - t0, 1),
            "checkpoint": args.reference_checkpoint,
            "summary": rep.summary(),
            "missing": list(rep.missing),
            "unknown": list(rep.unknown)[:20],
        }
        log(f"reference import: {rep.summary()}")
    distributed.barrier()
    stage_evaluate(cfg_ref, report, args.device, bundle="infer_reference",
                   key="evaluate_reference")
    # caption diff: ours against the imported reference model on test images
    n = args.diff_captions
    ours = decode_captions(cfg, "infer", n, args.device)
    theirs = decode_captions(cfg_ref, "infer_reference", n, args.device)
    same = sum(a == b for a, b in zip(ours, theirs))
    report["caption_diff"] = {
        "compared": min(len(ours), len(theirs)),
        "identical": same,
        "examples": [{"ours": a, "reference": b} for a, b in list(zip(ours, theirs))[:10]],
    }
    log(f"caption diff: {same}/{min(len(ours), len(theirs))} identical")


def main(argv=None) -> dict:
    from myimagecaptioningmodel_tpu_torch.models.captioner import resolve_device
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--images", default=None, help="AI_Challenger image directory")
    ap.add_argument("--annotations", default=None, help="caption annotations JSON")
    ap.add_argument("--workdir", required=True, help="output root (dataset/, save/, log/)")
    ap.add_argument("--config", default=None,
                    help="JSON config overriding the production defaults")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--segmenter", default="auto",
                    help="auto|pkuseg|jieba|space (auto prefers pkuseg)")
    ap.add_argument("--skip-build", action="store_true",
                    help="reuse existing dataset artifacts in workdir")
    ap.add_argument("--skip-train", action="store_true",
                    help="evaluate an existing checkpoint only")
    ap.add_argument("--reference-checkpoint", default=None,
                    help="reference save_persistables dir to import + diff")
    ap.add_argument("--diff-captions", type=int, default=256,
                    help="test images for the caption diff")
    ap.add_argument("--report", default=None,
                    help="report path (default <workdir>/PARITY_REPORT.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, this process's GPU in a group; "
                         "cpu only when asked for)")
    distributed.add_cli_arguments(ap)
    args = ap.parse_args(argv)
    distributed.initialize_from_cli(args)
    try:
        resolve_device(distributed.default_device(args.device))  # no card: stop here
        main_process = distributed.is_main_process()
        if main_process:
            os.makedirs(args.workdir, exist_ok=True)
        report: dict = {
            "command": " ".join(sys.argv),
            "started_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        cfg = build_config(args)
        if main_process:  # process 0 builds; the others wait for its files
            cfg = stage_build(cfg, args, report)
        distributed.barrier()
        cfg = sync_model_dims(cfg)
        if not args.skip_train:
            stage_train(cfg, args, report)
        stage_evaluate(cfg, report, args.device)
        if args.reference_checkpoint:
            stage_reference_import(cfg, args, report)
        if main_process:
            path = args.report or os.path.join(args.workdir, "PARITY_REPORT.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(report, f, ensure_ascii=False, indent=2)
            log(f"wrote {path}")
        return report
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()

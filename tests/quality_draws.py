"""Draws of the quality bars' recipes on the CPU, one training run a call.

The port or the JAX package trains the LSTM arm of ``tests/test_quality_bar.py``
("q3": 24 images of 3 classes, 32 px, hidden 48 / embedding 16, lr 8e-3, 50
epochs of B=4) or of ``tests/test_quality_bar_hard.py`` ("hard": 250
compositional images, 48 px, hidden 128 / embedding 32, lr 2e-3, 40 epochs
of B=16) from the JAX package's initial weights for ``--seed``, and prints
one JSON line: the step and epoch losses, dev and test BLEU-4 through each
package's own ``evaluate()``, and with ``--bn-probe`` how many training
images the final weights caption right with eval-mode BN (moving
statistics) and with batch statistics over the training batches, both read
by the port (a JAX checkpoint through ``convert_jax_checkpoint``).

``--threads`` sets PyTorch's threads, or XLA's CPU threads for the JAX
package (0: each library's default). ``--perturb E`` multiplies every
initial weight by ``1 + E * N(0, 1)`` (port only) before training: the
trajectory's sensitivity to a change of the size of one float32 rounding.

    JAX_PLATFORMS=cpu python tests/quality_draws.py port hard --seed 1 --out /tmp/draws
"""

import argparse
import json
import os
import re
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

RECIPES = {
    "q3": {"shape": [32, 32], "batch": 4, "lr": 8e-3, "hidden": 48, "emb": 16,
           "infer_max_length": 8, "epochs": 50},
    "hard": {"shape": [48, 48], "batch": 16, "lr": 2e-3, "hidden": 128, "emb": 32,
             "infer_max_length": 10, "epochs": 40},
}


def corpus(bar, root):
    """The bar's own images and annotations under ``root`` -> (image dir,
    annotation path, image count)."""
    import numpy as np
    from PIL import Image

    if bar == "hard":
        import test_quality_bar_hard as hard

        img_dir, ann = hard._make_corpus(root)
        return img_dir, ann, hard.N_IMAGES
    from test_quality_bar import CLASSES

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(23)
    records = []
    for i in range(24):
        color, phrase = CLASSES[i % 3]
        arr = np.clip(np.asarray(color, np.int16)[None, None, :]
                      + rng.randint(-15, 15, (48, 48, 3)), 0, 255).astype(np.uint8)
        name = f"img_{i:03d}.jpg"
        Image.fromarray(arr).save(img_dir / name, quality=95)
        records.append({"image_id": name, "caption": [phrase]})
    ann = root / "ann.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    return img_dir, ann, 24


def config_dict(bar, root, img_dir, ann, n, seed, epochs, dtype, ds="ds", save="save"):
    r = RECIPES[bar]
    out = root / ds
    return {
        "build_dataset": {"image_paths": [str(img_dir)], "annotation_path": str(ann),
                          "output_path": str(out), "h5_name2idx": str(out / "name2idx.json")},
        "data": {"image_shape": r["shape"], "dict_path": str(out), "h5_path": [str(out)],
                 "h5_name2idx": str(out / "name2idx.json"), "sample_count": n},
        "train": {"seed": seed, "learning_rate": r["lr"], "batch_size": r["batch"],
                  "max_epoch": epochs, "lr_decay_strategy": "cosine_decay",
                  "decay_epoch": epochs, "log_every_n_step": 1,
                  "checkpoint_path": str(root / save)},
        "model": {"decoder": {"vocab_size": 0, "embedding_size": r["emb"], "sentence_length": 0,
                              "hidden_dim": r["hidden"],
                              "infer_max_length": r["infer_max_length"]},
                  "compute_dtype": dtype},
        "log": {"log_path": str(root / "log")},
    }


def port_config(d):
    """The port's config of ``d`` with its dataset built (caption stages
    seeded as the bars': "space" segmenter, split seed 0)."""
    from myimagecaptioningmodel_tpu_torch import config as C
    from myimagecaptioningmodel_tpu_torch.data import dataset_gen

    cfg = C.Config.from_dict(d)
    tok = dataset_gen.build_all(cfg, segmenter="space", split_seed=0)["tokenize"]
    cfg = C.replace_nested(cfg, "model.decoder.vocab_size", tok["vocab_size"])
    return C.replace_nested(cfg, "model.decoder.sentence_length", tok["max_len"])


def perturb_checkpoint(directory, eps):
    import numpy as np
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    with open(os.path.join(directory, ckpt.META_FILE), encoding="utf-8") as f:
        meta = json.load(f)
    with np.load(os.path.join(directory, ckpt.CKPT_FILE)) as z:
        arrays = {k: z[k] for k in z.files}
    rs = np.random.RandomState(1234)
    for k in sorted(arrays):
        if k.startswith("params/") and arrays[k].dtype.kind == "f":
            noise = 1 + eps * rs.standard_normal(arrays[k].shape)
            arrays[k] = (arrays[k] * noise).astype(arrays[k].dtype)
    shutil.rmtree(directory)
    ckpt.write_checkpoint(directory, arrays, meta)


def bn_probe(cfg, checkpoint_dir):
    """Training images captioned right, with eval-mode BN and with batch
    statistics over the training batches, and the teacher-forced loss of
    each -> {mode: {"right", "of", "loss"}}."""
    import numpy as np
    import torch
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.data import image as image_mod
    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
    from myimagecaptioningmodel_tpu_torch.evaluation import metrics
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    with np.load(os.path.join(checkpoint_dir, ckpt.CKPT_FILE)) as z:
        part = {nm: ckpt.unflatten_tree({k[len(nm) + 1:]: z[k] for k in z.files
                                         if k.startswith(nm + "/")})
                for nm in ("params", "model_state")}
    dt = torch.float64 if cfg.model.compute_dtype == "float64" else torch.float32
    p, s = train_tree(part["params"], part["model_state"], torch.device("cpu"), dt)
    opts = ModelOptions.from_config(cfg)._replace(use_kernels=False)
    dr = DataReader(cfg)
    train = dr._load_split("train", None, 0)
    names = [n for n, _c in train]
    caps = np.stack([np.asarray(c) for _n, c in train])
    imgs = image_mod.chw_to_nhwc(dr.shards.read_batch(names).astype(np.float32))
    with open(cfg.build_dataset.annotation_path, encoding="utf-8") as f:
        want = {r["image_id"]: r["caption"][0] for r in json.load(f)}
    feature_tree = C.img2feature_tree
    B = cfg.train.batch_size
    out = {}
    for mode in ("eval", "batch"):
        right, losses = 0, []
        C.img2feature_tree = (lambda *a, **k: feature_tree(*a, **{**k, "train": mode == "batch"}))
        try:
            for b in range(0, len(names) - B + 1, B):
                x = torch.as_tensor(imgs[b:b + B])
                with torch.no_grad():
                    emb, _f, gf, _ = C.img2feature_tree(p, s, x, opts)
                    ids = C._decode_features(p["decoder"], emb, gf, opts)
                    losses.append(float(C.loss_fn(p, s, x, caps[b:b + B], opts)[0]))
                for j in range(ids.shape[0]):
                    words = metrics.filter_ids(ids[j].tolist(), dr.index_word,
                                               cfg.data.stop_idx, cfg.data.padding_idx)
                    right += metrics.words2sentence(words) == want[names[b + j]]
        finally:
            C.img2feature_tree = feature_tree
        out[mode] = {"right": right, "of": B * (len(names) // B),
                     "loss": float(np.mean(losses))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("port", "jax"))
    ap.add_argument("bar", choices=sorted(RECIPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=0, help="0: the recipe's")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--bn-probe", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.perturb and args.package != "port":
        ap.error("--perturb is a port run's option")
    if args.package == "jax" and args.threads:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_"
                                   f"eigen=false intra_op_parallelism_threads={args.threads}")
    import pathlib

    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    epochs = args.epochs or RECIPES[args.bar]["epochs"]
    tag = (f"{args.package}_{args.bar}_{args.dtype}_s{args.seed}_e{epochs}_t{args.threads}"
           + (f"_p{args.perturb:g}" if args.perturb else ""))
    root = pathlib.Path(args.out) / tag
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    img_dir, ann, n = corpus(args.bar, root)
    d = config_dict(args.bar, root, img_dir, ann, n, args.seed, epochs, args.dtype)
    t0 = time.perf_counter()
    if args.package == "jax":
        import jax
        import jax.numpy as jnp
        from myimagecaptioningmodel_tpu import config as JC
        from myimagecaptioningmodel_tpu.data import dataset_gen as JDG
        from myimagecaptioningmodel_tpu.evaluation import evaluate as JE
        from myimagecaptioningmodel_tpu.models import decoder as jdec
        from myimagecaptioningmodel_tpu.training import loop as JL

        cfg = JC.Config.from_dict(d)
        tok = JDG.build_all(cfg, segmenter="space", split_seed=0)["tokenize"]
        cfg = JC.replace_nested(cfg, "model.decoder.vocab_size", tok["vocab_size"])
        cfg = JC.replace_nested(cfg, "model.decoder.sentence_length", tok["max_len"])
        if args.dtype == "float64":  # as tests/test_torch_loop.py runs it
            jax.config.update("jax_enable_x64", True)
            jdec._zero_state = lambda b, h: (jnp.zeros((b, h), jnp.float64),) * 2
        result = JL.train(cfg)
        bleu = {m: JE.evaluate(cfg, bundle="infer", mode=m)["bleu"][3] for m in ("dev", "test")}
    else:
        import test_torch_quality_bar
        from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as E
        from myimagecaptioningmodel_tpu_torch.training import loop as L

        cfg = port_config(d)
        test_torch_quality_bar.start_from_jax_init(cfg)
        if args.perturb:
            perturb_checkpoint(os.path.join(cfg.train.checkpoint_path, "checkpoint"),
                               args.perturb)
        result = L.train(cfg, device="cpu")
        bleu = {m: E.evaluate(cfg, bundle="infer", mode=m, device="cpu")["bleu"][3]
                for m in ("dev", "test")}
    wall = time.perf_counter() - t0
    with open(os.path.join(cfg.log.log_path, "log.txt"), encoding="utf-8") as f:
        text = f.read()
    rec = {"tag": tag, "train_and_eval_s": wall, "bleu4": bleu,
           "last_epoch_loss": float(result["last_epoch_loss"]),
           "epoch_losses": [float(x) for x in re.findall(r"Epoch loss: ([-\d.e]+)", text)],
           "step_losses": [float(x) for x in re.findall(r"Step loss: ([-\d.e]+)", text)]}
    if args.bn_probe:
        from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

        last = os.path.join(cfg.train.checkpoint_path, "checkpoint")
        pcfg = cfg
        if args.package == "jax":
            pd = config_dict(args.bar, root, img_dir, ann, n, args.seed, epochs, args.dtype,
                             ds="ds_port", save="save_port")
            pcfg = port_config(pd)
            ckpt.convert_jax_checkpoint(last, os.path.join(pcfg.train.checkpoint_path,
                                                           "checkpoint"))
            last = os.path.join(pcfg.train.checkpoint_path, "checkpoint")
        rec["bn_probe"] = bn_probe(pcfg, last)
    with open(root.parent / f"{tag}.json", "w", encoding="utf-8") as f:
        json.dump(rec, f)
    print(json.dumps({k: v for k, v in rec.items() if k != "step_losses"}))


if __name__ == "__main__":
    main()

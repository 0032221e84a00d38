"""The pipeline quality bar of ``tests/test_quality_bar.py`` on the port:
build -> train -> export -> ``evaluate(device="cpu")`` reaches BLEU-4 >= 0.9
on a learnable 3-class corpus, and every decode variant (greedy, beam 3,
early stop, int8, the server) agrees on the trained bundle.

The corpus (24 noisy solid-colour 48 px JPEGs, one caption class a colour),
its generator and seed, the split seed and both arms' recipes (32 px rows,
hidden 48, embedding 16, batch 4, 50 epochs of cosine decay; the LSTM at lr
8e-3, the transformer, 2 layers, 4 heads, MLP ratio 2, at 1e-3) are the
original's, through the port's ``dataset_gen``, ``loop.train``,
``evaluate``, ``load_bundle`` and ``CaptionService``, each arm from the
JAX package's initial weights for its seed (``start_from_jax_init``).
"""

import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.data import dataset_gen
from myimagecaptioningmodel_tpu_torch.data import image as image_mod
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as evaluate_mod
from myimagecaptioningmodel_tpu_torch.evaluation import metrics
from myimagecaptioningmodel_tpu_torch.inference import server as server_mod
from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt
from myimagecaptioningmodel_tpu_torch.training import loop

pytestmark = [pytest.mark.slow, pytest.mark.quality]

CLASSES = [
    ((230, 40, 40), "一个 男人 在 打 篮球"),
    ((40, 230, 40), "一只 猫 在 睡觉"),
    ((40, 40, 230), "一个 女人 在 跑步"),
]
ARCHS = {
    "lstm": {"learning_rate": 8e-3, "decoder": {}},
    "transformer": {
        "learning_rate": 1e-3,
        "decoder": {"arch": "transformer", "num_layers": 2, "num_heads": 4,
                    "mlp_ratio": 2},
    },
}


def start_from_jax_init(cfg):
    """Write the JAX package's initial weights for ``cfg.train.seed``
    (``captioner.init(PRNGKey(seed))``, what the original's loop draws) as a
    port checkpoint at epoch 1, step 0, with zero Adam moments: the port's
    ``loop.train`` resumes from it as from its own first step.

    The bars' corpora hold out one image a split (3-class) or 12, and their
    float32 training is chaotic in both packages: one float32 rounding's
    change, or another thread count, draws another trained model, and some
    draws miss the bar. ``tests/quality_draws.py`` runs such draws; PERF.md
    section 7 keeps their counts."""
    opts = jcap.ModelOptions.from_config(jconfig.Config.from_json(cfg.to_json()))
    params, state = jax.tree_util.tree_map(
        np.asarray, jcap.init(jax.random.PRNGKey(cfg.train.seed or 0), opts))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    arrays = ckpt.flatten_tree({"params": params, "model_state": state, "opt_state": {
        "count": np.asarray(0, np.int32), "mu": zeros, "nu": zeros}})
    ckpt.write_checkpoint(os.path.join(cfg.train.checkpoint_path, "checkpoint"), arrays, {
        "next_epoch": 1, "step": 0, "best_bleu": 0.0, "best_meteor": 0.0,
        "train_encoder": cfg.model.encoder.encoder_trainable})


@pytest.fixture(scope="module", params=sorted(ARCHS))
def memorized(request, tmp_path_factory):
    arch = request.param
    root = tmp_path_factory.mktemp(f"quality_{arch}")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(23)
    records = []
    for i in range(24):
        color, phrase = CLASSES[i % 3]
        arr = np.clip(
            np.asarray(color, np.int16)[None, None, :] + rng.randint(-15, 15, (48, 48, 3)),
            0, 255,
        ).astype(np.uint8)
        name = f"img_{i:03d}.jpg"
        Image.fromarray(arr).save(img_dir / name, quality=95)
        records.append({"image_id": name, "caption": [phrase]})
    ann = root / "ann.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")

    out = root / "ds"
    cfg = config_mod.Config.from_dict(
        {
            "build_dataset": {
                "image_paths": [str(img_dir)],
                "annotation_path": str(ann),
                "output_path": str(out),
                "h5_name2idx": str(out / "name2idx.json"),
            },
            "data": {
                "image_shape": [32, 32],
                "dict_path": str(out),
                "h5_path": [str(out)],
                "h5_name2idx": str(out / "name2idx.json"),
                "sample_count": 24,
            },
            "train": {
                "seed": 0,
                "learning_rate": ARCHS[arch]["learning_rate"],
                "batch_size": 4,
                "max_epoch": 50,
                "lr_decay_strategy": "cosine_decay",
                "decay_epoch": 50,
                "log_every_n_step": 50,
                "checkpoint_path": str(root / "save"),
            },
            "model": {
                "decoder": {
                    "vocab_size": 0, "embedding_size": 16,
                    "sentence_length": 0, "hidden_dim": 48,
                    "infer_max_length": 8,
                    **ARCHS[arch]["decoder"],
                },
                "compute_dtype": "float32",
            },
            "log": {"log_path": str(root / "log")},
        }
    )
    summary = dataset_gen.build_all(cfg, segmenter="space", split_seed=0)
    cfg = config_mod.replace_nested(cfg, "model.decoder.vocab_size",
                                    summary["tokenize"]["vocab_size"])
    cfg = config_mod.replace_nested(cfg, "model.decoder.sentence_length",
                                    summary["tokenize"]["max_len"])
    start_from_jax_init(cfg)
    result = loop.train(cfg, device="cpu")
    return cfg, result, img_dir


def test_full_pipeline_reaches_bleu_bar(memorized):
    """dev AND test BLEU-4 >= 0.9, and their mean BLEU too, through the full
    evaluate() path (exported bundle -> decode -> detokenize -> BLEU)."""
    cfg, result, _img_dir = memorized
    assert result["last_epoch_loss"] < 0.3
    for mode in ("dev", "test"):
        res = evaluate_mod.evaluate(cfg, bundle="infer", mode=mode, device="cpu")
        assert res["bleu"][3] >= 0.9, (mode, res["bleu"])
        assert res["bleu"][4] >= 0.9, (mode, res["bleu"])


def test_decode_variants_agree_on_trained_bundle(memorized):
    """greedy / beam-3 / early-stop / int8 / server captions all match on
    the trained (confident) model."""
    cfg, _result, img_dir = memorized

    def scores(**kw):
        res = evaluate_mod.evaluate(cfg, bundle="infer", mode="test", device="cpu", **kw)
        return res["bleu"][3], res["bleu"][4]

    base = scores()
    for kw in ({"beam_size": 3}, {"early_stop": True}, {"quantize": True}):
        np.testing.assert_allclose(scores(**kw), base, atol=1e-6, err_msg=str(kw))

    # the resident server yields the same caption as the offline path
    model, _bcfg, _opts, decode = evaluate_mod.load_bundle(cfg, "infer", device="cpu")
    svc = server_mod.CaptionService(cfg, batch_size=2, max_wait_ms=1.0, device="cpu")
    try:
        for i in (0, 1):
            path = os.path.join(str(img_dir), f"img_{i:03d}.jpg")
            with open(path, "rb") as f:
                served = svc.caption_bytes(f.read())
            arr = image_mod.process_image(
                Image.open(path).convert("RGB"), tuple(cfg.data.image_shape),
                cfg.data.image_mean, cfg.data.image_std)
            ids = decode(model, image_mod.chw_to_nhwc(arr[None]))[0]
            words = metrics.filter_ids(ids.tolist(), svc.index_word, cfg.data.stop_idx,
                                       cfg.data.padding_idx)
            assert served["caption"] == metrics.words2sentence(words)
            # the trained model emits some class phrase verbatim
            assert served["caption"] in {p for _c, p in CLASSES}
    finally:
        svc.close()

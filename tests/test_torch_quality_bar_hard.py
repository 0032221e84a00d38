"""The discriminating quality bar of ``tests/test_quality_bar_hard.py`` on
the port: the 25-class compositional corpus through the port's
``dataset_gen`` -> ``loop.train`` -> export -> ``evaluate(device="cpu")``.

The corpus is the original's own generator (``_make_corpus``, imported
with its constants); the split seed, the recipes and the bars and bands
are the original's too: 250 images of 48 px whose left half's
colour is one of 5 subjects and right half's one of 5 activities,
captions "一个 {subject} 在 {activity}"; hidden 128 / embedding 32, lr 2e-3
cosine over 40 epochs, batch 16, float32. The production-capacity LSTM
must clear dev AND test BLEU-4 >= 0.9 and a capacity-crippled arm (hidden
16 / embedding 16, the same recipe) must land at or below 0.75; int8
weights stay within 0.02 of float; the transformer arm (2 layers, 4 heads,
MLP ratio 2, lr 1e-3) clears the bar with int8 within 0.02 and int8 with
int8 cross-attention memory at no less than float - 0.05; the crippled cut
still passes the old 3-class bar.

Every arm starts from the JAX package's initial weights for its seed, as
the original's do (``test_torch_quality_bar.start_from_jax_init``, whose
docstring says why). The encoder is x1.0, as the original runs: its config writes
``"encoder_scale": 0.35`` under ``model``, where neither package's config
has that field (it is ``model.encoder.encoder_scale``), so the loader drops
it, whatever its docstring says. At x0.35 this corpus does not
discriminate: on the port (CPU) the full arm reached dev BLEU-4 0.953, and
the crippled arm 0.769 dev / 0.617 test, above the 0.75 it must stay under.
"""

import json

import numpy as np
import pytest
from PIL import Image

from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.data import dataset_gen
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as evaluate_mod
from myimagecaptioningmodel_tpu_torch.training import loop
from test_quality_bar_hard import EPOCHS, N_IMAGES, SUBJECTS, _make_corpus
from test_torch_quality_bar import start_from_jax_init

pytestmark = [pytest.mark.slow, pytest.mark.quality]


def _cfg(root, ds, img_dir, ann, hidden, emb, tag, arch=None, lr=2e-3, epochs=EPOCHS):
    decoder = {
        "vocab_size": 0,
        "embedding_size": emb,
        "sentence_length": 0,
        "hidden_dim": hidden,
        "infer_max_length": 10,
    }
    if arch == "transformer":
        decoder.update({"arch": "transformer", "num_layers": 2, "num_heads": 4,
                        "mlp_ratio": 2})
        lr = 1e-3
    return config_mod.Config.from_dict(
        {
            "build_dataset": {
                "image_paths": [str(img_dir)],
                "annotation_path": str(ann),
                "output_path": str(ds),
                "h5_name2idx": str(ds / "name2idx.json"),
            },
            "data": {
                "image_shape": [48, 48],
                "dict_path": str(ds),
                "h5_path": [str(ds)],
                "h5_name2idx": str(ds / "name2idx.json"),
                "sample_count": N_IMAGES,
            },
            "train": {
                "seed": 0,
                "learning_rate": lr,
                "batch_size": 16,
                "max_epoch": epochs,
                "lr_decay_strategy": "cosine_decay",
                "decay_epoch": epochs,
                "log_every_n_step": 100,
                "checkpoint_path": str(root / f"save_{tag}"),
            },
            "model": {
                "decoder": decoder,
                "compute_dtype": "float32",
            },
            "log": {"log_path": str(root / f"log_{tag}")},
        }
    )


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality_hard")
    img_dir, ann = _make_corpus(root)
    ds = root / "ds"
    cfg0 = _cfg(root, ds, img_dir, ann, hidden=128, emb=32, tag="probe")
    summary = dataset_gen.build_all(cfg0, segmenter="space", split_seed=0)
    return root, ds, img_dir, ann, summary


def _train(corpus, hidden, emb, tag, arch=None):
    root, ds, img_dir, ann, summary = corpus
    cfg = _cfg(root, ds, img_dir, ann, hidden=hidden, emb=emb, tag=tag, arch=arch)
    cfg = config_mod.replace_nested(cfg, "model.decoder.vocab_size",
                                    summary["tokenize"]["vocab_size"])
    cfg = config_mod.replace_nested(cfg, "model.decoder.sentence_length",
                                    summary["tokenize"]["max_len"])
    start_from_jax_init(cfg)
    result = loop.train(cfg, device="cpu")
    assert np.isfinite(result["last_epoch_loss"])
    return cfg


def _bleu4(cfg, **kw):
    return {mode: evaluate_mod.evaluate(cfg, bundle="infer", mode=mode, device="cpu",
                                        **kw)["bleu"][3]
            for mode in ("dev", "test")}


@pytest.fixture(scope="module")
def full_arm(corpus):
    """The production-capacity LSTM arm, trained once and shared by the
    discrimination test and the int8 band."""
    return _train(corpus, hidden=128, emb=32, tag="full")


@pytest.fixture(scope="module")
def transformer_arm(corpus):
    """The transformer-family arm on the same corpus."""
    return _train(corpus, hidden=128, emb=32, tag="tf", arch="transformer")


def test_compositional_bar_discriminates(corpus, full_arm):
    """The full-capacity model clears the bar; the capacity-crippled mutant,
    trained with the same recipe on the same corpus, lands below it."""
    full = _bleu4(full_arm)
    for mode in ("dev", "test"):
        assert full[mode] >= 0.9, (mode, full)

    crippled = _bleu4(_train(corpus, hidden=16, emb=16, tag="crippled"))
    for mode in ("dev", "test"):
        assert crippled[mode] <= 0.75, (mode, crippled)


def test_int8_band_lstm(full_arm):
    """int8 decoder weights move BLEU-4 by at most 0.02 on both splits."""
    base = _bleu4(full_arm)
    q = _bleu4(full_arm, quantize=True)
    for mode in ("dev", "test"):
        assert abs(q[mode] - base[mode]) <= 0.02, (mode, base, q)


def test_transformer_bar_and_serving_bands(transformer_arm):
    """The transformer clears the bar; int8 weights within 0.02 of float;
    int8 weights with int8 cross-attention memory (approximate by design)
    at no less than float - 0.05."""
    base = _bleu4(transformer_arm)
    for mode in ("dev", "test"):
        assert base[mode] >= 0.9, (mode, base)
    q8 = _bleu4(transformer_arm, quantize=True)
    q8kv = _bleu4(transformer_arm, quantize=True, quantize_kv=True)
    for mode in ("dev", "test"):
        assert abs(q8[mode] - base[mode]) <= 0.02, (mode, base, q8)
        assert q8kv[mode] >= base[mode] - 0.05, (mode, base, q8kv)


def test_crippled_mutant_passes_old_bar(tmp_path):
    """The same capacity cut (hidden 16 / embedding 16) on the old 3-class
    bar's recipe (32 px, the x1.0 encoder, lr 8e-3, 50 epochs) still clears
    that bar: the compositional bar is the more sensitive one. With one dev
    and one test image the claim rests on the initial draw."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(23)
    three = [
        (SUBJECTS[0][0], "一个 男人 在 打 篮球"),
        (SUBJECTS[2][0], "一只 猫 在 睡觉"),
        (SUBJECTS[1][0], "一个 女人 在 跑步"),
    ]
    records = []
    for i in range(24):
        color, phrase = three[i % 3]
        arr = np.clip(
            np.asarray(color, np.int16)[None, None, :] + rng.randint(-15, 15, (48, 48, 3)),
            0, 255,
        ).astype(np.uint8)
        name = f"img_{i:03d}.jpg"
        Image.fromarray(arr).save(img_dir / name, quality=95)
        records.append({"image_id": name, "caption": [phrase]})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    ds = tmp_path / "ds"
    cfg = config_mod.Config.from_dict(
        {
            "build_dataset": {
                "image_paths": [str(img_dir)],
                "annotation_path": str(ann),
                "output_path": str(ds),
                "h5_name2idx": str(ds / "name2idx.json"),
            },
            "data": {
                "image_shape": [32, 32],
                "dict_path": str(ds),
                "h5_path": [str(ds)],
                "h5_name2idx": str(ds / "name2idx.json"),
                "sample_count": 24,
            },
            "train": {
                "seed": 0,
                "learning_rate": 8e-3,
                "batch_size": 4,
                "max_epoch": 50,
                "lr_decay_strategy": "cosine_decay",
                "decay_epoch": 50,
                "log_every_n_step": 50,
                "checkpoint_path": str(tmp_path / "save_old3"),
            },
            "model": {
                "decoder": {
                    "vocab_size": 0, "embedding_size": 16,
                    "sentence_length": 0, "hidden_dim": 16,
                    "infer_max_length": 8,
                },
                "compute_dtype": "float32",
            },
            "log": {"log_path": str(tmp_path / "log_old3")},
        }
    )
    summary = dataset_gen.build_all(cfg, segmenter="space", split_seed=0)
    cfg = config_mod.replace_nested(cfg, "model.decoder.vocab_size",
                                    summary["tokenize"]["vocab_size"])
    cfg = config_mod.replace_nested(cfg, "model.decoder.sentence_length",
                                    summary["tokenize"]["max_len"])
    start_from_jax_init(cfg)
    result = loop.train(cfg, device="cpu")
    assert np.isfinite(result["last_epoch_loss"]) and result["final_step"] == 50 * 5
    for mode in ("dev", "test"):
        res = evaluate_mod.evaluate(cfg, bundle="infer", mode=mode, device="cpu")
        assert res["bleu"][3] >= 0.9, (mode, res["bleu"])

"""The pretrained-encoder load through the port's training loop (reference
train.py:96-99, 103-107) against the JAX package's
(``tests/test_pretrained_encoder.py``), on the CPU.

``test_pretrained_encoder.py``'s scenario: four noise JPEGs of 40 px, one
caption, 32 px rows, hidden 16, embedding 8, batch 2, the encoder frozen
and the learning rate 0 (so what a run writes is what it loaded), the
"pretrained" encoder ``mobilenet_v2.init(PRNGKey(42))``; float64 on both
sides (JAX under x64), where the original runs float32: at 32 px and batch
2 the last BN layers normalize over two values a channel, and a pair close
to equal turns float32 rounding into moving statistics that differ by the
size of the statistic (1.86x of a leaf's largest in a float32 run here). The JAX
package's build feeds both loops (its shards converted,
``convert_jax_shards``); the pretrained files are the JAX package's
msgpack and the same values written with the port's ``save_params``. Both
loops run the same two legs:

1. a first run (1 epoch): the encoder is grafted on first init;
2. a resume (epoch 2) with the encoder unfrozen and
   ``pretrained_mobilenet_path`` pointing at a second file
   (``PRNGKey(43)``): the freeze flipped, so the encoder is reloaded from
   it; the port also runs a resume that keeps the encoder frozen, which
   reloads nothing.

Held on the port's checkpoints: every encoder weight (conv and BN affine)
is the file's bit for bit, and the decoder and the image projections are
the port's own init, untouched by either graft. Against the JAX loop's
checkpoints of the two legs (``convert_jax_checkpoint``): the encoder
weights equal, the encoder's BN moving statistics (train-mode BN runs while
the weights stay frozen) within ``STATE_RTOL`` of each leaf's largest value
plus ``STATE_ATOL``, and the meta (``train_encoder``, step, next epoch)
equal. The JAX package takes BN statistics in float32 even under x64: the
statistics read at most 2.6e-8 of a leaf's largest apart here, below one
float32 rounding; the expand convs' moving means are rounding noise around
0 (their inputs are BN outputs with offset 0, zero-mean over the batch:
1e-17 here), which the floor covers.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.data import dataset_gen as jdg
from myimagecaptioningmodel_tpu.models import mobilenet_v2 as jmnv2
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu.training import loop as jloop
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.compat.from_jax import read_msgpack, to_numpy, tree_to_torch
from myimagecaptioningmodel_tpu_torch.data import shards as tshards
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from myimagecaptioningmodel_tpu_torch.training import loop as tloop
from test_torch_loop import float64_jax

STATE_RTOL, STATE_ATOL = 2.0 ** -23, 1e-12
# leg -> (pretrained key, encoder trainable, epochs); the JAX loop runs the
# first two (the frozen resume, which reloads nothing, is the port's control)
LEGS = ("first", "unfrozen", "frozen")
LEG_SETUP = {"first": (42, False, 1), "unfrozen": (43, True, 2), "frozen": (43, False, 2)}
JAX_LEGS = ("first", "unfrozen")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_cfg(root, run, pretrained, trainable, epochs):
    out = root / "ds"
    return jconfig.Config.from_dict({
        "build_dataset": {"image_paths": [str(root / "images")],
                          "annotation_path": str(root / "ann.json"), "output_path": str(out),
                          "h5_name2idx": str(out / "name2idx.json")},
        "data": {"image_shape": [32, 32], "dict_path": str(out), "h5_path": [str(out)],
                 "h5_name2idx": str(out / "name2idx.json"),
                 "pretrained_mobilenet_path": pretrained},
        "train": {"seed": 0, "learning_rate": 0.0, "batch_size": 2, "max_epoch": epochs,
                  "checkpoint_path": str(root / run / "save"), "export_infer_model": False},
        "model": {"encoder": {"encoder_trainable": trainable},
                  "decoder": {"vocab_size": 16, "embedding_size": 8, "sentence_length": 6,
                              "hidden_dim": 16, "infer_max_length": 6,
                              "vocab_pad_multiple": 1},
                  "compute_dtype": "float64"},
        "log": {"log_path": str(root / run / "log")},
    })


def port_cfg(jcfg, pretrained, root):
    cfg = tconfig.Config.from_json(jcfg.to_json())
    for path, value in (("data.pretrained_mobilenet_path", pretrained),
                        ("data.h5_path", (str(root / "ds_port"),)),
                        ("data.h5_name2idx", str(root / "ds_port" / "name2idx.json"))):
        cfg = tconfig.replace_nested(cfg, path, value)
    return cfg


def with_vocab(cfg, tokenize):
    cfg = jconfig.replace_nested(cfg, "model.decoder.vocab_size", tokenize["vocab_size"])
    return jconfig.replace_nested(cfg, "model.decoder.sentence_length", tokenize["max_len"])


def read_checkpoint(directory):
    """A port checkpoint -> (params, model_state, meta), numpy, reference layout."""
    with np.load(os.path.join(directory, tckpt.CKPT_FILE)) as z:
        tree = tckpt.unflatten_tree({k: z[k] for k in z.files})
    with open(os.path.join(directory, tckpt.META_FILE), encoding="utf-8") as f:
        return tree["params"], tree["model_state"], json.load(f)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def run_legs(root):
    """Both loops' legs -> ({leg: (JAX ckpt or None, port ckpt)}, {key:
    pretrained encoder}, the port's own init as numpy)."""
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(0)
    records = []
    for i in range(4):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            root / "images" / name)
        records.append({"image_id": name, "caption": ["一个 人 在 散步"]})
    (root / "ann.json").write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")

    files, encoders = {}, {}
    for key in (42, 43):
        enc, _ = jmnv2.init(jax.random.PRNGKey(key))
        encoders[key] = jax.tree_util.tree_map(np.asarray, enc)
        jpath = str(root / f"pretrained_{key}.msgpack")
        jckpt.save_params(jpath, enc)
        tpath = str(root / f"pretrained_{key}.npz")
        tckpt.save_params(tpath, tree_to_torch(read_msgpack(jpath)))
        files[key] = (jpath, tpath)

    summary = jdg.build_all(jax_cfg(root, "probe", "", False, 1), segmenter="space",
                            split_seed=0)
    tshards.convert_jax_shards([str(root / "ds")], str(root / "ds_port"))
    out = {}
    for leg in LEGS:
        key, trainable, epochs = LEG_SETUP[leg]
        sides = ("jax", "port") if leg in JAX_LEGS else ("port",)
        if leg != "first":  # a resume continues a copy of the first leg's run
            for side in sides:
                for part in ("save", "log"):
                    shutil.copytree(root / f"{side}_first" / part, root / f"{side}_{leg}" / part)
        jax_ckpt = None
        if "jax" in sides:
            jcfg = with_vocab(jax_cfg(root, f"jax_{leg}", files[key][0], trainable, epochs),
                              summary["tokenize"])
            with pytest.MonkeyPatch.context() as mp, float64_jax(mp):
                jloop.train(jcfg, mesh=None)
            jdir = str(root / f"jax_{leg}" / "converted")
            tckpt.convert_jax_checkpoint(os.path.join(jcfg.train.checkpoint_path, "checkpoint"),
                                         jdir)
            jax_ckpt = read_checkpoint(jdir)
        tcfg = port_cfg(with_vocab(jax_cfg(root, f"port_{leg}", "", trainable, epochs),
                                   summary["tokenize"]), files[key][1], root)
        tloop.train(tcfg, device="cpu")
        out[leg] = (jax_ckpt,
                    read_checkpoint(os.path.join(tcfg.train.checkpoint_path, "checkpoint")))
    init = tcap.init(torch.Generator().manual_seed(0), tcap.ModelOptions.from_config(tcfg))[0]
    return out, encoders, {k: leaves(v) for k, v in to_numpy(init).items()}


def test_pretrained_encoder_graft_and_reload(tmp_path):
    """One test: the loops' runs are its expensive part, and every check
    reads them (split over test workers, each would run them)."""
    out, encoders, init = run_legs(tmp_path / "pretrained")
    for leg in LEGS:
        check_encoder_grafted_and_decoder_untouched(out, encoders, init, leg)
    for leg in JAX_LEGS:
        check_checkpoint_matches_the_jax_loop(out, leg)


def check_encoder_grafted_and_decoder_untouched(out, encoders, init, leg):
    key, trainable, epochs = LEG_SETUP[leg]
    # the frozen resume reloads nothing: the encoder stays the first file's
    want_key = 42 if leg == "frozen" else key
    params, _state, meta = out[leg][1]
    got, want = leaves(params["encoder"]), leaves(encoders[want_key])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    other = leaves(encoders[43 if want_key == 42 else 42])
    assert not np.array_equal(got["conv1_1/conv/w"], other["conv1_1/conv/w"])
    for part in ("decoder", "img_embed", "img_global"):
        mine = leaves(params[part])
        assert sorted(mine) == sorted(init[part])
        for k in mine:
            np.testing.assert_array_equal(mine[k], init[part][k], err_msg=f"{part}/{k}")
    assert meta["train_encoder"] is trainable and meta["next_epoch"] == epochs + 1


def check_checkpoint_matches_the_jax_loop(out, leg):
    (jp, js, jmeta), (tp, ts, tmeta) = out[leg]
    got, want = leaves(tp["encoder"]), leaves(jp["encoder"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = leaves(ts["encoder"]), leaves(js["encoder"])
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        tol = STATE_RTOL * np.abs(want[k]).max() + STATE_ATOL
        assert np.abs(got[k] - want[k]).max() <= tol, k
        moved += not np.array_equal(want[k], np.zeros_like(want[k])) and "mean" in k
    assert moved > 0  # the moving means left their init
    for field in ("train_encoder", "step", "next_epoch"):
        assert tmeta[field] == jmeta[field], field

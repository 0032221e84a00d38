"""The port's batch captioning (``inference/batch_caption.py``) against the
JAX package's, on the CPU.

A JAX bundle of each decoder family (weights from the port's seeded init,
spread BN statistics so that images caption differently; LSTM and a
2-layer transformer, small widths, float32), exported by the JAX package
and converted with ``convert_jax_bundle``, captions one directory: 10 small
RGB images (JPEG and PNG, one with an upper-case extension), a corrupt file,
a grayscale image and a text file that is not listed. At batch 4, so the
last batch is padded. The port's ``caption_directory`` returns the JAX
package's records (the undecodable and grayscale images as error records,
in path order) and writes a byte-equal jsonl, greedy and beam 3, both
families. ``caption_arrays`` takes its items in any order. The CLI runs in
a subprocess with ``jax`` and the JAX package blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.inference import batch_caption as jbc
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
from myimagecaptioningmodel_tpu_torch.inference import batch_caption as tbc
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
VOCAB, BATCH = 300, 4
ARCHS = {"lstm": (), "transformer": (("model.decoder.arch", "transformer"),
                                     ("model.decoder.num_layers", 2),
                                     ("model.decoder.num_heads", 2),
                                     ("model.decoder.mlp_ratio", 2))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cfg(root, arch):
    cfg = config_mod.Config()
    for path, v in [("model.decoder.vocab_size", VOCAB), ("model.decoder.embedding_size", 32),
                    ("model.decoder.hidden_dim", 64), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.infer_max_length", 6), ("model.decoder.sentence_length", 6),
                    ("model.compute_dtype", "float32"), ("data.image_shape", (64, 64)),
                    ("train.checkpoint_path", os.path.join(root, "save")),
                    ("data.dict_path", os.path.join(root, "dataset")), *ARCHS[arch]]:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


def _numpy(tree):
    """torch tree -> numpy, lists as the JAX package's tuples."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_numpy(v) for v in tree)
    return tree.numpy()


def write_images(image_dir):
    from PIL import Image

    image_dir.mkdir()
    rng = np.random.RandomState(3)
    for i in range(10):
        size = (40 + 4 * i, 56 - 2 * i)
        arr = rng.randint(0, 255, (size[1], size[0], 3), np.uint8)
        name = f"img{i:02d}" + (".JPG" if i == 7 else ".png" if i % 3 == 0 else ".jpg")
        Image.fromarray(arr).save(image_dir / name)
    Image.fromarray(rng.randint(0, 255, (48, 48), np.uint8)).save(image_dir / "gray.png")
    (image_dir / "corrupt.jpg").write_bytes(b"not a jpeg" * 10)
    (image_dir / "notes.txt").write_text("not an image")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{arch: (JAX cfg, port cfg)} sharing one image directory."""
    root = tmp_path_factory.mktemp("batch_caption")
    write_images(root / "images")
    out = {}
    for arch in ARCHS:
        jcfg = small_cfg(str(root / arch / "jax"), arch)
        opts = tcap.ModelOptions.from_config(jcfg)
        params, state = map(_numpy, tcap.init(torch.Generator().manual_seed(5), opts))
        rng = np.random.RandomState(5)
        for s in state["encoder"].values():
            n = s["bn"]["mean"].shape[0]
            s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
            s["bn"]["var"] = rng.rand(n).astype(np.float32) * 0.3 + 0.3
        os.makedirs(jcfg.data.dict_path)
        words = ["<pad>", "<unk>", "<start>", "<stop>"] + [f"w{i}" for i in range(4, VOCAB)]
        np.save(os.path.join(jcfg.data.dict_path, "word_dict.npy"),
                np.array([{w: i for i, w in enumerate(words)}, dict(enumerate(words))],
                         dtype=object), allow_pickle=True)
        jbundle = os.path.join(jcfg.train.checkpoint_path, "infer")
        jckpt.export_inference_bundle(jbundle, params, state, jcfg,
                                      vocab_src_dir=jcfg.data.dict_path)
        tcfg = config_mod.replace_nested(small_cfg(str(root / arch / "port"), arch),
                                         "data.dict_path", jcfg.data.dict_path)
        tckpt.convert_jax_bundle(jbundle, os.path.join(tcfg.train.checkpoint_path, "infer"))
        out[arch] = (jcfg, tcfg)
    return root, out


@pytest.mark.parametrize("beam", [0, 3])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_caption_directory_equals_jax(bundles, arch, beam):
    root, cfgs = bundles
    jcfg, tcfg = cfgs[arch]
    jout, tout = root / f"jax_{arch}_{beam}.jsonl", root / f"port_{arch}_{beam}.jsonl"
    want = jbc.caption_directory(jcfg, str(root / "images"), str(jout), BATCH, beam)
    got = tbc.caption_directory(tcfg, str(root / "images"), str(tout), BATCH, beam,
                                device="cpu")
    assert got == want
    assert tout.read_bytes() == jout.read_bytes()
    names = [r["image"] for r in got]
    assert names == sorted(names) and len(names) == 12 and "notes.txt" not in names
    errors = {r["image"] for r in got if "error" in r}
    assert errors == {"corrupt.jpg", "gray.png"}
    assert len({tuple(r["ids"]) for r in got if "ids" in r}) > 1, "captions should differ"


def test_caption_arrays_any_order_and_padding(bundles):
    """Items out of order, an undecodable one among them, at a batch that
    leaves a padded last batch: records in index order, ids equal to one
    decode of all rows."""
    _root, cfgs = bundles
    _jcfg, tcfg = cfgs["lstm"]
    model, _bc, _opts, decode = load_bundle(tcfg, device="cpu")
    index_word = DataReader(tcfg).index_word
    rng = np.random.RandomState(0)
    arrays = rng.rand(7, 3, 64, 64).astype(np.float32)
    order = [4, 0, 6, 2, 5, 1, 3]
    items = [(i, f"d/{i}.jpg", None if i == 5 else arrays[i]) for i in order]
    records = tbc.caption_arrays(tcfg, items, model, decode, index_word, batch_size=BATCH)
    assert [r["image"] for r in records] == [f"{i}.jpg" for i in range(7)]
    assert records[5] == {"image": "5.jpg", "error": "undecodable"}
    keep = [i for i in range(7) if i != 5]
    want = decode(model, np.ascontiguousarray(arrays[keep].transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_array_equal([records[i]["ids"] for i in keep], want)


def test_caption_arrays_stages_nhwc_batches_zero_padded(bundles):
    """What the decode is handed: 10 items at batch 4 give three batches of
    4 NHWC rows in arrival order, the last one's 2 spare rows zero, though
    its buffer held a full batch before."""
    _root, cfgs = bundles
    _jcfg, tcfg = cfgs["lstm"]
    rng = np.random.RandomState(1)
    arrays = rng.rand(10, 3, 64, 64).astype(np.float32)
    order = [3, 9, 0, 7, 1, 8, 2, 6, 4, 5]
    seen = []

    class Model:
        device = torch.device("cpu")

    def decode(_model, imgs):
        seen.append(imgs.clone())
        return torch.zeros((imgs.shape[0], 6), dtype=torch.int32)

    records = tbc.caption_arrays(tcfg, [(i, f"{i}.jpg", arrays[i]) for i in order], Model(),
                                 decode, DataReader(tcfg).index_word, batch_size=BATCH)
    assert [r["image"] for r in records] == [f"{i}.jpg" for i in range(10)]
    assert [tuple(b.shape) for b in seen] == [(BATCH, 64, 64, 3)] * 3
    for k, batch in enumerate(seen):
        rows = order[k * BATCH:(k + 1) * BATCH]
        want = np.zeros((BATCH, 64, 64, 3), np.float32)
        want[:len(rows)] = arrays[rows].transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(batch.numpy(), want)


def test_cli_without_jax(bundles, tmp_path):
    root, cfgs = bundles
    jcfg, tcfg = cfgs["transformer"]
    (tmp_path / "cfg.json").write_text(tcfg.to_json())
    out = tmp_path / "captions.jsonl"
    blocked = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu")
    module = "myimagecaptioningmodel_tpu_torch.inference.batch_caption"
    args = [str(root / "images"), "--out", str(out), "--config", str(tmp_path / "cfg.json"),
            "--batch", str(BATCH), "--device", "cpu"]
    code = (f"import runpy, sys\nfor name in {blocked!r}:\n    sys.modules[name] = None\n"
            f"sys.argv = [{module!r}] + {args!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(REPO),
                                         "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "captioned 12 images" in r.stderr
    want = jbc.caption_directory(jcfg, str(root / "images"), None, BATCH, 0)
    assert [json.loads(line) for line in out.read_text().splitlines()] == want

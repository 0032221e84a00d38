"""The port's frozen serving artifact (``inference/export_program.py``,
``torch.export``) against the JAX package's (``export_stablehlo``), on the
CPU.

A bundle trained by the JAX package's ``loop.train`` (the corpus of
``test_feed_pipeline``, hidden 16, 24 px, MobileNetV2 x0.35, 6 decode steps) is converted with
``convert_jax_bundle`` and exported by the port, five ways: greedy (through
the ``python -m`` CLI, with jax and the JAX package blocked), early-stop
greedy, beam 3, the uint8 NCHW input contract, and ``--quantize``. Each
``.pt2`` is reloaded in one subprocess where the port, the JAX package and
jax are all blocked (``torch.export.load(path).module()(images)``), and its
ids must equal, id for id:

- the JAX artifact's on the same inputs (``export.deserialize(...).call``,
  as ``tests/test_export_stablehlo.py`` makes it; the early-stop ids against
  the JAX greedy artifact's with every position after a row's first
  ``<stop>`` set to ``<pad>``, the fill the JAX decode's early stop makes);
- the port's own eager decode of the bundle (``load_bundle``, early stop
  with its loop that ends once every row is done).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.data import dataset_gen
from myimagecaptioningmodel_tpu.inference import export_stablehlo as jex
from myimagecaptioningmodel_tpu.training import loop as jloop
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
from myimagecaptioningmodel_tpu_torch.inference import export_program as tex
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from test_feed_pipeline import build_corpus, make_cfg, patch_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN, BATCH = 6, 2
# name -> (beam, input dtype, quantize, early stop)
CASES = {"greedy": (0, "float32", False, False), "early_stop": (0, "float32", False, True),
         "beam3": (3, "float32", False, False), "uint8": (0, "uint8", False, False),
         "quantize": (0, "float32", True, False)}
BLOCK_JAX = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu")
BLOCK_ALL = BLOCK_JAX + ("myimagecaptioningmodel_tpu_torch",)
RUN_ENV = {"PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(code, timeout):
    env = {**os.environ, **RUN_ENV}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _blocked(names):
    return f"import sys\nfor name in {names!r}:\n    sys.modules[name] = None\n"


def inputs(name):
    rng = np.random.RandomState(sorted(CASES).index(name))
    if CASES[name][1] == "uint8":
        return rng.randint(0, 256, (BATCH, 3, 24, 24), np.uint8)
    return rng.rand(BATCH, 24, 24, 3).astype(np.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX cfg, port cfg): a JAX-trained bundle ``infer`` and its port
    conversion ``port_infer`` under one checkpoint path."""
    root = tmp_path_factory.mktemp("export")
    img_dir, ann = build_corpus(root)
    cfg = make_cfg(root, img_dir, ann, "exp", export_infer_model=True)
    cfg = patch_vocab(cfg, dataset_gen.build_all(cfg, segmenter="space", split_seed=0))
    cfg = jconfig.replace_nested(cfg, "model.decoder.infer_max_length", MAX_LEN)
    cfg = jconfig.replace_nested(cfg, "model.encoder.encoder_scale", 0.35)  # a narrow encoder
    jloop.train(cfg, mesh=None)
    ck = cfg.train.checkpoint_path
    tckpt.convert_jax_bundle(os.path.join(ck, "infer"), os.path.join(ck, "port_infer"))
    return cfg, tconfig.Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def reloaded(trained, tmp_path_factory):
    """Each case's port artifact (greedy through the CLI, jax blocked) ->
    its ids, reloaded and run where the port and jax cannot be imported."""
    jcfg, tcfg = trained
    out = tmp_path_factory.mktemp("pt2")
    cfg_path = out / "cfg.json"
    cfg_path.write_text(json.dumps(tcfg.to_dict()), encoding="utf-8")
    bundle = os.path.join(tcfg.train.checkpoint_path, "port_infer")
    printed = _run(_blocked(BLOCK_JAX) + (
        "import runpy\n"
        f"sys.argv = ['x', {bundle!r}, {str(out / 'greedy.pt2')!r}, '--config', "
        f"{str(cfg_path)!r}, '--batch', '{BATCH}', '--device', 'cpu']\n"
        "runpy.run_module('myimagecaptioningmodel_tpu_torch.inference.export_program', "
        "run_name='__main__')\n"), timeout=300)
    assert "bytes" in printed and "int32" in printed, printed
    for name, (beam, dtype, quantize, early) in CASES.items():
        np.save(out / f"{name}.npy", inputs(name))
        if name != "greedy":
            ep = tex.export_decode(tcfg, "port_infer", BATCH, beam, "cpu", dtype, quantize, early)
            assert tex.export_to_file(str(out / f"{name}.pt2"), ep) > 1000
    _run(_blocked(BLOCK_ALL) + (
        "import numpy as np, torch\n"
        f"for name in {list(CASES)!r}:\n"
        f"    x = torch.from_numpy(np.load({str(out)!r} + f'/{{name}}.npy'))\n"
        f"    prog = torch.export.load({str(out)!r} + f'/{{name}}.pt2').module()\n"
        f"    np.save({str(out)!r} + f'/{{name}}_ids.npy', prog(x).numpy())\n"), timeout=300)
    return {name: np.load(out / f"{name}_ids.npy") for name in CASES}


def _jax_ids(jcfg, name):
    beam, dtype, quantize, _early = CASES[name]
    exported = jex.export_decode(jcfg, "infer", BATCH, beam, ["cpu"], dtype, quantize)
    return np.asarray(jax.export.deserialize(exported.serialize()).call(inputs(name)))


def _early_fill(ids, stop=3, pad=0):
    ids = ids.copy()
    for row in ids:
        hit = np.flatnonzero(row == stop)
        if hit.size:
            row[hit[0] + 1:] = pad
    return ids


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_equals_jax_artifact_and_eager_decode(trained, reloaded, name):
    jcfg, tcfg = trained
    beam, _dtype, quantize, early = CASES[name]
    got = reloaded[name]
    assert got.dtype == np.int32 and got.shape == (BATCH, MAX_LEN)
    want = _jax_ids(jcfg, name)
    if early:
        want = _early_fill(want, tcfg.data.stop_idx, tcfg.data.padding_idx)
    np.testing.assert_array_equal(got, want)
    model, _bcfg, _opts, decode = load_bundle(tcfg, "port_infer", beam, quantize=quantize,
                                              early_stop=early, device="cpu")
    np.testing.assert_array_equal(got, decode(model, inputs(name)).numpy())

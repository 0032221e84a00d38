"""The port stands alone: it imports nothing of JAX or of the JAX package,
keeps its own copy of the config with the same fields and defaults, and its
entry points need a card unless the caller asks for the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.data import image as jimage
from myimagecaptioningmodel_tpu.evaluation import metrics as jmetrics
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch import parity_run as tparity
from myimagecaptioningmodel_tpu_torch.compat import from_jax
from myimagecaptioningmodel_tpu_torch.data import image as timage
from myimagecaptioningmodel_tpu_torch.evaluation import metrics as tmetrics
from myimagecaptioningmodel_tpu_torch.evaluate import main as tevaluate_main
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import evaluate as tevaluate
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
from myimagecaptioningmodel_tpu_torch.inference import batch_caption as tbatch
from myimagecaptioningmodel_tpu_torch.inference import export_program as texport
from myimagecaptioningmodel_tpu_torch.inference import infer as tinfer
from myimagecaptioningmodel_tpu_torch.inference.server import CaptionService
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.train import main as ttrain_main
from myimagecaptioningmodel_tpu_torch.training import loop as tloop

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "myimagecaptioningmodel_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu")
# and what the card's machine lacks besides: the port imports these only
# inside the functions that need them
CARD_MISSING = ("h5py", "PIL", "msgpack", "jieba", "pkuseg")

IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import myimagecaptioningmodel_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke, chip_fault_check, chip_probe
print(" ".join(names))
"""


def import_all(blocked):
    return subprocess.run([sys.executable, "-c", IMPORT_ALL.format(blocked=blocked)], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})


def test_port_imports_with_jax_and_the_jax_package_blocked():
    out = import_all(BLOCKED)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20
    # the modules of kernels G, D/E and B, their decode graphs, the int8
    # transformer, the fused encoder, batch captioning, data and vocab tensor
    # parallelism, the Paddle import, the serving export, the parity kit and
    # the graft entry points
    for name in ("ops.kernels.fused_irb", "ops.kernels.fused_transformer",
                 "ops.kernels.fused_step", "ops.kernels.decode_graphs",
                 "models.transformer", "models.mobilenet_v2", "inference.batch_caption",
                 "parallel.distributed", "parallel.mesh", "parallel.vocab_parallel",
                 "compat.paddle_fmt", "compat.paddle_import", "inference.export_program",
                 "ops.kernels.attention", "parity_run", "graft_entry",
                 "utils.tracing"):
        assert "myimagecaptioningmodel_tpu_torch." + name in names


def test_port_imports_without_the_packages_the_card_lacks():
    """h5py, PIL, msgpack, jieba and pkuseg blocked too: every module of the
    port (the data plane, the loop, the entry points) and the card scripts
    still import."""
    out = import_all(BLOCKED + CARD_MISSING)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    for name in ("data.shards", "data.reader", "data.feeder", "data.dataset_gen",
                 "data.tokenizer", "data.segmenter", "native", "training.loop",
                 "training.checkpoint", "evaluation.cider", "train", "evaluate",
                 "dataset_gen", "inference.batch_caption", "parallel.distributed",
                 "parallel.mesh", "parallel.train_step", "parallel.vocab_parallel",
                 "compat.paddle_import", "inference.export_program", "parity_run"):
        assert "myimagecaptioningmodel_tpu_torch." + name in names


def test_no_source_line_imports_jax_or_the_jax_package():
    """Imports inside functions too: every line of the port and of the
    scripts that drive it on the card."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"myimagecaptioningmodel_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [REPO / name for name in (
        "chip_smoke.py", "chip_fault_check.py", "chip_probe.py")]
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad


def test_config_matches_the_jax_package():
    assert tconfig.Config().to_dict() == jconfig.Config().to_dict()
    cfg = jconfig.replace_nested(jconfig.Config(), "model.fuse_bn_stats", True)
    cfg = jconfig.replace_nested(cfg, "data.image_shape", (64, 64))
    port = tconfig.Config.from_json(cfg.to_json())
    assert json.loads(port.to_json()) == json.loads(cfg.to_json())
    assert port.model.fuse_bn_stats and port.data.image_shape == (64, 64)
    assert tconfig.replace_nested(port, "train.batch_size", 4).train.batch_size == 4


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.replace_nested(tconfig.Config(), "train.checkpoint_path", str(tmp_path))
    for call in (lambda: load_bundle(cfg), lambda: CaptionService(cfg),
                 lambda: tinfer.caption_array(cfg, None),
                 lambda: from_jax.captioner_from_tree({}, {}, None),
                 lambda: from_jax.train_tree({}, {}),
                 lambda: tloop.train(cfg), lambda: tevaluate(cfg),
                 lambda: ttrain_main([]), lambda: tevaluate_main([]),
                 lambda: tbatch.caption_directory(cfg, str(tmp_path)),
                 lambda: tbatch.main([str(tmp_path)]),
                 lambda: texport.export_decode(cfg),
                 lambda: tparity.main(["--workdir", str(tmp_path / "kit")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tcap.resolve_device("cpu") == torch.device("cpu")
    # asked for the CPU, load_bundle goes on to look for the bundle
    with pytest.raises(FileNotFoundError):
        load_bundle(cfg, device="cpu")


def test_metrics_and_image_copies_match_the_jax_package():
    from PIL import Image

    rng = np.random.RandomState(0)
    index_word = {i: f"w{i}" for i in range(20)}
    pred = rng.randint(0, 20, (6, 9))
    pred[0, 3] = 3  # a <stop> mid-caption
    for ids in pred:
        assert tmetrics.filter_ids(ids, index_word) == jmetrics.filter_ids(ids, index_word)
    words = tmetrics.filter_ids(pred[1], index_word)
    assert tmetrics.words2sentence(words) == jmetrics.words2sentence(words)
    img = Image.fromarray(rng.randint(0, 255, (30, 40, 3), np.uint8))
    args = ((16, 16), (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))
    arr = timage.process_image(img, *args)
    np.testing.assert_array_equal(arr, jimage.process_image(img, *args))
    np.testing.assert_array_equal(timage.chw_to_nhwc(arr[None]), jimage.chw_to_nhwc(arr[None]))
    assert timage.process_image(img.convert("L"), *args) is None

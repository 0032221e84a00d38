"""The port's turnkey parity kit (``myimagecaptioningmodel_tpu_torch/
parity_run.py``) against the JAX package's (``parity_run.py``), on the CPU.

Both kits run on ``tests/test_parity_run.py``'s corpus and config (noise
JPEGs of 40 px, two phrases, 32 px rows, hidden 16, embedding 8, batch 4),
with 60 images where that test has 16: under the 5/5/90 split 16 images
leave the dev and test splits empty (``int(0.05 * 16) == 0``), so nothing
would be scored. The run is float64 with the encoder frozen, as
``tests/test_torch_loop.py`` runs the loops (its note says why). Each kit
builds the corpus itself (JPEGs -> HDF5 in the JAX package, -> ``.npy``
shards in the port) with the split seeded (each kit's ``build_all`` gets
``split_seed=0``; the kits leave it unseeded), and imports
the same synthetic reference checkpoint (every variable the reference
writes, at the corpus's dims, written with the port's ``paddle_fmt``).
The JAX kit trains 3 epochs from ``PRNGKey(0)`` and backs up each; the
port's kit starts from the JAX run's epoch-1 checkpoint
(``convert_jax_checkpoint``; the port draws its own init) and trains
epochs 2 and 3. Held, with each report's numbers unrounded (the kits round
to 5 decimals):

- the same report keys, nested too; the same build stats;
- epochs 2 and 3's mean losses to ``LOSS_RTOL``, the final step and the best
  dev BLEU; dev and test BLEU-1..4, their mean and CIDEr-D, of our model and
  of the imported one, to ``SCORE_TOL``, the distinct counts, the import's
  summary and the caption diff equal;
- ``python -m myimagecaptioningmodel_tpu_torch.parity_run`` in a subprocess
  with jax, the JAX package and the packages the card's machine lacks
  (PIL among them) blocked: with ``--skip-build --skip-train`` it scores
  the in-process run's bundles and its reference import to the same
  numbers; a build without PIL stops with an error that names PIL; without
  a card and without ``--device cpu`` it stops with the device error; in a
  group of two gloo processes (``--distributed``) process 0 writes the
  same scores.

Tolerances: the JAX run's step losses come back as float32 values even
under x64 (its epoch means read 2.441969156265259 and 2.404140380712656
here), so the epoch means agree to one float32 rounding, ``LOSS_RTOL`` of
the loss (the port's float64 means differ by 2.1e-8 and 3.0e-8 relative);
the scores come from the same argmax ids through the same metric code, so
they agree to ``SCORE_TOL``.
"""

import functools
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import parity_run as jkit
import test_paddle_import
from myimagecaptioningmodel_tpu.data import dataset_gen as jdg
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch import parity_run as tkit
from myimagecaptioningmodel_tpu_torch.compat import paddle_fmt as tfmt
from myimagecaptioningmodel_tpu_torch.data import dataset_gen as tdg
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu", "h5py", "PIL",
           "msgpack", "jieba", "pkuseg")
PHRASES = ["一个 男人 在 打 篮球", "一只 猫 在 睡觉"]  # tests/test_parity_run.py's
N_IMAGES = 60  # 3 test, 3 dev, 54 train images
EPOCHS = 3
LOSS_RTOL = 2.0 ** -23
SCORE_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_corpus(root):
    """``tests/test_parity_run.py``'s corpus at ``N_IMAGES`` images and its
    config, float64 with the encoder frozen, each epoch backed up."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(3)
    records = []
    for i in range(N_IMAGES):
        name = f"img_{i:02d}.jpg"
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(img_dir / name)
        records.append({"image_id": name, "caption": [PHRASES[i % 2]]})
    ann = root / "ann.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    cfg_json = root / "tiny.json"
    cfg_json.write_text(json.dumps({
        "data": {"image_shape": [32, 32], "sample_count": N_IMAGES},
        "train": {"seed": 0, "batch_size": 4, "checkpoint_backup_every_n_epoch": 1},
        "model": {"decoder": {"vocab_size": 0, "embedding_size": 8, "sentence_length": 0,
                              "hidden_dim": 16, "infer_max_length": 6,
                              "vocab_pad_multiple": 8},
                  "encoder": {"encoder_trainable": False},
                  "compute_dtype": "float64"},
    }), encoding="utf-8")
    return img_dir, ann, cfg_json


def reference_checkpoint(root, cfg_json, ann, mp):
    """A synthetic reference checkpoint at the corpus's dims: every variable
    the reference writes (``test_paddle_import._make_paddle_vars``, at the
    corpus's vocabulary, which the caption stages give), written with the
    port's ``paddle_fmt``."""
    cfg = tconfig.Config.from_json_file(str(cfg_json))
    for path, value in (("build_dataset.output_path", str(root / "vocab_probe")),
                        ("build_dataset.annotation_path", str(ann))):
        cfg = tconfig.replace_nested(cfg, path, value)
    vocab = tdg.build_captions(cfg, segmenter="space", split_seed=0)["tokenize"]["vocab_size"]
    cfg = tconfig.replace_nested(cfg, "model.decoder.vocab_size", vocab)
    params, _state = tcap.init(torch.Generator().manual_seed(0),
                               tcap.ModelOptions.from_config(cfg))
    mp.setattr(test_paddle_import, "V", vocab)
    variables = test_paddle_import._make_paddle_vars(
        {k: {"conv": {"w": v["conv"]["w"].numpy()}} for k, v in params["encoder"].items()})
    d = str(root / "reference_persistables")
    tfmt.write_persistables_dir(d, variables)
    return d, len(variables)


@contextmanager
def float64_jax(mp):
    """JAX under x64 for a float64 run: the LSTM's zero state is float32 in
    the JAX decoder (its scan would reject a float64 carry)."""
    mp.setattr(jdec, "_zero_state", lambda b, h: (jnp.zeros((b, h), jnp.float64),) * 2)
    with jax.enable_x64(True):
        yield


def unrounded(mp, kit):
    """The kit's reports with every number as computed: ``round`` in the
    kit's module is the identity."""
    mp.setattr(kit, "round", lambda x, _digits=None: x, raising=False)


def kit_args(img_dir, ann, cfg_json, workdir, ref):
    return ["--images", str(img_dir), "--annotations", str(ann), "--workdir", str(workdir),
            "--config", str(cfg_json), "--epochs", str(EPOCHS), "--segmenter", "space",
            "--reference-checkpoint", ref, "--diff-captions", "6"]


def scalars(workdir, event):
    with open(os.path.join(workdir, "log", "log.jsonl"), encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def run_kits(root):
    """Both kits on the corpus under ``root`` -> (JAX report, port report,
    paths)."""
    img_dir, ann, cfg_json = make_corpus(root)
    with pytest.MonkeyPatch.context() as mp:
        ref, n_vars = reference_checkpoint(root, cfg_json, ann, mp)
        args = functools.partial(kit_args, img_dir, ann, cfg_json, ref=ref)
        unrounded(mp, jkit)
        unrounded(mp, tkit)
        for gen in (jdg, tdg):
            mp.setattr(gen, "build_all", functools.partial(gen.build_all, split_seed=0))
        with float64_jax(mp):
            jrep = jkit.main(args(root / "jax"))
        start = root / "port" / "save" / "checkpoint"
        tckpt.convert_jax_checkpoint(str(root / "jax" / "save" / "checkpoint1"), str(start))
        trep = tkit.main(args(root / "port") + ["--device", "cpu"])
    return jrep, trep, {"root": root, "ref": ref, "n_vars": n_vars, "cfg": cfg_json,
                        "img_dir": img_dir, "ann": ann}


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [key_tree(v) for v in obj]
    return None


def test_port_kit_agrees_with_the_jax_kit(tmp_path):
    """One test: the two kits' runs are its expensive part, and the checks
    below all read them (split over test workers, each would run them)."""
    for part in ("kits", "cli"):
        (tmp_path / part).mkdir()
    kits = run_kits(tmp_path / "kits")
    check_keys_and_build_stats(kits)
    check_training_and_scores(kits)
    check_reference_import_and_caption_diff(kits)
    check_python_m_with_jax_and_the_cards_missing_packages_blocked(kits, tmp_path / "cli")
    check_two_processes(kits, tmp_path / "cli")


def check_keys_and_build_stats(kits):
    jrep, trep, paths = kits
    assert key_tree(trep) == key_tree(jrep)
    assert list(trep) == ["command", "started_utc", "build", "train", "evaluate",
                          "reference_import", "evaluate_reference", "caption_diff"]
    on_disk = json.loads((paths["root"] / "port" / "PARITY_REPORT.json").read_text("utf-8"))
    assert key_tree(on_disk) == key_tree(trep)
    jb, tb = dict(jrep["build"]), dict(trep["build"])
    jb.pop("seconds"), tb.pop("seconds")
    assert tb == jb
    assert tb["segmenter"] == "space" and tb["images"] == N_IMAGES
    assert tb["matches_reference_vocab"] is False and tb["reference_stats"]["vocab_size"] == 12295


def check_training_and_scores(kits):
    jrep, trep, paths = kits
    root = paths["root"]
    jl = {r["epoch"]: r["loss"] for r in scalars(root / "jax", "epoch_loss")}
    tl = {r["epoch"]: r["loss"] for r in scalars(root / "port", "epoch_loss")}
    assert sorted(jl) == list(range(1, EPOCHS + 1)) and sorted(tl) == list(range(2, EPOCHS + 1))
    for epoch in tl:
        assert abs(tl[epoch] - jl[epoch]) <= LOSS_RTOL * jl[epoch], (epoch, tl[epoch], jl[epoch])
    jt, tt = jrep["train"], trep["train"]
    assert tt["epochs"] == jt["epochs"] == EPOCHS
    assert tt["final_step"] == jt["final_step"] == EPOCHS * 13
    assert abs(tt["last_epoch_loss"] - jt["last_epoch_loss"]) <= LOSS_RTOL * jt["last_epoch_loss"]
    assert abs(tt["best_bleu"] - jt["best_bleu"]) <= SCORE_TOL
    for key in ("evaluate", "evaluate_reference"):
        for mode in ("dev", "test"):
            j, t = jrep[key][mode], trep[key][mode]
            np.testing.assert_allclose(t["bleu"], j["bleu"], rtol=0, atol=SCORE_TOL,
                                       err_msg=f"{key} {mode}")
            assert abs(t["cider"] - j["cider"]) <= SCORE_TOL, (key, mode)
            assert t["distinct_sentences"] == j["distinct_sentences"], (key, mode)


def check_reference_import_and_caption_diff(kits):
    jrep, trep, paths = kits
    ji, ti = jrep["reference_import"], trep["reference_import"]
    assert ti["summary"] == ji["summary"] and ti["missing"] == ji["missing"] == []
    assert ti["unknown"] == ji["unknown"] == []
    assert f"imported {paths['n_vars']}" in ti["summary"]
    assert trep["caption_diff"] == jrep["caption_diff"]
    assert trep["caption_diff"]["compared"] == 3  # the test split's 3 images
    bundle = paths["root"] / "port" / "save" / "infer_reference" / "config.json"
    assert json.loads(bundle.read_text("utf-8"))["model"]["parity_mode"] is True


def _kit_code(runs):
    """A script that runs the kit through ``runpy`` as ``python -m`` does, with
    ``BLOCKED`` made unimportable, once for each argv in ``runs``; each run
    prints ``RUN <i> ok`` or ``RUN <i> <error type>: <message>``."""
    return ("import runpy, sys\n"
            + f"for name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
            + f"for i, argv in enumerate({runs!r}):\n"
            + "    sys.argv = ['parity_run'] + argv\n"
            + "    try:\n"
            + "        runpy.run_module('myimagecaptioningmodel_tpu_torch.parity_run',"
            + " run_name='__main__')\n"
            + "        print(f'RUN {i} ok', flush=True)\n"
            + "    except Exception as e:\n"
            + "        print(f'RUN {i} {type(e).__name__}: {e}', flush=True)\n")


def check_python_m_with_jax_and_the_cards_missing_packages_blocked(kits, tmp_path):
    _jrep, trep, paths = kits
    port = str(paths["root"] / "port")
    report = str(tmp_path / "again.json")
    common = ["--config", str(paths["cfg"]), "--segmenter", "space"]
    runs = [
        ["--workdir", port, *common, "--skip-build", "--skip-train", "--device", "cpu",
         "--reference-checkpoint", paths["ref"], "--diff-captions", "6", "--report", report],
        ["--workdir", str(tmp_path / "fresh"), "--images", str(paths["img_dir"]),
         "--annotations", str(paths["ann"]), *common, "--device", "cpu"],
        ["--workdir", str(tmp_path / "nocard"), *common, "--skip-build"],
    ]
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _kit_code(runs)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RUN ")]
    assert proc.returncode == 0 and len(lines) == 3, proc.stdout + proc.stderr[-2000:]
    assert lines[0] == "RUN 0 ok", lines[0]
    assert lines[1].startswith("RUN 1 RuntimeError") and "PIL" in lines[1], lines[1]
    assert "--skip-build" in lines[1] and "ShardBuilder" in lines[1], lines[1]
    assert lines[2].startswith("RUN 2 RuntimeError") and "no CUDA device" in lines[2], lines[2]
    assert not os.path.exists(tmp_path / "nocard")  # stopped before any stage

    again = json.loads(Path(report).read_text("utf-8"))
    assert again["build"]["skipped"] is True and "train" not in again
    assert again["build"]["dataset_meta"]["segmenter"] == "space"
    check_scores(again, trep)


def check_scores(report, trep):
    """A rerun's report (rounded, as the kit writes it) against the
    in-process port run's scores."""
    for key in ("evaluate", "evaluate_reference"):
        for mode in ("dev", "test"):
            got, want = report[key][mode], trep[key][mode]
            assert got["bleu"] == [round(b, 5) for b in want["bleu"]], (key, mode)
            assert got["cider"] == round(want["cider"], 5), (key, mode)
            assert got["distinct_sentences"] == want["distinct_sentences"]
    assert report["caption_diff"] == trep["caption_diff"]


def check_two_processes(kits, tmp_path):
    """The kit in a group of two gloo processes (``--distributed``, the
    JAX kit's ``--mesh``), each ``python -m`` with the same packages blocked:
    process 0 writes the report, and its scores are the one-process run's."""
    _jrep, trep, paths = kits
    report = tmp_path / "two.json"
    addr = f"localhost:{tdist.free_port()}"
    argv = ["--workdir", str(paths["root"] / "port"), "--config", str(paths["cfg"]),
            "--segmenter", "space", "--skip-build", "--skip-train", "--device", "cpu",
            "--reference-checkpoint", paths["ref"], "--diff-captions", "6",
            "--report", str(report), "--distributed", "--coordinator", addr,
            "--num-processes", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _kit_code([argv + ["--process-id", str(i)]])],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "RUN 0 ok" in out, out + err[-2000:]
    check_scores(json.loads(report.read_text("utf-8")), trep)

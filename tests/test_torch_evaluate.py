"""The port's ``evaluate()`` against the JAX package's, and the port's three
``python -m`` entry points, on the CPU.

- A JAX-trained bundle (one JAX ``loop.train`` epoch of 20 steps on the
  data-plane corpus, float32), converted with ``convert_jax_bundle``, is
  evaluated by both packages on the test split, greedy and beam 3: the ids
  are equal, and then BLEU-1..4 and their mean, CIDEr-D and the distinct
  count agree to 1e-9.
- The same bundle evaluated by 2 gloo ranks (``distributed.spawn_local``,
  batch 4 = 2 rows a rank, each rank decoding its rows and every rank
  scoring the gathered ids): every rank returns the one-process port's
  numbers exactly, greedy and beam 3.
- ``python -m myimagecaptioningmodel_tpu_torch.{dataset_gen,train,evaluate}``
  run in subprocesses with ``jax``, the JAX package, ``h5py`` and ``PIL``
  blocked, as on the card's machine: ``dataset_gen --captions-only`` writes
  the caption DBs the JAX build wrote, ``train --device cpu`` trains an epoch
  and exports, ``evaluate --device cpu`` scores the export; without
  ``--device`` and without a card, ``train`` and ``evaluate`` stop with the
  device error; ``train --distributed`` in two processes (gloo, explicit
  addresses) trains an epoch as one group, process 0 alone printing and
  exporting.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.data import dataset_gen as jdg
from myimagecaptioningmodel_tpu.evaluation import evaluate as jeval
from myimagecaptioningmodel_tpu.training import loop as jloop
from myimagecaptioningmodel_tpu_torch.data import shards as tshards
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as teval
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from test_torch_data_plane import build_images, make_cfg, port_cfg, with_vocab

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu", "h5py", "PIL",
           "msgpack", "jieba", "pkuseg")
TOL = 1e-9


# Module scope: pytest sets up the wider-scoped fixtures first, so a
# function-scoped one would come after the module fixtures below, whose
# float64 training then ran on PyTorch's whole spinning pool beside the
# other xdist workers, 14x slower.
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(root, JAX cfg, port cfg): the JAX run's bundle under ``jax/save/infer``,
    its conversion under ``port/save/infer``, the shards converted too."""
    root = tmp_path_factory.mktemp("evaluate")
    img_dir, ann = build_images(root)
    jcfg = make_cfg(root, img_dir, ann, "ds", run="jax",
                    train=(("train.max_epoch", 1), ("train.learning_rate", 3e-3)))
    summary = jdg.build_all(jcfg, segmenter="space", split_seed=0)
    jcfg = with_vocab(jcfg, summary["tokenize"])
    jloop.train(jcfg, mesh=None, max_steps_per_epoch=20)
    tshards.convert_jax_shards([str(root / "ds")], str(root / "ds_port"))
    tcfg = port_cfg(jcfg, data__h5_path=(str(root / "ds_port"),),
                    data__h5_name2idx=str(root / "ds_port" / "name2idx.json"),
                    train__checkpoint_path=str(root / "port" / "save"))
    tckpt.convert_jax_bundle(str(root / "jax" / "save" / "infer"),
                             str(root / "port" / "save" / "infer"))
    return root, jcfg, tcfg


def capture_ids(monkeypatch, module, ids, numpy_ids):
    """Wrap ``module.load_bundle``'s decode to append each batch's ids."""
    orig = module.load_bundle

    def load_bundle(*a, **k):
        out = orig(*a, **k)
        decode = out[-1]

        def wrapped(*args):
            got = decode(*args)
            ids.append(numpy_ids(got))
            return got

        return (*out[:-1], wrapped)

    monkeypatch.setattr(module, "load_bundle", load_bundle)


@pytest.mark.parametrize("beam", [0, 3])
def test_evaluate_matches_the_jax_package(trained, monkeypatch, beam):
    _root, jcfg, tcfg = trained
    jids, tids = [], []
    capture_ids(monkeypatch, jeval, jids, np.asarray)
    capture_ids(monkeypatch, teval, tids, lambda t: t.cpu().numpy())
    want = jeval.evaluate(jcfg, beam_size=beam)
    got = teval.evaluate(tcfg, beam_size=beam, device="cpu")
    assert len(tids) == len(jids) == 2
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["bleu"], want["bleu"], rtol=0, atol=TOL)
    assert abs(got["cider"] - want["cider"]) <= TOL
    assert got["distinct_sentences"] == want["distinct_sentences"]
    assert got["captions"] == 8 and got["seconds"] > 0
    assert max(want["bleu"]) > 0  # the trained bundle's captions match somewhere


def evaluate_rank(rank, tcfg):
    """A rank's ``evaluate()``, greedy and beam 3 (``seconds`` left out)."""
    out = []
    for beam in (0, 3):
        got = teval.evaluate(tcfg, beam_size=beam, device="cpu")
        got.pop("seconds")
        out.append(got)
    return out


def test_two_rank_evaluate_equals_one_process(trained):
    _root, _jcfg, tcfg = trained
    ranks = tdist.spawn_local(evaluate_rank, 2, args=(tcfg,), threads=1, timeout=300)
    for beam, got in zip((0, 3), zip(*ranks)):
        want = teval.evaluate(tcfg, beam_size=beam, device="cpu")
        want.pop("seconds")
        assert got[0] == got[1] == want, beam
        assert want["captions"] == 8 and max(want["bleu"]) > 0


def _module_code(module, args):
    return ("import runpy, sys\n"
            + f"for name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
            + f"sys.argv = [{module!r}] + {list(args)!r}\n"
            + f"runpy.run_module({module!r}, run_name='__main__')\n")


# one PyTorch thread, as the in-process tests: beside other test workers a
# spinning thread pool makes the CPU convolutions crawl
RUN_ENV = {"PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def run_module_async(module, *args):
    return subprocess.Popen([sys.executable, "-c", _module_code(module, args)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **RUN_ENV})


def run_module(module, *args):
    return subprocess.run([sys.executable, "-c", _module_code(module, args)], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **RUN_ENV})


def test_entry_points_run_with_the_cards_packages_missing(trained, tmp_path):
    root, jcfg, tcfg = trained
    # the caption stages alone, into a fresh directory, from the same annotations
    out = tmp_path / "captions"
    cfg = port_cfg(jcfg, build_dataset__output_path=str(out))
    (tmp_path / "captions.json").write_text(cfg.to_json())
    r = run_module("myimagecaptioningmodel_tpu_torch.dataset_gen", "--config",
                   str(tmp_path / "captions.json"), "--segmenter", "auto", "--split-seed", "0",
                   "--captions-only")
    assert r.returncode == 0, r.stderr
    assert "'segmenter': 'space'" in r.stdout  # neither pkuseg nor jieba: "space"
    for name in ("word_dict.npy", "train_cap.npy", "dev_data.npy", "eval_data.npy"):
        assert (out / name).read_bytes() == (root / "ds" / name).read_bytes(), name

    # train an epoch on the CPU, export, evaluate the export
    cfg = port_cfg(tcfg, train__checkpoint_path=str(tmp_path / "save"),
                   log__log_path=str(tmp_path / "log"), train__max_epoch=1,
                   train__batch_size=16)
    (tmp_path / "train.json").write_text(cfg.to_json())
    r = run_module("myimagecaptioningmodel_tpu_torch.train", "--config",
                   str(tmp_path / "train.json"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "'final_step': 18" in r.stdout and "Dev set: BLEU" in r.stdout
    assert os.path.exists(tmp_path / "save" / "infer" / "params.npz")
    r = run_module("myimagecaptioningmodel_tpu_torch.evaluate", "--config",
                   str(tmp_path / "train.json"), "--device", "cpu", "--beam", "3")
    assert r.returncode == 0, r.stderr
    assert "BLEU [" in r.stdout and "CIDEr-D:" in r.stdout and "distinct sentences" in r.stdout

    # no card and no --device: the device error, not a quiet CPU run
    for module in ("myimagecaptioningmodel_tpu_torch.train",
                   "myimagecaptioningmodel_tpu_torch.evaluate"):
        r = run_module(module, "--config", str(tmp_path / "train.json"))
        assert r.returncode != 0 and "no CUDA device" in r.stderr, (module, r.stderr[-500:])


def test_train_cli_in_two_processes(trained, tmp_path):
    _root, _jcfg, tcfg = trained
    cfg = port_cfg(tcfg, train__checkpoint_path=str(tmp_path / "save"),
                   log__log_path=str(tmp_path / "log"), train__max_epoch=1,
                   train__batch_size=32)
    (tmp_path / "train.json").write_text(cfg.to_json())
    address = f"localhost:{tdist.free_port()}"
    procs = [run_module_async("myimagecaptioningmodel_tpu_torch.train", "--config",
                              str(tmp_path / "train.json"), "--device", "cpu", "--distributed",
                              "--coordinator", address, "--num-processes", "2",
                              "--process-id", str(r)) for r in range(2)]
    out = [p.communicate(timeout=300) for p in procs]
    for p, (_o, err) in zip(procs, out):
        assert p.returncode == 0, err[-2000:]
    assert "'final_step': 9" in out[0][0] and "final_step" not in out[1][0]
    assert os.path.exists(tmp_path / "save" / "infer" / "params.npz")
    log = (tmp_path / "log" / "log.txt").read_text()
    assert log.count("Epoch 1\n") == 1 and log.count("Dev set: BLEU") == 1

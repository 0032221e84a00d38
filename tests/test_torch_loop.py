"""The port's training loop (``training/loop.py``) against the JAX package's,
on the CPU, on the data-plane corpus (160 images, 32 px rows, hidden 16,
embedding 8, float32, batch 4):

1. parity through a converted checkpoint: one JAX ``loop.train`` of two
   epochs of 4 steps, which backs up its epoch-1 checkpoint
   (``checkpoint1``); ``convert_jax_checkpoint`` of that backup starts the
   port's run at epoch 2. Epoch 2's per-step losses (from the log lines),
   each leaf's change over epoch 2 (the ``infer`` bundles less the epoch-1
   backup) and the dev BLEU and distinct count must agree to the limits
   stated at ``LOSS_ATOL`` / ``STEP_RTOL`` (float64, the encoder frozen: see
   there);
2. the port's ``_dev_eval`` on the JAX run's final params equals JAX's
   ``_dev_eval``: the same ids, BLEU to 1e-12, the same distinct count;
3. a mid-epoch crash and resume of the port is bit-equal to an
   uninterrupted port run;
4. the NaN guard raises and leaves the last checkpoint as it was;
5. every export of ``save_model`` exists and ``load_bundle`` reads it;
6. ``train()`` without a card and without ``device="cpu"`` raises;
7. ``use_kernels`` follows the device (a monkeypatched device check);
8. the transformer trains an epoch, and its dev BLEU equals JAX's
   ``_dev_eval`` on the same (exported) params;
9. data parallelism: the port's epoch 2, resumed from the same converted
   checkpoint on 2 gloo ranks (``distributed.spawn_local``, batch 4 = 2 a
   rank), logs JAX's per-step losses to ``LOSS_ATOL`` and its dev BLEU (to
   1e-12) and distinct count, both ranks return the same summary, and only
   rank 0 wrote checkpoints, exports and log lines;
10. the reader's ``process_shard`` equals JAX's (serial and batch readers,
    a shuffle and a resume skip), and ``micro_batches`` slices each global
    microbatch as JAX's reader does at the microbatch's share.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.data import dataset_gen as jdg
from myimagecaptioningmodel_tpu.data import reader as jreader
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.models.captioner import ModelOptions as JOptions
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import loop as jloop
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch.compat.from_jax import read_jax_bundle, train_tree
from myimagecaptioningmodel_tpu_torch.data import reader as treader
from myimagecaptioningmodel_tpu_torch.data import shards as tshards
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from myimagecaptioningmodel_tpu_torch.training import loop as tloop
from test_torch_data_plane import build_images, make_cfg, port_cfg, with_vocab

# The parity run is float64 on both sides (JAX under x64) with the encoder
# frozen: at 32 px the encoder's last BN layers normalize over 4 values a
# channel, whose backward amplifies the JAX package's float32 pieces (the
# attention softmax, the float32 learning rate) far past float32 noise (a
# trainable float32 run differs by 7e-5 in its first loss; the port's
# encoder gradients are held to JAX's in float64 by test_torch_train).
# Logged losses carry 6 decimals: they must agree to them.
# Each leaf's change over epoch 2 (final less start) is held to JAX's: the
# norm of the difference within STEP_RTOL of the norm of JAX's change
# (1.0e-5 at worst here), and every element within STEP_ATOL, far below
# what one step moves a weight (lr). A port that never updated a leaf
# misses by 1.0. A leaf that JAX left as it was must stay bit-equal. Two
# kinds of leaf are held otherwise:
# - ``decoder/attention/score/b`` adds one number to every score ahead of a
#   softmax, which cancels it: its gradient is rounding, and Adam's
#   normalized step turns rounding into a move of up to lr a step either way
#   (2.4e-4 from JAX's 1.8e-4 here). It is held to NOISE_ATOL;
# - the encoder's BN running statistics (updated while its weights stay
#   frozen) are held element by element: within STEP_RTOL of JAX's change
#   plus STATE_ATOL (their worst difference here is 5.6e-12), since some
#   change by float64 rounding only (1e-16).
LOSS_ATOL = 2e-6
STEPS = 4
LR = 1e-3
STEP_RTOL, STEP_ATOL = 1e-4, 1e-3 * LR
NOISE_LEAVES = ("p/decoder/attention/score/b",)
NOISE_ATOL = 2 * LR * STEPS
STATE_ATOL = 1e-10
PARITY = dict(train__max_epoch=2, train__checkpoint_backup_every_n_epoch=1,
              model__compute_dtype="float64", model__encoder__encoder_trainable=False)


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
def data(tmp_path_factory):
    """The JAX build of the corpus and its shards converted for the port:
    (root, JAX cfg, port cfg) sharing the caption DBs."""
    root = tmp_path_factory.mktemp("loop")
    img_dir, ann = build_images(root)
    jcfg = make_cfg(root, img_dir, ann, "ds")
    summary = jdg.build_all(jcfg, segmenter="space", split_seed=0)
    jcfg = with_vocab(jcfg, summary["tokenize"])
    tshards.convert_jax_shards([str(root / "ds")], str(root / "ds_port"))
    return root, jcfg


def run_cfg(root, jcfg, run, **paths):
    """(JAX cfg, port cfg) writing under ``root/run``, the port reading the
    converted shards; ``paths``: dotted overrides (``a__b``) for both."""
    for path, value in (("train.checkpoint_path", str(root / run / "save")),
                        ("log.log_path", str(root / run / "log")), *paths.items()):
        jcfg = jconfig.replace_nested(jcfg, path.replace("__", "."), value)
    tcfg = port_cfg(jcfg, data__h5_path=(str(root / "ds_port"),),
                    data__h5_name2idx=str(root / "ds_port" / "name2idx.json"))
    return jcfg, tcfg


def epoch_losses(log_dir, epoch):
    """Step losses logged in ``epoch`` (``log_every_n_step=1``)."""
    text = open(os.path.join(log_dir, "log.txt"), encoding="utf-8").read()
    part = text.split(f"Epoch {epoch}\n")[-1].split("Epoch loss")[0]
    return [float(x) for x in re.findall(r"Step loss: ([-\d.e]+)", part)]


def scalars(log_dir, event):
    with open(os.path.join(log_dir, "log.jsonl"), encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def bundle_leaves(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list, tuple)):
            out.update(bundle_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def float64_jax(mp):
    """JAX under x64 for a float64 run: the LSTM's zero state is float32 in
    the JAX decoder (its scan would reject a float64 carry)."""
    mp.setattr(jdec, "_zero_state", lambda b, h: (jnp.zeros((b, h), jnp.float64),) * 2)
    return jax.enable_x64(True)


@pytest.fixture(scope="module")
def parity(data):
    """The JAX run (two epochs, float64) and the port's epoch 2 from its
    converted epoch-1 backup."""
    root, jcfg0 = data
    jcfg, _ = run_cfg(root, jcfg0, "jax", **PARITY)
    with pytest.MonkeyPatch.context() as mp, float64_jax(mp):
        jloop.train(jcfg, mesh=None, max_steps_per_epoch=STEPS)
    _, tcfg = run_cfg(root, jcfg0, "port", **PARITY)
    backup = os.path.join(jcfg.train.checkpoint_path, "checkpoint1")
    tckpt.convert_jax_checkpoint(backup, os.path.join(tcfg.train.checkpoint_path, "checkpoint"))
    start = str(root / "port_start")
    tckpt.convert_jax_checkpoint(backup, start)
    result = tloop.train(tcfg, device="cpu", max_steps_per_epoch=STEPS)
    return jcfg, tcfg, result, start


def checkpoint_leaves(directory):
    """A port checkpoint's params and BN state keyed as ``bundle_leaves``'."""
    with np.load(os.path.join(directory, tckpt.CKPT_FILE)) as z:
        part = {short: tckpt.unflatten_tree({k[len(name) + 1:]: z[k] for k in z.files
                                             if k.startswith(name + "/")})
                for short, name in (("p", "params"), ("s", "model_state"))}
    return bundle_leaves(part)


def test_parity_through_a_converted_checkpoint(parity):
    jcfg, tcfg, result, start = parity
    want = epoch_losses(jcfg.log.log_path, 2)
    got = epoch_losses(tcfg.log.log_path, 2)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert result["final_step"] == 2 * STEPS and result["epochs"] == 2
    jp, js = read_jax_bundle(os.path.join(jcfg.train.checkpoint_path, "infer"))
    tp, ts, _ = tckpt.load_inference_bundle(os.path.join(tcfg.train.checkpoint_path, "infer"))
    jl, tl = bundle_leaves({"p": jp, "s": js}), bundle_leaves({"p": tp, "s": ts})
    sl = checkpoint_leaves(start)
    assert sorted(jl) == sorted(tl) == sorted(sl)
    moved = 0
    for k in jl:
        dj, dt = jl[k] - sl[k], tl[k] - sl[k]
        err = np.abs(dt - dj)
        if k in NOISE_LEAVES:
            assert err.max() <= NOISE_ATOL, k
        elif k.startswith("s/"):
            np.testing.assert_allclose(dt, dj, rtol=STEP_RTOL, atol=STATE_ATOL, err_msg=k)
        elif not dj.any():
            np.testing.assert_array_equal(tl[k], sl[k], err_msg=k)
        else:
            moved += 1
            assert np.linalg.norm(dt - dj) <= STEP_RTOL * np.linalg.norm(dj), k
            assert err.max() <= STEP_ATOL, k
    assert moved == 27  # the decoder's leaves but the attention score's bias
    jdev = scalars(jcfg.log.log_path, "dev_bleu")[-1]
    tdev = scalars(tcfg.log.log_path, "dev_bleu")[-1]
    assert tdev["epoch"] == jdev["epoch"] == 2
    assert tdev["distinct"] == jdev["distinct"]
    assert abs(tdev["bleu"] - jdev["bleu"]) <= 1e-12
    assert tdev["captions"] == 8


def jax_decoder(jcfg, ids):
    """The JAX package's dev decode (``build_steps(...).decode_step``), its
    ids appended to ``ids``."""
    opts = JOptions.from_config(jcfg)
    schedule = jlr.from_config(jcfg)
    steps = jts.build_steps(opts, jts.make_optimizer(jcfg, schedule), schedule, None)

    def decode(params, state, imgs):
        out = steps.decode_step(params, state, imgs)
        ids.append(np.asarray(out))
        return out

    return decode


def port_decoder(tcfg, ids):
    opts = tcap.ModelOptions.from_config(tcfg)
    steps = tts.build_steps(opts, tts.make_optimizer(tcfg, lambda c: 0.0), lambda c: 0.0)

    def decode(params, state, imgs):
        out = steps.decode_step(params, state, imgs)
        ids.append(out.numpy())
        return out

    return decode


def dev_evals(jcfg, tcfg, params, state):
    """JAX's and the port's ``_dev_eval`` on one reference-layout (params,
    state) -> ((bleu, distinct), ids) of each."""
    jids, tids = [], []
    j = jloop._dev_eval(jax_decoder(jcfg, jids), params, state,
                        jreader.DataReader(jcfg).get_reader(4, "dev", keep_float16=True),
                        jreader.DataReader(jcfg).index_word, 4, 3, 0)
    dt = torch.float64 if tcfg.model.compute_dtype == "float64" else torch.float32
    tp, ts = train_tree(params, state, "cpu", dt)
    t = tloop._dev_eval(port_decoder(tcfg, tids), tp, ts,
                        treader.DataReader(tcfg).get_reader(4, "dev", keep_float16=True),
                        treader.DataReader(tcfg).index_word, 4, 3, 0)
    return j, t, jids, tids


def test_dev_eval_equals_jax_on_the_same_params(parity):
    jcfg, tcfg, _, _ = parity
    params, state = read_jax_bundle(os.path.join(jcfg.train.checkpoint_path, "infer"))
    with pytest.MonkeyPatch.context() as mp, float64_jax(mp):
        (jbleu, jdistinct), (tbleu, tdistinct, n), jids, tids = dev_evals(jcfg, tcfg, params,
                                                                         state)
    assert len(tids) == len(jids) == 2 and n == 8
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a, b)
    assert abs(tbleu - jbleu) <= 1e-12 and tdistinct == jdistinct


def crash_cfg(root, jcfg0, run, **extra):
    return run_cfg(root, jcfg0, run, **{"train__max_epoch": 1,
                                        "train__checkpoint_every_n_steps": 2,
                                        "train__shuffle_each_epoch": True, **extra})[1]


def test_midepoch_crash_and_resume_is_bit_equal(data):
    root, jcfg0 = data
    a = crash_cfg(root, jcfg0, "crash_a")
    tloop.train(a, device="cpu", max_steps_per_epoch=8)
    b = crash_cfg(root, jcfg0, "crash_b")
    with pytest.raises(RuntimeError, match="fault injection"):
        tloop.train(b, device="cpu", max_steps_per_epoch=8, fault_injection_step=5)
    meta = json.load(open(os.path.join(b.train.checkpoint_path, "checkpoint", "meta.json")))
    assert meta["mid_epoch_batches"] == 4 and meta["next_epoch"] == 1 and meta["step"] == 4
    tloop.train(b, device="cpu", max_steps_per_epoch=8)
    assert "skipping 4 batches" in open(os.path.join(b.log.log_path, "log.txt")).read()
    assert epoch_losses(b.log.log_path, 1)[-4:] == epoch_losses(a.log.log_path, 1)[-4:]
    za = np.load(os.path.join(a.train.checkpoint_path, "checkpoint", "state.npz"))
    zb = np.load(os.path.join(b.train.checkpoint_path, "checkpoint", "state.npz"))
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_nan_guard_keeps_the_last_checkpoint(data, monkeypatch):
    root, jcfg0 = data
    cfg = crash_cfg(root, jcfg0, "nan_loss", train__learning_rate=1e18,
                    train__checkpoint_every_n_steps=1)
    with pytest.raises(FloatingPointError, match="NaN"):
        tloop.train(cfg, device="cpu", max_steps_per_epoch=8)
    path = os.path.join(cfg.train.checkpoint_path, "checkpoint", "state.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            assert all(np.isfinite(z[k]).all() for k in z.files)

    # finite loss, NaN updated params at step 3: the step-2 checkpoint stays
    cfg = crash_cfg(root, jcfg0, "nan_params", train__checkpoint_every_n_steps=1)
    orig = tloop.build_steps

    def poisoned(*args, **kwargs):
        steps = orig(*args, **kwargs)

        def train_step(*a):
            out = steps.train_step(*a)
            if out[3] == 3:
                with torch.no_grad():
                    out[0]["decoder"]["out_bias"][0] = float("nan")
            return out

        return steps._replace(train_step=train_step)

    monkeypatch.setattr(tloop, "build_steps", poisoned)
    with pytest.raises(FloatingPointError, match="refusing to overwrite"):
        tloop.train(cfg, device="cpu", max_steps_per_epoch=8)
    meta = json.load(open(os.path.join(cfg.train.checkpoint_path, "checkpoint", "meta.json")))
    assert meta["step"] == 2
    with np.load(os.path.join(cfg.train.checkpoint_path, "checkpoint", "state.npz")) as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)


def test_exports_exist_and_load(data, monkeypatch):
    root, jcfg0 = data
    _, cfg = run_cfg(root, jcfg0, "exports", train__max_epoch=1, train__ema_decay=0.9,
                     train__export_params=True, train__checkpoint_backup_every_n_epoch=1)
    # a dev BLEU above the best so far, so that the best-BLEU copies are written
    monkeypatch.setattr(tloop, "_dev_eval", lambda *a: (0.25, 3, 8))
    summary = tloop.train(cfg, device="cpu", max_steps_per_epoch=2)
    assert summary == {"epochs": 1, "final_step": 2, "last_dev_bleu": 0.25,
                       "best_bleu": 0.25, "last_epoch_loss": summary["last_epoch_loss"]}
    save = cfg.train.checkpoint_path
    assert sorted(os.listdir(save)) == ["checkpoint", "checkpoint1", "checkpoint_best_bleu",
                                        "infer", "infer_bleu", "infer_ema", "params"]
    for name in ("checkpoint", "checkpoint1", "checkpoint_best_bleu"):
        assert tckpt.checkpoint_exists(os.path.join(save, name))
    assert os.path.exists(os.path.join(save, "params", tckpt.PARAMS_FILE))
    images = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    for name in ("infer", "infer_bleu", "infer_ema"):
        model, bcfg, opts, decode = load_bundle(cfg, name, device="cpu")
        assert not opts.use_kernels and bcfg.to_dict() == cfg.to_dict()
        assert tuple(decode(model, images).shape) == (2, cfg.model.decoder.infer_max_length)
        assert os.path.exists(os.path.join(save, name, "word_dict.npy"))
    for event in ("epoch_loss", "step_times", "train_wall", "dev_bleu"):
        assert scalars(cfg.log.log_path, event)


def test_train_needs_a_card_unless_asked_for_the_cpu(data, monkeypatch):
    root, jcfg0 = data
    _, cfg = run_cfg(root, jcfg0, "nocard")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(cfg)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_use_kernels_follows_the_device(data, monkeypatch, device):
    root, jcfg0 = data
    _, cfg = run_cfg(root, jcfg0, f"kernels_{device}")
    seen = {}

    def build_steps(opts, *a, **k):
        seen["use_kernels"] = opts.use_kernels
        raise _Stop

    monkeypatch.setattr(tloop, "resolve_device", lambda d=None: torch.device(device))
    monkeypatch.setattr(tloop, "build_steps", build_steps)
    with pytest.raises(_Stop):
        tloop.train(cfg)
    assert seen == {"use_kernels": device == "cuda"}


def test_transformer_epoch_and_dev_bleu_equal_jax(data):
    root, jcfg0 = data
    jcfg, tcfg = run_cfg(root, jcfg0, "tf", train__max_epoch=1,
                         model__decoder__arch="transformer", model__decoder__num_layers=2,
                         model__decoder__num_heads=2)
    result = tloop.train(tcfg, device="cpu", max_steps_per_epoch=2)
    assert result["final_step"] == 2 and np.isfinite(result["last_epoch_loss"])
    params, state, _ = tckpt.load_inference_bundle(os.path.join(tcfg.train.checkpoint_path,
                                                                "infer"))
    assert isinstance(params["decoder"]["layers"], dict)  # "0", "1": as flax stores a tuple
    jparams = dict(params, decoder=dict(params["decoder"], layers=tuple(
        params["decoder"]["layers"][str(i)] for i in range(2))))
    (jbleu, jdistinct), (tbleu, tdistinct, _n), jids, tids = dev_evals(jcfg, tcfg, jparams,
                                                                      state)
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a, b)
    assert abs(tbleu - jbleu) <= 1e-12 and tdistinct == jdistinct
    logged = scalars(tcfg.log.log_path, "dev_bleu")[-1]
    assert abs(logged["bleu"] - jbleu) <= 1e-12 and logged["distinct"] == jdistinct


def dp_epoch2(rank, tcfg):
    """A rank of the data-parallel resume: ``train`` -> (summary, the
    checkpoint and export writes this rank made)."""
    writes = []
    for name in ("write_checkpoint", "export_inference_bundle"):
        orig = getattr(tckpt, name)

        def counted(*a, _orig=orig, _name=name, **k):
            writes.append(_name)
            return _orig(*a, **k)

        setattr(tckpt, name, counted)
    return tloop.train(tcfg, device="cpu", max_steps_per_epoch=STEPS), writes


def test_two_rank_resume_equals_jax(parity, data):
    jcfg, _tcfg, result, _start = parity
    root, jcfg0 = data
    _, tcfg = run_cfg(root, jcfg0, "port_dp", **PARITY)
    tckpt.convert_jax_checkpoint(os.path.join(jcfg.train.checkpoint_path, "checkpoint1"),
                                 os.path.join(tcfg.train.checkpoint_path, "checkpoint"))
    ranks = tdist.spawn_local(dp_epoch2, 2, args=(tcfg,), threads=1, timeout=600)
    (summary0, writes0), (summary1, writes1) = ranks
    assert summary0 == summary1 and summary0["final_step"] == result["final_step"]
    assert writes0 and not writes1
    np.testing.assert_allclose(epoch_losses(tcfg.log.log_path, 2),
                               epoch_losses(jcfg.log.log_path, 2), rtol=0, atol=LOSS_ATOL)
    text = open(os.path.join(tcfg.log.log_path, "log.txt"), encoding="utf-8").read()
    assert text.count("Epoch 2\n") == 1 and text.count("Dev set: BLEU") == 1
    jdev = scalars(jcfg.log.log_path, "dev_bleu")[-1]
    tdev = scalars(tcfg.log.log_path, "dev_bleu")
    assert len(tdev) == 1 and tdev[0]["distinct"] == jdev["distinct"]
    assert abs(tdev[0]["bleu"] - jdev["bleu"]) <= 1e-12 and tdev[0]["captions"] == 8
    assert abs(summary1["last_dev_bleu"] - jdev["bleu"]) <= 1e-12


def _samples(batches):
    """A reader's batches (sample lists or stacked tuples) -> [(row, caption)]."""
    out = []
    for b in batches:
        pairs = zip(*b) if isinstance(b, tuple) else b
        out.extend((np.asarray(img), np.asarray(cap)) for img, cap in pairs)
    return out


@pytest.mark.parametrize("threads", [0, 2])
def test_process_shard_reader_equals_jax(data, threads):
    root, jcfg0 = data
    jcfg, tcfg = run_cfg(root, jcfg0, "reader")
    kw = dict(keep_float16=True, shuffle_seed=3, skip_samples=4, reader_threads=threads)
    for index in range(2):
        jr = jreader.DataReader(jcfg)
        tr = treader.DataReader(tcfg)
        want = _samples(jr.get_reader(2, "train", process_shard=(index, 2), **kw)())
        got = _samples(tr.get_reader(2, "train", process_shard=(index, 2), **kw)())
        assert len(got) == len(want) > 0
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        # microbatches: this rank's share of each global microbatch of 2
        # (JAX's reader at the share, 1 row), over whole global batches of 4
        micro = _samples(tr.get_reader(2, "train", process_shard=(index, 2),
                                       micro_batches=2, **kw)())
        share = _samples(jr.get_reader(1, "train", process_shard=(index, 2), **kw)())
        assert 0 < len(micro) <= len(share) and len(micro) % 2 == 0
        for (a, b), (c, d) in zip(micro, share):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        for reader in (jr, tr):
            with pytest.raises(ValueError, match="train-only"):
                list(reader.get_reader(2, "dev", process_shard=(index, 2))())

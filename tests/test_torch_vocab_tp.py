"""The port's vocab tensor parallelism (``parallel/vocab_parallel.py``, the
(data, model) grid of ``parallel/mesh.py``, the TP train step and loop)
against single-rank functions and the JAX package, on the CPU.

The ranks are gloo processes (``distributed.spawn_local``, one torch thread
each) running ``torch_tp_workers``, which imports no JAX:

- the vocab-parallel embedding, head input and cross-entropy (with and
  without label smoothing, the padded rows on the last rank) on 2 ranks
  against the same functions on one rank, float64: every value and every
  gradient to 1e-12 (the sums add in another order); the merge's tie rule
  on ties planted across the rank boundary;
- one TP train step of each decoder family on (data=1, model=2), float64,
  against the JAX package's ``build_steps`` on a (data=1, model=2) mesh of
  two of the 8 virtual CPU devices, with its ``param_shardings``: the loss,
  the BN state, Adam's moments, every param and the EMA to the float64
  step's limits of ``test_torch_train_step`` (LSTM) and
  ``test_torch_transformer_train`` (transformer, ``LIMITS``); both ranks
  hold the same bits. Under
  TP the JAX step swaps in its taps-form depthwise conv (``safe_depthwise``,
  against a grouped-conv miscompile under partial batch sharding, which a
  data axis of 1 does not have); that form is another function in float64
  (its own single-device step moves by 8e-7 in a BN variance and 9e-8 in
  the loss with it), so the JAX side here keeps the grouped conv that its
  single-device step and the port run (``_GroupedConv``; the JAX code is
  not changed);
- ``loop.train`` at ``model_parallel=2`` on a (data=2, model=2) grid of 4
  ranks against the port's ``model_parallel=1`` run, at
  ``tests/test_tp_train.py``'s sizes and limits: the step losses to 1e-3,
  the dev BLEU to 1e-6, the reloaded checkpoint to 5e-4; only rank 0
  writes checkpoints;
- ``model_parallel`` values that do not divide the processes or the padded
  vocab raise ``ValueError``, as in the JAX package.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_workers as W
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.parallel import mesh as jmesh
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.data import dataset_gen as tdg
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.parallel import mesh as tmesh
from test_torch_train import f64_zero_state, flat, jax_tree, tiny_batch, tiny_cfg
from test_torch_train_step import _adam_state

LR = 1e-3
# vocab 64 padded to 96: rank 0 holds rows 0-47, rank 1 rows 48-63 and the 32
# padded rows
STEP = {"train.learning_rate": LR, "train.gradient_clip": 0.05, "train.ema_decay": 0.9,
        "train.label_smoothing": 0.1, "model.decoder.vocab_pad_multiple": 48}
# (loss rtol, moment atol and "clear" gradient share, as x max|.|) of the
# float64 steps of test_torch_train_step and test_torch_transformer_train
LIMITS = {"lstm": (1e-9, 1e-5), "transformer": (1e-7, 1e-4)}
FAMILIES = {
    "lstm": {},
    "transformer": {"model.decoder.arch": "transformer", "model.decoder.num_layers": 2,
                    "model.decoder.num_heads": 4, "model.decoder.mlp_ratio": 2},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the layers --------------------------------------------------------------------


def layer_inputs():
    rng = np.random.RandomState(3)
    V, E, B, T, real = 12, 6, 3, 4, 9
    bias = rng.randn(V)
    bias[real:] = -1e9
    ids = rng.randint(0, V, (B, T))
    ids[0, :2] = (0, 6)  # the padding id and the first row of rank 1
    return {
        "table": rng.randn(V, E), "bias": bias, "x": rng.randn(B, T, E), "ids": ids,
        "target": rng.randint(0, real, (B, T)), "real_v": real, "g_emb": rng.randn(B, T, E),
        "w": rng.rand(B, T),
        # rank 0's (value, global index) and rank 1's: equal values across the
        # boundary (the lower index must win), and one clear winner on rank 1
        "ties": {"value": [np.array([1.0, 2.0, 3.0, -4.0]), np.array([1.0, 2.5, 3.0, -4.0])],
                 "index": [np.array([5, 1, 4, 0]), np.array([7, 8, 6, 11])]},
    }


@pytest.fixture(scope="module")
def layer_ranks():
    return tdist.spawn_local(W.layers_rank, 2, args=(layer_inputs(),), threads=1, timeout=180)


@pytest.mark.parametrize("name", ["embed", "embed_dtable"] + [
    f"ce{eps}{g}" for eps in (0.0, 0.1) for g in ("", "_dx", "_dtable", "_dbias")])
def test_vocab_parallel_layers_equal_one_rank(layer_ranks, name):
    want = W.layers_single(layer_inputs())[name]
    if name.endswith(("dtable", "dbias")):  # each rank's rows
        got = np.concatenate([r["vp"][name] for r in layer_ranks])
    else:  # the same on both ranks
        got = layer_ranks[0]["vp"][name]
        np.testing.assert_array_equal(got, layer_ranks[1]["vp"][name])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(np.abs(want).max(), 1.0))


def test_merge_takes_the_lowest_index_on_ties(layer_ranks):
    for r in layer_ranks:
        np.testing.assert_array_equal(r["merge"], [5, 8, 4, 0])
    assert [r["rows"] for r in layer_ranks] == [(0, 6), (6, 12)]


# ---- one TP train step against JAX on a (1, 2) mesh ----------------------------------


def _grouped_conv(opts):
    """``opts`` whose ``_replace`` keeps ``safe_depthwise`` off (see the
    module docstring)."""

    class _GroupedConv(type(opts)):
        def _replace(self, **kw):
            kw.pop("safe_depthwise", None)
            return super()._replace(**kw)

    return _GroupedConv(*opts)


def step_cfg(arch):
    return tiny_cfg("float64", False, **STEP, **FAMILIES[arch])


def step_batch():
    return tiny_batch(np.float64, seed=0)


@pytest.fixture(scope="module", params=list(FAMILIES))
def tp_step(request):
    """(JAX's step on a (1, 2) mesh, each rank's port step) for a family."""
    arch = request.param
    cfg = step_cfg(arch)
    images, caps = step_batch()
    params, state = jax_tree(cfg, np.float64)
    ranks = tdist.spawn_local(W.step_rank, 2, args=(cfg.to_dict(), params, state, images,
                                                    caps, 2), threads=1, timeout=300)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        f64_zero_state(mp)
        mesh = jmesh.make_mesh(jax.devices()[:2], model_parallel=2)
        schedule = jlr.from_config(cfg)
        tx = jts.make_optimizer(cfg, schedule)
        opt = tx.init(params)
        p_sh = jmesh.param_shardings(mesh, params)
        o_sh = jmesh.opt_state_shardings(mesh, opt, params, p_sh)
        steps = jts.build_steps(_grouped_conv(jcap.ModelOptions.from_config(cfg)), tx,
                                schedule, mesh,
                                donate=False, params_sharding=p_sh, opt_sharding=o_sh)
        jp, jo, js, _, jloss, _ = steps.train_step(
            jax.device_put(params, p_sh), jax.device_put(opt, o_sh), state,
            jnp.asarray(0), images, caps)
        mu, nu = (flat(t) for t in _adam_state(jo))
        want = {"loss": float(jloss), "params": flat(jp), "state": flat(js), "mu": mu,
                "nu": nu, "ema": flat(jts.ema_params_from_opt_state(jo))}
    return arch, want, ranks


def test_tp_train_step_equals_jax(tp_step):
    arch, want, ranks = tp_step
    got = ranks[0]
    assert [r["local_rows"] for r in ranks] == [48, 48]
    for k in ("params", "state", "mu", "nu", "ema"):  # both ranks gathered the same bits
        assert got[k].keys() == want[k].keys()
        for leaf in got[k]:
            np.testing.assert_array_equal(got[k][leaf], ranks[1][k][leaf], err_msg=f"{k}/{leaf}")
    assert got["loss"] == ranks[1]["loss"]
    loss_rtol, moment = LIMITS[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    for k in want["state"]:
        np.testing.assert_allclose(got["state"][k], want["state"][k], rtol=0, atol=1e-10,
                                   err_msg=k)
    for k in ("mu", "nu"):
        scale = max(np.abs(v).max() for v in want[k].values())
        for leaf in want[k]:
            np.testing.assert_allclose(got[k][leaf], want[k][leaf], rtol=1e-6,
                                       atol=moment * scale, err_msg=f"{k}/{leaf}")
    gmax = max(np.abs(v).max() for v in want["mu"].values())
    for k, share in (("params", 1.0), ("ema", 1.0 - STEP["train.ema_decay"])):
        for leaf, w in want[k].items():
            clear = np.abs(want["mu"][leaf]) > moment * gmax
            err = np.abs(got[k][leaf] - w)
            assert (err[clear] <= 1e-4 * LR * share).all(), (arch, k, leaf, err[clear].max())
            assert (err <= 2 * LR * share).all(), (arch, k, leaf)
    # the vocab-sized leaves moved on both ranks' rows
    for leaf in ("decoder/embedding/table", "decoder/out_bias"):
        w0 = flat(jax_tree(step_cfg(arch), np.float64)[0])[leaf]
        moved = np.abs(got["params"][leaf][:64] - w0[:64]).max(axis=-1) if w0.ndim == 2 else \
            np.abs(got["params"][leaf][:64] - w0[:64])
        assert (moved[:48] > 0).any() and (moved[48:64] > 0).any(), leaf


# ---- the loop on a (data=2, model=2) grid ----------------------------------------------


def _losses(log_path):
    pat = re.compile(r"Step \d+ Mean loss: [\d.]+ Step loss: ([\d.]+)")
    with open(os.path.join(log_path, "log.txt"), encoding="utf-8") as f:
        return [float(m.group(1)) for m in (pat.search(line) for line in f) if m]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The port's model_parallel=1 run in this process and its
    model_parallel=2 run on 4 ranks, on one corpus (test_tp_train's sizes)."""
    from PIL import Image
    import json

    from myimagecaptioningmodel_tpu_torch.training import loop as tloop

    root = tmp_path_factory.mktemp("vocab_tp")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(5)
    phrases = ["一个 男人 在 打 篮球", "一只 猫 在 睡觉"]
    records = []
    for i in range(16):
        name = f"img_{i:02d}.jpg"
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(img_dir / name)
        records.append({"image_id": name, "caption": [phrases[i % 2]]})
    ann = root / "ann.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    out = root / "ds"

    def make_cfg(tag, mp):
        return tconfig.Config.from_dict({
            "build_dataset": {"image_paths": [str(img_dir)], "annotation_path": str(ann),
                              "output_path": str(out), "h5_name2idx": str(out / "name2idx.json")},
            "data": {"image_shape": [32, 32], "dict_path": str(out), "h5_path": [str(out)],
                     "h5_name2idx": str(out / "name2idx.json")},
            "train": {"seed": 0, "batch_size": 8, "max_epoch": 1, "log_every_n_step": 1,
                      "model_parallel": mp, "checkpoint_path": str(root / tag / "save")},
            "model": {"decoder": {"vocab_size": 0, "embedding_size": 8, "sentence_length": 0,
                                  "hidden_dim": 16, "infer_max_length": 6,
                                  "vocab_pad_multiple": 8},
                      "compute_dtype": "float32"},
            "log": {"log_path": str(root / tag / "log")},
        })

    summary = tdg.build_all(make_cfg("build", 1), segmenter="space", split_seed=0)

    def patch(cfg):
        cfg = tconfig.replace_nested(cfg, "model.decoder.vocab_size",
                                     summary["tokenize"]["vocab_size"])
        return tconfig.replace_nested(cfg, "model.decoder.sentence_length",
                                      summary["tokenize"]["max_len"])

    cfg_dp, cfg_tp = patch(make_cfg("dp", 1)), patch(make_cfg("tp", 2))
    res_dp = tloop.train(cfg_dp, device="cpu")
    ranks = tdist.spawn_local(W.loop_rank, 4, args=(cfg_tp.to_dict(),), threads=1, timeout=420)
    return cfg_dp, cfg_tp, res_dp, ranks


def test_tp_loop_matches_one_rank(loops):
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import make_optimizer, tree_leaves
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
    from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr

    cfg_dp, cfg_tp, res_dp, ranks = loops
    res_tp = ranks[0]["summary"]
    assert all(r["summary"] == res_tp for r in ranks)
    assert [r["grid"] for r in ranks] == [(2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)]
    assert res_tp["final_step"] == res_dp["final_step"] > 0
    l_dp, l_tp = _losses(cfg_dp.log.log_path), _losses(cfg_tp.log.log_path)
    assert len(l_tp) == len(l_dp) >= 2
    np.testing.assert_allclose(l_tp, l_dp, atol=1e-3)
    np.testing.assert_allclose(res_tp["last_dev_bleu"], res_dp["last_dev_bleu"], atol=1e-6)
    # one writer: rank 0 wrote the checkpoint, the others nothing
    assert "checkpoint" in ranks[0]["written"]
    assert all(r["written"] == [] for r in ranks[1:])

    # the TP checkpoint has the model_parallel=1 format and reloads equal to it
    opts = tcap.ModelOptions.from_config(cfg_dp)
    like_p, like_s = train_tree(*tcap.init(torch.Generator().manual_seed(0), opts),
                                device="cpu")
    like_o = make_optimizer(cfg_dp, tlr.from_config(cfg_dp)).init(like_p)
    loaded = [tckpt.load_checkpoint(os.path.join(c.train.checkpoint_path, "checkpoint"),
                                    like_p, like_o, like_s)[0] for c in (cfg_dp, cfg_tp)]
    for a, b in zip(*(tree_leaves(p) for p in loaded)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=5e-4)


# ---- validation -----------------------------------------------------------------------


def test_model_parallel_must_divide_the_processes():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(device="cpu", model_parallel=3)


def test_model_parallel_must_divide_the_padded_vocab():
    mesh = tmesh.Mesh(1, 0, torch.device("cpu"), model_size=4, model_rank=1)
    assert tmesh.vocab_rows(mesh, 12416) == tmesh.VocabShard(3104, 6208)
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        tmesh.vocab_rows(mesh, 12295)


def test_shardings_by_tree_path():
    """The table, the bias, their moments and EMA are sharded; a replicated
    leaf of the same shape is not (by path, never by shape)."""
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import Optimizer, tree_leaves

    mesh = tmesh.Mesh(1, 0, torch.device("cpu"), model_size=2, model_rank=1)
    params = {"decoder": {"embedding": {"table": torch.zeros(8, 4)}, "out_bias": torch.zeros(8),
                          "twin": {"w": torch.zeros(8, 4)}}, "img_embed": {"b": torch.zeros(8)}}
    p_sh = tmesh.param_shardings(mesh, params)
    rows = tmesh.VocabShard(4, 8)
    assert p_sh["decoder"]["embedding"]["table"] == rows and p_sh["decoder"]["out_bias"] == rows
    assert p_sh["decoder"]["twin"]["w"] is None and p_sh["img_embed"]["b"] is None
    opt = Optimizer(lambda c: 1e-3, ema_decay=0.5).init(params)
    o_sh = tmesh.opt_state_shardings(mesh, opt, params, p_sh)
    assert o_sh.adam.mu == tree_leaves(p_sh) == o_sh.adam.nu and o_sh.ema.ema is p_sh
    sp, so = tmesh.shard_state(mesh, params, opt)
    assert sp["decoder"]["embedding"]["table"].shape == (4, 4)
    assert sp["decoder"]["twin"]["w"].shape == (8, 4)
    assert [t.shape[0] for t in so.adam.mu] == [4, 4, 8, 8]

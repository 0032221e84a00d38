"""The port's transformer training against the JAX package, on the CPU.

A tiny transformer captioner (MobileNetV2 x0.35 at 64x64, B=4, sentence
length 8; D=32, 2 layers, 4 heads, MLP ratio 2, vocab 64 padded to 128,
E=16; label smoothing 0.1) with random weights from a seed; the same numpy
images and captions go through ``jax.value_and_grad`` of the JAX
``captioner.loss_fn`` and through the port's ``loss_fn`` and
``torch.autograd.grad``, with the port's ``fuse_bn_stats`` off and on (kernel
F's plain version on the CPU), against the JAX package's unfused path, as
``tests/test_torch_train.py`` holds the LSTM. Gradients are compared in the
reference layout, by group: the decoder, the encoder and the two
projections (``img_embed``, ``img_global``).

- float64 (JAX under x64): loss to rtol 1e-7, every gradient leaf to atol
  2e-6 x the largest |grad| of its group, the new BN state to 1e-10. Both
  packages keep LayerNorm, the residual stream and the attention scores in
  float32 under float64 (the reference's rounding points), so a float64
  step is float32 there (measured: loss 1.1e-8 relative; gradients 8.4e-8
  of their group's max in the decoder, 3.4e-7 in the encoder, 2.9e-7 in
  the projections; BN state 6.6e-14).
- float32: loss to rtol 3e-5 (measured 9.7e-6); the decoder's gradients to
  atol 5e-4 x their group's max (measured 9.5e-5), the projections' to
  2e-3 (measured 4.4e-4); the encoder's, amplified by float32 BN noise
  through 52 BN layers at B=4, to a relative L2 error of 0.05 over all its
  leaves, as the LSTM's (measured 0.028); the BN state to 1e-3 + 1e-3
  relative (measured 2.7e-5).

Then one ``train_step`` with a by-value clip (0.05), a params-EMA and
``grad_accum_steps=2`` against the JAX step in float64, with the limits of
``tests/test_torch_train_step.py`` but two: the float32 points above leave
up to 3.4e-7 x the unclipped max|g| (9.5) of noise in the float64
gradients, 10x the LSTM's, so Adam's moments are held to rtol 1e-6 + atol
1e-4 x their largest magnitude (measured 2.5e-5) and the updates to 1e-4 x
lr where |g| > 1e-4 x the largest |g| after the clip (at 1e-5 an update read
3.9e-4 x lr off). Then the tree walkers on trees with lists, and a trained
transformer tree exported and reloaded through ``load_bundle``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as teval
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr
from test_torch_train import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    flat, jax_loss_and_grads, jax_tree, one_torch_thread, port_loss_and_grads, tiny_batch,
    tiny_cfg,
)
from test_torch_train_step import STEP_OPTIONS, _adam_state, _as_tree, _Float64Zeros

TF_OPTIONS = {"model.decoder.arch": "transformer", "model.decoder.num_layers": 2,
              "model.decoder.num_heads": 4, "model.decoder.mlp_ratio": 2,
              "train.label_smoothing": 0.1}
MOMENT_ATOL, CLEAR = 1e-4, 1e-4  # the float64 step's limits, below
GROUPS = ("decoder", "encoder", "img")  # img_embed and img_global together


def tf_cfg(dtype, fuse=False, **extra):
    return tiny_cfg(dtype, fuse, **TF_OPTIONS, **extra)


def group(key):
    return "img" if key.startswith("img_") else key.split("/")[0]


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loss_grads_and_bn_state_match_jax(dtype, fuse):
    f64 = dtype == "float64"
    cfg, params, state, images, caps, jl, jg, jstate = jax_loss_and_grads(
        dtype, tuple(TF_OPTIONS.items()))
    cfg = tf_cfg(dtype, fuse)
    opts = tcap.ModelOptions.from_config(cfg)
    assert (opts.arch, opts.fuse_bn_stats, opts.label_smoothing) == ("transformer", fuse, 0.1)
    loss, g, new_state = port_loss_and_grads(
        cfg, params, state, images, caps, torch.float64 if f64 else torch.float32)
    g, new_state = flat(g), flat(new_state)
    assert g.keys() == jg.keys() and new_state.keys() == jstate.keys()
    assert any(k.startswith("decoder/layers/1/") for k in g)
    gmax = {name: max(np.abs(v).max() for k, v in jg.items() if group(k) == name)
            for name in GROUPS}

    np.testing.assert_allclose(loss, jl, rtol=1e-7 if f64 else 3e-5)
    if f64:
        for k in jg:
            np.testing.assert_allclose(g[k], jg[k], rtol=0, atol=2e-6 * gmax[group(k)],
                                       err_msg=k)
        for k in jstate:
            np.testing.assert_allclose(new_state[k], jstate[k], rtol=0, atol=1e-10, err_msg=k)
        return
    atol = {"decoder": 5e-4, "img": 2e-3}
    enc = [k for k in jg if group(k) == "encoder"]
    for k in jg:
        if k not in enc:
            np.testing.assert_allclose(g[k], jg[k], rtol=0, atol=atol[group(k)] * gmax[group(k)],
                                       err_msg=k)
    diff = np.sqrt(sum(((g[k] - jg[k]) ** 2).sum() for k in enc))
    norm = np.sqrt(sum((jg[k] ** 2).sum() for k in enc))
    assert diff / norm <= 0.05, diff / norm
    for k in jstate:
        np.testing.assert_allclose(new_state[k], jstate[k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_train_step_matches_jax(monkeypatch):
    """One float64 step with clip, EMA and two microbatches, held as the
    module docstring says."""
    cfg = tf_cfg("float64", **STEP_OPTIONS)
    lr = cfg.train.learning_rate
    monkeypatch.setattr(jts, "jnp", _Float64Zeros())
    with jax.enable_x64(True):
        params, state = jax_tree(cfg, np.float64)
        images, caps = tiny_batch(np.float64)
        schedule = jlr.from_config(cfg)
        tx = jts.make_optimizer(cfg, schedule)
        steps = jts.build_steps(jcap.ModelOptions.from_config(cfg), tx, schedule,
                                donate=False, grad_accum_steps=cfg.train.grad_accum_steps)
        jp, jo, js, jstep, jloss, _ = steps.train_step(
            params, tx.init(params), state, jnp.asarray(0), images, caps)
        jema = flat(jts.ema_params_from_opt_state(jo))
        jmu, jnu = (flat(t) for t in _adam_state(jo))
        jp, js, jloss = flat(jp), flat(js), float(jloss)

    schedule = tlr.from_config(cfg)
    optimizer = tts.make_optimizer(cfg, schedule)
    tp, ts = train_tree(params, state, device="cpu", dtype=torch.float64)
    before = [p.detach().clone() for p in tree_leaves(tp)]
    tsteps = tts.build_steps(tcap.ModelOptions.from_config(cfg), optimizer, schedule,
                             cfg.train.grad_accum_steps)
    tp, to, tstate, tstep, tloss, _ = tsteps.train_step(
        tp, optimizer.init(tp), ts, 0, torch.as_tensor(images), torch.as_tensor(caps))
    assert tstep == int(jstep) == 1
    # every leaf moved, those of every transformer layer included
    assert all(not torch.equal(p, b) for p, b in zip(tree_leaves(tp), before))
    p_new, s_new = (flat(t) for t in reference_tree(tp, tstate))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-7)
    for k in js:
        np.testing.assert_allclose(s_new[k], js[k], rtol=0, atol=1e-10, err_msg=k)
    for got, want in zip(to.adam[1:], (jmu, jnu)):
        got = flat(reference_tree(_as_tree(tp, got), {})[0])
        scale = max(np.abs(v).max() for v in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=MOMENT_ATOL * scale,
                                       err_msg=k)
    gmax = max(np.abs(v).max() for v in jmu.values())
    ema = flat(reference_tree(tts.ema_params_from_opt_state(to), {})[0])
    for got_tree, want_tree, share in ((p_new, jp, 1.0), (ema, jema, 1 - cfg.train.ema_decay)):
        assert got_tree.keys() == want_tree.keys()
        for k in want_tree:
            clear = np.abs(jmu[k]) > CLEAR * gmax
            err = np.abs(got_tree[k] - want_tree[k])
            assert (err[clear] <= 1e-4 * lr * share).all(), (k, err[clear].max())
            assert (err <= 2 * lr * share).all(), k


def test_tree_walkers_follow_lists():
    """``tree_leaves`` walks dicts in sorted-key order and lists and tuples in
    index order; ``tree_map`` rebuilds that structure (tuples as lists);
    ``train_tree`` marks every leaf under a list for gradients and
    ``reference_tree`` gives the lists back in layer order."""
    t = [torch.tensor([float(i)]) for i in range(6)]
    tree = {"b": [t[2], {"y": t[4], "x": t[3]}], "a": t[0], "c": (t[5],), "0": t[1]}
    assert [float(x) for x in tree_leaves(tree)] == [1.0, 0.0, 2.0, 3.0, 4.0, 5.0]
    doubled = tts.tree_map(lambda x: 2 * x, tree)
    assert isinstance(doubled["b"], list) and isinstance(doubled["c"], list)
    assert [float(x) for x in tree_leaves(doubled)] == [2.0, 0.0, 4.0, 6.0, 8.0, 10.0]

    cfg = tf_cfg("float32")
    params, state = jax_tree(cfg, np.float32)
    tp, _ts = train_tree(params, state, device="cpu")
    layers = tp["decoder"]["layers"]
    assert isinstance(layers, list) and len(layers) == 2
    assert all(leaf.requires_grad and leaf.is_leaf for leaf in tree_leaves(tp))
    back, _ = reference_tree(tp, {})
    assert isinstance(back["decoder"]["layers"], list)
    for i in range(2):
        np.testing.assert_array_equal(back["decoder"]["layers"][i]["mlp"]["fc1"]["w"],
                                      params["decoder"]["layers"][i]["mlp"]["fc1"]["w"])
    np.testing.assert_array_equal(back["encoder"]["conv1_1"]["conv"]["w"],
                                  params["encoder"]["conv1_1"]["conv"]["w"])


def test_export_and_load_bundle_round_trip(tmp_path):
    """A transformer training tree, through ``reference_tree``,
    ``export_inference_bundle`` and ``load_bundle``, comes back leaf for leaf
    (the decoder in the bundle's float32, ``layers`` in order), and the
    loaded model decodes."""
    cfg = tf_cfg("float32", **{"train.checkpoint_path": str(tmp_path)})
    params, state = jax_tree(cfg, np.float32)
    tp, ts = train_tree(params, state, device="cpu")
    with torch.no_grad():  # layers differ from one another and from init
        for i, leaf in enumerate(tree_leaves(tp)):
            leaf.add_(0.01 * (i + 1))
    p_np, s_np = reference_tree(tp, ts)
    tckpt.export_inference_bundle(str(tmp_path / "trained"), p_np, s_np, cfg)
    model, _bcfg, opts, decode = teval.load_bundle(cfg, "trained", device="cpu")
    assert opts.arch == "transformer"
    dec = model.params["decoder"]
    want = flat(p_np["decoder"])
    got = flat(dec)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    images, _caps = tiny_batch(np.float32)
    ids = decode(model, images)
    assert tuple(ids.shape) == (4, cfg.model.decoder.infer_max_length)

"""The training half of the port's ``training/checkpoint.py`` on the CPU:
checkpoints round-trip the params, an ``OptState`` with its EMA and the BN
state bit for bit (the LSTM and the transformer, whose ``decoder/layers``
is a list), ``_recover`` promotes what survives a crashed swap, an
``AsyncCheckpointWriter`` error surfaces, ``graft_subtree`` loads an
encoder, and ``convert_jax_checkpoint`` of a JAX checkpoint written with a
gradient clip and an EMA gives the port the same leaves, in ``tree_leaves``
order, as the JAX optimizer state holds.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.compat.from_jax import (
    conv_hwio_to_oihw, reference_layout, train_tree,
)
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt
from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr

ARCHS = ("lstm", "transformer")


def tiny_cfg(arch, **extra):
    cfg = tconfig.Config()
    for path, v in (("model.decoder.vocab_size", 40), ("model.decoder.embedding_size", 8),
                    ("model.decoder.hidden_dim", 16), ("model.decoder.num_layers", 2),
                    ("model.decoder.num_heads", 2), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.sentence_length", 6), ("model.decoder.arch", arch),
                    ("model.compute_dtype", "float32"), ("train.ema_decay", 0.9),
                    ("train.gradient_clip", 0.05), *extra.items()):
        cfg = tconfig.replace_nested(cfg, path, v)
    return cfg


def random_state(cfg, seed=0):
    """(params, OptState with EMA and nonzero count and moments, BN state) on
    the CPU, every leaf drawn from ``seed``."""
    opts = tcap.ModelOptions.from_config(cfg)
    p, s = tcap.init(torch.Generator().manual_seed(seed), opts)
    params, state = train_tree(p, s, "cpu")
    opt = tts.make_optimizer(cfg, tlr.from_config(cfg)).init(params)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in tts.tree_leaves((opt.adam.mu, opt.adam.nu, opt.ema.ema, state)):
            t.copy_(torch.randn(t.shape, generator=gen))
    return params, opt._replace(adam=opt.adam._replace(count=7)), state


def assert_trees_equal(a, b):
    la, lb = tts.tree_leaves(a), tts.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach(), y.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_bit_for_bit(tmp_path, arch):
    cfg = tiny_cfg(arch)
    params, opt, state = random_state(cfg)
    meta = {"next_epoch": 3, "step": 7, "mid_epoch_batches": 2}
    tckpt.save_checkpoint(str(tmp_path / "ck"), params, opt, state, meta)
    assert sorted(os.listdir(tmp_path / "ck")) == ["COMMITTED", "meta.json", "state.npz"]
    like = random_state(cfg, seed=5)
    p2, o2, s2, m2 = tckpt.load_checkpoint(str(tmp_path / "ck"), *like)
    assert m2 == meta and o2.adam.count == 7
    assert_trees_equal(p2, params)
    assert all(p.requires_grad for p in tts.tree_leaves(p2))
    assert_trees_equal(o2.adam.mu, opt.adam.mu)
    assert_trees_equal(o2.adam.nu, opt.adam.nu)
    assert_trees_equal(o2.ema.ema, opt.ema.ema)
    assert_trees_equal(s2, state)
    if arch == "transformer":
        assert isinstance(p2["decoder"]["layers"], list) and len(p2["decoder"]["layers"]) == 2
    # a template without the EMA (or a checkpoint without it) is refused
    no_ema = like[1]._replace(ema=None)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.load_checkpoint(str(tmp_path / "ck"), like[0], no_ema, like[2])
    assert tckpt.checkpoint_exists(str(tmp_path / "ck"))
    assert not tckpt.checkpoint_exists(str(tmp_path / "none"))


def test_async_writer_snapshots_and_surfaces_errors(tmp_path):
    cfg = tiny_cfg("lstm")
    params, opt, state = random_state(cfg)
    writer = tckpt.AsyncCheckpointWriter()
    writer.save(str(tmp_path / "ck"), params, opt, state, {"step": 1})
    with torch.no_grad():  # the host copy was taken in save(): later updates do not reach it
        for p in tts.tree_leaves(params):
            p.add_(1.0)
    writer.wait()
    loaded = tckpt.load_checkpoint(str(tmp_path / "ck"), *random_state(cfg, 3))[0]
    for a, b in zip(tts.tree_leaves(loaded), tts.tree_leaves(params)):
        assert torch.equal(a.detach() + 1.0, b.detach())
    assert writer.snapshot_seconds > 0 and writer.write_seconds > 0
    (tmp_path / "blocker").write_text("a file where a directory must go")
    writer.save(str(tmp_path / "blocker" / "ck"), params, opt, state, {"step": 2})
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # reported once
    writer.save(str(tmp_path / "blocker" / "ck"), params, opt, state, {"step": 3})
    with pytest.raises(OSError):  # or at the next save
        writer.save(str(tmp_path / "ck"), params, opt, state, {"step": 4})


def test_recover_handles_crash_debris(tmp_path):
    cfg = tiny_cfg("lstm")
    params, opt, state = random_state(cfg)
    d = str(tmp_path / "ck")
    tckpt.save_checkpoint(d, params, opt, state, {"step": 1})
    # crash after the rename-aside, before the publish: .tmp complete, no dir
    tckpt.save_checkpoint(d + "_b", params, opt, state, {"step": 2})
    os.rename(d, d + ".old")
    os.rename(d + "_b", d + ".tmp")
    assert tckpt.checkpoint_exists(d)
    assert json.load(open(os.path.join(d, "meta.json")))["step"] == 2
    assert not os.path.exists(d + ".tmp") and not os.path.exists(d + ".old")
    # crash with an incomplete .tmp after the rename-aside: the .old comes back
    os.rename(d, d + ".old")
    os.makedirs(d + ".tmp")
    (tmp_path / "ck.tmp" / "state.npz").write_bytes(b"partial")
    assert tckpt.checkpoint_exists(d)
    assert json.load(open(os.path.join(d, "meta.json")))["step"] == 2
    assert not os.path.exists(d + ".tmp")
    # a stray .tmp beside a complete checkpoint is dropped
    os.makedirs(d + ".tmp")
    assert tckpt.checkpoint_exists(d) and not os.path.exists(d + ".tmp")


def test_graft_subtree(tmp_path):
    cfg = tiny_cfg("lstm")
    params, _opt, _state = random_state(cfg)
    donor, _o, _s = random_state(cfg, seed=9)
    tckpt.save_params(str(tmp_path / "whole.npz"), donor)
    # an encoder-only file, in the reference layout (as a JAX encoder's params)
    np.savez(tmp_path / "enc.npz", **tckpt.flatten_tree(reference_layout(donor)["encoder"]))
    for path in ("whole.npz", "enc.npz"):
        out = tckpt.graft_subtree(params, str(tmp_path / path), "encoder")
        assert_trees_equal(out["encoder"], donor["encoder"])
        assert out["decoder"] is params["decoder"]
        assert all(p.requires_grad for p in tts.tree_leaves(out["encoder"]))
    tckpt.save_params(str(tmp_path / "dec.npz"), donor["decoder"])
    with pytest.raises(ValueError, match="neither"):
        tckpt.graft_subtree(params, str(tmp_path / "dec.npz"), "encoder")
    # load_params gives the reference layout (HWIO convs)
    raw = tckpt.load_params(str(tmp_path / "whole.npz"))
    name = sorted(raw["encoder"])[0]
    np.testing.assert_array_equal(conv_hwio_to_oihw(raw["encoder"][name]["conv"]["w"]),
                                  donor["encoder"][name]["conv"]["w"].detach().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_jax_checkpoint(tmp_path, arch):
    tcfg = tiny_cfg(arch)
    jcfg = jconfig.Config.from_json(tcfg.to_json())
    p, s = tcap.init(torch.Generator().manual_seed(0), tcap.ModelOptions.from_config(tcfg))
    to_np = lambda t: np.asarray(t, np.float32)  # noqa: E731
    jp = jax.tree_util.tree_map(to_np, p)
    js = jax.tree_util.tree_map(to_np, s)
    if arch == "transformer":  # the JAX package keeps the layers as a tuple
        jp["decoder"]["layers"] = tuple(jp["decoder"]["layers"])
    tx = jts.make_optimizer(jcfg, jlr.from_config(jcfg))
    jo = jax.jit(tx.init)(jp)  # jitted: one compile, not one per eager op and shape
    update = jax.jit(tx.update)
    rng = np.random.RandomState(0)
    for _ in range(2):  # two updates: nonzero moments and EMA, count 2
        grads = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), jp)
        _u, jo = update(grads, jo, jp)
    meta = {"next_epoch": 2, "step": 2, "best_bleu": 0.5}
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, jo, js, meta)
    tckpt.convert_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))

    like = random_state(tcfg, seed=3)
    params, opt, state, m = tckpt.load_checkpoint(str(tmp_path / "port"), *like)
    assert m == meta
    want_p, want_s = train_tree(jp, js, "cpu")
    assert_trees_equal(params, want_p)
    assert_trees_equal(state, want_s)

    def adam(state):  # the ScaleByAdamState of a chain's nested tuples
        if hasattr(state, "mu"):
            return state
        found = [adam(s) for s in state] if isinstance(state, tuple) else []
        return next((x for x in found if x is not None), None)

    def port_leaves(tree):  # a JAX params-shaped tree -> port leaves in tree_leaves order
        return tts.tree_leaves(train_tree(jax.tree_util.tree_map(np.asarray, tree), {},
                                          "cpu")[0])

    ja = adam(jo)
    assert opt.adam.count == int(ja.count) == 2
    for got, want in ((opt.adam.mu, port_leaves(ja.mu)), (opt.adam.nu, port_leaves(ja.nu)),
                      (tts.tree_leaves(opt.ema.ema),
                       port_leaves(jts.ema_params_from_opt_state(jo)))):
        assert len(got) == len(want) == len(jax.tree_util.tree_leaves(jp))
        for a, b in zip(got, want):
            assert torch.equal(a, b.detach())

"""The params bridge (myimagecaptioningmodel_tpu_torch/compat/from_jax.py)
and the port's bundle (myimagecaptioningmodel_tpu_torch/training/checkpoint.py).

- the msgpack reader decodes what ``flax.serialization`` writes, array for
  array (exact), including chunked arrays, bfloat16 leaves and numpy scalars;
- a JAX bundle converts to a port bundle with the same arrays and config;
- conv weights: HWIO -> OIHW for regular and depthwise convs (checked through
  the JAX and torch convolutions, float32 to 1e-5);
- the port bundle's crash-atomic publish and recovery.
"""

import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models import mobilenet_v2 as jmnv2
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu_torch.compat import from_jax
from myimagecaptioningmodel_tpu_torch.models.mobilenet_v2 import MobileNetV2
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt


def small_cfg():
    cfg = config_mod.Config()
    for path, v in (("model.decoder.vocab_size", 60), ("model.decoder.embedding_size", 16),
                    ("model.decoder.hidden_dim", 32), ("model.encoder.encoder_scale", 0.35),
                    ("model.compute_dtype", "float32")):
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_tree():
    opts = jcap.ModelOptions.from_config(small_cfg())
    params, state = jcap.init(jax.random.PRNGKey(0), opts)
    return jax.tree_util.tree_map(np.asarray, {"params": params, "model_state": state})


def test_msgpack_reader_matches_flax(jax_tree):
    raw = fser.to_bytes(jax_tree)
    _assert_same_tree(from_jax.read_msgpack(raw), fser.msgpack_restore(raw))
    _assert_same_tree(from_jax.read_msgpack(raw), jax_tree)


def test_msgpack_reader_chunked_bf16_and_scalars(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)  # force chunking
    rng = np.random.RandomState(0)
    tree = {
        "big": rng.randn(7, 9).astype(np.float32),
        "ints": np.arange(40, dtype=np.int32),
        "bf16": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
        "scalar": np.float32(2.5),
        "nested": {"x": rng.randn(2).astype(np.float64)},
    }
    out = from_jax.read_msgpack(fser.to_bytes(tree))
    np.testing.assert_array_equal(out["big"], tree["big"])
    np.testing.assert_array_equal(out["ints"], tree["ints"])
    np.testing.assert_array_equal(
        out["bf16"], np.asarray(tree["bf16"].astype(jnp.float32)))
    assert out["scalar"] == np.float32(2.5)
    np.testing.assert_array_equal(out["nested"]["x"], tree["nested"]["x"])


def test_jax_bundle_converts_to_port_bundle(tmp_path, jax_tree):
    cfg = small_cfg()
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    np.save(vocab / "word_dict.npy",
            np.array([{"<pad>": 0}, {0: "<pad>"}], dtype=object), allow_pickle=True)
    jckpt.export_inference_bundle(str(tmp_path / "jax"), jax_tree["params"],
                                  jax_tree["model_state"], cfg, vocab_src_dir=str(vocab))
    tckpt.convert_jax_bundle(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == [
        "COMMITTED", "config.json", "params.npz", "word_dict.npy"]
    params, state, cfg2 = tckpt.load_inference_bundle(str(tmp_path / "port"))
    _assert_same_tree({"params": params, "model_state": state}, jax_tree)
    # the port keeps its own Config class: the same fields and values
    assert cfg2.to_dict() == cfg.to_dict()
    # a JAX bundle is not silently read as a port bundle
    with pytest.raises(FileNotFoundError, match="convert_jax_bundle"):
        tckpt.load_inference_bundle(str(tmp_path / "jax"))


def test_flatten_roundtrip_and_bad_keys():
    tree = {"a": {"b": np.zeros(2), "c": {"d": np.ones(3)}}, "e": np.arange(2)}
    flat = tckpt.flatten_tree(tree)
    assert sorted(flat) == ["a/b", "a/c/d", "e"]
    _assert_same_tree(tckpt.unflatten_tree(flat), tree)
    with pytest.raises(ValueError):
        tckpt.flatten_tree({"x/y": np.zeros(1)})


def test_conv_layouts_regular_and_depthwise():
    rng = np.random.RandomState(1)
    w = rng.randn(3, 3, 1, 12).astype(np.float32)  # depthwise HWIO
    assert from_jax.conv_hwio_to_oihw(w).shape == (12, 1, 3, 3)
    np.testing.assert_array_equal(from_jax.conv_hwio_to_oihw(w)[5, 0], w[:, :, 0, 5])
    w = rng.randn(1, 1, 8, 16).astype(np.float32)
    assert from_jax.conv_hwio_to_oihw(w).shape == (16, 8, 1, 1)


def test_encoder_from_jax_tree_matches_jax(jax_tree):
    """The converted encoder module computes the JAX encoder's features
    (a few layers of the real network: checks every conv/BN layout)."""
    rng = np.random.RandomState(2)
    params = jax_tree["params"]["encoder"]
    state = jax.tree_util.tree_map(np.array, jax_tree["model_state"]["encoder"])
    for s in state.values():  # non-trivial moving statistics
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
        s["bn"]["var"] = rng.rand(n).astype(np.float32) + 0.5
    enc = MobileNetV2(0.35).load(params, state)
    assert sorted(enc.layers) == sorted(params)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    ref, _ = jmnv2.apply(params, state, jnp.asarray(x), train=False, scale=0.35,
                         compute_dtype=jnp.float32)
    out = enc(torch.as_tensor(x), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _bundle(tmp_path, seed):
    tree = {"w": np.full(3, seed, np.float32)}
    tckpt.export_inference_bundle(str(tmp_path / "b"), tree, {}, small_cfg())


def test_bundle_atomic_swap_and_recovery(tmp_path):
    d = str(tmp_path / "b")
    _bundle(tmp_path, 1)
    _bundle(tmp_path, 2)  # replaces the first through the swap
    assert not os.path.exists(d + ".old") and not os.path.exists(d + ".tmp")
    assert tckpt.load_inference_bundle(d)[0]["w"][0] == 2

    # crash after the old copy was renamed aside, before the new one landed:
    # the complete .tmp is published
    os.rename(d, d + ".tmp")
    assert tckpt.load_inference_bundle(d)[0]["w"][0] == 2

    # crash with an incomplete .tmp and the old copy aside: the .old returns
    os.rename(d, d + ".old")
    os.makedirs(d + ".tmp")
    assert tckpt.load_inference_bundle(d)[0]["w"][0] == 2
    assert not os.path.exists(d + ".tmp")

    # an uncommitted directory is never loaded
    os.remove(os.path.join(d, "COMMITTED"))
    with pytest.raises(FileNotFoundError):
        tckpt.load_inference_bundle(d)

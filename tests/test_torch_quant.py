"""The port's int8 decode path (ops/quantization.py, the int8 branches of
ops/layers.py, models/decoder.py and fused_step.prepare, and the bridge's
quantize-at-load) against the JAX package's, on CPU in float32.

Tolerances: int8 weights and scales equal bit for bit; tensors to 1e-5
(absolute and relative; only summation order differs); ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import decoder as JD
from myimagecaptioningmodel_tpu.ops import layers as jL
from myimagecaptioningmodel_tpu.ops import quantization as JQ
from myimagecaptioningmodel_tpu.ops.pallas import fused_step as JFS
from myimagecaptioningmodel_tpu_torch.compat.from_jax import captioner_from_tree, tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.ops import layers as tL
from myimagecaptioningmodel_tpu_torch.ops import quantization as TQ
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS

F32 = jnp.float32
TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = JD.DecoderDims(vocab_size=300, embedding_size=32, hidden_dim=64, feat_channels=12,
                      vocab_pad_multiple=128)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def decoders():
    """(JAX float params, JAX int8 params, port int8 params) from one tree."""
    params = JD.init(jax.random.PRNGKey(0), DIMS)
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, params))
    return params, JQ.quantize_decoder(params), TQ.quantize_decoder(tparams)


def test_quantize_decoder_bit_for_bit(decoders):
    _p, jq, tq = decoders
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    assert jl.keys() == tl.keys()
    assert "embedding/table_q" in tl and "lstm/w_q" in tl and "attention/score/w" in tl
    for name, j in jl.items():
        t = tl[name]
        assert _np(t).dtype == np.asarray(j).dtype, name
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=name)
    assert TQ.is_quantized(tq["out"]) and TQ.is_quantized(tq["embedding"])
    assert not TQ.is_quantized(tq["attention"]["score"])


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_and_dequantize(axis):
    rng = np.random.RandomState(1)
    w = rng.randn(40, 24).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: the 1e-12 floor
    w[5, :] = 0.0
    w[0, 0] = 2.5 * 127 / 10  # values on a half step exercise round-half-even
    jq, js = JQ.quantize_weight(jnp.asarray(w), axis=axis)
    tq, ts = TQ.quantize_weight(torch.as_tensor(w), axis=axis)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        _np(TQ.dequantize(tq, ts, axis, torch.float32)),
        np.asarray(JQ.dequantize(jq, js, axis, F32)))


def test_leaf_views_int8_and_float(decoders):
    """dense_weight / embedding_table dequantize as the JAX package's do;
    dense_in_dim and head_table read a leaf whichever way it is stored."""
    p, jq, tq = decoders
    tp = tree_to_torch(jax.tree_util.tree_map(np.asarray, p))
    for key in ("lstm", "p_hid", "out_proj"):
        np.testing.assert_array_equal(_np(TQ.dense_weight(tq[key])),
                                      np.asarray(JQ.dense_weight(jq[key])), err_msg=key)
        assert TQ.dense_in_dim(tq[key]) == TQ.dense_in_dim(tp[key]) == p[key]["w"].shape[0]
    np.testing.assert_array_equal(_np(TQ.embedding_table(tq["embedding"])),
                                  np.asarray(JQ.embedding_table(jq["embedding"])))
    table, scale = TQ.head_table(tq["embedding"], torch.bfloat16)
    assert table.dtype == torch.int8 and scale.dtype == torch.float32
    table, scale = TQ.head_table(tp["embedding"], torch.bfloat16)
    assert table.dtype == torch.bfloat16 and scale is None
    assert TQ.head_table(tp["embedding"])[0] is tp["embedding"]["table"]


def test_int8_dense_and_embed(decoders):
    _p, jq, tq = decoders
    rng = np.random.RandomState(2)
    x = rng.randn(5, 64).astype(np.float32)
    np.testing.assert_allclose(_np(tL.dense(tq["out"], torch.as_tensor(x), torch.float32)),
                               np.asarray(jL.dense(jq["out"], jnp.asarray(x), F32)), **TOL)
    ids = np.array([[0, 3, 7], [299, 0, 12]], np.int32)
    out = tL.embed(tq["embedding"], torch.as_tensor(ids).long(), padding_idx=0)
    np.testing.assert_allclose(_np(out), np.asarray(jL.embed(jq["embedding"], jnp.asarray(ids))),
                               **TOL)
    assert out.dtype == torch.float32 and float(out[0, 0].abs().max()) == 0.0


def _pre(params, tparams, B, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(B, 5, DIMS.hidden_dim).astype(np.float32)
    gf = rng.rand(B, DIMS.hidden_dim).astype(np.float32)
    return (JD.precompute(params, jnp.asarray(img), jnp.asarray(gf), F32),
            TD.precompute(tparams, torch.as_tensor(img), torch.as_tensor(gf), torch.float32))


@pytest.mark.parametrize("parity_mode", [False, True])
def test_int8_precompute_step_and_head(decoders, parity_mode):
    _p, jq, tq = decoders
    jpre, tpre = _pre(jq, tq, 4, 3)
    for name, t, j in zip(TD.Precomputed._fields, tpre, jpre):
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=name, **TOL)
    rng = np.random.RandomState(4)
    h = (rng.randn(4, 64) * 0.3).astype(np.float32)
    c = (rng.randn(4, 64) * 0.3).astype(np.float32)
    word = np.array([2, 0, 17, 299], np.int32)
    jout = JD.step(jq, jpre, jnp.asarray(word), jnp.asarray(h), jnp.asarray(c), parity_mode,
                   0, F32)
    tout = TD.step(tq, tpre, torch.as_tensor(word).long(), torch.as_tensor(h),
                   torch.as_tensor(c), parity_mode, 0, torch.float32)
    for name, t, j in zip(("h", "c", "logits"), tout, jout):
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=name, **TOL)


def test_int8_prepare_dequantizes_as_jax(decoders):
    _p, jq, tq = decoders
    jpre, tpre = _pre(jq, tq, 3, 5)
    jfp = JFS.prepare(jq, jpre, padding_idx=0, dt=F32)
    tfp = TFS.prepare(tq, tpre, padding_idx=0, dt=torch.float32)
    for name, t, j in zip(TFS.FusedStepParams._fields, tfp, jfp):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=name, **TOL)
    assert tfp.head_table.dtype == torch.float32


@pytest.mark.parametrize("parity_mode", [False, True])
@pytest.mark.parametrize("early_stop", [False, True])
def test_int8_greedy_ids_equal_jax(decoders, parity_mode, early_stop):
    """The plain path and, under parity mode, the vocab-argmax head on the
    int8 table with its scale (kernel A's int8 path; its plain version on
    CPU) against the JAX package's plain int8 decode. Without parity mode the
    kernel path dequantizes at prepare, as JAX's fused path does, and is
    held against JAX's Pallas path in interpret mode."""
    _p, jq, tq = decoders
    jpre, tpre = _pre(jq, tq, 6, 6)
    kw = dict(parity_mode=parity_mode, early_stop=early_stop, stop_idx=3)
    want = JD.greedy_decode_ids(jq, jpre, 5, compute_dtype=F32, use_pallas=False, **kw)
    assert len({tuple(r) for r in np.asarray(want)}) > 1
    got = TD.greedy_decode_ids(tq, tpre, 5, compute_dtype=torch.float32, use_kernels=False,
                               **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    if parity_mode:
        got = TD.greedy_decode_ids(tq, tpre, 5, compute_dtype=torch.float32,
                                   use_kernels=True, **kw)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_int8_fused_greedy_matches_jax_pallas():
    dims = JD.DecoderDims(vocab_size=2000, embedding_size=128, hidden_dim=128,
                          feat_channels=12, vocab_pad_multiple=128)
    params = JD.init(jax.random.PRNGKey(2), dims)
    jq = JQ.quantize_decoder(params)
    tq = TQ.quantize_decoder(tree_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(7)
    img = rng.rand(8, 5, 128).astype(np.float32)
    gf = rng.rand(8, 128).astype(np.float32)
    jpre = JD.precompute(jq, jnp.asarray(img), jnp.asarray(gf), F32)
    tpre = TD.precompute(tq, torch.as_tensor(img), torch.as_tensor(gf), torch.float32)
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        want = JD.greedy_decode_ids(jq, jpre, 3, compute_dtype=F32, use_pallas=True)
    got = TD.greedy_decode_ids(tq, tpre, 3, compute_dtype=torch.float32, use_kernels=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_bridge_quantizes_float32_before_the_cast():
    """A bfloat16 model: the port quantizes the float32 tree, as the JAX
    package quantizes its float32 params at load, before any weight is
    rounded to the compute dtype; w_q stays int8 and scale float32."""
    from myimagecaptioningmodel_tpu import config as config_mod

    cfg = config_mod.Config()
    for path, v in [("model.decoder.vocab_size", 200), ("model.decoder.embedding_size", 16),
                    ("model.decoder.hidden_dim", 32), ("model.encoder.encoder_scale", 0.35),
                    ("model.compute_dtype", "bfloat16")]:
        cfg = config_mod.replace_nested(cfg, path, v)
    opts = tcap.ModelOptions.from_config(cfg)
    params, state = tcap.init(torch.Generator().manual_seed(1), opts)
    params, state = (jax.tree_util.tree_map(_np, t) for t in (params, state))
    model = captioner_from_tree(params, state, opts, device="cpu", quantize=True)
    want = dict(_leaves(JQ.quantize_decoder(jax.tree_util.tree_map(jnp.asarray,
                                                                   params["decoder"]))))
    got = dict(_leaves(model.params["decoder"]))
    for name in ("lstm/w_q", "lstm/scale", "out_proj/w_q", "out_proj/scale",
                 "embedding/table_q", "embedding/scale"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]), err_msg=name)
    assert got["lstm/w_q"].dtype == torch.int8 and got["lstm/scale"].dtype == torch.float32
    # the float weights that stay are rounded to the compute dtype once, at load
    assert got["attention/score/w"].dtype == torch.bfloat16
    assert model.params["img_embed"]["w"].dtype == torch.bfloat16

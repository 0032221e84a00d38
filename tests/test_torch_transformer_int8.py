"""int8 transformer serving in the port against the JAX package, on the CPU,
in float32.

Dims of ``tests/test_fused_transformer.py``: V=2050, E=128, D=256, 2 layers,
2 heads, MLP ratio 2, M=6 memory slots, T=5, 8 images; weights from the JAX
package's ``init`` through the bridge, inputs from a numpy seed.

- ``quantize_transformer_decoder`` and ``quantize_kv_pre`` against the JAX
  package's: int8 values equal, scales to one float32 ulp (the same absmax /
  127 in float32);
- kernels D's and E's plain versions on int8 weights against the JAX
  whole-decode kernels in interpret mode (``int8_stream``; D also with
  ``int8_kv``), fixed length and early stop: ids, words, back-pointers and
  lengths equal, beam scores to 1e-4 (float32 sums in other orders);
- ``quantize_kv`` exact on integer-valued memory whose per-channel absmax is
  127 (the grid is the identity): the int8-memory decode equals the float
  one id for id, through D's plain version and the plain loop; on real
  memory the plain loop (``quantize_kv_pre``) equals the JAX XLA fallback;
- ``load_bundle(quantize=True)`` greedy and beam 4, and
  ``load_bundle(quantize_kv=True)`` greedy, on a transformer bundle with
  ``device="cpu"``, equal the JAX ``load_bundle``'s ids on the plain path
  and on the kernel path (D's and E's plain versions); the two
  ``ValueError``s of ``quantize_kv``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.evaluation import evaluate as jeval
from myimagecaptioningmodel_tpu.models import transformer as JTF
from myimagecaptioningmodel_tpu.ops.pallas import fused_transformer as JFT
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as teval
from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT
from test_torch_transformer_slice import bundles  # noqa: F401  (a module fixture)

F32 = torch.float32
T_STEPS = 5
DIMS = dict(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2, num_heads=2,
            mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def q8():
    """(JAX int8 params, port int8 params from the same float32 tree, their
    memories for 8 images, the port dims)."""
    jparams = JTF.init(jax.random.PRNGKey(0), JTF.TransformerDims(**DIMS))
    jparams = {**jparams, "out_bias": jparams["out_bias"].at[3].add(2.5)}
    jq = JTF.quantize_transformer_decoder(jparams)
    tq = TTF.quantize_transformer_decoder(tree_to_torch(_np(jparams), "cpu"))
    rng = np.random.RandomState(0)
    img = rng.rand(8, 5, 256).astype(np.float32)
    gf = rng.rand(8, 256).astype(np.float32)
    jpre = JTF.precompute(jq, jnp.asarray(img), jnp.asarray(gf), 2, jnp.float32)
    tpre = TTF.precompute(tq, torch.from_numpy(img), torch.from_numpy(gf), 2, F32)
    return jq, tq, jpre, tpre, TTF.TransformerDims(**DIMS)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_quantize_transformer_decoder_matches_jax(q8):
    jq, tq, _jpre, _tpre, _dims = q8
    jl, tl = dict(_leaves(_np(jq))), {k: v.numpy() for k, v in _leaves(tq)}
    assert sorted(jl) == sorted(tl)
    n_int8 = 0
    for name, want in jl.items():
        got = tl[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if want.dtype == np.int8:
            n_int8 += 1
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert n_int8 == 2 + 2 * (4 + 4 + 2) + 1  # in/out_proj, each layer's 10, the table


def test_quantize_kv_pre_matches_jax(q8):
    """On the same memory (the JAX package's, so that no value sits on the
    other side of a rounding boundary)."""
    _jq, _tq, jpre, _tpre, _dims = q8
    want = JTF.quantize_kv_pre(jpre)
    got = TTF.quantize_kv_pre(TTF.TransformerPre(
        *([torch.from_numpy(np.array(a)) for a in mem] for mem in (jpre.mem_k, jpre.mem_v))))
    for g, w in zip(got.mem_k + got.mem_v, want.mem_k + want.mem_v):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_greedy_plain_version_int8_equals_jax_kernel(q8, quantize_kv, early):
    jq, tq, jpre, tpre, _dims = q8
    want = np.asarray(JFT.fused_greedy_decode(
        JFT.prepare(jq, jpre, 2, jnp.float32, quantize_kv=quantize_kv), T_STEPS, 2,
        compute_dtype=jnp.float32, interpret=True, early_stop=early))
    ftp = FT.prepare(tq, tpre, 2, F32, quantize_kv=quantize_kv)
    assert ftp.w_qkv.dtype == ftp.w_fc2.dtype == torch.int8 and ftp.s_misc.shape == (2, 3, 256)
    assert (ftp.mem_kv.dtype == torch.int8) == quantize_kv
    got = FT.fused_greedy_decode(ftp, T_STEPS, 2, compute_dtype=F32, early_stop=early)
    np.testing.assert_array_equal(got.numpy(), want)
    if early:
        assert (want == 3).any() and (want[:, -1] == 0).any(), "rows should stop at different steps"


@pytest.mark.parametrize("early", [False, True])
def test_beam_plain_version_int8_equals_jax_kernel(q8, early):
    jq, tq, jpre, tpre, _dims = q8
    want = JFT.fused_beam_decode(JFT.prepare(jq, jpre, 2, jnp.float32), T_STEPS, 2, 2,
                                 compute_dtype=jnp.float32, interpret=True, early_stop=early)
    got = FT.fused_beam_decode(FT.prepare(tq, tpre, 2, F32), T_STEPS, 2, 2, compute_dtype=F32,
                               early_stop=early)
    for name, g, w in zip(("words", "srcs", "scores", "lengths"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name == "scores":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    with pytest.raises(ValueError, match="greedy decode only"):
        FT.fused_beam_decode(FT.prepare(tq, tpre, 2, F32, quantize_kv=True), T_STEPS, 2, 2,
                             compute_dtype=F32)


def test_quantize_kv_exact_on_integer_memory(q8):
    """With integer memory whose per-channel absmax is 127 the int8 grid is
    the identity: every path with ``quantize_kv`` equals the float decode."""
    _jq, tq, _jpre, _tpre, dims = q8
    rng = np.random.RandomState(3)

    def int_mem():
        m = rng.randint(-127, 128, (8, 6, 2, 128)).astype(np.float32)
        m[0, 0] = 127.0
        return torch.from_numpy(m)

    pre = TTF.TransformerPre([int_mem() for _ in range(2)], [int_mem() for _ in range(2)])
    for use_kernels in (False, True):
        full = TTF.greedy_decode_ids(tq, pre, dims, T_STEPS, compute_dtype=F32,
                                     use_kernels=use_kernels)
        got = TTF.greedy_decode_ids(tq, pre, dims, T_STEPS, compute_dtype=F32,
                                    use_kernels=use_kernels, quantize_kv=True)
        np.testing.assert_array_equal(got.numpy(), full.numpy())
    ftp = FT.prepare(tq, pre, 2, F32, quantize_kv=True)
    assert (ftp.mem_scale == 1.0).all()


def test_quantize_kv_plain_loop_equals_jax_xla(q8):
    jq, tq, jpre, tpre, dims = q8
    want = JTF.greedy_decode_ids(jq, jpre, JTF.TransformerDims(**DIMS), T_STEPS,
                                 compute_dtype=jnp.float32, use_pallas=False, quantize_kv=True)
    got = TTF.greedy_decode_ids(tq, tpre, dims, T_STEPS, compute_dtype=F32, quantize_kv=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("beam,quantize_kv", [(0, False), (4, False), (0, True)])
def test_load_bundle_int8_equal_jax(bundles, beam, quantize_kv):  # noqa: F811
    """Both port paths against the JAX ``load_bundle`` (its XLA path): the
    kernels' plain versions dequantize the head and the embedding at pack
    where the plain path scales after each product, a float32 rounding
    difference that the JAX package's own test holds id for id."""
    jcfg, tcfg, images = bundles
    jp, js, _jc, _jo, jdecode = jeval.load_bundle(jcfg, beam_size=beam, quantize=True,
                                                  quantize_kv=quantize_kv)
    want = np.asarray(jdecode(jp, js, images))
    model, _bc, opts, decode = teval.load_bundle(tcfg, beam_size=beam, quantize=True,
                                                 quantize_kv=quantize_kv, device="cpu")
    dec = model.params["decoder"]
    assert dec["layers"][1]["mlp"]["fc2"]["w_q"].dtype == torch.int8
    assert dec["embedding"]["table_q"].dtype == torch.int8 and opts.quantize_kv == quantize_kv
    np.testing.assert_array_equal(decode(model, images).numpy(), want)
    o = opts._replace(use_kernels=True)  # kernels D / E: their plain versions on the CPU
    got = (beam_decode(model, images, o, beam, stop_idx=o.stop_idx)[0] if beam
           else tcap.greedy_decode(model, images, o))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_kv_value_errors(bundles, tmp_path):  # noqa: F811
    _jcfg, tcfg, _images = bundles
    with pytest.raises(ValueError, match="greedy decode only"):
        teval.load_bundle(tcfg, beam_size=4, quantize_kv=True, device="cpu")
    src = os.path.join(tcfg.train.checkpoint_path, "infer")  # the same bundle, as an LSTM's
    shutil.copytree(src, tmp_path / "save" / "infer")
    with open(tmp_path / "save" / "infer" / "config.json") as f:
        c = json.load(f)
    c["model"]["decoder"]["arch"] = "lstm"
    with open(tmp_path / "save" / "infer" / "config.json", "w") as f:
        json.dump(c, f)
    lcfg = config_mod.replace_nested(tcfg, "train.checkpoint_path", str(tmp_path / "save"))
    with pytest.raises(ValueError, match="transformer-family"):
        teval.load_bundle(lcfg, quantize_kv=True, device="cpu")

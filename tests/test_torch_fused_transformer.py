"""Kernels D and E's plain versions (``ops/kernels/fused_transformer.py``)
on the CPU, in float32.

- ``fused_greedy_decode_reference`` and ``fused_beam_decode_reference``
  against the JAX package's whole-decode Pallas kernels run in interpret
  mode, as its own tests run them (``tests/test_fused_transformer.py``): one
  case each, the JAX kernels' smallest shapes (8 images; E with beam 2),
  early stop with rows (beams) that stop at different steps. Ids, words and
  back-pointers equal; beam scores to 1e-4;
- against the port's plain decode (``models/transformer.py``) for the other
  cases: greedy at B in {1, 3} fixed and early stop, beam at W in {1, 4}
  (slot-major rows against the plain path's image-major ones), M = 50
  memory slots (the full model's 49 + 1);
- ``prepare``'s packing (the weights packed once per bundle give the same
  tensors and ids), the wrappers taking the plain versions for CPU
  tensors (no launch counted), what they refuse (beam sizes outside 1..8),
  and the int8 pack (int8 layer streams with their scales; a decoder with
  only some int8 leaves is dequantized). The int8 decodes are held in
  ``tests/test_torch_transformer_int8.py``.

Dims of ``tests/test_fused_transformer.py``: V=2050, E=128, D=256, 2 layers,
2 heads, MLP ratio 2, M=6, T=5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import transformer as JTF
from myimagecaptioningmodel_tpu.ops.pallas import fused_transformer as JFT
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

F32 = torch.float32
T_STEPS = 5
DIMS = dict(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2, num_heads=2,
            mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)


def _setup(seed, n_img, M, stop_bias):
    jdims, tdims = JTF.TransformerDims(**DIMS), TTF.TransformerDims(**DIMS)
    jparams = JTF.init(jax.random.PRNGKey(seed), jdims)
    jparams = {**jparams, "out_bias": jparams["out_bias"].at[3].add(stop_bias)}
    rng = np.random.RandomState(seed)
    img_embed = rng.rand(n_img, M - 1, 256).astype(np.float32)
    gf = rng.rand(n_img, 256).astype(np.float32)
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jpre = JTF.precompute(jparams, jnp.asarray(img_embed), jnp.asarray(gf), 2, jnp.float32)
    tpre = TTF.precompute(tparams, torch.from_numpy(img_embed), torch.from_numpy(gf), 2, F32)
    return jdims, tdims, jparams, tparams, jpre, tpre


@pytest.fixture(scope="module")
def small():
    return _setup(0, 3, 6, 2.5)


def test_greedy_plain_version_equals_jax_kernel_interpret():
    _jd, tdims, jparams, tparams, jpre, tpre = _setup(0, 8, 6, 2.5)
    want = JFT.fused_greedy_decode(JFT.prepare(jparams, jpre, 2, jnp.float32), T_STEPS, 2,
                                   compute_dtype=jnp.float32, interpret=True, early_stop=True)
    want = np.asarray(want)
    assert (want == 3).any() and (want[:, -1] == 0).any(), "rows should stop at different steps"
    ftp = FT.prepare(tparams, tpre, 2, F32)
    got = FT.fused_greedy_decode_reference(ftp, T_STEPS, 2, compute_dtype=F32, early_stop=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_plain_version_equals_jax_kernel_interpret():
    _jd, tdims, jparams, tparams, jpre, tpre = _setup(1, 8, 6, 3.0)
    want = JFT.fused_beam_decode(JFT.prepare(jparams, jpre, 2, jnp.float32), T_STEPS, 2, 2,
                                 compute_dtype=jnp.float32, interpret=True, early_stop=True)
    got = FT.fused_beam_decode_reference(FT.prepare(tparams, tpre, 2, F32), T_STEPS, 2, 2,
                                         compute_dtype=F32, early_stop=True)
    for name, g, w in zip(("words", "srcs", "scores", "lengths"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name == "scores":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (np.asarray(want[0]) == 3).any()


@pytest.mark.parametrize("B", [1, 3])
def test_greedy_plain_version_equals_plain_decode(small, B):
    _jd, tdims, _jp, tparams, _jpre, tpre = small
    pre = TTF.TransformerPre([k[:B] for k in tpre.mem_k], [v[:B] for v in tpre.mem_v])
    ftp = FT.prepare(tparams, pre, 2, F32)
    for early in (False, True):
        want = TTF.greedy_decode_ids(tparams, pre, tdims, T_STEPS, compute_dtype=F32,
                                     early_stop=early)
        got = FT.fused_greedy_decode_reference(ftp, T_STEPS, 2, compute_dtype=F32,
                                               early_stop=early)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("W", [1, 4])
def test_beam_plain_version_equals_plain_decode(small, W):
    _jd, tdims, _jp, tparams, _jpre, tpre = small
    ftp = FT.prepare(tparams, tpre, 2, F32)
    for early in (False, True):
        want_ids, want_sc = TTF.beam_search_ids(tparams, tpre, tdims, T_STEPS, W,
                                                compute_dtype=F32, early_stop=early,
                                                length_norm=0.7)
        quad = FT.fused_beam_decode_reference(ftp, T_STEPS, 2, W, compute_dtype=F32,
                                              early_stop=early)
        ids, sc = beam_backtrack(*quad, length_norm=0.7)
        np.testing.assert_array_equal(ids.numpy(), want_ids.numpy())
        np.testing.assert_allclose(sc.numpy(), want_sc.numpy(), rtol=1e-4, atol=1e-4)


def test_fifty_memory_slots():
    """M = 49 + 1, the full model's memory, through both plain versions."""
    _jd, tdims, _jp, tparams, _jpre, tpre = _setup(2, 2, 50, 0.0)
    ftp = FT.prepare(tparams, tpre, 2, F32)
    assert ftp.mem_kv.shape == (2, 2, 2, 50, 256)
    np.testing.assert_array_equal(
        FT.fused_greedy_decode_reference(ftp, 3, 2, compute_dtype=F32).numpy(),
        TTF.greedy_decode_ids(tparams, tpre, tdims, 3, compute_dtype=F32).numpy())
    ids, _ = beam_backtrack(*FT.fused_beam_decode_reference(ftp, 3, 2, 3, compute_dtype=F32),
                            length_norm=0.0)
    np.testing.assert_array_equal(
        ids.numpy(), TTF.beam_search_ids(tparams, tpre, tdims, 3, 3, compute_dtype=F32)[0].numpy())


def test_prepare_packing(small):
    _jd, _td, _jp, tparams, _jpre, tpre = small
    ftp = FT.prepare(tparams, tpre, 2, torch.bfloat16)
    assert ftp.dims == (2, 256, 512, 6, 3, 2050, 128)
    a = tparams["layers"][1]["attn"]
    np.testing.assert_array_equal(ftp.w_qkv[1, :, 256:512].float().numpy(),
                                  a["wk"]["w"].to(torch.bfloat16).float().numpy())
    assert ftp.w_qkv.dtype == torch.bfloat16 and ftp.b_qkv.dtype == F32
    assert not ftp.b_qkv[:, 256:512].any()  # wk has no bias
    np.testing.assert_array_equal(ftp.b_qkv[1, 512:].numpy(), a["wv"]["b"].numpy())
    np.testing.assert_array_equal(ftp.ln[0, 5].numpy(), tparams["layers"][0]["ln3"]["b"].numpy())
    np.testing.assert_array_equal(
        ftp.mem_kv[1, 1, 2].float().numpy(),
        tpre.mem_v[1][2].reshape(6, 256).to(torch.bfloat16).float().numpy())


def test_weights_packed_once_equal_packed_per_decode(small):
    """A loaded bundle packs its weights once (``pack_weights``) and hands
    them to every decode: the same tensors, the same ids."""
    _jd, tdims, _jp, tparams, _jpre, tpre = small
    packed = FT.pack_weights(tparams, F32)
    assert packed.mem_kv is None
    for got, want in zip(FT.prepare(tparams, tpre, 2, F32, packed),
                         FT.prepare(tparams, tpre, 2, F32)):
        assert (got is None and want is None) or torch.equal(got, want)  # None: int8 scales
    for decode in (TTF.greedy_decode_ids, functools.partial(TTF.beam_search_ids, beam_size=2)):
        got = decode(tparams, tpre, tdims, T_STEPS, compute_dtype=F32, use_kernels=True,
                     packed=packed)
        want = decode(tparams, tpre, tdims, T_STEPS, compute_dtype=F32)
        np.testing.assert_array_equal(np.asarray(got[0] if isinstance(got, tuple) else got),
                                      np.asarray(want[0] if isinstance(want, tuple) else want))


def test_wrappers_on_cpu_and_what_they_refuse(small):
    _jd, tdims, _jp, tparams, _jpre, tpre = small
    ftp = FT.prepare(tparams, tpre, 2, F32)
    n_d, n_e = FT.fused_greedy_decode.launches, FT.fused_beam_decode.launches
    np.testing.assert_array_equal(
        FT.fused_greedy_decode(ftp, T_STEPS, 2, compute_dtype=F32).numpy(),
        FT.fused_greedy_decode_reference(ftp, T_STEPS, 2, compute_dtype=F32).numpy())
    for got, want in zip(FT.fused_beam_decode(ftp, T_STEPS, 2, 2, compute_dtype=F32),
                         FT.fused_beam_decode_reference(ftp, T_STEPS, 2, 2, compute_dtype=F32)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (FT.fused_greedy_decode.launches, FT.fused_beam_decode.launches) == (n_d, n_e)
    for W in (0, 9):
        with pytest.raises(ValueError, match="beam sizes 1 to 8"):
            FT.fused_beam_decode(ftp, T_STEPS, 2, W, compute_dtype=F32)
    q = dict(tparams, out_proj={"w_q": torch.ones(256, 128, dtype=torch.int8),
                                "scale": torch.full((128,), 0.5)})
    part = FT.prepare(q, tpre, 2, F32)  # only out_proj int8: dequantized, float streams
    assert part.s_qkv is None and part.w_qkv.dtype == F32 and (part.out_proj_w == 0.5).all()
    full = FT.prepare(TTF.quantize_transformer_decoder(tparams), tpre, 2, torch.bfloat16)
    assert full.w_o.dtype == full.w_fc1.dtype == torch.int8 and full.table.dtype == torch.bfloat16
    assert full.s_qkv.shape == (2, 768) and full.s_fc1.shape == (2, 512)
    assert full.s_fc2.shape == (2, 256) and full.in_proj_w.dtype == torch.bfloat16

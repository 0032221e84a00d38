"""The port's kernel modules (myimagecaptioningmodel_tpu_torch/ops/kernels)
against the JAX package's Pallas kernels, which run here in interpret mode.

On CPU tensors the port's wrappers run their plain versions; those are held
against JAX's kernels. Tolerances: float32 to 1e-5 for h', c', proj and the
top-k head's values and logsumexp (1e-4 with an int8 table, whose products
run on bfloat16-rounded operands), ids exact.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import decoder as JD
from myimagecaptioningmodel_tpu.ops.pallas import fused_step as JFS
from myimagecaptioningmodel_tpu.ops.pallas import vocab_head as JVH
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as TVH

F32 = jnp.float32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- kernel A: vocab argmax ------------------------------------------------


@pytest.mark.parametrize("V", [100, 2048, 5000])
def test_vocab_argmax_matches_jax_kernel(V):
    """Includes V=5000 with block_v=1024: a ragged tail block."""
    rng = np.random.RandomState(0)
    B, E = 16, 32
    proj, table, bias = (rng.randn(B, E), rng.randn(V, E), rng.randn(V))
    proj, table, bias = (a.astype(np.float32) for a in (proj, table, bias))
    ref = JVH.greedy_vocab_argmax(
        jnp.asarray(proj), jnp.asarray(table), jnp.asarray(bias),
        block_v=1024, interpret=True,
    )
    before = TVH.greedy_vocab_argmax.launches
    out = TVH.greedy_vocab_argmax(*map(torch.as_tensor, (proj, table, bias)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_np(out), _np(ref))
    # a CPU call runs the plain version and launches nothing
    assert TVH.greedy_vocab_argmax.launches == before


def test_vocab_argmax_ties_take_lowest_index():
    """Equal maxima across blocks and within a block -> lowest index, as
    jnp.argmax."""
    rng = np.random.RandomState(1)
    B, E, V = 6, 16, 3000
    table = rng.randn(V, E).astype(np.float32)
    proj = rng.randn(B, E).astype(np.float32)
    bias = np.full(V, -50.0, np.float32)
    winners = [2999, 1500, 1024, 1023, 7, 0]
    for w in winners:  # copies of one row, same bias: exact ties
        table[w] = table[0] * 0 + 3.0
        bias[w] = 0.0
    proj[:] = np.abs(proj)
    ref = JVH.greedy_vocab_argmax(jnp.asarray(proj), jnp.asarray(table),
                                  jnp.asarray(bias), block_v=1024, interpret=True)
    out = TVH.greedy_vocab_argmax(*map(torch.as_tensor, (proj, table, bias)))
    np.testing.assert_array_equal(_np(out), _np(ref))
    assert (_np(out) == 0).all()


def test_vocab_argmax_padded_rows_never_win():
    """Padded vocab rows carry a -1e9 bias (decoder.init) and so never win."""
    rng = np.random.RandomState(2)
    B, E, V, real = 8, 16, 2048, 2000
    proj = rng.randn(B, E).astype(np.float32)
    table = rng.randn(V, E).astype(np.float32)
    table[real:] = 100.0
    bias = np.zeros(V, np.float32)
    bias[real:] = -1e9
    out = TVH.greedy_vocab_argmax(*map(torch.as_tensor, (proj, table, bias)))
    ref = JVH.greedy_vocab_argmax(jnp.asarray(proj), jnp.asarray(table),
                                  jnp.asarray(bias), block_v=1024, interpret=True)
    np.testing.assert_array_equal(_np(out), _np(ref))
    assert _np(out).max() < real


def test_vocab_argmax_int8_matches_jax_kernel():
    """int8 table + per-row scale: proj rounded to bfloat16, the scale after
    the product, then the bias (vocab_head.py:39-54)."""
    rng = np.random.RandomState(2)
    B, E, V = 8, 32, 1500
    proj = rng.randn(B, E).astype(np.float32)
    table_q = rng.randint(-127, 128, (V, E)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, V).astype(np.float32)
    bias = rng.randn(V).astype(np.float32)
    ref = JVH.greedy_vocab_argmax(jnp.asarray(proj), jnp.asarray(table_q), jnp.asarray(bias),
                                  scale=jnp.asarray(scale), block_v=512, interpret=True)
    out = TVH.greedy_vocab_argmax(*map(torch.as_tensor, (proj, table_q, bias, scale)))
    np.testing.assert_array_equal(_np(out), _np(ref))


# ---- kernel C: top-k vocab head + logsumexp ---------------------------------


@pytest.mark.parametrize("V,k,block_v", [(100, 4, 64), (2048, 4, 512), (3000, 8, 1024)])
def test_topk_head_matches_jax_kernel(V, k, block_v):
    rng = np.random.RandomState(3)
    B, E = 16, 32
    proj, table, bias = (rng.randn(B, E), rng.randn(V, E), rng.randn(V))
    proj, table, bias = (a.astype(np.float32) for a in (proj, table, bias))
    rv, ri, rlse = JVH.topk_vocab_head(jnp.asarray(proj), jnp.asarray(table),
                                       jnp.asarray(bias), k=k, block_v=block_v,
                                       interpret=True)
    before = TVH.topk_vocab_head.launches
    v, i, lse = TVH.topk_vocab_head(*map(torch.as_tensor, (proj, table, bias)), k)
    assert (v.dtype, i.dtype, lse.dtype) == (torch.float32, torch.int32, torch.float32)
    np.testing.assert_array_equal(_np(i), _np(ri))
    np.testing.assert_allclose(_np(v), _np(rv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-5)
    assert TVH.topk_vocab_head.launches == before  # CPU: the plain version


def test_topk_head_int8_matches_jax_kernel():
    rng = np.random.RandomState(4)
    B, E, V, k = 8, 16, 1000, 4
    proj = rng.randn(B, E).astype(np.float32)
    table_q = rng.randint(-127, 128, (V, E)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, V).astype(np.float32)
    bias = rng.randn(V).astype(np.float32)
    rv, ri, rlse = JVH.topk_vocab_head(jnp.asarray(proj), jnp.asarray(table_q),
                                       jnp.asarray(bias), k=k, scale=jnp.asarray(scale),
                                       block_v=256, interpret=True)
    v, i, lse = TVH.topk_vocab_head(*map(torch.as_tensor, (proj, table_q, bias)), k,
                                    scale=torch.as_tensor(scale))
    np.testing.assert_array_equal(_np(i), _np(ri))
    np.testing.assert_allclose(_np(v), _np(rv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-4, atol=1e-4)


def test_topk_head_ties_in_ascending_index_order():
    """Equal logits across and within blocks come out lowest index first, as
    jax.lax.top_k orders them."""
    rng = np.random.RandomState(5)
    B, E, V, k = 4, 16, 3000, 6
    table = rng.randn(V, E).astype(np.float32) * 0.01
    proj = np.abs(rng.randn(B, E)).astype(np.float32)
    bias = np.full(V, -50.0, np.float32)
    winners = [2999, 1500, 1024, 1023, 7, 0]
    table[winners] = 3.0
    bias[winners] = 0.0
    _v, ri, _l = JVH.topk_vocab_head(jnp.asarray(proj), jnp.asarray(table), jnp.asarray(bias),
                                     k=k, block_v=1024, interpret=True)
    _v, i, _l = TVH.topk_vocab_head(*map(torch.as_tensor, (proj, table, bias)), k)
    np.testing.assert_array_equal(_np(i), _np(ri))
    assert (_np(i) == sorted(winners)).all()


def test_topk_stable_orders_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = TVH.topk_stable(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tv), _np(jv))


def test_topk_head_refuses_k_above_limit():
    proj, table, bias = torch.zeros(2, 16), torch.zeros(100, 16), torch.zeros(100)
    with pytest.raises(ValueError, match=str(TVH.TOPK_MAX_K)):
        TVH.topk_vocab_head(proj, table, bias, TVH.TOPK_MAX_K + 1)
    with pytest.raises(ValueError):
        TVH.topk_vocab_head(proj, table[:3], bias[:3], 4)  # k > V
    assert TVH.topk_vocab_head(proj, table, bias, TVH.TOPK_MAX_K)[1].shape == (2, 32)


# ---- kernel B: fused decode step -------------------------------------------


@pytest.fixture(scope="module")
def step_params():
    dims = JD.DecoderDims(vocab_size=2000, embedding_size=128, hidden_dim=256,
                          feat_channels=1280, vocab_pad_multiple=128)
    params = JD.init(jax.random.PRNGKey(0), dims)
    return dims, params, tree_to_torch(jax.tree_util.tree_map(np.asarray, params))


def _precomputed(step_params, B, seed=0):
    dims, params, tparams = step_params
    rng = np.random.RandomState(seed)
    img_embed = rng.rand(B, 49, dims.hidden_dim).astype(np.float32)
    global_feat = rng.rand(B, dims.hidden_dim).astype(np.float32)
    jpre = JD.precompute(params, jnp.asarray(img_embed), jnp.asarray(global_feat), F32)
    tpre = TD.precompute(tparams, torch.as_tensor(img_embed),
                         torch.as_tensor(global_feat), torch.float32)
    return jpre, tpre


def test_precompute_and_prepare_match_jax(step_params):
    _dims, params, tparams = step_params
    jpre, tpre = _precomputed(step_params, 16)
    for t, j in zip(tpre, jpre):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)
    jfp = JFS.prepare(params, jpre, padding_idx=0, dt=F32)
    tfp = TFS.prepare(tparams, tpre, padding_idx=0, dt=torch.float32)
    for name, t, j in zip(TFS.FusedStepParams._fields, tfp, jfp):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5, err_msg=name)
    # the gather table's padding row is zeroed, the head table's is not
    assert float(tfp.emb_table[0].abs().max()) == 0.0
    assert float(tfp.head_table[0].abs().max()) > 0.0


@pytest.mark.parametrize("B", [1, 5, 16])
@pytest.mark.parametrize("with_head", [True, False])
def test_fused_step_matches_jax_kernel(step_params, with_head, B):
    dims, params, tparams = step_params
    jpre, tpre = _precomputed(step_params, B, seed=B)
    jfp = JFS.prepare(params, jpre, padding_idx=0, dt=F32)
    tfp = TFS.prepare(tparams, tpre, padding_idx=0, dt=torch.float32)
    rng = np.random.RandomState(1)
    H = dims.hidden_dim
    h = (rng.randn(B, H) * 0.1).astype(np.float32)
    c = (rng.randn(B, H) * 0.1).astype(np.float32)
    word = rng.randint(0, dims.vocab_size, (B,))
    word[0] = 0  # the padding id embeds to zero
    jout = JFS.fused_decode_step(
        jfp, jnp.take(jfp.emb_table, jnp.asarray(word), axis=0), jnp.asarray(h),
        jnp.asarray(c), jpre.img_k, jpre.img_v, with_head=with_head,
        compute_dtype=F32, interpret=True,
    )
    before = TFS.fused_decode_step.launches
    tout = TFS.fused_decode_step(
        tfp, tfp.emb_table[torch.as_tensor(word)], torch.as_tensor(h),
        torch.as_tensor(c), tpre.img_k, tpre.img_v, with_head=with_head,
        compute_dtype=torch.float32,
    )
    assert TFS.fused_decode_step.launches == before
    for name, t, j in zip(("h", "c", "proj"), tout, jout):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(_np(tout[3]), _np(jout[3]))
    assert tout[3].dtype == torch.int32

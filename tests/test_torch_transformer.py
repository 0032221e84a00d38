"""The port's transformer decoder family (``models/transformer.py``) against
the JAX package's, on the CPU, in float32.

Weights come from the JAX package's ``init`` through the bridge; inputs from
a numpy seed. Dims of ``tests/test_fused_transformer.py``: V=2050 (padded to
2050), E=128, D=256, 2 layers, 2 heads, MLP ratio 2, M=6 memory slots, T=5.

- the bridge: the JAX pytree, a flax msgpack bundle and an npz round trip
  give the same port tree, ``layers`` a list in layer order;
- per module to rtol 1e-5, atol 1e-5: LayerNorm, attention with its mask,
  ``precompute``, three KV-cached decode steps (x and the caches),
  ``head_logits``, ``teacher_forcing_logits``;
- greedy ids id for id against the JAX XLA path, B in {1, 3, 8}, fixed
  length and early stop, a ``<stop>`` bias of 0, 2.5 and 1e4; the port's
  plain loop and its kernel path (kernel D's plain version on CPU tensors);
- beam search (W in {1, 2, 4}, early stop, length norm 0 and 0.7): ids equal
  and scores to 1e-4 against the JAX XLA beam, both port paths.

The slice as a whole (bundle, ``load_bundle``, ``CaptionService``) is held in
``tests/test_torch_transformer_slice.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from myimagecaptioningmodel_tpu.models import transformer as JTF
from myimagecaptioningmodel_tpu_torch.compat.from_jax import read_msgpack, tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt

F32 = torch.float32
T_STEPS = 5
DIMS = dict(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2, num_heads=2,
            mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)
JDIMS = JTF.TransformerDims(**DIMS)


# compiled once per static setting; the <stop> bias rides in the params
@functools.partial(jax.jit, static_argnames=("early",))
def _jax_greedy(params, pre, early):
    return JTF.greedy_decode_ids(params, pre, JDIMS, T_STEPS, compute_dtype=jnp.float32,
                                 use_pallas=False, early_stop=early)


@functools.partial(jax.jit, static_argnames=("W", "early", "length_norm"))
def _jax_beam(params, pre, W, early, length_norm):
    return JTF.beam_search_ids(params, pre, JDIMS, T_STEPS, W, length_norm=length_norm,
                               compute_dtype=jnp.float32, use_pallas=False, early_stop=early)


@pytest.fixture(scope="module")
def setup():
    jdims, tdims = JTF.TransformerDims(**DIMS), TTF.TransformerDims(**DIMS)
    jparams = JTF.init(jax.random.PRNGKey(0), jdims)
    rng = np.random.RandomState(0)
    B, M = 8, 6
    img_embed = rng.rand(B, M - 1, 256).astype(np.float32)
    gf = rng.rand(B, 256).astype(np.float32)
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jpre = JTF.precompute(jparams, jnp.asarray(img_embed), jnp.asarray(gf), 2, jnp.float32)
    tpre = TTF.precompute(tparams, torch.from_numpy(img_embed), torch.from_numpy(gf), 2, F32)
    return jdims, tdims, jparams, tparams, jpre, tpre, img_embed, gf


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=tol, atol=tol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_bridge_pytree_msgpack_npz_agree(setup, tmp_path):
    _jd, _td, jparams, tparams, *_ = setup
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    from_msgpack = tree_to_torch(read_msgpack(serialization.to_bytes(np_tree)), "cpu")
    path = str(tmp_path / "p.npz")
    np.savez(path, **tckpt.flatten_tree(np_tree))
    with np.load(path) as z:
        from_npz = tree_to_torch(tckpt.unflatten_tree({k: z[k] for k in z.files}), "cpu")
    want = list(_leaves(tparams))
    assert isinstance(tparams["layers"], list) and len(tparams["layers"]) == 2
    for other in (from_msgpack, from_npz):
        assert isinstance(other["layers"], list)
        got = list(_leaves(other))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), p
    # layer order kept: layer 1's weights are JAX layer 1's
    np.testing.assert_array_equal(from_npz["layers"][1]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(jparams["layers"][1]["attn"]["wq"]["w"]))


def test_layer_norm_attend_precompute(setup):
    _jd, _td, jparams, tparams, jpre, tpre, *_ = setup
    x = np.random.RandomState(1).randn(3, 4, 256).astype(np.float32) * 2 + 0.5
    ln = jparams["layers"][0]["ln1"]
    _close(TTF._layer_norm(tparams["layers"][0]["ln1"], torch.from_numpy(x)),
           JTF._layer_norm(ln, jnp.asarray(x)))
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(3, 4, 2, 128).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((4, 4), bool))[None]
    _close(TTF._attend(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)),
           JTF._attend(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
    for got, want in zip(tpre.mem_k + tpre.mem_v, jpre.mem_k + jpre.mem_v):
        _close(got, want)


def test_three_decode_steps(setup):
    jdims, tdims, jparams, tparams, jpre, tpre, *_ = setup
    B = 8
    words = np.random.RandomState(3).randint(0, 2050, (3, B))
    words[1, :2] = 0  # <pad> embeds to zero
    jc = JTF._init_cache(jdims, B, T_STEPS, jnp.float32)
    tc = TTF._init_cache(tdims, B, T_STEPS, F32, "cpu")
    jl, tl = JTF.prepare_decode_layers(jparams), TTF.prepare_decode_layers(tparams)
    for t in range(3):
        jx, jc = JTF._decode_step(jparams, jpre, jdims, jnp.asarray(words[t]), jc, jnp.int32(t),
                                  0, jnp.float32, layers=jl)
        tx = TTF._decode_step(tparams, tpre, tdims, torch.from_numpy(words[t]), tc, t, 0, F32,
                              layers=tl)
        _close(tx, jx)
        for (jk, jv), (tk, tv) in zip(jc, tc):
            _close(tk, jk)
            _close(tv, jv)
    _close(TTF.head_logits(tparams, tx, F32), JTF.head_logits(jparams, jx, jnp.float32), 1e-4)


def test_teacher_forcing_logits(setup):
    jdims, tdims, jparams, tparams, jpre, tpre, *_ = setup
    src = np.random.RandomState(4).randint(0, 2050, (8, T_STEPS))
    src[:, 3:] = 0
    _close(TTF.teacher_forcing_logits(tparams, tpre, torch.from_numpy(src), tdims, 0, F32),
           JTF.teacher_forcing_logits(jparams, jpre, jnp.asarray(src), jdims, 0, jnp.float32),
           1e-4)


def _biased(params, stop_bias, torch_tree=False):
    if torch_tree:
        p = dict(params)
        p["out_bias"] = params["out_bias"].clone()
        p["out_bias"][3] += stop_bias
        return p
    return {**params, "out_bias": params["out_bias"].at[3].add(stop_bias)}


def _sub(pre, B, cls):
    return cls([k[:B] for k in pre.mem_k], [v[:B] for v in pre.mem_v])


@pytest.mark.parametrize("stop_bias", [0.0, 2.5, 1e4])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_greedy_ids_equal_jax(setup, B, stop_bias):
    jdims, tdims, jparams, tparams, jpre, tpre, *_ = setup
    jp, tp = _biased(jparams, stop_bias), _biased(tparams, stop_bias, True)
    jpre_b = JTF.TransformerPre(tuple(k[:B] for k in jpre.mem_k), tuple(v[:B] for v in jpre.mem_v))
    tpre_b = _sub(tpre, B, TTF.TransformerPre)
    for early in (False, True):
        want = np.asarray(_jax_greedy(jp, jpre_b, early))
        for use_kernels in (False, True):
            got = TTF.greedy_decode_ids(tp, tpre_b, tdims, T_STEPS, compute_dtype=F32,
                                        use_kernels=use_kernels, early_stop=early)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{early} {use_kernels}")
        if stop_bias >= 1e4 and early:
            assert (want[:, 0] == 3).all() and (want[:, 1:] == 0).all()


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_beam_equal_jax(setup, W, early):
    jdims, tdims, jparams, tparams, jpre, tpre, *_ = setup
    stop_bias = 3.0 if early else 0.0  # beams that finish at different steps
    jp, tp = _biased(jparams, stop_bias), _biased(tparams, stop_bias, True)
    jpre_b = JTF.TransformerPre(tuple(k[:3] for k in jpre.mem_k), tuple(v[:3] for v in jpre.mem_v))
    tpre_b = _sub(tpre, 3, TTF.TransformerPre)
    for length_norm in (0.0, 0.7):
        want_ids, want_sc = _jax_beam(jp, jpre_b, W, early, length_norm)
        for use_kernels in (False, True):
            ids, sc = TTF.beam_search_ids(tp, tpre_b, tdims, T_STEPS, W, length_norm=length_norm,
                                          compute_dtype=F32, use_kernels=use_kernels,
                                          early_stop=early)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
            np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=1e-4, atol=1e-4)

"""Kernel B's packed layout, its plain step and attention, and the LSTM
decodes' CUDA-graph paths (``ops/kernels/fused_step.py``,
``inference/beam.py``), on the CPU.

- ``pack_weights`` de-interleaved gives ``prepare``'s gate matrices exactly
  (float and int8 params), and its other tensors equal ``prepare``'s;
- the plain step on the packed layout (``reference_step`` on a
  ``PackedStep``, and ``fused_decode_step`` taking it for CPU tensors, the
  word rows gathered in its prologue) equals JAX ``reference_step`` and the
  JAX kernel in interpret mode, in float32 (1e-5: the same formula, other
  summation orders);
- the kernels' attention, summed from eight H-slice partials in slice
  order (``attention_slices``), equals the plain step's to 1e-5;
- the gathered word rows (the padding id's zeroed) give the step on
  ``prepare``'s ``emb_table[word]`` bit for bit;
- the greedy and beam graph paths with the capture stubbed (as
  ``tests/test_torch_decode_graphs.py`` does): ``step_key`` differs in every
  int and weight address and not in the batch; one capture, each batch
  copied in and decoded as the eager path decodes it, a replay without the
  copy decodes the previous batch; every call counts ``max_length`` steps
  of kernels B and A (greedy) or B and C (beam);
- the beam search that runs every step after every beam has finished
  (<pad> at zero cost, identity back-pointers) gives the early-stopped
  plain loop's ids and scores (``length_norm`` 0 and 1, so lengths count
  too) and JAX's fixed-length scan's, to 1e-5.

Dims: V=2000 (padded to 2048), E=128, H=256, k=49 (the JAX kernel's);
the beam and graph cases V=19, E=8, H=16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.inference import beam as jbeam
from myimagecaptioningmodel_tpu.models import decoder as JD
from myimagecaptioningmodel_tpu.ops.pallas import fused_step as JFS
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.inference import beam as TB
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.ops.kernels import decode_graphs as DG
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as TVH
from myimagecaptioningmodel_tpu_torch.ops.quantization import quantize_decoder

F32 = jnp.float32
T32 = torch.float32


@pytest.fixture(scope="module")
def step_params():
    dims = JD.DecoderDims(vocab_size=2000, embedding_size=128, hidden_dim=256,
                          feat_channels=1280, vocab_pad_multiple=128)
    params = JD.init(jax.random.PRNGKey(1), dims)
    return dims, params, tree_to_torch(jax.tree_util.tree_map(np.asarray, params))


def _pre(step_params, B, seed):
    dims, params, tparams = step_params
    rng = np.random.RandomState(seed)
    img = rng.rand(B, 49, dims.hidden_dim).astype(np.float32)
    gf = rng.rand(B, dims.hidden_dim).astype(np.float32)
    return (JD.precompute(params, jnp.asarray(img), jnp.asarray(gf), F32),
            TD.precompute(tparams, torch.as_tensor(img), torch.as_tensor(gf), T32))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_pack_weights_deinterleaves_to_prepare(step_params, int8, dt):
    _dims, _params, tparams = step_params
    tparams = quantize_decoder(tparams) if int8 else tparams
    _jpre, tpre = _pre(step_params, 3, 0)
    fp = TFS.prepare(tparams, tpre, 0, dt)
    pk = TFS.with_batch(TFS.pack_weights(tparams, dt), tparams, tpre)
    E = fp.w_word_cat.shape[0]
    w = TFS.deinterleave_gates(pk.w_gate)
    assert torch.equal(w[:E], fp.w_word_cat) and torch.equal(w[E:], fp.w_hh_cat)
    assert torch.equal(TFS.interleave_gates(w), pk.w_gate)
    # the interleaving: gate q of unit j at column (j // 16) 80 + 16 q + j % 16
    H = fp.w_p.shape[0]
    for q, j in ((0, 0), (4, 17), (2, H - 1), (3, 200)):
        assert torch.equal(pk.w_gate[:, (j // 16) * 80 + 16 * q + j % 16],
                           torch.cat([fp.w_word_cat, fp.w_hh_cat])[:, q * H + j])
    unpacked = TFS.unpack(pk)
    for name in TFS.FusedStepParams._fields:
        want, got = getattr(fp, name), getattr(unpacked, name)
        if name == "emb_table":  # the compute dtype's table, its padding row zeroed
            want = want.to(dt).float()
        assert torch.equal(got, want), name
    assert torch.equal(TFS.pack_step(fp).w_gate, pk.w_gate)


@pytest.mark.parametrize("with_head", [True, False])
@pytest.mark.parametrize("B", [1, 5])
def test_packed_plain_step_matches_jax(step_params, B, with_head):
    dims, params, tparams = step_params
    jpre, tpre = _pre(step_params, B, B)
    jfp = JFS.prepare(params, jpre, padding_idx=0, dt=F32)
    pk = TFS.with_batch(TFS.pack_weights(tparams, T32), tparams, tpre)
    rng = np.random.RandomState(2)
    H = dims.hidden_dim
    h = (rng.randn(B, H) * 0.1).astype(np.float32)
    c = (rng.randn(B, H) * 0.1).astype(np.float32)
    word = rng.randint(0, dims.vocab_size, (B,)).astype(np.int32)
    word[0] = 0  # the padding id embeds to zero
    jemb = jnp.take(jfp.emb_table, jnp.asarray(word), axis=0)
    jargs = (jemb, jnp.asarray(h), jnp.asarray(c), jpre.img_k, jpre.img_v)
    wants = [JFS.reference_step(jfp, *jargs, with_head=with_head, compute_dtype=F32),
             JFS.fused_decode_step(jfp, *jargs, with_head=with_head, compute_dtype=F32,
                                   interpret=True)]
    targs = (torch.as_tensor(h), torch.as_tensor(c), tpre.img_k, tpre.img_v)
    n = TFS.fused_decode_step.launches
    gots = [TFS.reference_step(pk, TFS.gather_words(pk.table, torch.as_tensor(word), 0), *targs,
                               with_head=with_head, compute_dtype=T32),
            TFS.fused_decode_step(pk, None, *targs, with_head=with_head, compute_dtype=T32,
                                  word=torch.as_tensor(word), padding_idx=0)]
    assert TFS.fused_decode_step.launches == n  # CPU tensors: the plain version
    for want in wants:
        for got in gots:
            for name, t, j in zip(("h", "c", "proj"), got, want):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            if with_head:
                np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_attention_slices_match_the_plain_step():
    g = torch.Generator().manual_seed(0)
    B, k, H = 3, 49, 256
    hid_emb, sent_key, sentinel, p_hid = (torch.randn(B, H, generator=g) for _ in range(4))
    img_k, img_v = (torch.randn(B, k, H, generator=g) for _ in range(2))
    w_score, b_score = torch.randn(1, H, generator=g) / 16, torch.randn(1, generator=g)
    got = TFS.attention_slices(hid_emb, sent_key, sentinel, p_hid, img_k, img_v, w_score, b_score)
    want = TFS._attention(w_score, b_score, hid_emb, sent_key, sentinel, img_k, img_v) + p_hid
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gathered_words_equal_the_emb_table_step(step_params, dt):
    _dims, _params, tparams = step_params
    _jpre, tpre = _pre(step_params, 4, 3)
    fp = TFS.prepare(tparams, tpre, 0, dt)
    word = torch.tensor([0, 7, 0, 1999], dtype=torch.int32)  # the padding row included
    g = torch.Generator().manual_seed(4)
    h, c = torch.randn(4, 256, generator=g) * 0.1, torch.randn(4, 256, generator=g) * 0.1
    args = (h, c, tpre.img_k.to(dt), tpre.img_v.to(dt))
    want = TFS.reference_step(fp, fp.emb_table[word.long()], *args, compute_dtype=dt)
    got = TFS.fused_decode_step(TFS.pack_step(fp), None, *args, compute_dtype=dt, word=word)
    for t, w in zip(got, want):
        assert torch.equal(t, w)


# ---- the graph paths, capture stubbed --------------------------------------------

DIMS = JD.DecoderDims(vocab_size=19, embedding_size=8, hidden_dim=16, feat_channels=12)
T = 9


class _Stubbed(DG.DecodeGraphs):
    """Capture runs the decode function once and keeps it; replay runs it
    again on the graph's own tensors, as the card's graph would."""

    def capture(self, record, device):
        return record, record()

    def replay(self, graph):
        graph()


def _small(seed=3, stop_bias=1.0):
    p = dict(JD.init(jax.random.PRNGKey(seed), DIMS))
    p["out_proj"] = {**p["out_proj"], "w": p["out_proj"]["w"] * 4.0}
    p["out_bias"] = p["out_bias"].at[3].add(stop_bias)
    return jax.tree_util.tree_map(np.asarray, p)


def _small_pre(params, B, seed):
    rng = np.random.RandomState(seed)
    img, gf = rng.randn(B, 4, 16).astype(np.float32), rng.randn(B, 16).astype(np.float32)
    return (JD.precompute(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(img),
                          jnp.asarray(gf), F32),
            TD.precompute(tree_to_torch(params), torch.as_tensor(img), torch.as_tensor(gf), T32))


def test_step_key_differs_in_every_int_and_weight_not_the_batch():
    tp = tree_to_torch(_small())
    pk = TFS.pack_weights(tp, T32)
    a = TFS.with_batch(pk, tp, _small_pre(_small(), 3, 0)[1])
    b = TFS.with_batch(pk, tp, _small_pre(_small(), 3, 1)[1])
    ints = TFS._ints(T32, 3, a, 4, 3, T, 2, 0, 3, True)
    assert len(ints) == 12
    assert TFS.step_key("e", a, ints) == TFS.step_key("e", b, list(ints))  # the batch: copied in
    for i in range(len(ints)):
        changed = list(ints)
        changed[i] += 1
        assert TFS.step_key("e", a, ints) != TFS.step_key("e", a, changed), i
    for field in TFS._PTR_FIELDS:
        other = a._replace(**{field: getattr(a, field).clone()})
        assert TFS.step_key("e", a, ints) != TFS.step_key("e", other, ints), field
    assert TFS.step_key("e", a, ints, (a.table,)) != TFS.step_key("e", a, ints, (b.w_p,))


def test_greedy_graph_captures_once_and_copies_each_batch(monkeypatch):
    params = _small(stop_bias=2.0)
    tp = tree_to_torch(params)
    pk = TFS.pack_weights(tp, T32)
    graphs = _Stubbed()

    def enqueue(pk_, work, ints, dev):  # the plain decode on the graph's own tensors
        assert (work["word"] == 2).all() and (work["ids_tm"] == 0).all()
        assert not work["h0"].any() and not work["done"].any() and not work["flag"].any()
        ids = TFS.lstm_greedy_decode_reference(pk_._replace(gxb=work["gxb"]), work["img_k"],
                                               work["img_v"], T, early_stop=True,
                                               compute_dtype=T32)
        work["ids_tm"].copy_(ids.T)
        return 9 * T

    monkeypatch.setattr(TFS, "_enqueue", enqueue)
    monkeypatch.setattr(TFS, "_argmax_nblocks", lambda V: -(-V // 32))
    outs = []
    for seed in (0, 1):
        pre = _small_pre(params, 5, seed)[1]
        b = TFS.with_batch(pk, tp, pre)
        ints = TFS._ints(T32, 5, b, 4, 5, T, 2, 0, 3, True)
        n = (TFS.fused_decode_step.launches, TVH.greedy_vocab_argmax.launches)
        ids = TFS._greedy_graph(b, pre.img_k, pre.img_v, ints, 2, 0, T32, graphs)
        assert (TFS.fused_decode_step.launches, TVH.greedy_vocab_argmax.launches) == (n[0] + T,
                                                                                      n[1] + T)
        want = TD.greedy_decode_ids(tp, pre, T, compute_dtype=T32, early_stop=True)
        assert torch.equal(ids, want)
        assert TFS.lstm_greedy_decode.kernel_launches == 9 * T
        outs.append(ids)
    assert graphs.captures == 1 and graphs.replays == 2
    assert not torch.equal(outs[0], outs[1])
    monkeypatch.setattr(graphs, "load", lambda work, inputs: None)
    pre = _small_pre(params, 5, 0)[1]
    b = TFS.with_batch(pk, tp, pre)
    stale = TFS._greedy_graph(b, pre.img_k, pre.img_v, TFS._ints(T32, 5, b, 4, 5, T, 2, 0, 3, True),
                              2, 0, T32, graphs)
    assert torch.equal(stale, outs[1])  # the previous batch, decoded again


def test_beam_graph_captures_once_and_copies_each_batch(monkeypatch):
    params = _small(stop_bias=1.0)
    tp = tree_to_torch(params)
    packed = TFS.pack_weights(tp, T32)
    graphs = _Stubbed()
    outs = []
    for seed in (0, 1):
        pre = _small_pre(params, 5, seed)[1]
        args = (tp, pre, packed, 5, 3, T, 2, 3, 0, T32, True)
        n = (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches)
        got = TB._fused_search(*args, graphs)
        assert (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches) == (n[0] + T,
                                                                                  n[1] + T)
        want = TB._fused_search(*args)  # eager, no graph
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        outs.append(got)
    assert graphs.captures == 1 and graphs.replays == 2
    monkeypatch.setattr(graphs, "load", lambda work, inputs: None)
    stale = TB._fused_search(tp, _small_pre(params, 5, 0)[1], packed, 5, 3, T, 2, 3, 0, T32, True,
                             graphs)
    assert all(torch.equal(a, b) for a, b in zip(stale, outs[1]))


@pytest.mark.parametrize("W", [3, 4])
def test_beam_all_steps_equal_the_early_stopped_loop(W):
    """A model that finishes in a step or two: every later step extends
    each beam by <pad> at zero cost, the stable top-W keeps the
    back-pointers the identity."""
    params = _small(stop_bias=6.0)
    jpre, tpre = _small_pre(params, 5, 3)
    tp = tree_to_torch(params)
    words, srcs, scores, lengths = TB._fused_search(tp, tpre, None, 5, W, T, 2, 3, 0, T32, True)
    done = int((lengths.max()))  # every beam has finished by then
    assert done < T - 2
    assert (words[done:] == 0).all()
    assert (srcs[done:] == torch.arange(W)).all()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for length_norm in (0.0, 1.0):
        got = TB.beam_search_ids(tp, tpre, T, W, compute_dtype=T32, use_kernels=True,
                                 early_stop=True, length_norm=length_norm)
        plain = TB.beam_search_ids(tp, tpre, T, W, compute_dtype=T32, early_stop=True,
                                   length_norm=length_norm)
        fixed = jbeam.beam_search_ids(jp, jpre, T, beam_size=W, compute_dtype=F32,
                                      length_norm=length_norm)
        for want in (plain, fixed):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)

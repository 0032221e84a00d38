"""The port's beam search (myimagecaptioningmodel_tpu_torch/inference/beam.py)
against the JAX package's, on CPU in float32.

Same params (the JAX package's init, the output projection sharpened so that
log-probs are far from ties, the <stop> bias raised so that beams finish at
different steps) and the same numpy features go through both:

- ``beam_search_ids`` ids id for id and scores to 1e-5: W in {1, 3, 4},
  parity mode on and off, float and int8 params, the port's ``use_kernels``
  off and on (on CPU tensors the fused-head branch runs its kernels' plain
  versions), fixed length and early stop, ``length_norm`` 0 and 1;
- the fused-head branch against JAX ``use_pallas=True`` with the Pallas
  kernels in interpret mode, at dims those kernels take (V=2048, E=H=128,
  B*W=8, T=4), float and int8. With int8 both dequantize the step's weights
  at ``prepare`` and stream the int8 table through the top-k head; JAX's
  plain int8 path scales after each product instead, so the port's fused
  int8 branch is held against JAX's fused one only;
- the port's own semantics tests (beam 1 equals greedy, finished beams pad,
  the crafted ``length_norm`` case, early stop equals the fixed-length run);
- ``CaptionService(beam_size=4, quantize=True)`` and its HTTP surface, on a
  bundle converted from a JAX bundle, answer with the JAX service's ids.
"""

import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.inference import beam as jbeam
from myimagecaptioningmodel_tpu.inference import server as jserver
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.ops.quantization import quantize_decoder as jquantize
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.inference import beam as tbeam
from myimagecaptioningmodel_tpu_torch.inference import infer as tinfer
from myimagecaptioningmodel_tpu_torch.inference import server as tserver
from myimagecaptioningmodel_tpu_torch.models import decoder as tdec
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as TVH
from myimagecaptioningmodel_tpu_torch.ops.quantization import quantize_decoder
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt

F32 = jnp.float32
T32 = torch.float32
DIMS = jdec.DecoderDims(vocab_size=19, embedding_size=8, hidden_dim=16, feat_channels=12)
T = 9


def _decoder(dims, seed, sharpen=4.0, stop_bias=1.0):
    p = dict(jdec.init(jax.random.PRNGKey(seed), dims))
    p["out_proj"] = {**p["out_proj"], "w": p["out_proj"]["w"] * sharpen}
    p["out_bias"] = p["out_bias"].at[3].add(stop_bias)
    return jax.tree_util.tree_map(np.asarray, p)


def _both(params, int8, img, gf):
    """-> (JAX params, JAX Precomputed, port params, port Precomputed)."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp = jquantize(jp) if int8 else jp
    tp = tree_to_torch(params)
    if int8:
        tp = quantize_decoder(tp)
    jpre = jdec.precompute(jp, jnp.asarray(img), jnp.asarray(gf), F32)
    tpre = tdec.precompute(tp, torch.as_tensor(img), torch.as_tensor(gf), T32)
    return jp, jpre, tp, tpre


def _features(B, k, H, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, k, H).astype(np.float32), rng.randn(B, H).astype(np.float32))


def _assert_same(got, want):
    (tids, tsc), (jids, jsc) = got, want
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("parity_mode", [False, True])
@pytest.mark.parametrize("W", [1, 3, 4])
def test_beam_matches_jax(W, parity_mode, int8):
    # parity mode's uniform attention stops every row at once under a raised
    # <stop> bias: leave it off there
    params = _decoder(DIMS, 3, stop_bias=0.0 if parity_mode else 1.0)
    jp, jpre, tp, tpre = _both(params, int8, *_features(5, 4, 16, 3))
    kw = dict(max_length=T, beam_size=W, parity_mode=parity_mode)
    want = {
        (False, 0.0): jbeam.beam_search_ids(jp, jpre, compute_dtype=F32, **kw),
        (True, 1.0): jbeam.beam_search_ids(jp, jpre, compute_dtype=F32, length_norm=1.0,
                                           early_stop=True, **kw),
    }
    assert len({tuple(r) for r in np.asarray(want[(False, 0.0)][0])}) > 1
    for use_kernels in (False, True):
        if int8 and use_kernels and W > 1 and not parity_mode:
            continue  # the fused int8 branch: test_fused_head_matches_jax_pallas
        for early_stop in (False, True):
            for length_norm in (0.0, 1.0):
                got = tbeam.beam_search_ids(
                    tp, tpre, compute_dtype=T32, use_kernels=use_kernels,
                    early_stop=early_stop, length_norm=length_norm, **kw)
                # JAX's early stop equals its fixed-length run (tests/test_beam.py)
                jw = want[(False, 0.0)] if length_norm == 0.0 else want[(True, 1.0)]
                _assert_same(got, jw)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_head_matches_jax_pallas(int8):
    dims = jdec.DecoderDims(vocab_size=2000, embedding_size=128, hidden_dim=128,
                            feat_channels=12, vocab_pad_multiple=128)
    params = _decoder(dims, 0, sharpen=16.0, stop_bias=0.0)
    jp, jpre, tp, tpre = _both(params, int8, *_features(2, 5, 128, 1))
    assert jdec.pallas_dims_ok(jp)
    want = jbeam.beam_search_ids(jp, jpre, 4, beam_size=4, compute_dtype=F32,
                                 use_pallas=True, interpret=True)
    before = (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches)
    got = tbeam.beam_search_ids(tp, tpre, 4, beam_size=4, compute_dtype=T32,
                                use_kernels=True)
    _assert_same(got, want)
    # CPU tensors: the plain versions ran, no kernel was launched
    assert (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches) == before


def test_early_stop_when_all_beams_finish():
    """A model that finishes in a step or two: the early-stopped search
    backtracks through the pre-filled history to the fixed-length ids."""
    jp, jpre, tp, tpre = _both(_decoder(DIMS, 3, stop_bias=3.0), False,
                               *_features(5, 4, 16, 3))
    kw = dict(max_length=T, beam_size=3)
    want = jbeam.beam_search_ids(jp, jpre, compute_dtype=F32, early_stop=True, **kw)
    assert (np.asarray(want[0])[:, -1] == 0).all()
    for use_kernels in (False, True):
        for early_stop in (False, True):
            _assert_same(tbeam.beam_search_ids(tp, tpre, compute_dtype=T32,
                                               use_kernels=use_kernels,
                                               early_stop=early_stop, **kw), want)


# ---- the port's own semantics (tests/test_beam.py's, on the port) ----------


@pytest.fixture(scope="module")
def small():
    params = tree_to_torch(_decoder(DIMS, 3, sharpen=1.0, stop_bias=0.0))
    img, gf = _features(3, 5, 16, 4)
    return params, tdec.precompute(params, torch.as_tensor(img), torch.as_tensor(gf), T32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_beam1_equals_greedy(small, use_kernels):
    params, pre = small
    greedy = tdec.greedy_decode_ids(params, pre, 7, compute_dtype=T32)
    ids, _ = tbeam.beam_search_ids(params, pre, 7, beam_size=1, compute_dtype=T32,
                                   use_kernels=use_kernels)
    np.testing.assert_array_equal(ids.numpy(), greedy.numpy())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_finished_beams_pad(small, use_kernels):
    params, pre = small
    ids, _ = tbeam.beam_search_ids(params, pre, 10, beam_size=3, compute_dtype=T32,
                                   use_kernels=use_kernels)
    for row in ids.numpy():
        stops = np.flatnonzero(row == 3)
        if stops.size:
            assert (row[stops[0] + 1:] == 0).all(), row


def test_length_norm_semantics(monkeypatch):
    """Raw sum-log-prob picks the short hypothesis; dividing by len**1 flips
    the pick to the longer beam (ids: 3 stop, 4 'A'), on a crafted step."""
    V, H, B, W = 6, 4, 1, 2
    LO = -20.0

    def crafted_step(params, pre, word, h, c, parity_mode=False, padding_idx=0,
                     compute_dtype=T32):
        from_start = torch.full((V,), LO)
        from_start[3], from_start[4] = np.log(0.6), np.log(0.39)
        from_a = torch.full((V,), LO)
        from_a[3] = np.log(0.95)
        logits = torch.where((word == 2)[:, None], from_start,
                             torch.where((word == 4)[:, None], from_a, torch.full((V,), LO)))
        return h, c, logits

    monkeypatch.setattr(tdec, "step", crafted_step)
    params = {"p_hid": {"w": torch.zeros(H, H), "b": torch.zeros(H)},
              "embedding": {"table": torch.zeros(V, 8)}}
    z = torch.zeros(B, 2, H)
    pre = tdec.Precomputed(z, z, torch.zeros(B, H), torch.zeros(B, 4 * H), torch.zeros(B, H))

    def log_z(p):
        return np.log(np.sum(p) + (V - len(p)) * np.exp(LO))

    short_raw = np.log(0.6) - log_z([0.6, 0.39])
    long_raw = np.log(0.39) - log_z([0.6, 0.39]) + np.log(0.95) - log_z([0.95])
    assert short_raw > long_raw and long_raw / 2 > short_raw
    kw = dict(max_length=3, beam_size=W, compute_dtype=T32)
    for length_norm, ids_want, score_want in ((0.0, [3, 0, 0], short_raw),
                                              (1.0, [4, 3, 0], long_raw / 2)):
        for early_stop in (False, True):
            ids, score = tbeam.beam_search_ids(params, pre, length_norm=length_norm,
                                               early_stop=early_stop, **kw)
            np.testing.assert_array_equal(ids.numpy()[0], ids_want)
            np.testing.assert_allclose(float(score[0]), score_want, rtol=1e-5)


def test_transformer_loss_reaches_every_layer_leaf(small):
    """The transformer family trains: its ``loss_terms`` runs and the
    gradient reaches every leaf of every layer in ``decoder/layers``
    (``tests/test_torch_transformer_train.py`` holds the values to JAX)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
    from myimagecaptioningmodel_tpu_torch.models.transformer import TransformerDims
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

    tdims = TransformerDims(vocab_size=40, embedding_size=8, model_dim=16, num_layers=2,
                            num_heads=2, mlp_ratio=2, max_positions=6)
    opts = tcap.ModelOptions(dims=tdec.DecoderDims(hidden_dim=16), arch="transformer",
                             tdims=tdims, encoder_scale=0.35, compute_dtype="float32",
                             sentence_length=6)
    params, state = train_tree(*tcap.init(torch.Generator().manual_seed(1), opts), device="cpu")
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    caps = torch.tensor([[2, 5, 6, 7, 3, 0], [2, 9, 3, 0, 0, 0]])
    ce_sum, n_tok, _ = tcap.loss_terms(params, state, images, caps, opts)
    assert float(n_tok) == 6 and torch.isfinite(ce_sum)
    layers = tree_leaves(params["decoder"]["layers"])
    grads = torch.autograd.grad(ce_sum, layers)
    assert len(layers) == 2 * 24 and all(g.abs().sum() > 0 for g in grads)


# ---- serving: load_bundle, CaptionService, HTTP, infer ----------------------


def _small_cfg(root):
    cfg = config_mod.Config()
    for path, v in [("model.decoder.vocab_size", 2000), ("model.decoder.embedding_size", 128),
                    ("model.decoder.hidden_dim", 256), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.infer_max_length", 6), ("model.compute_dtype", "float32"),
                    ("data.image_shape", (64, 64)),
                    ("train.checkpoint_path", os.path.join(root, "save")),
                    ("data.dict_path", os.path.join(root, "dataset"))]:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


@pytest.fixture(scope="module")
def beam_services(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("beam"))
    jcfg = _small_cfg(os.path.join(root, "jax"))
    params, state = jcap.init(jax.random.PRNGKey(0), jcap.ModelOptions.from_config(jcfg))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.RandomState(0)
    for s in state["encoder"].values():  # spread BN statistics: images differ
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
        s["bn"]["var"] = rng.rand(n).astype(np.float32) * 0.3 + 0.3
    os.makedirs(jcfg.data.dict_path)
    words = ["<pad>", "<unk>", "<start>", "<stop>"] + [f"w{i}" for i in range(4, 2000)]
    np.save(os.path.join(jcfg.data.dict_path, "word_dict.npy"),
            np.array([{w: i for i, w in enumerate(words)}, dict(enumerate(words))],
                     dtype=object), allow_pickle=True)
    jbundle = os.path.join(jcfg.train.checkpoint_path, "infer")
    jckpt.export_inference_bundle(jbundle, params, state, jcfg,
                                  vocab_src_dir=jcfg.data.dict_path)
    tcfg = _small_cfg(os.path.join(root, "port"))
    tckpt.convert_jax_bundle(jbundle, os.path.join(tcfg.train.checkpoint_path, "infer"))
    jsvc = jserver.CaptionService(jcfg, batch_size=4, beam_size=4, quantize=True,
                                  max_wait_ms=5.0)
    tsvc = tserver.CaptionService(tcfg, batch_size=4, beam_size=4, quantize=True,
                                  max_wait_ms=5.0, device="cpu")
    yield jsvc, tsvc, tcfg
    jsvc.close()
    tsvc.close()


def _jpeg(seed, size=40):
    from PIL import Image

    buf = io.BytesIO()
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_beam_int8_service_matches_jax(beam_services):
    jsvc, tsvc, tcfg = beam_services
    assert "table_q" in tsvc.model.params["decoder"]["embedding"]
    payloads = [_jpeg(s) for s in range(4)]
    want = [jsvc.caption_bytes(p) for p in payloads]
    got = [None] * len(payloads)

    def worker(i):
        got[i] = tsvc.caption_bytes(payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert got == want
    assert len({tuple(r["ids"]) for r in want}) > 1
    # the single-image path (B=1) with the same options, as a function and
    # as the command line
    ids, sentence = tinfer.caption_array(tcfg, tsvc.prepare(payloads[1]), beam_size=4,
                                         quantize=True, device="cpu")
    assert (ids, sentence) == (want[1]["ids"], want[1]["caption"])
    path = os.path.join(tcfg.train.checkpoint_path, "img.jpg")
    with open(path, "wb") as f:
        f.write(payloads[2])
    cfg_path = os.path.join(tcfg.train.checkpoint_path, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(tcfg.to_json())
    assert tinfer.cli([path, "--config", cfg_path, "--beam", "4", "--quantize",
                       "--device", "cpu"]) == want[2]["caption"]


def test_beam_http_surface(beam_services):
    jsvc, tsvc, _cfg = beam_services
    httpd = tserver.make_server(tsvc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        data = _jpeg(5)
        req = urllib.request.Request(f"{base}/caption", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == jsvc.caption_bytes(data)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["beam"] == 4 and health["batch"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()

"""The port's transformer serving slice end to end against the JAX
package, on the CPU, in float32.

A small transformer bundle (MobileNetV2 x0.35 at 64 px, D=256, E=128, 2
layers, 2 heads, MLP ratio 2, vocab 2000, 6 steps; weights from the port's
seeded init, BN statistics spread so that images differ) is written as a
JAX bundle and converted to a port bundle:

- ``load_bundle(device="cpu")`` greedy and beam 4 give the JAX
  ``load_bundle``'s ids, on the plain path and on the kernel path (kernels D
  and E run their plain versions on CPU tensors);
- ``CaptionService`` (beam 4) answers concurrent requests with the JAX ids,
  and its HTTP ``/healthz`` reports them;
- int8 weights (``quantize=True``) load (their decodes are held in
  ``tests/test_torch_transformer_int8.py``), and the bundle's float32 tree
  trains: ``loss_terms`` (once unported) equals the JAX ``loss_terms`` on
  the JAX bundle's weights, CE sum to rtol 3e-5 and the token count exactly
  (``tests/test_torch_transformer_train.py`` holds the gradients).
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.evaluation import evaluate as jeval
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as teval
from myimagecaptioningmodel_tpu_torch.inference import server as tserver
from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt


def _small_cfg(root):
    cfg = config_mod.Config()
    for path, v in [("model.decoder.arch", "transformer"), ("model.decoder.vocab_size", 2000),
                    ("model.decoder.embedding_size", 128), ("model.decoder.hidden_dim", 256),
                    ("model.decoder.num_layers", 2), ("model.decoder.num_heads", 2),
                    ("model.decoder.mlp_ratio", 2), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.infer_max_length", 6), ("model.decoder.sentence_length", 6),
                    ("model.compute_dtype", "float32"), ("data.image_shape", (64, 64)),
                    ("train.checkpoint_path", os.path.join(root, "save")),
                    ("data.dict_path", os.path.join(root, "dataset"))]:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


def _numpy(tree):
    """torch tree -> numpy, lists as the JAX package's tuples."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_numpy(v) for v in tree)
    return tree.numpy()


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A JAX transformer bundle (weights from the port's seeded init, which
    draws the same shapes as the JAX one in a fraction of its time; spread
    BN statistics so images differ) and its port conversion."""
    root = str(tmp_path_factory.mktemp("tfslice"))
    jcfg = _small_cfg(os.path.join(root, "jax"))
    jopts = jcap.ModelOptions.from_config(jcfg)
    assert jopts.arch == "transformer" and not jopts.use_pallas
    topts = tcap.ModelOptions.from_config(jcfg)
    params, state = map(_numpy, tcap.init(torch.Generator().manual_seed(5), topts))
    rng = np.random.RandomState(5)
    for s in state["encoder"].values():
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
        s["bn"]["var"] = rng.rand(n).astype(np.float32) * 0.3 + 0.3
    os.makedirs(jcfg.data.dict_path)
    words = ["<pad>", "<unk>", "<start>", "<stop>"] + [f"w{i}" for i in range(4, 2000)]
    np.save(os.path.join(jcfg.data.dict_path, "word_dict.npy"),
            np.array([{w: i for i, w in enumerate(words)}, dict(enumerate(words))],
                     dtype=object), allow_pickle=True)
    jbundle = os.path.join(jcfg.train.checkpoint_path, "infer")
    jckpt.export_inference_bundle(jbundle, params, state, jcfg, vocab_src_dir=jcfg.data.dict_path)
    tcfg = _small_cfg(os.path.join(root, "port"))
    tckpt.convert_jax_bundle(jbundle, os.path.join(tcfg.train.checkpoint_path, "infer"))
    images = rng.rand(5, 64, 64, 3).astype(np.float32)
    return jcfg, tcfg, images


@pytest.mark.parametrize("beam", [0, 4])
def test_load_bundle_equal_jax(bundles, beam):
    jcfg, tcfg, images = bundles
    jp, js, _jc, jopts, jdecode = jeval.load_bundle(jcfg, beam_size=beam)
    want = np.asarray(jdecode(jp, js, images))
    model, _bc, opts, decode = teval.load_bundle(tcfg, beam_size=beam, device="cpu")
    assert opts.arch == "transformer" and opts.tdims.num_layers == 2 and not opts.use_kernels
    assert len({tuple(r) for r in want}) > 1, "rows should differ"
    np.testing.assert_array_equal(decode(model, images).numpy(), want)
    o = opts._replace(use_kernels=True)  # kernels D / E: their plain versions on the CPU
    got = (beam_decode(model, images, o, beam, stop_idx=o.stop_idx)[0] if beam
           else tcap.greedy_decode(model, images, o))
    np.testing.assert_array_equal(got.numpy(), want)


def test_service_and_http(bundles):
    jcfg, tcfg, images = bundles
    jp, js, _jc, _jo, jdecode = jeval.load_bundle(jcfg, beam_size=4)
    svc = tserver.CaptionService(tcfg, batch_size=4, max_wait_ms=5.0, device="cpu",
                                 beam_size=4)
    httpd = tserver.make_server(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        got = [None] * 4

        def worker(i):
            got[i] = svc.caption_array(images[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        want = np.asarray(jdecode(jp, js, images[:4]))
        assert [g["ids"] for g in got] == want.tolist()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["beam"] == 4 and health["served"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def test_int8_load_and_training_loss_match_jax(bundles):
    jcfg, tcfg, images = bundles
    model, _bc, _opts, _decode = teval.load_bundle(tcfg, quantize=True, device="cpu")
    assert model.params["decoder"]["layers"][0]["attn"]["wq"]["w_q"].dtype == torch.int8
    caps = np.zeros((5, 6), np.int32)
    caps[:, 0], caps[:, 1:4], caps[:, 4] = 2, np.arange(15).reshape(5, 3) + 4, 3
    jp, js, _jc, jopts, _jdecode = jeval.load_bundle(jcfg)
    want_sum, want_n, _ = jax.jit(lambda p: jcap.loss_terms(p, js, images, caps, jopts, True))(jp)
    tp, ts, _cfg = tckpt.load_inference_bundle(os.path.join(tcfg.train.checkpoint_path, "infer"))
    tp, ts = train_tree(tp, ts, device="cpu")
    with torch.no_grad():
        ce_sum, n_tok, _ = tcap.loss_terms(tp, ts, torch.as_tensor(images),
                                           torch.as_tensor(caps), tcap.ModelOptions.from_config(tcfg))
    assert float(n_tok) == float(want_n) == 20
    np.testing.assert_allclose(float(ce_sum), float(want_sum), rtol=3e-5)

"""The port's serving slice end to end against the JAX package, on CPU.

Same params (the JAX package's init, with spread BN statistics so that
images differ) and the same numpy images go through both:

- encoder features and the img2feature projections, float32 to 1e-4 (the
  MobileNetV2 depth accumulates rounding);
- greedy caption ids, equal id for id in float32: fixed-length and early-stop,
  parity mode on and off, the port's plain path and its kernel path (whose
  wrappers run their plain versions on CPU tensors), at B=5 and at B=1 (the
  port pads no batch; JAX's rows are per-row, so its B=5 row is the answer);
- CaptionService and HTTP /caption on a bundle converted from a JAX bundle
  answer with the JAX CaptionService's ids;
- the port's server imports with jax (and flax, PIL, h5py, msgpack) blocked.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.inference import server as jserver
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.training import checkpoint as jckpt
from myimagecaptioningmodel_tpu_torch.compat.from_jax import captioner_from_tree
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle as tload_bundle
from myimagecaptioningmodel_tpu_torch.inference import infer as tinfer
from myimagecaptioningmodel_tpu_torch.inference import server as tserver
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.training import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 6


def small_cfg(root=None):
    cfg = config_mod.Config()
    sets = [("model.decoder.vocab_size", 2000), ("model.decoder.embedding_size", 128),
            ("model.decoder.hidden_dim", 256), ("model.encoder.encoder_scale", 0.35),
            ("model.decoder.infer_max_length", MAX_LEN), ("model.compute_dtype", "float32"),
            ("data.image_shape", (64, 64))]
    if root is not None:
        sets += [("train.checkpoint_path", os.path.join(root, "save")),
                 ("data.dict_path", os.path.join(root, "dataset"))]
    for path, v in sets:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    jopts = jcap.ModelOptions.from_config(cfg)
    assert not jopts.use_pallas  # CPU: the JAX package's plain decode
    params, state = jcap.init(jax.random.PRNGKey(0), jopts)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.RandomState(0)
    for s in state["encoder"].values():
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
        s["bn"]["var"] = rng.rand(n).astype(np.float32) * 0.3 + 0.3
    images = rng.rand(5, 64, 64, 3).astype(np.float32)
    img_embed, feat, gf, _ = jax.jit(
        lambda p, s, x: jcap.img2feature(p, s, x, jopts, train=False)
    )(params, state, images)
    topts = tcap.ModelOptions.from_config(cfg)
    model = captioner_from_tree(params, state, topts, device="cpu")
    return cfg, params, state, images, (img_embed, feat, gf), topts, model


def test_features_match_jax(setup):
    _cfg, _p, _s, images, jfeats, topts, model = setup
    tfeats = tcap.img2feature(model, images, topts)
    for name, t, j in zip(("img_embed", "feat", "global_feat"), tfeats, jfeats):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _jax_ids(params, jfeats, parity_mode, early_stop, stop_idx):
    img_embed, _feat, gf = jfeats

    @jax.jit
    def run(dec, img_embed, gf):
        pre = jdec.precompute(dec, img_embed, gf, jnp.float32)
        return jdec.greedy_decode_ids(
            dec, pre, MAX_LEN, 2, parity_mode, 0, jnp.float32,
            use_pallas=False, early_stop=early_stop, stop_idx=stop_idx,
        )

    return np.asarray(run(params["decoder"], img_embed, gf))


@pytest.mark.parametrize("parity_mode", [False, True])
def test_greedy_ids_equal_jax(setup, parity_mode):
    _cfg, params, _s, images, jfeats, topts, model = setup
    fixed = _jax_ids(params, jfeats, parity_mode, False, 3)
    assert len({tuple(r) for r in fixed}) > 1, "rows should differ"
    # early stop on a token the fixed decode emits mid-caption in some rows
    stop = int(fixed[0, 2])
    early = _jax_ids(params, jfeats, parity_mode, True, stop)
    assert (early == 0).any() and not (early == fixed).all()
    for early_stop, want in ((False, fixed), (True, early)):
        for use_kernels in (False, True):
            o = topts._replace(parity_mode=parity_mode, early_stop_decode=early_stop,
                               stop_idx=stop, use_kernels=use_kernels)
            got = tcap.greedy_decode(model, images, o)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            for r in (0, 3):  # B=1: no padding rows, same ids
                one = tcap.greedy_decode(model, images[r:r + 1], o)
                np.testing.assert_array_equal(one.numpy()[0], want[r])


def test_transformer_bundle_serves_with_int8_weights(tmp_path):
    """The transformer family serves, with int8 weights too:
    ``quantize=True`` on a transformer bundle quantizes its decoder and
    decodes (the int8 decodes are held against the JAX package in
    ``tests/test_torch_transformer_int8.py``)."""
    cfg = config_mod.replace_nested(small_cfg(str(tmp_path)), "model.decoder.arch", "transformer")
    opts = tcap.ModelOptions.from_config(cfg)
    assert opts.arch == "transformer" and opts.tdims.model_dim == 256
    params, state = tcap.init(torch.Generator().manual_seed(0), opts)
    tckpt.export_inference_bundle(os.path.join(cfg.train.checkpoint_path, "infer"), params,
                                  state, cfg)
    model, _bc, _opts, decode = tload_bundle(cfg, quantize=True, device="cpu")
    assert model.params["decoder"]["layers"][0]["mlp"]["fc1"]["w_q"].dtype == torch.int8
    ids = decode(model, np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    assert ids.shape == (2, cfg.model.decoder.infer_max_length) and ids.dtype == torch.int32


def jpeg_bytes(seed, size=40):
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def services(setup, tmp_path_factory):
    _cfg, params, state, *_ = setup
    root = str(tmp_path_factory.mktemp("slice"))
    jcfg = small_cfg(os.path.join(root, "jax"))
    os.makedirs(jcfg.data.dict_path)
    words = ["<pad>", "<unk>", "<start>", "<stop>"] + [f"w{i}" for i in range(4, 2000)]
    np.save(os.path.join(jcfg.data.dict_path, "word_dict.npy"),
            np.array([{w: i for i, w in enumerate(words)}, dict(enumerate(words))],
                     dtype=object), allow_pickle=True)
    jbundle = os.path.join(jcfg.train.checkpoint_path, "infer")
    jckpt.export_inference_bundle(jbundle, params, state, jcfg,
                                  vocab_src_dir=jcfg.data.dict_path)
    tcfg = small_cfg(os.path.join(root, "port"))
    tckpt.convert_jax_bundle(jbundle, os.path.join(tcfg.train.checkpoint_path, "infer"))
    jsvc = jserver.CaptionService(jcfg, batch_size=4, max_wait_ms=5.0)
    tsvc = tserver.CaptionService(tcfg, batch_size=4, max_wait_ms=5.0, device="cpu")
    yield jsvc, tsvc, tcfg
    jsvc.close()
    tsvc.close()


def test_service_matches_jax_service(services):
    jsvc, tsvc, tcfg = services
    payloads = [jpeg_bytes(s) for s in range(4)]
    want = [jsvc.caption_bytes(p) for p in payloads]
    got = [None] * 4

    def worker(i):
        got[i] = tsvc.caption_bytes(payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert got == want
    st = tsvc.stats()
    assert st["served"] == 4 and 1 <= st["dispatches"] <= 4
    # the same image through the single-image CLI path (B=1)
    ids, sentence = tinfer.caption_array(tcfg, tsvc.prepare(payloads[0]), device="cpu")
    assert (ids, sentence) == (want[0]["ids"], want[0]["caption"])


def test_http_surface(services):
    jsvc, tsvc, _ = services
    httpd = tserver.make_server(tsvc, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        data = jpeg_bytes(11)
        req = urllib.request.Request(f"{base}/caption", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == jsvc.caption_bytes(data)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["batch"] == 4
        assert health["served"] >= 1 and health["device"] == "cpu"
        bad = urllib.request.Request(f"{base}/caption", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'PIL', 'h5py', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import myimagecaptioningmodel_tpu_torch.inference.server\n"
        "import myimagecaptioningmodel_tpu_torch.inference.infer\n"
        "import myimagecaptioningmodel_tpu_torch.compat.from_jax\n"
        "import myimagecaptioningmodel_tpu_torch.ops.kernels.fused_step\n"
        "import myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head\n"
        "import myimagecaptioningmodel_tpu_torch.ops.quantization\n"
        "import myimagecaptioningmodel_tpu_torch.inference.beam\n"
        "import myimagecaptioningmodel_tpu_torch.evaluation.evaluate\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

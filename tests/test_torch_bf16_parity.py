"""The port against the JAX package in bfloat16, the default compute dtype,
on the CPU.

Both sides take the same parameters (the reference's pytree, through the
bridge) and the same numpy inputs; the JAX side runs its plain path, jitted.
bfloat16 keeps 8 significant bits, the two packages sum in other orders, and
XLA's CPU compiler keeps excess precision across a convert pair inside one
jitted graph (``xla_allow_excess_precision``, on by default), where the port
rounds at every point the reference's code names. So the tests hold
decisions and rounding points, not bits:

- one conv + BN layer of the encoder, each kind, from the same bf16 input:
  the port's output equals the reference's (run eagerly, so that every
  rounding it names happens) within one bf16 ulp, on at most 1e-3 of the
  elements (measured: equal but for 1-ulp flips on ~1e-6 of a 1x1 conv's);
  end to end the jitted reference then keeps more precision and the two
  encoders' features differ by ~4.6% relative L2 (each package's own
  bfloat16 features lie 3.4% and 4.5% from its float32 ones; measured);
- LSTM and transformer greedy ids under ``chip_smoke.near_tie_ok``'s bf16
  rule: the port's ids are teacher-forced through the JAX decode step, and
  at each step the port's pick is JAX's argmax wherever JAX's top-2 logit
  gap exceeds 2e-2, else within 2e-2 of JAX's largest logit; most steps must
  be clear (measured: 66 of 96 LSTM steps, 79 of 80 transformer steps; the
  largest shortfall of a near tie 0.0086);
- the LSTM training loss (``loss_fn`` and ``loss_terms``) against the JAX
  ``loss_fn`` / ``loss_terms`` to rtol 3e-2 and the token count exactly: at
  this size (B=4, 18 tokens) each package's bfloat16 loss lies up to 2.0e-2
  from its own float32 loss, which the two agree on to 6e-6, and the two
  bfloat16 losses lay at most 1.5e-2 apart over four batches (measured);
- the one known divergence: the port keeps the transformer's attention
  scores and vocab logits in float32, as kernels D and E compute them, where
  the reference rounds both to the compute dtype (test names below); its
  training forward keeps them too, so the transformer's bfloat16 training
  loss (``test_transformer_loss_bf16``, the tiny captioner above with D=32,
  2 layers, 4 heads, label smoothing 0.1) is held to the LSTM's rtol 3e-2:
  the two packages' bfloat16 losses lay up to 8.9e-3 apart over four
  batches, each package's bfloat16 loss up to 8.3e-3 from its own float32
  one, and the float32 losses 1.4e-5 apart (measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as config_mod
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.models import mobilenet_v2 as JM
from myimagecaptioningmodel_tpu.models import transformer as JTF
from myimagecaptioningmodel_tpu_torch.compat.from_jax import (
    captioner_from_tree,
    conv_hwio_to_oihw,
    train_tree,
    tree_to_torch,
)
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as TM
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

BF16 = torch.bfloat16
GAP = 2e-2  # chip_smoke.near_tie_ok's bf16 gap
MAX_LEN, B_GREEDY = 6, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread (beside the JAX compiles and other test
    workers, PyTorch's spinning thread pool slows the CPU convolutions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def near_tie_check(ids, logits):
    """chip_smoke.near_tie_ok's bf16 rule for one step -> (all rows pass,
    clear rows). ids [B] the port's picks, logits [B, V] JAX's."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    picked = logits[np.arange(len(ids)), ids]
    ok = np.where(clear, ids == logits.argmax(-1), picked >= logits.max(-1) - GAP)
    return bool(ok.all()), clear


def bf16_ulp(mag):
    """One bf16 ulp (8 significant bits) of each magnitude."""
    return np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


# ---- encoder layers: the rounding points ------------------------------------


@pytest.mark.parametrize("cin,cout,k,stride,groups", [
    (3, 16, 3, 2, 1), (16, 96, 1, 1, 1), (96, 96, 3, 2, 96), (96, 24, 1, 1, 1)],
    ids=["stem", "expand", "dwise", "linear"])
def test_conv_bn_layer_matches_jax_eager(cin, cout, k, stride, groups):
    rng = np.random.RandomState(cin + cout)
    w = (rng.randn(k, k, cin // groups, cout) / np.sqrt(k * k * cin / groups)).astype(np.float32)
    p = {"conv": {"w": w}, "bn": {"scale": (1 + 0.1 * rng.randn(cout)).astype(np.float32),
                                  "offset": (0.1 * rng.randn(cout)).astype(np.float32)}}
    s = {"bn": {"mean": (0.1 * rng.randn(cout)).astype(np.float32),
                "var": (rng.rand(cout) * 0.3 + 0.3).astype(np.float32)}}
    x = jnp.asarray(rng.rand(4, 16, 16, cin).astype(np.float32) * 2).astype(jnp.bfloat16)
    pad = (k - 1) // 2
    want, _ = JM._apply_conv_bn(p, s, x, stride, pad, groups, True, False, jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    layer = TM.ConvBN(cin, cout, k, stride, groups, True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(conv_hwio_to_oihw(w))))
        for name, v in (("scale", p["bn"]["scale"]), ("offset", p["bn"]["offset"]),
                        ("mean", s["bn"]["mean"]), ("var", s["bn"]["var"])):
            getattr(layer, name).copy_(torch.from_numpy(v))
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16).permute(0, 3, 1, 2)
        got = layer(xt, BF16).permute(0, 2, 3, 1).float().numpy()
    diff = np.abs(got - want)
    assert (diff <= bf16_ulp(np.abs(want))).all()
    assert (diff > 0).mean() <= 1e-3


# ---- LSTM -------------------------------------------------------------------


def lstm_cfg(dtype="bfloat16"):
    """tests/test_torch_slice.py's small config, in bfloat16."""
    cfg = config_mod.Config()
    for path, v in [("model.decoder.vocab_size", 2000), ("model.decoder.embedding_size", 128),
                    ("model.decoder.hidden_dim", 256), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.infer_max_length", MAX_LEN), ("model.compute_dtype", dtype),
                    ("data.image_shape", (64, 64))]:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


@functools.lru_cache(maxsize=None)
def lstm_setup():
    """(cfg, params, state, images, JAX features) with spread BN statistics,
    so that images differ; the reference's pytree drawn by the port's init."""
    cfg = lstm_cfg()
    params, state = tcap.init(torch.Generator().manual_seed(0), tcap.ModelOptions.from_config(cfg))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    state = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), state)
    rng = np.random.RandomState(0)
    for s in state["encoder"].values():
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.randn(n).astype(np.float32) * 0.1
        s["bn"]["var"] = rng.rand(n).astype(np.float32) * 0.3 + 0.3
    images = rng.rand(B_GREEDY, 64, 64, 3).astype(np.float32)
    jopts = jcap.ModelOptions.from_config(cfg)
    img_embed, _feat, gf, _ = jax.jit(
        lambda p, s, x: jcap.img2feature(p, s, x, jopts, train=False))(params, state, images)
    return cfg, params, state, images, (img_embed, gf)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lstm_greedy_ids_bf16(use_kernels):
    """The port's greedy ids, images to ids, against the JAX decode step
    teacher-forced on them (the port's kernel path runs its kernels' plain
    versions on CPU tensors)."""
    cfg, params, state, images, (img_embed, gf) = lstm_setup()
    topts = tcap.ModelOptions.from_config(cfg)._replace(use_kernels=use_kernels)
    model = captioner_from_tree(params, state, topts, device="cpu")
    ids = tcap.greedy_decode(model, images, topts).numpy()
    assert ids.shape == (B_GREEDY, MAX_LEN)
    dec, dt = params["decoder"], jnp.bfloat16
    step = jax.jit(lambda d, pre, w, h, c: jdec.step(d, pre, w, h, c, False, 0, dt))
    pre = jdec.precompute(dec, img_embed, gf, dt)
    h = c = jnp.zeros((B_GREEDY, dec["p_hid"]["w"].shape[0]), jnp.float32)
    word = jnp.full((B_GREEDY,), topts.start_idx, jnp.int32)
    n_clear = 0
    for t in range(MAX_LEN):
        h, c, logits = step(dec, pre, word, h, c)
        ok, clear = near_tie_check(ids[:, t], np.asarray(logits, np.float32))
        assert ok, f"step {t}"
        n_clear += int(clear.sum())
        word = jnp.asarray(ids[:, t])
    assert n_clear >= ids.size // 2, n_clear


def lstm_train_cfg(dtype, fuse):
    """tests/test_torch_train.py's tiny captioner (B=4, vocab 64, E=16, H=32,
    sentence length 8)."""
    cfg = config_mod.Config()
    for path, v in [("model.decoder.vocab_size", 64), ("model.decoder.embedding_size", 16),
                    ("model.decoder.hidden_dim", 32), ("model.encoder.encoder_scale", 0.35),
                    ("model.decoder.sentence_length", 8), ("model.compute_dtype", dtype),
                    ("model.fuse_bn_stats", fuse), ("data.image_shape", (64, 64))]:
        cfg = config_mod.replace_nested(cfg, path, v)
    return cfg


def train_batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(4, 64, 64, 3).astype(np.float32)
    caps = np.zeros((4, 8), np.int32)
    caps[:, 0] = 2
    for b in range(4):
        n = rng.randint(3, 8)
        caps[b, 1:n] = rng.randint(4, 64, n - 1)
        caps[b, n] = 3
    return images, caps


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_lstm_loss_bf16(fuse):
    cfg = lstm_train_cfg("bfloat16", fuse)
    params, state = tcap.init(torch.Generator().manual_seed(0), tcap.ModelOptions.from_config(cfg))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), state)
    topts = tcap.ModelOptions.from_config(cfg)
    jopts = jcap.ModelOptions.from_config(cfg)
    for seed in range(2):
        images, caps = train_batch(seed)
        jl, (js, jn, _) = jax.jit(lambda p: (
            jcap.loss_fn(p, state, images, caps, jopts, True)[0],
            jcap.loss_terms(p, state, images, caps, jopts, True)))(params)
        tp, ts = train_tree(params, state, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            loss, _ = tcap.loss_fn(tp, ts, torch.as_tensor(images), torch.as_tensor(caps), topts)
            s, n, _ = tcap.loss_terms(tp, ts, torch.as_tensor(images), torch.as_tensor(caps),
                                      topts)
        assert float(n) == float(jn)
        np.testing.assert_allclose(float(loss), float(jl), rtol=3e-2)
        np.testing.assert_allclose(float(s), float(js), rtol=3e-2)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_transformer_loss_bf16(fuse):
    cfg = lstm_train_cfg("bfloat16", fuse)
    for path, v in [("model.decoder.arch", "transformer"), ("model.decoder.num_layers", 2),
                    ("model.decoder.num_heads", 4), ("model.decoder.mlp_ratio", 2),
                    ("train.label_smoothing", 0.1)]:
        cfg = config_mod.replace_nested(cfg, path, v)
    topts, jopts = tcap.ModelOptions.from_config(cfg), jcap.ModelOptions.from_config(cfg)
    assert topts.arch == "transformer" and topts.dtype == BF16
    params, state = tcap.init(torch.Generator().manual_seed(0), topts)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    state = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), state)
    jloss = jax.jit(lambda p, im, cp: jcap.loss_fn(p, state, im, cp, jopts, True)[0])
    for seed in range(2):
        images, caps = train_batch(seed)
        jl = jloss(params, images, caps)
        tp, ts = train_tree(params, state, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            loss, _ = tcap.loss_fn(tp, ts, torch.as_tensor(images), torch.as_tensor(caps), topts)
        np.testing.assert_allclose(float(loss), float(jl), rtol=3e-2)


# ---- transformer ------------------------------------------------------------

TF_DIMS = dict(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2, num_heads=2,
               mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)
TF_STEPS = 5


@functools.lru_cache(maxsize=None)
def tf_setup():
    jdims = JTF.TransformerDims(**TF_DIMS)
    jparams = JTF.init(jax.random.PRNGKey(0), jdims)
    tparams = tree_to_torch(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(0)
    img = rng.rand(B_GREEDY, 5, 256).astype(np.float32)
    gf = rng.rand(B_GREEDY, 256).astype(np.float32)
    return jdims, jparams, tparams, img, gf


@pytest.mark.parametrize("use_kernels", [False, True])
def test_transformer_greedy_ids_bf16(use_kernels):
    jdims, jparams, tparams, img, gf = tf_setup()
    tdims = TTF.TransformerDims(**TF_DIMS)
    tpre = TTF.precompute(tparams, torch.from_numpy(img), torch.from_numpy(gf), 2, BF16)
    ids = TTF.greedy_decode_ids(tparams, tpre, tdims, TF_STEPS, compute_dtype=BF16,
                                use_kernels=use_kernels).numpy()
    dt = jnp.bfloat16
    jpre = JTF.precompute(jparams, jnp.asarray(img), jnp.asarray(gf), 2, dt)
    layers = JTF.prepare_decode_layers(jparams)
    step = jax.jit(lambda p, pre, w, c, t, l: JTF._decode_step(p, pre, jdims, w, c, t, 0, dt,
                                                               layers=l))
    head = jax.jit(lambda p, x: JTF.head_logits(p, x, dt))
    cache = JTF._init_cache(jdims, B_GREEDY, TF_STEPS, dt)
    word = jnp.full((B_GREEDY,), 2, jnp.int32)
    n_clear = 0
    for t in range(TF_STEPS):
        x, cache = step(jparams, jpre, word, cache, jnp.int32(t), layers)
        logits = np.asarray(head(jparams, x), np.float32).reshape(B_GREEDY, -1)
        ok, clear = near_tie_check(ids[:, t], logits)
        assert ok, f"step {t}"
        n_clear += int(clear.sum())
        word = jnp.asarray(ids[:, t])
    assert n_clear >= ids.size // 2, n_clear


def test_transformer_head_logits_kept_float32_diverges_from_reference():
    """The port keeps the transformer's vocab logits in float32, to match
    kernels D and E; the reference rounds the product to the compute dtype
    (JAX ``transformer.head_logits``). Transformer training (ROADMAP queue 1
    item 1) decides whether its training forward takes the reference's
    rounding. Pinned here: the port's logits, rounded to bf16, equal the
    reference's within one bf16 ulp plus the float32 accumulation-order bound
    2 E 2^-24 sum |proj| |table|; unrounded, most are not bf16 numbers. The
    out bias is zeroed on both sides, so the logits are the product."""
    _jdims, jparams, tparams, _img, _gf = tf_setup()
    jp = {**jparams, "out_bias": jnp.zeros_like(jparams["out_bias"])}
    tp = dict(tparams, out_bias=torch.zeros_like(tparams["out_bias"]))
    x = np.random.RandomState(7).randn(8, 256).astype(np.float32)
    got = TTF.head_logits(tp, torch.from_numpy(x), BF16)
    want = np.asarray(JTF.head_logits(jp, jnp.asarray(x), jnp.bfloat16), np.float32)
    assert got.dtype == torch.float32
    proj = TTF.head_proj(tp, torch.from_numpy(x), BF16).float()
    table = tp["embedding"]["table"].to(BF16).float()
    acc = 2 * proj.shape[1] * 2.0 ** -24 * (proj.abs() @ table.abs().T).numpy()
    rounded = got.to(BF16).float().numpy()
    assert (np.abs(rounded - want) <= bf16_ulp(np.abs(want)) + acc).all()
    assert (got.numpy() != rounded).mean() > 0.5  # float32, not bf16, values


def test_transformer_attention_scores_kept_float32_diverges_from_reference():
    """The port keeps the transformer's attention scores ``q . k`` in
    float32 (``transformer._scores``), to match kernels D and E; the
    reference's ``_attend`` rounds them to the compute dtype
    (``jnp.einsum("bqhd,bkhd->bhqk", q, k)`` on bf16 operands). Pinned as
    for the logits: rounded to bf16 they equal the reference's within one
    ulp plus the accumulation bound; unrounded, most are not bf16 numbers."""
    rng = np.random.RandomState(8)
    q, k = (jnp.asarray(rng.randn(3, 4, 2, 128).astype(np.float32)).astype(jnp.bfloat16)
            for _ in range(2))
    want = np.asarray(jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32))
    tq, tk = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16) for a in (q, k))
    got = TTF._scores(tq, tk)
    assert got.dtype == torch.float32
    acc = 2 * 128 * 2.0 ** -24 * torch.einsum(
        "bqhd,bkhd->bhqk", tq.float().abs(), tk.float().abs()).numpy()
    rounded = got.to(BF16).float().numpy()
    assert (np.abs(rounded - want) <= bf16_ulp(np.abs(want)) + acc).all()
    assert (got.numpy() != rounded).mean() > 0.5

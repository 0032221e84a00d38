"""The port's training loss, gradients and BN state against the JAX package,
on the CPU.

A tiny LSTM captioner (MobileNetV2 x0.35 at 64x64, B=4, vocab 64 padded to
128, E=16, H=32, sentence length 8) with random weights from a seed; the same
numpy images and captions go through ``jax.value_and_grad`` of the JAX
``captioner.loss_fn`` and through the port's ``loss_fn`` and
``torch.autograd.grad``, with the port's ``fuse_bn_stats`` off and on (its
kernel F runs its plain version on the CPU). Both are held against the JAX
package's unfused path, compiled once per dtype: its fused path equals it to
summation order (the JAX package's own ``tests/test_fused_bn_stats.py``),
and kernel F's Pallas version is held against the port's in
``tests/test_torch_matmul_bn.py``, so compiling the interpret-mode kernel
into the whole model would check nothing more. Gradients are compared in
the reference layout (HWIO convs).

- float64 (JAX under x64): loss to rtol 1e-9; every gradient leaf to
  rtol 1e-6 + atol 1e-7 x max|grad| (the attention softmax runs in float32
  in both packages; its rounding noise reaches the encoder's gradients at
  up to 5e-8 x max|grad|, and leaves ~1e-9 in gradients that are zero in
  exact arithmetic, such as the score bias's); the new BN state to 1e-10
  (measured 8e-14).
- float32: loss to rtol 1e-5; the decoder's and projections' gradients to
  atol 5e-5 x max|grad| (measured 3e-6 to 5e-6). The encoder's gradients and
  BN state differ by summation order only, but float32 statistics noise is
  amplified through the 52 BN layers of this tiny-batch net (the JAX
  package's own fused-vs-unfused tests meet the same and check in float64):
  the encoder's gradients are held to a relative L2 error of 0.05 over all
  its leaves together (measured 0.02), the BN state to 1e-3 + 1e-3 relative
  (measured 3e-5).

The JAX decoder's zero LSTM state is float32 whatever the compute dtype,
which its float64 scan rejects; the float64 runs swap in a float64 zero
state for the JAX side with ``monkeypatch`` (the JAX code is not changed).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

B, T, VOCAB = 4, 8, 64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: at these sizes threads buy nothing, and
    beside the JAX compiles and other test workers PyTorch's spinning thread
    pool slows the float64 convolutions by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(dtype: str, fuse: bool = False, **extra):
    cfg = jconfig.Config()
    sets = [("model.decoder.vocab_size", VOCAB), ("model.decoder.embedding_size", 16),
            ("model.decoder.hidden_dim", 32), ("model.encoder.encoder_scale", 0.35),
            ("model.decoder.sentence_length", T), ("model.compute_dtype", dtype),
            ("model.fuse_bn_stats", fuse), ("data.image_shape", (64, 64)), *extra.items()]
    for path, v in sets:
        cfg = jconfig.replace_nested(cfg, path, v)
    return cfg


def tiny_batch(np_dt, seed=0):
    """Images and captions (<start> w.. <stop> then padding, lengths vary)."""
    rng = np.random.RandomState(seed)
    images = rng.rand(B, 64, 64, 3).astype(np_dt)
    caps = np.zeros((B, T), np.int32)
    caps[:, 0] = 2
    for b in range(B):
        n = rng.randint(3, T)
        caps[b, 1:n] = rng.randint(4, VOCAB, n - 1)
        caps[b, n] = 3
    return images, caps


def jax_tree(cfg, np_dt):
    """(params, state) for both packages, as numpy: the reference's pytree,
    drawn by the port's ``init`` from a seeded generator (the JAX package's
    eager init compiles op by op for about 20 s on the CPU)."""
    params, state = tcap.init(torch.Generator().manual_seed(0),
                              tcap.ModelOptions.from_config(cfg))
    cast = lambda a: np.asarray(a, np_dt)  # noqa: E731
    return jax.tree_util.tree_map(cast, params), jax.tree_util.tree_map(cast, state)


def f64_zero_state(monkeypatch):
    monkeypatch.setattr(jdec, "_zero_state",
                        lambda b, h: (jnp.zeros((b, h), jnp.float64),) * 2)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(dtype: str, extra=()):
    """The JAX package's unfused loss, gradients and new BN state on the tiny
    captioner -> (cfg, params, state, images, caps, loss, flat grads, flat
    new state), computed once per (dtype, extra config paths)."""
    f64 = dtype == "float64"
    np_dt = np.float64 if f64 else np.float32
    cfg = tiny_cfg(dtype, False, **dict(extra))
    with pytest.MonkeyPatch.context() as mp:
        if f64:
            f64_zero_state(mp)
        with jax.enable_x64(f64):
            params, state = jax_tree(cfg, np_dt)
            images, caps = tiny_batch(np_dt)
            jopts = jcap.ModelOptions.from_config(cfg)
            (jl, jstate), jg = jax.jit(jax.value_and_grad(
                lambda p: jcap.loss_fn(p, state, images, caps, jopts, True), has_aux=True
            ))(params)
            return cfg, params, state, images, caps, float(jl), flat(jg), flat(jstate)


def port_loss_and_grads(cfg, params, state, images, caps, tdt):
    """-> (loss, grads in the reference layout as numpy, new state as numpy)."""
    opts = tcap.ModelOptions.from_config(cfg)
    tp, ts = train_tree(params, state, device="cpu", dtype=tdt)
    loss, new_state = tcap.loss_fn(tp, ts, torch.as_tensor(images), torch.as_tensor(caps), opts)
    # parity_mode leaves the attention score unused: its gradient is zero
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)

    def rebuild(tree):  # tree_leaves' order: dicts by sorted key, lists by index
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v) for v in tree]
        return next(it)

    g_ref, _ = reference_tree(rebuild(tp), {})
    _, s_ref = reference_tree({"encoder": {}}, new_state)
    return float(loss.detach()), g_ref, s_ref


def flat(tree, prefix=""):
    """Nested dicts and lists -> {"a/0/b": float64 numpy}."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loss_grads_and_bn_state_match_jax(dtype, fuse):
    f64 = dtype == "float64"
    cfg, params, state, images, caps, jl, jg, jstate = jax_loss_and_grads(dtype)
    cfg = tiny_cfg(dtype, fuse)
    assert tcap.ModelOptions.from_config(cfg).fuse_bn_stats == fuse
    loss, g, new_state = port_loss_and_grads(
        cfg, params, state, images, caps, torch.float64 if f64 else torch.float32)
    g, new_state = flat(g), flat(new_state)
    assert g.keys() == jg.keys() and new_state.keys() == jstate.keys()
    gmax = max(np.abs(v).max() for v in jg.values())

    np.testing.assert_allclose(loss, jl, rtol=1e-9 if f64 else 1e-5)
    if f64:
        for k in jg:
            np.testing.assert_allclose(g[k], jg[k], rtol=1e-6, atol=1e-7 * gmax, err_msg=k)
        for k in jstate:
            np.testing.assert_allclose(new_state[k], jstate[k], rtol=0, atol=1e-10, err_msg=k)
        return
    enc = [k for k in jg if k.startswith("encoder/")]
    for k in jg:
        if k not in enc:
            np.testing.assert_allclose(g[k], jg[k], rtol=0, atol=5e-5 * gmax, err_msg=k)
    diff = np.sqrt(sum(((g[k] - jg[k]) ** 2).sum() for k in enc))
    norm = np.sqrt(sum((jg[k] ** 2).sum() for k in enc))
    assert diff / norm <= 0.05, diff / norm
    for k in jstate:
        np.testing.assert_allclose(new_state[k], jstate[k], rtol=1e-3, atol=1e-3, err_msg=k)

"""Kernel G's plain versions and the fused-IRB eval encoder of the port
(``ops/kernels/fused_irb.py``, ``models/mobilenet_v2.apply(use_fused_irb=
True)``) against the JAX package, on the CPU, in float32.

The same numpy inputs (made from a seed) go through both. The JAX kernels
``fused_inverted_residual`` and ``fused_irb_chain`` run in interpret mode
(``pltpu.force_tpu_interpret_mode``), as the JAX package's own tests run
them; the port's wrappers run their plain versions because the tensors lie
on the CPU.

- ``fold_bn`` / ``fold_irb`` on the port's OIHW tree against the JAX
  package's on HWIO, with random BN statistics and scales (init's mean 0,
  var 1, scale 1 hide a transposed tap): to 1e-6 relative (the same float32
  arithmetic; the division may round differently);
- both entries at the five shapes of ``tests/test_fused_irb.py``, a 7x7
  stride-1 shape and an odd W: to 1e-5 of the output's largest magnitude
  (float32 sums in other orders: the JAX kernel's dot against PyTorch's
  matmul and convolution); the chain's zero rows, W tail and channel pad
  exactly 0, as the JAX kernel's;
- ``reference_irb`` against the JAX package's;
- ``prepare_irb``'s weights (``FoldedIRB``'s layout, cast once) through both
  entries give the same tensors, bit for bit, as the ``FoldedIRB`` they come
  from, and both hold to the JAX kernels (interpret mode) at the 112 px and
  7x7 block shapes of MobileNetV2 x0.25 (channels rounded up to multiples
  of 8, as kernel G takes them), to 1e-5; ``SplitScratch`` hands out one
  buffer that grows and is reused;
- the whole encoder at 32 and 64 px (at 64 px the JAX package chains the
  blocks at h = 32, 16 and 8, stride-2 blocks among them) against the JAX
  fused eval encoder, to 1e-4 of the features' largest magnitude (17 blocks
  and two convolutions of float32 order differences), and against the
  port's own plain eval encoder to 2e-3, the tolerance of the JAX package's
  test (BN folded into the weights rounds otherwise than BN after the conv).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myimagecaptioningmodel_tpu.models import mobilenet_v2 as JM
from myimagecaptioningmodel_tpu.ops.pallas import fused_irb as JF
from myimagecaptioningmodel_tpu_torch.compat.from_jax import conv_hwio_to_oihw
from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as TM
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as TF


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _folded(rng, cin, cexp, cout):
    arrs = dict(we=rng.randn(cin, cexp) * 0.3, be=rng.randn(1, cexp) * 0.1,
                wd=rng.randn(9, cexp) * 0.3, bd=rng.randn(1, cexp) * 0.1,
                wp=rng.randn(cexp, cout) * 0.3, bp=rng.randn(1, cout) * 0.1)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return (JF.FoldedIRB(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            TF.FoldedIRB(**{k: torch.from_numpy(v) for k, v in arrs.items()}))


def _random_bn(params, state, rng):
    """Random BN scales, offsets and moving statistics, in place."""
    for name in params:
        c = params[name]["conv"]["w"].shape[-1]
        params[name]["bn"] = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
                              "offset": (rng.randn(c) * 0.1).astype(np.float32)}
        state[name]["bn"] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                             "var": (rng.rand(c) + 0.5).astype(np.float32)}


def _encoder_trees(seed):
    """(JAX HWIO numpy tree, port OIHW torch tree) of one MobileNetV2 x1.0
    with random weights and random BN statistics."""
    params, state = TM.init(torch.Generator().manual_seed(seed))
    np_p = {n: {"conv": {"w": p["conv"]["w"].numpy()}, "bn": {}} for n, p in params.items()}
    np_s = {n: {"bn": {}} for n in state}
    _random_bn(np_p, np_s, np.random.RandomState(seed))

    def port(tree):
        return {n: {k: ({"w": torch.from_numpy(conv_hwio_to_oihw(v["w"]))} if k == "conv" else
                        {m: torch.from_numpy(a) for m, a in v.items()}) for k, v in leaf.items()}
                for n, leaf in tree.items()}

    return (np_p, np_s), (port(np_p), port(np_s))


SHAPES = [  # (h, w, cin, cexp, cout, stride, shortcut)
    (8, 8, 8, 24, 8, 1, True),
    (8, 8, 8, 24, 16, 1, False),
    (8, 8, 8, 24, 16, 2, False),
    (14, 14, 16, 48, 16, 1, True),
    (14, 14, 16, 48, 24, 2, False),
    (7, 7, 16, 96, 16, 1, True),  # the 7x7 stage
    (6, 9, 8, 40, 8, 1, True),  # an odd W
]


def test_fold_irb_oihw_matches_jax_hwio():
    (jp, js), (tp, ts) = _encoder_trees(1)
    for name in ("conv2_1", "conv3_2", "conv7_1"):
        keys = ("expand", "dwise", "linear")
        jf = JF.fold_irb({k: jp[f"{name}_{k}"] for k in keys}, {k: js[f"{name}_{k}"] for k in keys})
        tf = TF.fold_irb({k: tp[f"{name}_{k}"] for k in keys}, {k: ts[f"{name}_{k}"] for k in keys})
        for field, j, t in zip(JF.FoldedIRB._fields, jf, tf):
            assert tuple(t.shape) == j.shape, (name, field)
            _close(t.numpy(), np.asarray(j), 1e-6, (name, field))
    w, b = TF.fold_bn(tp["conv9"]["conv"]["w"], tp["conv9"]["bn"], ts["conv9"]["bn"])
    jw, jb = JF.fold_bn(jp["conv9"]["conv"]["w"], jp["conv9"]["bn"], js["conv9"]["bn"])
    _close(w.numpy(), conv_hwio_to_oihw(np.asarray(jw)), 1e-6)
    _close(b.numpy(), np.asarray(jb), 1e-6)


@pytest.mark.parametrize("h,w,cin,cexp,cout,stride,shortcut", SHAPES)
def test_fused_inverted_residual_plain_matches_jax_kernel(h, w, cin, cexp, cout, stride,
                                                          shortcut):
    rng = np.random.RandomState(h * w + cexp + stride)
    x = (rng.randn(2, h, w, cin) * 0.5).astype(np.float32)
    jfold, tfold = _folded(rng, cin, cexp, cout)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JF.fused_inverted_residual(jnp.asarray(x), jfold, stride, shortcut))
    n = TF.fused_inverted_residual.launches
    got = TF.fused_inverted_residual(torch.from_numpy(x), tfold, stride, shortcut)
    assert TF.fused_inverted_residual.launches == n  # the plain version, no kernel
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want, 1e-5)
    _close(TF.reference_irb(torch.from_numpy(x), tfold, stride, shortcut).numpy(),
           np.asarray(JF.reference_irb(jnp.asarray(x), jfold, stride, shortcut)), 1e-5)


@pytest.mark.parametrize("h,w,cin,cexp,cout,stride,shortcut", SHAPES)
def test_fused_irb_chain_plain_matches_jax_kernel(h, w, cin, cexp, cout, stride, shortcut):
    rng = np.random.RandomState(h * w + cexp + stride + 1)
    x = (rng.randn(2, h, w, cin) * 0.5).astype(np.float32)
    jfold, tfold = _folded(rng, cin, cexp, cout)
    jx = JF.pad_activation(jnp.asarray(x))
    tx = TF.pad_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JF.fused_irb_chain(jx, jfold, stride, shortcut, real_w=w))
    got = TF.fused_irb_chain(tx, tfold, stride, shortcut, real_w=w).numpy()
    assert got.shape == want.shape
    ho, wo = h // stride, w // stride
    real = np.zeros(want.shape, bool)
    real[:, 1:ho + 1, :wo, :cout] = True
    assert (got[~real] == 0).all() and (want[~real] == 0).all()
    _close(got[real], want[real], 1e-5)
    np.testing.assert_array_equal(
        TF.strip_activation(torch.from_numpy(got), cout, wo).numpy(),
        np.asarray(JF.strip_activation(jnp.asarray(got), cout, wo)))


@pytest.mark.parametrize("size", [32, 64])
def test_fused_eval_encoder_matches_jax(size):
    (jp, js), (tp, ts) = _encoder_trees(size)
    x = np.random.RandomState(size).rand(1, size, size, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, _ = JM.apply(jp, js, jnp.asarray(x), train=False, compute_dtype=jnp.float32,
                           use_fused_irb=True)
    want = np.asarray(want)
    n = TF.fused_inverted_residual.launches
    got, state = TM.apply(tp, ts, torch.from_numpy(x), train=False, compute_dtype=torch.float32,
                          use_fused_irb=True)
    assert state is ts  # eval: the state comes back unchanged
    assert TF.fused_inverted_residual.launches == n
    assert tuple(got.shape) == want.shape == (1, size // 32, size // 32, 1280)
    _close(got.numpy(), want, 1e-4)
    plain, _ = TM.apply(tp, ts, torch.from_numpy(x), train=False, compute_dtype=torch.float32)
    _close(got.numpy(), plain.numpy(), 2e-3)


# (h, w, cin, cexp, cout, stride, shortcut): MobileNetV2 x0.25's blocks at 112
# px and 7x7 (conv2_1, conv3_1, conv7_2, conv8_1), channels rounded up to 8
NARROW = [
    (112, 112, 8, 8, 8, 1, False),
    (112, 112, 8, 48, 8, 2, False),
    (7, 7, 40, 240, 40, 1, True),
    (7, 7, 40, 240, 80, 1, False),
]


@pytest.mark.parametrize("h,w,cin,cexp,cout,stride,shortcut", NARROW)
def test_prepared_weights_equal_folded_and_jax(h, w, cin, cexp, cout, stride, shortcut):
    rng = np.random.RandomState(h + cexp + cout)
    x = (rng.randn(1, h, w, cin) * 0.5).astype(np.float32)
    jfold, tfold = _folded(rng, cin, cexp, cout)
    prep = TF.prepare_irb(tfold, torch.float32, TF.SplitScratch())
    tx = torch.from_numpy(x)
    n = TF.fused_inverted_residual.launches
    got_f = TF.fused_inverted_residual(tx, tfold, stride, shortcut)
    got_p = TF.fused_inverted_residual(tx, prep, stride, shortcut)
    assert TF.fused_inverted_residual.launches == n  # the plain version, no kernel
    assert torch.equal(got_p, got_f)
    jx = JF.pad_activation(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JF.fused_inverted_residual(jnp.asarray(x), jfold, stride, shortcut))
        want_c = np.asarray(JF.fused_irb_chain(jx, jfold, stride, shortcut, real_w=w))
    _close(got_p.numpy(), want, 1e-5)
    tx_c = TF.pad_activation(tx)
    chain_p = TF.fused_irb_chain(tx_c, prep, stride, shortcut, real_w=w)
    assert torch.equal(chain_p, TF.fused_irb_chain(tx_c, tfold, stride, shortcut, real_w=w))
    assert chain_p.shape == want_c.shape
    _close(chain_p.numpy(), want_c, 1e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float64])
def test_prepare_irb_keeps_folded_layout(dt):
    """The products' weights rounded to the activation dtype, the biases flat
    in the accumulation dtype, FoldedIRB's shapes again through as_folded."""
    _jfold, fold = _folded(np.random.RandomState(3), 16, 40, 24)
    prep = TF.prepare_irb(fold, dt)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    assert prep.we.dtype == prep.wp.dtype == dt and prep.scratch is None
    assert torch.equal(prep.we, fold.we.to(dt)) and torch.equal(prep.wp, fold.wp.to(dt))
    for name in ("be", "bd", "bp"):
        assert getattr(prep, name).shape == (getattr(fold, name).shape[1],)
        assert torch.equal(getattr(prep, name), getattr(fold, name)[0].to(acc))
    assert prep.wd.dtype == acc and torch.equal(prep.wd, fold.wd.to(acc))
    assert all(t.is_contiguous() for t in prep[:6])
    back = TF.as_folded(prep)
    assert isinstance(back, TF.FoldedIRB) and TF.as_folded(fold) is fold
    assert [tuple(t.shape) for t in back] == [tuple(t.shape) for t in fold]


def test_split_scratch_grows_and_is_reused():
    scratch = TF.SplitScratch()
    a = scratch.get(100, torch.device("cpu"))
    assert a.numel() == 100 and a.dtype == torch.float32
    b = scratch.get(40, torch.device("cpu"))
    assert b.numel() == 40 and b.data_ptr() == a.data_ptr()
    c = scratch.get(300, torch.device("cpu"))
    assert c.numel() == 300 and scratch.get(300, torch.device("cpu")).data_ptr() == c.data_ptr()

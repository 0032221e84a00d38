"""The attention scores' hand-written backward and the ``remat`` and
``fused_attn_bwd`` switches of the LSTM ``teacher_forcing_logits``, against
the JAX package, on the CPU.

At the dims of the JAX package's own test of the fused backward
(``tests/test_model.py::test_fused_attn_bwd_matches_autodiff``: H=640, k=16,
B=4, T=7, V=200, E=32), from a numpy seed: the decoder's params are drawn by
the port's ``init`` and carried to torch by ``compat/from_jax.tree_to_torch``;
the JAX side takes the same numpy tree. The loss is ``mean(logits^2)``.

- float32: the port's fused loss and every gradient against the JAX
  package's ``fused_attn_bwd=True`` to rtol 2e-4, atol 1e-6 (the JAX test's
  own tolerance: the two sum in other orders); the port's fused path against
  its default path, the loss bit-equal (the forward is the same expression)
  and the gradients to the same tolerance;
- bfloat16: the loss to rtol 3e-2 (``tests/test_torch_bf16_parity.py``'s
  LSTM loss tolerance) against JAX's fused path, and the gradients to a
  relative L2 error of 3e-2 all together and leaf by leaf, a leaf that
  bfloat16 leaves as rounding noise to 1.25 x the port's default path's
  error against the same JAX gradients (bfloat16 keeps 8 bits, and XLA
  keeps excess precision inside a jitted graph where the port rounds at
  every op; measured: the fused loss 1.5e-3 from JAX's, leaves 2e-3 to
  1.2e-2 but hid_emb's 0.095 (default path 0.100) and the score bias's
  0.54 (1.0));
- ``attn_scores_fused_bwd`` alone, with and without a score bias, forward
  and vjp against JAX's in float32 to the same rtol 2e-4, atol 1e-6, and
  its forward bit-equal to the expression written out;
- ``remat=False``: the loss bit-equal and the gradients equal to
  ``remat=True``'s;
- ``parity_mode``: the switch changes nothing (attention is skipped);
  ``vocab_parallel`` in a group of one: the fused path's bits.

Kernel H itself (``csrc/attn_scores.cu``) is held to its plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 29). Here,
at (T, B, k, H) = (7, 3, 16, 200), float32 and bfloat16, the limits of that
check (``chip_smoke.h_scores``) are fed the plain versions: with their sums
in another order and, in bf16, their tanh moved by the kernel's stated
worst-case error they score <= 1; with each planted fault of
``chip_fault_check.H_FAULTS`` they score > 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.ops import attention as jatt
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as tdec
from myimagecaptioningmodel_tpu_torch.ops import attention as tatt
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

H, K, B, T, V, E = 640, 16, 4, 7, 200, 32
F32_TOL = dict(rtol=2e-4, atol=1e-6)
BF16_RTOL = 3e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def case():
    """(numpy params, p_img [B, k, H], global feat [B, H], source [B, T])."""
    dims = tdec.DecoderDims(vocab_size=V, embedding_size=E, hidden_dim=H, feat_channels=64)
    params = tdec.init(torch.Generator().manual_seed(0), dims)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.RandomState(0)
    p_img = (rng.randn(B, K, H) * 0.1).astype(np.float32)
    gfeat = (rng.randn(B, H) * 0.1).astype(np.float32)
    src = rng.randint(1, V, (B, T)).astype(np.int32)
    return params, p_img, gfeat, src


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(dtype: str):
    """The JAX package's fused-backward loss and flat gradients."""
    params, p_img, gfeat, src = case()
    dt = jnp.dtype(dtype)

    def loss(p):
        pre = jdec.precompute(p, jnp.asarray(p_img), jnp.asarray(gfeat), dt)
        logits = jdec.teacher_forcing_logits(p, pre, jnp.asarray(src), compute_dtype=dt,
                                             fused_attn_bwd=True)
        return jnp.mean(logits.astype(jnp.float32) ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    v, g = jax.jit(jax.value_and_grad(loss))(jp)
    return float(v), [np.asarray(x, np.float32) for x in tree_leaves(g)]


def port_loss_and_grads(dt, **switches):
    """The port's loss and flat gradients (the leaves in ``tree_leaves``
    order, which is the JAX tree's)."""
    params, p_img, gfeat, src = case()
    tp = tree_to_torch(params)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    pre = tdec.precompute(tp, torch.from_numpy(p_img), torch.from_numpy(gfeat), dt)
    logits = tdec.teacher_forcing_logits(tp, pre, torch.from_numpy(src).long(),
                                         compute_dtype=dt, **switches)
    loss = torch.mean(logits.float() ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g.detach()
                           for x, g in zip(leaves, grads)]


def leaf_names():
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(case()[0])]


def test_fused_matches_jax_float32():
    jl, jg = jax_loss_and_grads("float32")
    loss, grads = port_loss_and_grads(torch.float32, fused_attn_bwd=True)
    np.testing.assert_allclose(float(loss), jl, **F32_TOL)
    assert len(grads) == len(jg)
    for name, g, j in zip(leaf_names(), grads, jg):
        np.testing.assert_allclose(g.numpy(), j, err_msg=name, **F32_TOL)


def test_fused_matches_default_path():
    """The forward is the same expression: the loss bit for bit; the
    gradients differ by summation order only."""
    l_def, g_def = port_loss_and_grads(torch.float32)
    l_fus, g_fus = port_loss_and_grads(torch.float32, fused_attn_bwd=True)
    assert torch.equal(l_def, l_fus)
    for name, a, f in zip(leaf_names(), g_def, g_fus):
        np.testing.assert_allclose(f.numpy(), a.numpy(), err_msg=name, **F32_TOL)
    # the score params' gradients come from the fused backward itself
    assert any(not torch.equal(a, f) for a, f in zip(g_def, g_fus))


def rel_l2(g, j):
    g = g.float().numpy()
    return float(np.linalg.norm(g - j) / max(np.linalg.norm(j), 1e-30))


def test_fused_matches_jax_bfloat16():
    """Each leaf within BF16_RTOL, or no further from JAX than autograd of the
    same forward (the port's default path) is: two leaves are rounding noise
    at this size, the score bias's gradient (zero in exact arithmetic: the
    softmax's gradient sums to 0 over the k+1 slots) and hid_emb's (a near
    cancellation of that sum, the k image keys being close), at ~0.1-1
    relative on both paths (measured)."""
    jl, jg = jax_loss_and_grads("bfloat16")
    loss, grads = port_loss_and_grads(torch.bfloat16, fused_attn_bwd=True)
    _, witness = port_loss_and_grads(torch.bfloat16)
    np.testing.assert_allclose(float(loss), jl, rtol=BF16_RTOL)
    over = []
    for name, g, w, j in zip(leaf_names(), grads, witness, jg):
        err, err_w = rel_l2(g, j), rel_l2(w, j)
        if err > max(BF16_RTOL, 1.25 * err_w):
            over.append((name, err, err_w))
    assert not over
    total = rel_l2(torch.cat([g.float().flatten() for g in grads]),
                   np.concatenate([j.ravel() for j in jg]))
    assert total <= BF16_RTOL


@pytest.mark.parametrize("with_bias", [True, False])
def test_attn_scores_fused_bwd_alone(with_bias):
    """The function alone, forward and vjp, against JAX's custom VJP; a score
    without ``b`` has no bias gradient."""
    rng = np.random.RandomState(1)
    Hs, Ks, Bs, Ts = 96, 5, 3, 4
    w = (rng.randn(Hs, 1) * 0.2).astype(np.float32)
    b = (rng.randn(1) * 0.5).astype(np.float32)
    ik = (rng.randn(Bs, Ks, Hs) * 0.5).astype(np.float32)
    he = (rng.randn(Ts, Bs, Hs) * 0.5).astype(np.float32)
    de = rng.randn(Ts, Bs, Ks).astype(np.float32)
    score = {"w": w, "b": b} if with_bias else {"w": w}

    jscore = jax.tree_util.tree_map(jnp.asarray, score)
    je, vjp = jax.vjp(lambda s, i, h: jatt.attn_scores_fused_bwd(jnp.float32, s, i, h),
                      jscore, jnp.asarray(ik), jnp.asarray(he))
    jds, jdk, jdh = vjp(jnp.asarray(de))

    tscore = {k: torch.from_numpy(v).requires_grad_(True) for k, v in score.items()}
    tik = torch.from_numpy(ik).requires_grad_(True)
    the = torch.from_numpy(he).requires_grad_(True)
    e = tatt.attn_scores_fused_bwd(torch.float32, tscore, tik, the)
    inputs = [tscore["w"]] + ([tscore["b"]] if with_bias else []) + [tik, the]
    got = torch.autograd.grad(e, inputs, torch.from_numpy(de))
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(je), **F32_TOL)
    want = [jds["w"]] + ([jds["b"]] if with_bias else []) + [jdk, jdh]
    for g, j in zip(got, want):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32_TOL)
    # the forward is the decoder's default expression, bit for bit
    z = torch.tanh(tik[None] + the[:, :, None, :])
    assert torch.equal(e, TL.dense(tscore, z, torch.float32)[..., 0])


def test_remat_off_matches_on():
    l_on, g_on = port_loss_and_grads(torch.float32)
    l_off, g_off = port_loss_and_grads(torch.float32, remat=False)
    assert torch.equal(l_on, l_off)
    for name, a, b in zip(leaf_names(), g_on, g_off):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("fused", [False, True])
def test_parity_mode_skips_attention_in_both(fused):
    params, p_img, gfeat, src = case()
    tp = tree_to_torch(params)
    pre = tdec.precompute(tp, torch.from_numpy(p_img), torch.from_numpy(gfeat), torch.float32)
    src_t = torch.from_numpy(src).long()
    want = tdec.teacher_forcing_logits(tp, pre, src_t, parity_mode=True,
                                       compute_dtype=torch.float32)
    got = tdec.teacher_forcing_logits(tp, pre, src_t, parity_mode=True,
                                      compute_dtype=torch.float32, fused_attn_bwd=fused,
                                      remat=not fused)
    assert torch.equal(got, want)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a card gets no plain fallback."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH

    ik, he = torch.empty((2, 3, 8), device="meta"), torch.empty((4, 2, 8), device="meta")
    w, de = torch.empty((8, 1), device="meta"), torch.empty((4, 2, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KH.attn_scores(ik, he, w, None, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        KH.attn_scores_bwd(ik, he, w, None, de, torch.float32)


def test_fused_composes_with_vocab_parallel():
    """In a group of one the vocab-parallel lookup, head and fused scores
    give the plain fused path's loss and gradients, bit for bit."""
    l_vp, g_vp = port_loss_and_grads(torch.float32, fused_attn_bwd=True, vocab_parallel=True)
    l_f, g_f = port_loss_and_grads(torch.float32, fused_attn_bwd=True)
    assert torch.equal(l_vp, l_f)
    for name, a, b in zip(leaf_names(), g_vp, g_f):
        assert torch.equal(a, b), name


H_LIMIT_SHAPE = (7, 3, 16, 200)


def h_limit_operands(dt):
    import chip_smoke as S

    gen = torch.Generator().manual_seed(sum(H_LIMIT_SHAPE))
    return S.h_operands(gen, "cpu", *H_LIMIT_SHAPE, dt)


def h_other_order(fwd, bwd, ops, dt):
    """The outputs of ``fwd``/``bwd`` with every sum over h, t, b and k
    taken in reversed order: the operands flipped, the outputs flipped back."""
    import chip_smoke as S

    ik, he, w, b, de = ops
    e, dw, db, dk, dh = S.h_run(fwd, bwd, (ik.flip(0, 1, 2), he.flip(0, 1, 2), w.flip(0), b,
                                           de.flip(0, 1, 2)), dt)
    return e.flip(0, 1, 2), dw.flip(0), db, dk.flip(0, 1, 2), dh.flip(0, 1, 2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["up", "down"])
def test_kernel_h_limits_pass_the_stated_tanh_error(monkeypatch, dt, sign):
    """The plain versions as the kernel differs from them: every sum in
    another order and, in bf16, every z moved by the stated worst case of
    tanh.approx.f32 (``chip_smoke.H_TANH_EPS``, all in one direction) before
    its rounding to bf16. The float32 kernel evaluates libm tanhf, the
    plain version's own function on the card: its z is not moved. The check
    passes (every score <= 1)."""
    import chip_smoke as S
    from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH

    def moved_z(img_k, h_emb, d):
        x = img_k[None].to(d) + h_emb.to(d)[:, :, None, :]
        return (torch.tanh(x.double()) * (1 + sign * S.H_TANH_EPS)).to(d)

    ops = h_limit_operands(dt)
    with monkeypatch.context() as m:  # the got side only
        if dt == torch.bfloat16:
            m.setattr(KH, "_z", moved_z)
        got = h_other_order(KH.attn_scores_reference, KH.attn_scores_bwd_reference, ops, dt)
    want = S.h_run(KH.attn_scores_reference, KH.attn_scores_bwd_reference, ops, dt)
    assert any(not torch.equal(g, w) for g, w in zip(got, want) if g is not None)
    scores, _err = S.h_scores(got, ops, dt)
    assert set(scores) == set(S.H_TERMS)
    assert max(scores.values()) <= 1.0, scores


H_FAULT_NAMES = ("one_minus_z2_dropped", "bias_dropped", "dimg_k_misses_last_t",
                 "dw_misses_last_image", "db_misses_last_t")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("fault", H_FAULT_NAMES)
def test_kernel_h_limits_catch_each_fault(dt, fault):
    """Each of chip_fault_check.py part 12's plants, applied to the plain
    versions, scores > 1."""
    import chip_fault_check as F
    import chip_smoke as S
    from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH

    plants = {p.__name__.strip("_"): p for p in F.H_FAULTS}
    assert tuple(plants) == H_FAULT_NAMES  # every plant of part 12, in its order
    fwd, bwd = plants[fault](KH.attn_scores_reference, KH.attn_scores_bwd_reference)
    ops = h_limit_operands(dt)
    scores, _err = S.h_scores(S.h_run(fwd, bwd, ops, dt), ops, dt)
    assert max(scores.values()) > 1.0, (fault, scores)

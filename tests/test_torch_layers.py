"""Port layer primitives (myimagecaptioningmodel_tpu_torch/ops) against the
JAX package's, on the same numpy inputs.

Tolerance: float32 to 1e-5 (absolute and relative). Both sides compute the
same float32 formulas; only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.ops import attention as jattn
from myimagecaptioningmodel_tpu.ops import layers as jL
from myimagecaptioningmodel_tpu.ops import lstm as jlstm
from myimagecaptioningmodel_tpu_torch.compat.from_jax import conv_hwio_to_oihw
from myimagecaptioningmodel_tpu_torch.ops import attention as tattn
from myimagecaptioningmodel_tpu_torch.ops import layers as tL
from myimagecaptioningmodel_tpu_torch.ops import lstm as tlstm

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = jnp.float32


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _tt(tree):
    return {k: (_tt(v) if isinstance(v, dict) else torch.as_tensor(v)) for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(5, 16), (3, 7, 16)])
def test_dense(shape):
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(16, 24).astype(np.float32), "b": rng.randn(24).astype(np.float32)}
    x = rng.randn(*shape).astype(np.float32)
    _close(tL.dense(_tt(p), torch.as_tensor(x), torch.float32),
           jL.dense(p, jnp.asarray(x), F32))


def test_embed_zeroes_padding_lookups():
    rng = np.random.RandomState(1)
    p = {"table": rng.randn(50, 8).astype(np.float32)}
    ids = np.array([[0, 3, 7], [0, 0, 49]], np.int32)
    out = tL.embed(_tt(p), torch.as_tensor(ids).long(), padding_idx=0)
    _close(out, jL.embed(p, jnp.asarray(ids), padding_idx=0))
    assert float(out[0, 0].abs().max()) == 0.0


def test_eval_batch_norm():
    rng = np.random.RandomState(2)
    p = {"scale": rng.rand(6).astype(np.float32) + 0.5,
         "offset": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32),
         "var": rng.rand(6).astype(np.float32) + 0.1}
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    ref, _ = jL.batch_norm(p, s, jnp.asarray(x), train=False)
    _close(tL.batch_norm(_tt(p), _tt(s), torch.as_tensor(x)), ref)
    # the encoder's NCHW use: channel axis 1
    y = tL.batch_norm(_tt(p), _tt(s), torch.as_tensor(x).permute(0, 3, 1, 2), channel_axis=1)
    _close(y.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize(
    "cin,cout,k,stride,groups",
    [(3, 8, 3, 2, 1), (8, 16, 1, 1, 1), (12, 12, 3, 1, 12), (12, 12, 3, 2, 12)],
)
def test_conv2d_and_depthwise(cin, cout, k, stride, groups):
    rng = np.random.RandomState(3)
    w = rng.randn(k, k, cin // groups, cout).astype(np.float32)  # HWIO
    x = rng.randn(2, 9, 9, cin).astype(np.float32)  # NHWC
    pad = (k - 1) // 2
    ref = jL.conv2d({"w": w}, jnp.asarray(x), stride, pad, groups, F32)
    out = tL.conv2d(torch.as_tensor(conv_hwio_to_oihw(w)),
                    torch.as_tensor(x).permute(0, 3, 1, 2), stride, pad, groups,
                    torch.float32)
    _close(out.permute(0, 2, 3, 1), ref)


def test_relu6():
    x = np.linspace(-3, 9, 25).astype(np.float32)
    _close(tL.relu6(torch.as_tensor(x)), jL.relu6(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_relu6_gradient_matches_jax_at_the_ends(dtype):
    """``jnp.clip``'s gradient is 1/2 at x == 0 and x == 6 (1 inside, 0
    outside); ``torch.clamp``'s is 1 there. A BN output equal to its offset
    of 0 (a constant channel at init) lands on the tie."""
    import jax

    x = np.array([-1.0, -0.0, 0.0, 1e-3, 3.0, 5.96875, 6.0, 6.03125, 7.0], np.float32)
    dy = np.linspace(0.5, 2.5, x.size).astype(np.float32)
    want = np.asarray(jax.vjp(jL.relu6, jnp.asarray(x))[1](jnp.asarray(dy))[0])
    tx = torch.tensor(x, dtype=dtype, requires_grad=True)
    (got,) = torch.autograd.grad(tL.relu6(tx), tx, torch.tensor(dy, dtype=dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert list(want[[1, 2, 6]] / dy[[1, 2, 6]]) == [0.5, 0.5, 0.5]


def test_lstm_from_gates_gate_order():
    rng = np.random.RandomState(4)
    gates = rng.randn(5, 4 * 16).astype(np.float32) * 2
    c = rng.randn(5, 16).astype(np.float32)
    th, tc = tlstm.lstm_from_gates(torch.as_tensor(gates), torch.as_tensor(c))
    jh, jc = jlstm.lstm_from_gates(jnp.asarray(gates), jnp.asarray(c))
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("parity_mode", [False, True])
def test_adaptive_attention(parity_mode):
    rng = np.random.RandomState(5)
    B, k, H = 3, 7, 16
    p = {"score": {"w": rng.randn(H, 1).astype(np.float32),
                   "b": rng.randn(1).astype(np.float32)}}
    arrs = [rng.randn(*s).astype(np.float32)
            for s in [(B, k, H), (B, k, H), (B, H), (B, H), (B, H)]]
    tctx, talpha = tattn.adaptive_attention(
        _tt(p), *map(torch.as_tensor, arrs), parity_mode=parity_mode,
        compute_dtype=torch.float32)
    jctx, jalpha = jattn.adaptive_attention(
        p, *map(jnp.asarray, arrs), parity_mode=parity_mode, compute_dtype=F32)
    _close(tctx, jctx)
    _close(talpha, jalpha)

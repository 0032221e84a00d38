"""Kernel F's plain version, the fused 1x1 conv + BN and train-mode BN of the
port against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through the JAX functions and
the port's. The JAX ``_matmul_stats`` and ``conv1x1_bn_train`` run their
Pallas kernel in interpret mode off the TPU, as the JAX package's own tests
run them; the port's wrapper runs its plain version because the tensors lie
on the CPU. M includes sizes that are not a multiple of any block.

Tolerances:
- ``matmul_stats``: y in float64 to 1e-12 and in float32 to 1e-5 x max|y|
  (the two products add in other orders); in bfloat16 to one bf16 ulp of
  the larger magnitude (an order difference may round a value to the
  neighbouring bf16 number); sum and sumsq to 1e-5 of sum|y| and sumsq
  (1e-12 in float64), plus what the differing bf16 values move them by.
- ``conv1x1_bn_train`` and ``batch_norm_train``, forward and backward:
  float64 to 1e-10 relative to each output's largest magnitude, float32 to
  1e-4 (one-pass statistics in float32 and the products' summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.ops import layers as JL
from myimagecaptioningmodel_tpu.ops.pallas import matmul_bn as JMB
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as TMB

NP = {"float64": np.float64, "float32": np.float32, "bfloat16": np.float32}
TORCH = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


@pytest.mark.parametrize("M,K,N", [(512, 32, 96), (1000, 24, 144), (37, 11, 20)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_matmul_stats_plain_matches_jax(dtype, M, K, N):
    rng = np.random.RandomState(M + K + N)
    x = rng.randn(M, K).astype(NP[dtype])
    w = (rng.randn(K, N) / np.sqrt(K)).astype(NP[dtype])
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.dtype(dtype)
        jy, js, jq = JMB._matmul_stats(jnp.asarray(x, jdt), jnp.asarray(w, jdt), True)
        jy, js, jq = (np.asarray(a.astype(jnp.float64 if dtype == "float64" else jnp.float32))
                      for a in (jy, js, jq))
    tdt = TORCH[dtype]
    y, s, q = TMB.matmul_stats(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt))
    assert y.dtype == tdt and s.dtype == q.dtype == TL.stat_dtype(y) and y.shape == (M, N)
    y, s, q = _np(y), _np(s), _np(q)
    if dtype == "bfloat16":
        mag = np.maximum(np.abs(y), np.abs(jy)).clip(1e-30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert (np.abs(y - jy) <= ulp).all()
        # the sums may differ by what the differing values add
        moved = np.abs(y - jy).sum(0), (np.abs(y * y - jy * jy)).sum(0)
    else:
        _close(y, jy, 1e-12 if dtype == "float64" else 1e-5, "y")
        moved = 0.0, 0.0
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert (np.abs(s - js) <= tol * np.abs(jy).sum(0) + moved[0]).all()
    assert (np.abs(q - jq) <= tol * jq + moved[1]).all()


def _bn_inputs(rng, np_dt, B=3, Hs=5, Cin=12, Cout=20):
    x = (rng.randn(B, Hs, Hs, Cin) * 2 + 0.5).astype(np_dt)
    w = (rng.randn(1, 1, Cin, Cout) / np.sqrt(Cin)).astype(np_dt)
    scale = (1 + 0.1 * rng.randn(Cout)).astype(np_dt)
    offset = (0.1 * rng.randn(Cout)).astype(np_dt)
    dy = rng.randn(B, Hs, Hs, Cout).astype(np_dt)
    return x, w, scale, offset, dy


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_conv1x1_bn_train_forward_and_backward_match_jax(dtype):
    rng = np.random.RandomState(3)
    x, w, scale, offset, dy = _bn_inputs(rng, NP[dtype])
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.dtype(dtype)

        def jf(w_, sc, of, x_):
            return JMB.conv1x1_bn_train({"w": w_}, {"scale": sc, "offset": of}, x_, jdt)

        (jy, jmean, jvar), vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (w, scale, offset, x)))
        zeros = jnp.zeros_like(jmean)
        jdw, jds, jdo, jdx = (np.asarray(a) for a in vjp((jnp.asarray(dy), zeros, zeros)))
        jy, jmean, jvar = (np.asarray(a) for a in (jy, jmean, jvar))
    tdt = TORCH[dtype]
    tw = torch.tensor(np.transpose(w, (3, 2, 0, 1)), requires_grad=True)  # OIHW
    ts = torch.tensor(scale, requires_grad=True)
    to = torch.tensor(offset, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, mean, var = TMB.conv1x1_bn_train(tw, {"scale": ts, "offset": to}, tx, tdt)
    assert not mean.requires_grad and not var.requires_grad
    dw, ds, do, dx = torch.autograd.grad(y, (tw, ts, to, tx), torch.as_tensor(dy))
    tol = 1e-10 if dtype == "float64" else 1e-4
    for name, got, want in (("y", y, jy), ("mean", mean, jmean), ("var", var, jvar),
                            ("dw", dw.permute(2, 3, 1, 0), jdw), ("dscale", ds, jds),
                            ("doffset", do, jdo), ("dx", dx, jdx)):
        _close(_np(got), want, tol, name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_norm_train_matches_jax(dtype):
    """Train-mode BN (forward, hand-written backward, moving-stat update) and
    the fused path's triple against the unfused one."""
    rng = np.random.RandomState(4)
    x, _w, scale, offset, dy = _bn_inputs(rng, NP[dtype], Cin=20)
    dy = dy[..., :20]
    s = {"mean": rng.randn(20).astype(NP[dtype]), "var": rng.rand(20).astype(NP[dtype]) + 0.5}
    with jax.enable_x64(dtype == "float64"):
        def jf(sc, of, x_):
            y, new_s = JL.batch_norm({"scale": sc, "offset": of},
                                     {k: jnp.asarray(v) for k, v in s.items()}, x_, True)
            return y, new_s

        (jy, jnew), vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (scale, offset, x)))
        zero_s = {k: jnp.zeros_like(v) for k, v in jnew.items()}
        jds, jdo, jdx = (np.asarray(a) for a in vjp((jnp.asarray(dy), zero_s)))
        jy, jnew = np.asarray(jy), {k: np.asarray(v) for k, v in jnew.items()}
    ts = torch.tensor(scale, requires_grad=True)
    to = torch.tensor(offset, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, new = TL.batch_norm_train({"scale": ts, "offset": to},
                                 {k: torch.as_tensor(v) for k, v in s.items()}, tx)
    ds, do, dx = torch.autograd.grad(y, (ts, to, tx), torch.as_tensor(dy))
    tol = 1e-10 if dtype == "float64" else 1e-4
    for name, got, want in (("y", y, jy), ("dscale", ds, jds), ("doffset", do, jdo),
                            ("dx", dx, jdx), ("mean", new["mean"], jnew["mean"]),
                            ("var", new["var"], jnew["var"])):
        _close(_np(got), want, tol, name)
    p0, s0 = TL.init_batch_norm(20)
    jp0, js0 = JL.init_batch_norm(20)
    for got, want in ((p0, jp0), (s0, js0)):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

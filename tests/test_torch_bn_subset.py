"""The port's subset-statistics BN (``model.bn_stat_rows``) against the JAX
package, on the CPU, in float64.

- ``layers._BNTrainSubset`` against the JAX ``layers._bn_train_subset`` (a
  ``jax.custom_vjp``) on one NHWC batch (B=5, 3x4 spatial, 6 channels, with
  an offset and a spread per channel): y, the batch mean and variance, and
  the VJP's dscale, doffset and dx for one random cotangent, at R in {1, 2,
  B-1}, to 1e-12 (measured at most 6.8e-14). ``R >= B`` (and 0) is the exact
  BN: ``batch_norm_train`` then gives what it gives without ``stat_rows``,
  bit for bit, as the JAX ``batch_norm`` falls back.
- the whole LSTM loss, gradients and new BN state with ``bn_stat_rows=2``
  on the tiny captioner of ``test_torch_train`` (B=4), ``fuse_bn_stats`` off
  and on, each against the JAX package's same path (fused: the 1x1 convs
  keep full-batch statistics through kernel F, whose Pallas version runs
  in interpret mode on the CPU and the port's plain version): loss to rtol
  1e-9, every gradient leaf to rtol 1e-6 + atol 1e-7 x max|grad|, the BN
  state to 1e-10, as ``test_torch_train``'s float64 case. The subset path
  must differ from the exact one (the knob is live). The fused case has
  channels that are constant at init, whose BN output is its offset, 0: it
  holds ``layers.relu6``'s gradient of 1/2 there, the reference's (with
  ``torch.clamp``'s 1 those channels' BN offsets read twice the
  reference's gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.ops import layers as JL
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from test_torch_train import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    flat, jax_loss_and_grads, one_torch_thread, port_loss_and_grads, tiny_cfg,
)

B, C = 5, 6


def bn_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(B, 3, 4, C) * rng.rand(C) * 3 + rng.randn(C)
    scale, offset = 1 + 0.3 * rng.randn(C), 0.2 * rng.randn(C)
    dy = rng.randn(B, 3, 4, C)
    return x, scale, offset, dy


@pytest.mark.parametrize("rows", [1, 2, B - 1])
def test_subset_bn_and_vjp_match_jax(rows):
    x, scale, offset, dy = bn_inputs()
    with jax.enable_x64(True):
        (jy, jmean, jvar), vjp = jax.vjp(
            lambda s, o, xx: JL._bn_train_subset(s, o, xx, rows),
            jnp.asarray(scale), jnp.asarray(offset), jnp.asarray(x))
        jds, jdo, jdx = vjp((jnp.asarray(dy), jnp.zeros(C), jnp.zeros(C)))
        want = [np.asarray(a) for a in (jy, jmean, jvar, jds, jdo, jdx)]
    ts, to, tx = (torch.tensor(a, requires_grad=True) for a in (scale, offset, x))
    y, mean, var = TL._BNTrainSubset.apply(ts, to, tx, rows)
    ds, do, dx = torch.autograd.grad(y, (ts, to, tx), torch.from_numpy(dy))
    got = [t.detach().numpy() for t in (y, mean, var, ds, do, dx)]
    for name, g, w in zip(("y", "mean", "var", "dscale", "doffset", "dx"), got, want):
        assert g.dtype == np.float64, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=name)
    # statistics of the first rows only; every row normalized
    np.testing.assert_allclose(got[1], x[:rows].mean(axis=(0, 1, 2)), atol=1e-12)
    assert not np.allclose(got[0][rows:], 0)


@pytest.mark.parametrize("rows", [0, B, B + 1])
def test_stat_rows_out_of_range_is_exact_bn(rows):
    x, scale, offset, _dy = bn_inputs()
    p = {"scale": torch.from_numpy(scale), "offset": torch.from_numpy(offset)}
    s = {"mean": torch.zeros(C, dtype=torch.float64), "var": torch.ones(C, dtype=torch.float64)}
    y, ns = TL.batch_norm_train(p, s, torch.from_numpy(x), stat_rows=rows)
    y0, ns0 = TL.batch_norm_train(p, s, torch.from_numpy(x))
    assert torch.equal(y, y0) and all(torch.equal(ns[k], ns0[k]) for k in ns)
    with jax.enable_x64(True):
        jy, js = JL.batch_norm({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               {k: jnp.asarray(v.numpy()) for k, v in s.items()},
                               jnp.asarray(x), True, rows)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ns["var"].numpy(), np.asarray(js["var"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_lstm_loss_with_stat_rows_matches_jax(fuse):
    extra = (("model.bn_stat_rows", 2), ("model.fuse_bn_stats", fuse))
    cfg, params, state, images, caps, jl, jg, js = jax_loss_and_grads("float64", extra)
    assert (cfg.model.bn_stat_rows, cfg.model.fuse_bn_stats) == (2, fuse)
    loss, g, new_state = port_loss_and_grads(cfg, params, state, images, caps, torch.float64)
    g, new_state = flat(g), flat(new_state)
    assert g.keys() == jg.keys() and new_state.keys() == js.keys()
    gmax = max(np.abs(v).max() for v in jg.values())
    np.testing.assert_allclose(loss, jl, rtol=1e-9)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-6, atol=1e-7 * gmax, err_msg=k)
    for k in js:
        np.testing.assert_allclose(new_state[k], js[k], rtol=0, atol=1e-10, err_msg=k)
    exact, _g, _s = port_loss_and_grads(tiny_cfg("float64", fuse), params, state, images, caps,
                                        torch.float64)
    assert abs(loss - exact) > 1e-6 * abs(exact)

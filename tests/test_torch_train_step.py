"""One train step, the learning-rate schedules and label smoothing of the
port against the JAX package, on the CPU.

The tiny captioner and batch of ``test_torch_train`` (numpy weights and
inputs from a seed), in float64 (JAX under x64), so that the comparison is not
floored by float32 BN noise:

- one ``train_step`` of ``build_steps`` with a by-value gradient clip, a
  params-EMA and ``grad_accum_steps=2`` all on (one JAX compile of the whole
  step): loss to rtol 1e-9, the new BN state to 1e-10, Adam's moments
  (the clipped, accumulated gradient and its square) to rtol 1e-6 + atol
  1e-5 x their largest magnitude (the clip brings that down to 0.05, while
  the float64 gradients keep up to 5e-8 x their unclipped max|g| of the
  float32 softmax's noise, about 3e-7 here), and every parameter's update
  (and the EMA's) to 1e-4 x lr. Adam's first update is lr x g / (|g| + eps), close to lr x
  sign(g), so where |g| is within the attention softmax's float32 noise
  (~5e-8 x max|g|) the sign is arbitrary: the 1e-4 x lr limit holds where
  |g| > 1e-5 x max|g| (g read from the JAX optimizer's first moment), and
  Adam's bound of lr elsewhere. The JAX schedule returns lr in float32,
  1e-3 rounded by 5e-8 relative. The JAX accumulation scan keeps float32
  accumulators, which its float64 carry rejects: the test swaps in float64
  zeros for the JAX side with ``monkeypatch``, as the float64 LSTM state
  (the JAX code is not changed).
- the five learning-rate schedules at steps on both sides of every epoch
  boundary they have: rtol 1e-6 (the JAX schedules compute in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr
from test_torch_train import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    f64_zero_state, flat, jax_tree, one_torch_thread, tiny_batch, tiny_cfg,
)

LR = 1e-3
STEP_OPTIONS = {"train.learning_rate": LR, "train.gradient_clip": 0.05,
                "train.ema_decay": 0.9, "train.grad_accum_steps": 2}


class _Float64Zeros:
    """``jnp`` with ``zeros(shape, float32)`` made float64."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def zeros(shape, dtype=None):
        return jnp.zeros(shape, jnp.float64 if dtype == jnp.float32 else dtype)


def _adam_state(opt_state):
    """The (mu, nu) trees of an optax state (chains searched)."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _as_tree(like, leaves):
    """A list in ``tree_leaves`` order -> the nested dicts and lists of
    ``like``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return next(it)

    return rebuild(like)


def test_train_step_matches_jax(monkeypatch):
    cfg = tiny_cfg("float64", False, **STEP_OPTIONS)
    f64_zero_state(monkeypatch)
    monkeypatch.setattr(jts, "jnp", _Float64Zeros())
    with jax.enable_x64(True):
        params, state = jax_tree(cfg, np.float64)
        images, caps = tiny_batch(np.float64)
        schedule = jlr.from_config(cfg)
        tx = jts.make_optimizer(cfg, schedule)
        steps = jts.build_steps(jcap.ModelOptions.from_config(cfg), tx, schedule,
                                donate=False, grad_accum_steps=cfg.train.grad_accum_steps)
        jp, jo, js, jstep, jloss, jlr_ = steps.train_step(
            params, tx.init(params), state, jnp.asarray(0), images, caps)
        jema = jts.ema_params_from_opt_state(jo)
        jmu, jnu = (flat(t) for t in _adam_state(jo))
        jp, js = flat(jp), flat(js)
        jema = None if jema is None else flat(jema)
        jstep, jloss, jlr_ = int(jstep), float(jloss), float(jlr_)

    schedule = tlr.from_config(cfg)
    optimizer = tts.make_optimizer(cfg, schedule)
    tp, ts = train_tree(params, state, device="cpu", dtype=torch.float64)
    tsteps = tts.build_steps(tcap.ModelOptions.from_config(cfg), optimizer, schedule,
                             cfg.train.grad_accum_steps)
    tp, to, tstate, tstep, tloss, tlr_ = tsteps.train_step(
        tp, optimizer.init(tp), ts, 0, torch.as_tensor(images), torch.as_tensor(caps))
    p_new, s_new = (flat(t) for t in reference_tree(tp, tstate))
    assert (tstep, tlr_) == (jstep, pytest.approx(jlr_, rel=1e-7))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-9)
    for k in js:
        np.testing.assert_allclose(s_new[k], js[k], rtol=0, atol=1e-10, err_msg=k)

    # Adam's moments: (1 - b1) x the clipped gradient, (1 - b2) x its square
    for got, want in zip(to.adam[1:], (jmu, jnu)):
        got = flat(reference_tree(_as_tree(tp, got), {})[0])
        scale = max(np.abs(v).max() for v in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5 * scale, err_msg=k)

    gmax = max(np.abs(v).max() for v in jmu.values())
    trees = [(p_new, jp, 1.0)]
    ema = tts.ema_params_from_opt_state(to)
    assert ema is not None and jema is not None
    # ema = p + (1 - d) u after one step from ema = p
    trees.append((flat(reference_tree(ema, {})[0]), jema, 1.0 - cfg.train.ema_decay))
    for got_tree, want_tree, share in trees:
        assert got_tree.keys() == want_tree.keys()
        for k in want_tree:
            clear = np.abs(jmu[k]) > 1e-5 * gmax
            err = np.abs(got_tree[k] - want_tree[k])
            assert (err[clear] <= 1e-4 * LR * share).all(), (k, err[clear].max())
            assert (err <= 2 * LR * share).all(), k


def test_lr_schedules_match_jax():
    steps = [0, 1, 98, 99, 100, 101, 150, 199, 200, 298, 299, 300, 301, 450, 599, 600,
             700, 999, 1000, 1499, 3000]
    kw = dict(base_lr=2e-3, sample_cnt=1000, batch_size=10, decay_epoch=2, warmup_epoch=3,
              max_epoch=10)
    for strategy in (None, "cosine_decay", "cosine_decay_restart",
                     "cosine_decay_restart_warmup", "cosine_decay_warmup"):
        tf, jf = tlr.get_lr(strategy, **kw), jlr.get_lr(strategy, **kw)
        got = [tf(s) for s in steps]
        want = [float(jf(jnp.asarray(s))) for s in steps]
        assert all(isinstance(v, float) for v in got)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=str(strategy))
    with pytest.raises(ValueError):
        tlr.get_lr("linear", **kw)


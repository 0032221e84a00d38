"""The training loss's other modes against the JAX package, on the CPU, in
float64 on the tiny captioner of ``test_torch_train``: ``label_smoothing``
with ``parity_mode`` (the reference's degenerate attention, whose score
weights get no gradient), and a frozen encoder (``encoder_trainable=False``:
no encoder gradient, but the moving statistics still update). Loss to rtol
1e-9, every gradient leaf to rtol 1e-6 + atol 1e-7 x max|grad| and the new
BN state to 1e-10, as that file's float64 case.
"""

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from test_torch_train import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    flat, jax_loss_and_grads, one_torch_thread, port_loss_and_grads,
)

MODES = {
    "label_smoothing_parity_mode": (("train.label_smoothing", 0.1), ("model.parity_mode", True)),
    "frozen_encoder": (("model.encoder.encoder_trainable", False),),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_and_grads_match_jax(mode):
    cfg, params, state, images, caps, jl, jg, js = jax_loss_and_grads("float64", MODES[mode])
    opts = tcap.ModelOptions.from_config(cfg)
    want = dict(MODES[mode])
    assert (opts.label_smoothing, opts.parity_mode, opts.encoder_trainable) == (
        want.get("train.label_smoothing", 0.0), want.get("model.parity_mode", False),
        want.get("model.encoder.encoder_trainable", True))
    loss, g, new_state = port_loss_and_grads(cfg, params, state, images, caps, torch.float64)
    g, new_state = flat(g), flat(new_state)
    gmax = max(np.abs(v).max() for v in jg.values())
    np.testing.assert_allclose(loss, jl, rtol=1e-9)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-6, atol=1e-7 * gmax, err_msg=k)
    for k in js:
        np.testing.assert_allclose(new_state[k], js[k], rtol=0, atol=1e-10, err_msg=k)
    if not opts.encoder_trainable:
        assert all(not g[k].any() for k in g if k.startswith("encoder/"))
    if opts.parity_mode:
        assert all(not g[k].any() for k in g if k.startswith("decoder/attention/score"))

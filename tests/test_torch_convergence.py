"""Learning dynamics of the port against the JAX package's
(``tests/test_convergence.py``): the decoder memorizes a tiny caption set.

``test_convergence.py``'s dims (vocab 12, embedding 8, hidden 32), inputs,
captions and recipe (Adam 5e-3, 300 full-batch steps, float32) on both
sides, the port starting from the JAX package's ``decoder.init(PRNGKey(0))``
carried across (``tree_to_torch``): the port's teacher-forced CE
(``decoder.teacher_forcing_logits``) and Adam (``train_step.Optimizer``,
optax's ``adam``) against JAX's. Held:

- the port converges (loss < 0.05), its greedy decode reproduces both
  captions and its beam search (beam 3) agrees, as the original holds JAX;
- its ids equal the JAX run's, greedy and beam;
- its loss curve is JAX's within ``CURVE_RTOL`` at every step, and its
  first loss (the same params) within float32 rounding. The two float32
  runs sum in other orders, and Adam, whose steps are close to lr x
  sign(g), carries the rounding on: the curves differ by at most 4.0e-4 of
  the loss (1.3e-5 absolute, at step 22) here, 5x inside the limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myimagecaptioningmodel_tpu.inference import beam as jbeam
from myimagecaptioningmodel_tpu.models import decoder as jdec
from myimagecaptioningmodel_tpu.models.decoder import DecoderDims
from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.inference import beam as tbeam
from myimagecaptioningmodel_tpu_torch.models import decoder as tdec
from myimagecaptioningmodel_tpu_torch.parallel.train_step import Optimizer, tree_leaves

STEPS, LR = 300, 5e-3
CAPS = [[2, 4, 5, 6, 3, 0], [2, 7, 8, 9, 3, 0]]  # <start> a b c <stop>, padded to 6
CURVE_RTOL = 2e-3
T32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs():
    """``test_convergence.py``'s two fixed feature maps and global features."""
    rng = np.random.RandomState(0)
    return rng.randn(2, 4, 32).astype(np.float32), rng.randn(2, 32).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """The original's run -> (initial params as numpy, losses, greedy ids,
    beam ids)."""
    F32 = jnp.float32
    params = jdec.init(jax.random.PRNGKey(0), DecoderDims(
        vocab_size=12, embedding_size=8, hidden_dim=32, feat_channels=16))
    start = jax.tree_util.tree_map(np.asarray, params)
    img, gf = (jnp.asarray(x) for x in inputs())
    caps = jnp.asarray(CAPS, jnp.int32)
    source, target = caps[:, :-1], caps[:, 1:]
    mask = (target != 0).astype(F32)
    tx = optax.adam(LR)

    @jax.jit
    def train_step(params, opt_state):
        def loss_fn(p):
            pre = jdec.precompute(p, img, gf, F32)
            logits = jdec.teacher_forcing_logits(p, pre, source, compute_dtype=F32)
            logz = jax.nn.logsumexp(logits, -1)
            gold = jnp.take_along_axis(logits, target[..., None], -1)[..., 0]
            return jnp.sum((logz - gold) * mask) / jnp.sum(mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state, losses = tx.init(params), []
    for _ in range(STEPS):
        params, opt_state, loss = train_step(params, opt_state)
        losses.append(float(loss))
    pre = jdec.precompute(params, img, gf, F32)
    greedy = np.asarray(jdec.greedy_decode_ids(params, pre, 5, compute_dtype=F32))
    beam, _ = jbeam.beam_search_ids(params, pre, 5, beam_size=3, compute_dtype=F32)
    return start, np.array(losses), greedy, np.asarray(beam)


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The same recipe on the port from the JAX init -> (losses, greedy ids,
    beam ids)."""
    params = tree_to_torch(jax_run[0], dtype=T32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    img, gf = (torch.from_numpy(x) for x in inputs())
    caps = torch.tensor(CAPS)
    source, target = caps[:, :-1], caps[:, 1:]
    mask = (target != 0).to(T32)
    opt = Optimizer(lambda _count: LR)
    state, losses = opt.init(params), []
    for _ in range(STEPS):
        pre = tdec.precompute(params, img, gf, T32)
        logits = tdec.teacher_forcing_logits(params, pre, source, compute_dtype=T32)
        gold = logits.gather(-1, target[..., None])[..., 0]
        loss = ((torch.logsumexp(logits, -1) - gold) * mask).sum() / mask.sum()
        state = opt.apply(torch.autograd.grad(loss, leaves), state, params)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        pre = tdec.precompute(params, img, gf, T32)
        greedy = tdec.greedy_decode_ids(params, pre, 5, compute_dtype=T32).numpy()
        beam, _ = tbeam.beam_search_ids(params, pre, 5, beam_size=3, compute_dtype=T32)
    return np.array(losses), greedy, beam.numpy()


def test_decoder_overfits_tiny_captions(port_run):
    losses, greedy, beam = port_run
    assert losses[-1] < 0.05, f"did not converge: {losses[-1]} (start {losses[0]})"
    np.testing.assert_array_equal(greedy[0][:4], [4, 5, 6, 3])
    np.testing.assert_array_equal(greedy[1][:4], [7, 8, 9, 3])
    np.testing.assert_array_equal(beam[:, :4], greedy[:, :4])


def test_loss_curve_and_ids_match_jax(jax_run, port_run):
    _start, j_losses, j_greedy, j_beam = jax_run
    losses, greedy, beam = port_run
    assert abs(losses[0] - j_losses[0]) <= 2.0 ** -22 * j_losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=CURVE_RTOL, atol=0)
    np.testing.assert_array_equal(greedy, j_greedy)
    np.testing.assert_array_equal(beam, j_beam)

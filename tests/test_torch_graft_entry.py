"""The port's graft entry points (``myimagecaptioningmodel_tpu_torch/
graft_entry.py``) against the JAX package's ``__graft_entry__.py``, on the
CPU; the counterpart of ``tests/test_graft_entry.py``. Readings on a CPU.

- ``entry(device="cpu")``: its images and captions equal JAX ``entry()``'s
  element for element. With JAX's entry params carried across
  (``compat/from_jax.train_tree``) its bfloat16 loss is within
  ``ENTRY_RTOL`` of JAX's (read 1.8e-4; the port in float32 against JAX
  in bf16, 4.9e-5; all-zero logits, ln(12295) = 9.4170, miss JAX's
  9.4389 by 2.3e-3). At random init the logits are nearly flat, so the
  loss carries little of the model; its gradient carries the rest. The
  gradient over every leaf but the encoder's (the decoder, ``img_embed``,
  ``img_global``; both packages differentiate those leaves alone, which
  spares the encoder's backward), concatenated, is within ``GRAD_RTOL`` of
  JAX's ``jax.grad`` (read 0.132; the port in float32 against JAX in bf16,
  0.124: bf16's own noise), and with each caption beside another image
  (the batch's images rolled by one) it must miss (read 0.305). The
  encoder's gradient is bf16 rounding noise at init (1.2 relative for
  either package against the port's float32) and is left out here; the
  float32 and float64 tests hold it.
- The dry run's rank body in one process (8 rows, no process group) from
  JAX's initial trees of both families (``captioner.init`` at
  ``PRNGKey(0)`` and ``PRNGKey(1)``) against JAX's single-device
  ``build_steps(...).train_step`` on the same batch, float32 (LSTM and
  transformer readings): the loss within ``DRY_RTOL`` (3.2e-6, 5.4e-6);
  the greedy ids after the step equal to JAX's ``decode_step``'s; Adam's
  first moment after the step, (1 - b1) x the gradient, the worst
  decoder-side leaf within ``MU_RTOL`` (1.25e-3, 1.5e-3) and the whole
  tree within ``MU_TREE_RTOL`` (6.8e-2, 2.3e-2: the encoder's BN at 32
  px normalizes over as few as 8 values, and float32 rounding there moves
  its gradient by a few percent); a leaf whose gradient is zero in exact
  arithmetic (the attention score's bias) within ``ZERO_LEAF`` of the
  largest leaf (1.9e-11); and the loss's change in the step, a second
  step's loss less the first's, within ``CHANGE_RTOL`` (1.4e-2, 2.1e-3 of
  a change of -0.030 and -0.194): the update's effect. Adam's update
  itself is lr x the gradient's sign wherever the gradient is clear of
  eps, so its elements flip with any rounding where the gradient is
  near zero; the loss's change weighs them by their gradient.
- ``dryrun_multichip(4, device="cpu")``: four gloo ranks on a (data 2,
  model 2) grid print JAX's ok line; every rank holds the same losses,
  and each rank's step is held to the rank body's world-1 run from the
  same trees by the same limits (loss 3.4e-7; moment 2.6e-4 / 2.7e-4 a
  leaf, 2.2e-4 / 1.5e-4 the tree; change 2.3e-3 / 1.4e-3); each data
  index's ids are that run's rows.

Planted faults (each in a copy of the port): Adam without its bias
correction misses JAX's loss change by 0.54 / 0.27; ranks that keep their
gradients local (no all-reduce) miss the world-1 run by 1.3 / 1.0 a leaf,
0.97 / 0.94 the tree and 0.18 / 0.16 in the change.

- Without a card, ``entry()`` and ``dryrun_multichip()`` raise and name
  ``device="cpu"``; the command line reaches both.

The first three are one test. Its JAX side (~50 s alone on a CPU: JAX's
eager init at real dims, whose per-shape programs the dry run's inits then
reuse, and two train-step compiles) would be paid again by every xdist
worker that ran a share of it, and more than that in processes of their
own (each family's then takes ~55 s cold); the four ranks run in their own
processes, and the port's entry steps and JAX's dry-run steps in threads,
beside JAX's entry gradient.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.models.decoder import DecoderDims as JDims
from myimagecaptioningmodel_tpu.models.transformer import TransformerDims as JTDims
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch import graft_entry as tentry
from myimagecaptioningmodel_tpu_torch.compat.from_jax import to_numpy, train_tree
from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves, tree_unflatten

ENTRY_RTOL = 5e-4
GRAD_RTOL = 0.2
DRY_RTOL = 1e-5
MU_RTOL = 5e-3
MU_TREE_RTOL = 0.15
CHANGE_RTOL = 5e-2
ZERO_LEAF = 1e-8
ZERO_GRAD_LEAVES = ("decoder/attention/score/b",)
DRY_N = 4
FAMILIES = ("lstm", "transformer")
OK_LINE = re.compile(r"^dryrun_multichip\(4\): ok, loss=(\d+\.\d{4}) "
                     r"\(transformer loss=(\d+\.\d{4})\)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=""):
    """Nested dicts and lists -> {"a/0/b": float64 numpy}."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def adam_mu(opt_state):
    """The first-moment tree of an optax state (chains searched)."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = adam_mu(s)
            if found is not None:
                return found
    return None


def tree_err(got, want):
    """|got - want| / |want| over every leaf, concatenated (flat trees)."""
    assert got.keys() == want.keys()
    g = np.concatenate([got[k].ravel() for k in want])
    w = np.concatenate([want[k].ravel() for k in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def beside_encoder(params):
    """The params but the encoder's (the decoder, ``img_embed``,
    ``img_global``)."""
    return {k: v for k, v in params.items() if k != "encoder"}


def moment_errs(got, want):
    """Adam's first moments (flat) -> (the worst |got - want| / |want| of a
    decoder-side leaf, that leaf, the same over the whole tree
    concatenated). A leaf whose gradient is zero in exact arithmetic
    (the attention score's bias: a softmax ignores a shift) is held to
    ``ZERO_LEAF`` of the largest leaf's norm instead."""
    assert got.keys() == want.keys()
    scale = max(np.linalg.norm(v) for v in want.values())
    errs = {}
    for k in want:
        d, w = np.linalg.norm(got[k] - want[k]), np.linalg.norm(want[k])
        if k in ZERO_GRAD_LEAVES:
            assert d <= ZERO_LEAF * scale, (k, d, scale)
        elif not k.startswith("encoder/"):
            errs[k] = d / w
    worst = max(errs, key=errs.get)
    return float(errs[worst]), worst, tree_err(got, want)


def jax_options():
    """JAX ``_dryrun_body``'s options of each family."""
    opts = jcap.ModelOptions(
        dims=JDims(vocab_size=64, embedding_size=8, hidden_dim=16, feat_channels=1280),
        sentence_length=6, infer_max_length=6, compute_dtype="float32")
    tdims = JTDims(vocab_size=64, embedding_size=8, model_dim=16, num_layers=2, num_heads=2,
                   mlp_ratio=2, max_positions=6)
    return {"lstm": opts, "transformer": opts._replace(arch="transformer", tdims=tdims)}


def jax_dry_run():
    """JAX's initial trees of both families (numpy; ``captioner.init`` at
    ``PRNGKey(0)`` for the LSTM, ``PRNGKey(1)`` for the transformer) and,
    per family, its single-device step on the dry run's batch: the loss,
    the greedy ids after the step, Adam's first moment and a second
    step's loss."""
    cfg = jconfig.Config()
    schedule = jlr.from_config(cfg)
    tx = jts.make_optimizer(cfg, schedule)
    images, caps = tentry.dryrun_batch(DRY_N)
    trees, want = {}, {}
    for seed, (arch, opts) in enumerate(jax_options().items()):
        params, state = jcap.init(jax.random.PRNGKey(seed), opts)
        trees[arch] = as_numpy((params, state))
        steps = jts.build_steps(opts, tx, schedule, donate=False)
        params, opt_state, state, step, loss, _lr = steps.train_step(
            params, jax.jit(tx.init)(params), state, jnp.zeros((), jnp.int32), images, caps)
        want[arch] = {"loss": float(loss),
                      "ids": np.asarray(steps.decode_step(params, state, images)),
                      "mu": as_numpy(adam_mu(opt_state)),
                      "loss_after": float(steps.train_step(params, opt_state, state, step,
                                                           images, caps)[4])}
    return trees, want


def entry_loss_and_grads(fn, params, state, images, caps):
    """The port's ``entry()`` loss with JAX's (params, state), numpy in
    JAX's layout, carried across, and its gradient but the encoder's
    (flat)."""
    tp, ts = train_tree(params, state, device="cpu")
    rest = beside_encoder(tp)
    leaves = tree_leaves(rest)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = fn(tp, ts, images, caps)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), flat(to_numpy(tree_unflatten(rest, grads)))


def check_step(got, want, arch):
    """One dry-run step against another: the loss, the ids, Adam's first
    moment (``MU_RTOL`` a decoder-side leaf, ``MU_TREE_RTOL`` the whole
    tree) and the loss's change in the step (``CHANGE_RTOL``)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=DRY_RTOL, err_msg=arch)
    np.testing.assert_array_equal(got["ids"], want["ids"], err_msg=arch)
    leaf_err, leaf, tree_err = moment_errs(flat(got["mu"]), flat(want["mu"]))
    change = want["loss_after"] - want["loss"]
    change_err = abs(got["loss_after"] - got["loss"] - change) / abs(change)
    assert leaf_err <= MU_RTOL and tree_err <= MU_TREE_RTOL, (arch, leaf, leaf_err, tree_err)
    assert change_err <= CHANGE_RTOL, (arch, change, change_err)


def test_port_matches_jax_and_four_ranks_match_one(capfd):
    # the four gloo ranks run in processes of their own, and the port's
    # entry steps and JAX's dry-run steps in threads, beside JAX's entry
    # gradient
    with ThreadPoolExecutor(3) as pool:
        four = pool.submit(tentry.dryrun_multichip, DRY_N, "cpu")

        # entry(): the batch element for element, the bf16 loss and its
        # gradient on JAX's params; with each caption beside another
        # image (the rows rolled by one), the gradient must miss
        fn, args = jentry.entry()
        args = as_numpy(args)
        dry = pool.submit(jax_dry_run)
        t_fn, (_tp, _ts, t_images, t_caps) = tentry.entry(device="cpu")
        got = pool.submit(lambda: [
            entry_loss_and_grads(t_fn, args[0], args[1], im, t_caps)
            for im in (t_images, torch.roll(t_images, 1, 0))])
        want, want_grads = jax.jit(jax.value_and_grad(
            lambda rest, enc: fn(dict(rest, encoder=enc), *args[1:])))(
                beside_encoder(args[0]), args[0]["encoder"])
        want, want_grads = float(want), flat(as_numpy(want_grads))
        assert t_images.dtype == torch.float32 and t_caps.dtype == torch.int32
        np.testing.assert_array_equal(t_images.numpy(), args[2])
        np.testing.assert_array_equal(t_caps.numpy(), args[3])
        assert tentry.entry_options().compute_dtype == "bfloat16"

        # the dry run's rank body in one process from JAX's trees
        trees, dry_want = dry.result(timeout=600)
        (loss, grads), (_loss_rolled, grads_rolled) = got.result(timeout=600)
        assert np.isfinite(loss) and loss > 0
        np.testing.assert_allclose(loss, want, rtol=ENTRY_RTOL)
        err, err_rolled = (tree_err(g, want_grads) for g in (grads, grads_rolled))
        assert err <= GRAD_RTOL < err_rolled, (err, err_rolled)
        one_jax = tentry.dryrun_rank(0, DRY_N, "cpu", trees)
        assert one_jax["grid"] == (1, 0, 1, 0)
        for arch in FAMILIES:
            assert dry_want[arch]["ids"].shape == (2 * DRY_N, 6)
            check_step(one_jax[arch], dry_want[arch], arch)
        ranks = four.result(timeout=600)

    # four ranks on a (data 2, model 2) grid against one process, the
    # port's own trees
    one = tentry.dryrun_rank(0, DRY_N, "cpu")
    lines = OK_LINE.findall(capfd.readouterr().out)
    assert len(lines) == 1, lines  # one line, of rank 0's losses
    assert [r["grid"] for r in ranks] == [(2, d, 2, m) for d in range(2) for m in range(2)]
    for i, arch in enumerate(FAMILIES):
        assert len({r[arch]["loss"] for r in ranks}) == 1
        assert lines[0][i] == f"{ranks[0][arch]['loss']:.4f}"
        for r in ranks:  # each data index's rows
            d = r["grid"][1]
            check_step(r[arch], dict(one[arch], ids=one[arch]["ids"][d * DRY_N:(d + 1) * DRY_N]),
                       arch)


def test_dryrun_options_are_jax_s():
    got, want = tentry.dryrun_options(), jax_options()
    for arch in FAMILIES:
        assert tuple(got[arch].dims) == tuple(want[arch].dims)
        assert (got[arch].tdims is None) == (want[arch].tdims is None)
        if got[arch].tdims is not None:
            assert tuple(got[arch].tdims) == tuple(want[arch].tdims)
        for k in ("sentence_length", "infer_max_length", "compute_dtype", "arch", "start_idx",
                  "padding_idx", "encoder_trainable", "fuse_bn_stats", "label_smoothing"):
            assert getattr(got[arch], k) == getattr(want[arch], k), (arch, k)


def test_entry_and_dryrun_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.dryrun_multichip(DRY_N)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.main([])


def test_command_line_reaches_both(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tentry, "dryrun_multichip", lambda n, d: calls.append((n, d)))
    monkeypatch.setattr(tentry, "entry", lambda d: (
        calls.append(d) or (lambda x: torch.tensor(x), (1.25,))))
    tentry.main(["--multichip", "4", "--device", "cpu"])
    tentry.main(["--device", "cpu"])
    assert calls == [(4, "cpu"), "cpu"]
    assert capsys.readouterr().out == "entry: loss=1.2500\n"

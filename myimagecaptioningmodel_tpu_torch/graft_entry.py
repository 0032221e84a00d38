"""The graft entry points of the port: the real-dims loss step and the
multi-rank dry run; the counterpart of the repo root's
``__graft_entry__.py``.

    python -m myimagecaptioningmodel_tpu_torch.graft_entry [--device cpu]
    python -m myimagecaptioningmodel_tpu_torch.graft_entry --multichip 4 [--device cpu]

``entry()`` -> (fn, example_args): the teacher-forcing loss of the
flagship captioner at real dims (B=8, MobileNetV2 x1.0 at 224 px, vocab
12295 padded to 12416, H=1024, 35 steps, bfloat16), the weights drawn
from a seed, the batch drawn exactly as the JAX package draws it.

``dryrun_multichip(n)``: one full train step (forward, backward, the
gradient all-reduce, Adam) and one greedy decode of each decoder family
at tiny dims on n ranks laid out as a (data, model) grid, with a model
axis of 2 (vocab tensor parallelism) when n is even and at least 4, as the
JAX package lays out its mesh. Outside an n-rank process group it starts
n gloo ranks on this host (``distributed.spawn_local``): each rank on its
own card when there are n, sharing the cards when there are fewer, on the
CPU only when the caller asks for it. Rank 0's losses make the JAX
package's line, ``dryrun_multichip(n): ok, loss=... (transformer
loss=...)``.

Both run on the card unless the caller passes ``device="cpu"``, and raise
without one.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.config import Config
from myimagecaptioningmodel_tpu_torch.models import captioner
from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions
from myimagecaptioningmodel_tpu_torch.models.decoder import DecoderDims
from myimagecaptioningmodel_tpu_torch.models.transformer import TransformerDims

ENTRY_BATCH, ENTRY_IMAGE = 8, 224
DRY_VOCAB, DRY_LEN, DRY_IMAGE = 64, 6, 32


def entry_options() -> ModelOptions:
    """The flagship captioner's options: the default config's."""
    return ModelOptions.from_config(Config())


def entry(device=None):
    """-> (fn, example_args): ``fn(params, state, images, captions)`` is the
    scalar teacher-forcing loss (``captioner.loss_fn``) of the flagship
    captioner; the args are its weights from seed 0 (float32 master
    weights, each op in bfloat16) and a batch of images float32 [8, 224,
    224, 3] and captions int32 [8, 35] drawn from one ``RandomState(0)`` in
    the JAX package's order, on ``device`` (the card unless the caller
    names another)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree

    dev = captioner.resolve_device(device)
    opts = entry_options()
    params, state = train_tree(*captioner.init(torch.Generator().manual_seed(0), opts),
                               device=dev)
    rng = np.random.RandomState(0)
    images = rng.rand(ENTRY_BATCH, ENTRY_IMAGE, ENTRY_IMAGE, 3).astype(np.float32)
    caps = rng.randint(1, opts.dims.vocab_size, (ENTRY_BATCH, opts.sentence_length))

    def fn(params, state, images, captions):
        loss, _new_state = captioner.loss_fn(params, state, images, captions, opts)
        return loss

    return fn, (params, state, torch.from_numpy(images).to(dev),
                torch.from_numpy(caps.astype(np.int32)).to(dev))


# ---- the dry run ---------------------------------------------------------------


def dryrun_options() -> Dict[str, ModelOptions]:
    """The dry run's options of each family (the JAX package's dims)."""
    lstm = ModelOptions(
        dims=DecoderDims(vocab_size=DRY_VOCAB, embedding_size=8, hidden_dim=16,
                         feat_channels=1280),
        sentence_length=DRY_LEN, infer_max_length=DRY_LEN, compute_dtype="float32")
    tdims = TransformerDims(vocab_size=DRY_VOCAB, embedding_size=8, model_dim=16,
                            num_layers=2, num_heads=2, mlp_ratio=2, max_positions=DRY_LEN)
    return {"lstm": lstm, "transformer": lstm._replace(arch="transformer", tdims=tdims)}


def dryrun_batch(n_devices: int):
    """The global batch of 2n rows (images [2n, 32, 32, 3] float32, captions
    [2n, 6] int32) from one ``RandomState(0)``, as the JAX package draws it."""
    rng = np.random.RandomState(0)
    images = rng.rand(2 * n_devices, DRY_IMAGE, DRY_IMAGE, 3).astype(np.float32)
    caps = rng.randint(1, DRY_VOCAB, (2 * n_devices, DRY_LEN)).astype(np.int32)
    return images, caps


def dryrun_rank(rank: int, n_devices: int, device=None, trees=None) -> dict:
    """One rank of the dry run (every rank of the group calls it; one process
    outside a group): the (data, model) grid of the process group, this
    rank's rows of ``dryrun_batch(n_devices)``, then per family one train
    step (the loss must be finite), one greedy decode (the ids' shape is
    checked) and a second step, on the CPU when asked for, else on this rank's card
    (``distributed.local_device``: its own with as many cards as ranks).
    ``trees``: each family's initial (params, state) in the JAX layout,
    numpy or tensors (default: the port's init, the LSTM from seed 0, the
    transformer from seed 1). -> {family: {"loss", "ids" (this rank's
    rows), "mu" (Adam's first moment after the step, (1 - b1) x the
    gradient: the full tree, float32 numpy in the JAX layout, gathered over
    the model group), "loss_after" (a second step's loss on the same batch:
    the loss at the updated params)}, "grid": (data size, data index, model
    size, model index)}."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_layout, train_tree
    from myimagecaptioningmodel_tpu_torch.parallel import distributed
    from myimagecaptioningmodel_tpu_torch.parallel import mesh as mesh_mod
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        build_steps, make_optimizer, tree_unflatten,
    )
    from myimagecaptioningmodel_tpu_torch.training import lr_schedules

    dev = captioner.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = distributed.local_device(rank)
    world = distributed.process_count()
    # DP x TP grid: the vocab head sharded over the model axis when possible
    model_parallel = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = mesh_mod.make_mesh(dev, model_parallel=model_parallel)
    cfg = Config()
    schedule = lr_schedules.from_config(cfg)
    optimizer = make_optimizer(cfg, schedule)
    images, caps = mesh_mod.shard_batch(mesh, *dryrun_batch(n_devices))
    options = dryrun_options()
    if trees is None:
        trees = {arch: captioner.init(torch.Generator().manual_seed(seed), opts)
                 for seed, (arch, opts) in enumerate(options.items())}
    out = {"grid": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank)}
    for arch, opts in options.items():
        # use_kernels stays off: kernel B takes H in multiples of 64 and E in
        # multiples of 32, and the JAX package's dry run decodes through XLA
        # at these dims too
        opts = opts._replace(vocab_parallel=model_parallel > 1)
        params, state = train_tree(*trees[arch], device=dev)
        params, opt_state = mesh_mod.shard_state(mesh, params, optimizer.init(params))
        steps = build_steps(opts, optimizer, schedule)
        params, opt_state, state, _step, loss, _lr = steps.train_step(
            params, opt_state, state, 0, images, caps)
        ids = steps.decode_step(params, state, images)
        full, full_opt = mesh_mod.gather_state(mesh, params, opt_state)
        mu = reference_layout(tree_unflatten(full, full_opt.adam.mu))  # copies
        # the loss after the update: a second step's, on the same batch
        loss_after = float(steps.train_step(params, opt_state, state, 1, images, caps)[4])
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"{arch} dry-run loss not finite: {loss}")
        if tuple(ids.shape) != (images.shape[0], opts.infer_max_length):
            raise AssertionError(f"{arch} dry-run ids of shape {tuple(ids.shape)}")
        out[arch] = {"loss": loss, "ids": ids.cpu().numpy(), "mu": mu,
                     "loss_after": loss_after}
    return out


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The dry run on ``n_devices`` ranks (module docstring) -> each rank's
    ``dryrun_rank`` result in rank order (this rank's alone when called
    inside an n-rank process group). A failing rank raises here. Rank 0's
    losses make the JAX package's line, printed by rank 0 in a group and
    by this process after the ranks it started have ended."""
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    captioner.resolve_device(device)  # no card and no device="cpu": raise now
    if distributed.active():
        if distributed.process_count() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a group of "
                             f"{distributed.process_count()} processes")
        ranks = [dryrun_rank(distributed.process_index(), n_devices, device)]
        if not distributed.is_main_process():
            return ranks
    else:
        ranks = distributed.spawn_local(dryrun_rank, n_devices, args=(n_devices, device),
                                        threads=1)
    print(f"dryrun_multichip({n_devices}): ok, loss={ranks[0]['lstm']['loss']:.4f} "
          f"(transformer loss={ranks[0]['transformer']['loss']:.4f})", flush=True)
    return ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The port's graft entry points.")
    ap.add_argument("--multichip", type=int, default=None, metavar="N",
                    help="run the dry run on N ranks instead of the real-dims loss")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    if args.multichip:
        dryrun_multichip(args.multichip, args.device)
        return
    fn, example = entry(args.device)
    print(f"entry: loss={float(fn(*example)):.4f}")


if __name__ == "__main__":
    main()

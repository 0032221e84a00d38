"""Training loop (reference train.py:26-181, SURVEY §3.1); the counterpart
of ``myimagecaptioningmodel_tpu/training/loop.py`` on one device.

Epoch loop with the reference's observable behavior:
- per-step NaN-loss guard (train.py:140-141) — checked with a one-step delay
  so the host does not wait on the step it has just queued;
- per-``log_every_n_step`` mean/step loss + LR logging (train.py:145-148);
- per-epoch dev-set greedy decode + BLEU + distinct-sentence count
  (train.py:152-169), through the decoder family's kernels on a card (B with
  head A for the LSTM, D for the transformer; ``opts.use_kernels`` follows
  the device);
- checkpoint / optional backup / params export / inference-bundle export /
  best-BLEU copies (train.py:68-91);
- crash-resume carried in the checkpoint itself (``meta.next_epoch``,
  ``step``, ``mid_epoch_batches``), mid-epoch to the exact batch when
  ``train.checkpoint_every_n_steps`` is set;
- the "encoder just unfroze -> reload its pretrained weights" transition
  (train.py:103-107).

Data parallelism, as the JAX loop's multi-host mode: inside a process group
(``parallel/distributed.initialize`` on every process before ``train``),
``cfg.train.batch_size`` stays the GLOBAL batch and must divide by the
process count; each process reads only its rows of every global batch (the
reader's ``process_shard``) onto its own device (``cuda:LOCAL_RANK`` unless
``device`` names another), the train step all-reduces its gradients and the
BN its statistics (global-batch BN, kernel F's sums too), and the per-step
losses are the single-process run's. Process 0 alone writes the log,
checkpoints and exports; every process resumes from the same checkpoint
(a shared filesystem) and starts from process 0's values (``put_tree``).
The dev evaluation decodes each process's rows and reduces the BLEU sum
and the distinct count.

Vocab tensor parallelism (``cfg.train.model_parallel`` > 1, as the JAX
loop's mesh): the processes form a (data, model) grid (``mesh.make_mesh``;
the count must divide, and the padded vocab must divide by it); each data
index reads its rows, the ranks of a model group share them and each keeps
its rows of the table, the output bias and their moments and EMA
(``mesh.shard_state``). Checkpoints and exports gather those rows back
(``mesh.gather_state``, every rank taking part) before process 0 writes, so
they have the format of a ``model_parallel=1`` run, and a run resumes from
either. The dev decode runs the vocab-parallel head (kernel A on each
rank's slice on a card).

What differs from the JAX loop: the parameters
come from ``captioner.init`` on ``torch.Generator().manual_seed(seed)``, so
a run does not start from the JAX package's ``PRNGKey(seed)`` weights (a
converted checkpoint carries a JAX run across,
``checkpoint.convert_jax_checkpoint``). As there, the final partial train
batch of an epoch is dropped.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.data.feeder import PrefetchingFeeder
from myimagecaptioningmodel_tpu_torch.data import reader as reader_mod
from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
from myimagecaptioningmodel_tpu_torch.evaluation import metrics
from myimagecaptioningmodel_tpu_torch.models import captioner
from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions, resolve_device
from myimagecaptioningmodel_tpu_torch.parallel import distributed
from myimagecaptioningmodel_tpu_torch.parallel import mesh as mesh_mod
from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
    build_steps, ema_params_from_opt_state, make_optimizer, tree_leaves,
)
from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt
from myimagecaptioningmodel_tpu_torch.training import lr_schedules
from myimagecaptioningmodel_tpu_torch.training.logger import Logger
from myimagecaptioningmodel_tpu_torch.utils.profiling import StepTimer


@torch.no_grad()
def _all_finite(tree) -> bool:
    """Every float leaf finite: one ``_foreach_norm`` (max |x|, which NaN
    and Inf reach) over the leaves and one read back."""
    leaves = [p for p in tree_leaves(tree) if p.is_floating_point()]
    if not leaves:
        return True
    return bool(torch.isfinite(torch.stack(torch._foreach_norm(leaves, float("inf")))).all())


def _dev_eval(decode_fn, params, model_state, reader_gen, index_word, batch_size,
              stop_idx, padding_idx):
    """Per-epoch dev greedy decode + BLEU + distinct sentences (reference
    train.py:152-167) -> (BLEU, distinct sentences, captions decoded), one
    decode shape for every batch and the host scoring batch i while the
    card decodes batch i+1 (``reader.decode_and_score``).

    Inside a process group, as the JAX loop's ``multihost``: every process
    streams the same global dev batches, decodes its own rows, scores them
    (``calc_bleu_rows`` is a sum over rows), and the BLEU sums and the
    distinct sentences are reduced across the processes: the
    single-process numbers on every rank."""
    bleu_total, captions = 0.0, 0
    sentences = set()
    shard = ((distributed.data_index(), distributed.data_size())
             if distributed.active() else None)

    def score(ids, refs, n):
        nonlocal bleu_total, captions
        captions += len(ids)
        row_sum, _rows = metrics.calc_bleu_rows(
            ids, refs, index_word, stop_idx=stop_idx, padding_idx=padding_idx)
        bleu_total += row_sum / n
        for row in ids.tolist():
            sentences.add(metrics.words2sentence(
                metrics.filter_ids(row, index_word, stop_idx, padding_idx)))

    batches = reader_mod.decode_and_score(
        reader_gen, batch_size, lambda imgs: decode_fn(params, model_state, imgs), score,
        shard=shard)
    distinct = len(sentences)
    if shard is not None:  # over the data group: a model group shares its rows
        group = distributed.data_group()
        bleu_total = float(distributed.sum_across_processes([bleu_total], group)[0])
        captions = int(distributed.sum_across_processes([captions], group)[0])
        distinct = distributed.global_distinct_count(sentences, group)
    if batches == 0:
        return 0.0, 0, 0
    return bleu_total / batches, distinct, captions


def save_model(cfg, logger: Logger, params, opt_state, model_state, epoch: int, step: int,
               eval_bleu: Optional[float] = None) -> None:
    """Checkpoint/export policy, reference train.py:68-91."""
    p = cfg.train.checkpoint_path
    meta = {
        "next_epoch": epoch + 1,
        "step": int(step),
        "best_bleu": logger.best_bleu,
        "best_meteor": logger.best_meteor,
        "train_encoder": logger.train_encoder,
    }
    arrays = ckpt.checkpoint_arrays(params, opt_state, model_state)
    ckpt.write_checkpoint(os.path.join(p, "checkpoint"), arrays, meta)
    n = cfg.train.checkpoint_backup_every_n_epoch
    if n and epoch % n == 0:
        ckpt.write_checkpoint(os.path.join(p, f"checkpoint{epoch}"), arrays, meta)
    if cfg.train.export_params:
        ckpt.save_params(os.path.join(p, "params", ckpt.PARAMS_FILE), params)
    p_np, s_np = reference_tree(params, model_state)
    if cfg.train.export_infer_model:
        ckpt.export_inference_bundle(os.path.join(p, "infer"), p_np, s_np, cfg,
                                     cfg.data.dict_path)
        # EMA weights (train.ema_decay > 0): a second serving bundle with the
        # averaged params — evaluate/infer pick it via bundle="infer_ema"
        ema = ema_params_from_opt_state(opt_state)
        if ema is not None:
            ckpt.export_inference_bundle(os.path.join(p, "infer_ema"),
                                         reference_tree(ema, model_state)[0], s_np, cfg,
                                         cfg.data.dict_path)
    if cfg.train.save_best_bleu_checkpoint and eval_bleu is not None:
        if eval_bleu > logger.best_bleu:
            logger.best_bleu = eval_bleu
            meta["best_bleu"] = eval_bleu
            ckpt.write_checkpoint(os.path.join(p, "checkpoint_best_bleu"), arrays, meta)
            if cfg.train.export_infer_model:
                ckpt.export_inference_bundle(os.path.join(p, "infer_bleu"), p_np, s_np, cfg,
                                             cfg.data.dict_path)


def train(cfg=None, device=None, max_steps_per_epoch: Optional[int] = None,
          fault_injection_step: Optional[int] = None) -> dict:
    """Run training to ``max_epoch`` on ``device`` (CUDA unless the caller
    passes another; ``resolve_device``); returns a summary dict.

    ``fault_injection_step`` (testing; the reference has no fault
    injection) raises RuntimeError after that many global steps, to check
    that a mid-epoch crash and resume reproduces an uninterrupted run.

    Inside a process group the run is data-parallel, and with
    ``train.model_parallel`` > 1 also vocab-parallel (module docstring).

    Besides ``log.txt``, the logger's ``log.jsonl`` records per epoch
    ``epoch_loss``, ``step_times`` (host ms per queued step),
    ``train_wall`` (the epoch's training seconds up to its last loss read,
    images, and the seconds the loop waited on the feeder's queue),
    ``dev_bleu`` (with the evaluation's seconds and captions) and
    ``checkpoint_save`` (for the epoch's last rolling save, the seconds
    ``save()`` held the loop and the seconds the write took in its
    thread)."""
    from myimagecaptioningmodel_tpu_torch import config as config_mod

    cfg = cfg or config_mod.default
    # the (data, model) grid of the process group (one process outside one)
    mesh = mesh_mod.make_mesh(resolve_device(distributed.default_device(device)),
                              max(1, int(cfg.train.model_parallel)))
    device, n_proc, proc_idx = mesh.device, mesh.size, mesh.rank
    opts = ModelOptions.from_config(cfg)
    if mesh.model_size > 1:  # vocab tensor parallelism
        padded = (opts.tdims if opts.arch == "transformer" else opts.dims).padded_vocab
        mesh_mod.vocab_rows(mesh, padded)  # the padded vocab divides, or ValueError
        opts = opts._replace(vocab_parallel=True)
    dp = distributed.active()
    is_main = distributed.is_main_process()
    batch_size = cfg.train.batch_size
    if batch_size % n_proc:
        raise ValueError(f"global batch {batch_size} must divide evenly over {n_proc} "
                         "processes")
    local_batch = batch_size // n_proc
    accum = int(getattr(cfg.train, "grad_accum_steps", 1) or 1)
    if accum > 1 and local_batch % accum:
        raise ValueError(f"batch_size {batch_size} ({local_batch} a process) not divisible "
                         f"by grad_accum_steps {accum}")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # this process's streams and graphs on its GPU
    logger = Logger(cfg.log.log_path, opts.encoder_trainable, write=is_main)
    data_reader = DataReader(cfg)
    data_reader.init_shards()
    if not data_reader.shards.storage_info.get("normalized", True):
        # raw uint8 shards: the mean/std recorded at build time define what
        # the pixels mean. Pin them into the model options (the device-side
        # conversion, prepare_images) and into the cfg that save_model
        # exports, so every bundle consumer normalizes as training did.
        shard_norm = data_reader.storage_norm
        if opts.image_norm is not None and not (
            np.allclose(shard_norm[0], opts.image_norm[0])
            and np.allclose(shard_norm[1], opts.image_norm[1])
        ):
            logger.log("WARNING: config image_mean/std differ from the dataset's "
                       f"recorded normalization; using the shard attrs {shard_norm}")
        opts = opts._replace(image_norm=shard_norm)
        cfg = config_mod.replace_nested(cfg, "data.image_mean",
                                        tuple(float(v) for v in shard_norm[0]))
        cfg = config_mod.replace_nested(cfg, "data.image_std",
                                        tuple(float(v) for v in shard_norm[1]))

    # on the card the dev decode runs the decoder family's kernels
    opts = opts._replace(use_kernels=device.type == "cuda")
    schedule = lr_schedules.from_config(cfg)
    optimizer = make_optimizer(cfg, schedule)
    steps = build_steps(opts, optimizer, schedule, grad_accum_steps=accum)

    seed = cfg.train.seed
    ref_params, ref_state = captioner.init(torch.Generator().manual_seed(seed or 0), opts)
    dtype = torch.float64 if opts.compute_dtype == "float64" else torch.float32
    params, model_state = train_tree(ref_params, ref_state, device, dtype)
    del ref_params, ref_state
    opt_state = optimizer.init(params)
    step = 0
    start_epoch = 1

    resume_skip_batches = 0  # mid-epoch resume fast-forward
    ckpt_dir = os.path.join(cfg.train.checkpoint_path, "checkpoint")
    if dp:
        # crash-debris recovery (checkpoint._recover) changes shared storage:
        # process 0 alone runs it, and the others look once it is done
        if is_main:
            ckpt.checkpoint_exists(ckpt_dir)
        distributed.barrier()
    if ckpt.checkpoint_exists(ckpt_dir):
        params, opt_state, model_state, meta = ckpt.load_checkpoint(
            ckpt_dir, params, opt_state, model_state)
        step = int(meta["step"])
        start_epoch = meta["next_epoch"]
        resume_skip_batches = meta.get("mid_epoch_batches", 0)
        logger.log(
            f"Resumed from {ckpt_dir} at epoch {start_epoch}, step {step}"
            + (f" (mid-epoch, skipping {resume_skip_batches} batches)"
               if resume_skip_batches else ""))
        # encoder freeze flipped since last run? reload pretrained encoder
        # (reference train.py:103-107)
        if logger.train_encoder != opts.encoder_trainable:
            logger.train_encoder = opts.encoder_trainable
            if opts.encoder_trainable and cfg.data.pretrained_mobilenet_path:
                params = ckpt.graft_subtree(params, cfg.data.pretrained_mobilenet_path,
                                            "encoder")
                logger.log("Encoder unfroze: reloaded pretrained encoder weights")
    elif cfg.data.pretrained_mobilenet_path:
        params = ckpt.graft_subtree(params, cfg.data.pretrained_mobilenet_path, "encoder")
        logger.log("Loaded pretrained MobileNetV2 encoder")
    if dp:  # every process starts from process 0's values
        distributed.put_tree((params, opt_state, model_state))
    # vocab TP: each rank keeps its rows of the vocab-sized leaves; saves
    # gather them back (mesh.gather_state, every rank taking part)
    params, opt_state = mesh_mod.shard_state(mesh, params, opt_state)

    ckpt_writer = ckpt.AsyncCheckpointWriter()  # rolling saves off the hot loop
    last_bleu = 0.0
    mean_loss = float("nan")  # stays NaN when resume finds nothing to run

    for epoch in range(start_epoch, cfg.train.max_epoch + 1):
        logger.epoch = epoch
        begin = time.time()
        logger.log(f"Epoch {epoch}")
        epoch_loss = 0.0
        prev_loss = None  # one-step-delayed NaN check
        timer = StepTimer("train_step")

        skip = resume_skip_batches if epoch == start_epoch else 0
        nsteps = skip  # resumed epochs continue the in-epoch step count
        executed = 0  # steps actually run (mean-loss denominator)
        shuffle_seed = ((cfg.train.seed or 0) * 100003 + epoch
                        if cfg.train.shuffle_each_epoch else None)
        feeder = PrefetchingFeeder(
            data_reader.get_reader(local_batch, "train", keep_float16=True,
                                   shuffle_seed=shuffle_seed,
                                   skip_samples=skip * batch_size,  # global samples
                                   reader_threads=cfg.train.reader_threads,
                                   process_shard=(proc_idx, n_proc) if dp else None,
                                   micro_batches=accum if dp else 1),
            capacity=cfg.train.data_loader_capacity,
            drop_remainder=True,
            device=device,
            image_norm=data_reader.storage_norm,
            device_convert=cfg.train.device_convert,
        )
        every_n = cfg.train.checkpoint_every_n_steps
        t_train = time.perf_counter()
        try:
            for imgs, caps in feeder:
                with timer:
                    params, opt_state, model_state, step, loss, lr = steps.train_step(
                        params, opt_state, model_state, step, imgs, caps)
                if prev_loss is not None:
                    lval = float(prev_loss)
                    if np.isnan(lval):
                        raise FloatingPointError(f"Epoch:{epoch} Step:{nsteps} loss is NaN")
                    epoch_loss += lval
                prev_loss = loss
                nsteps += 1
                executed += 1
                if every_n and nsteps % every_n == 0:
                    # Validate the exact state being saved before overwriting
                    # the only rolling checkpoint: the loss comes from the
                    # step's incoming params, so a finite loss can coexist
                    # with NaN/Inf updated params (NaN gradients, optimizer
                    # overflow), and resume would restart from them.
                    lval = float(loss)
                    if np.isnan(lval) or not _all_finite(params):
                        raise FloatingPointError(
                            f"Epoch:{epoch} Step:{nsteps} loss or updated params "
                            "are NaN/Inf; refusing to overwrite the checkpoint")
                    # the host copy happens here; the npz write and the
                    # atomic swap overlap the next steps. A write error
                    # surfaces at the next save/wait. One writer.
                    save_p, save_o = mesh_mod.gather_state(mesh, params, opt_state)
                    if is_main:
                        ckpt_writer.save(ckpt_dir, save_p, save_o, model_state, {
                            "next_epoch": epoch,
                            "step": int(step),
                            "mid_epoch_batches": nsteps,
                            "best_bleu": logger.best_bleu,
                            "best_meteor": logger.best_meteor,
                            "train_encoder": logger.train_encoder,
                        })
                if fault_injection_step is not None and step >= fault_injection_step:
                    raise RuntimeError(f"fault injection at global step {step}")
                if nsteps % cfg.train.log_every_n_step == 0:
                    lval = float(loss)  # a sync point, every N steps only
                    # epoch_loss holds steps 1..executed-1 (one-step-delayed
                    # NaN fold); adding this step's loss makes this the mean
                    # over all `executed` steps (reference train.py:145-148)
                    logger.log(
                        f"    Step {nsteps} Mean loss: {(epoch_loss + lval) / executed:6f} "
                        f"Step loss: {lval:6f}, lr: {float(lr)}")
                if max_steps_per_epoch and nsteps >= max_steps_per_epoch:
                    break
        finally:
            # Capture the in-flight exception BEFORE wait(): inside the
            # `except` below, sys.exc_info() would report `werr` itself.
            unwinding = sys.exc_info()[1] is not None
            feeder.close()
            # land any in-flight rolling checkpoint before epoch-end writes
            # touch the same directory (and before a crash unwinds past
            # it); while the loop is already unwinding with the real failure
            # (NaN guard, fault injection), a background write error is
            # logged and the original error propagates.
            try:
                ckpt_writer.wait()
            except Exception as werr:
                if unwinding:
                    logger.log("WARNING: background checkpoint write failed while "
                               f"handling another error: {type(werr).__name__}: {werr}")
                else:
                    raise
        if prev_loss is not None:
            lval = float(prev_loss)
            if np.isnan(lval):
                raise FloatingPointError(f"Epoch:{epoch} Step:{nsteps} loss is NaN")
            epoch_loss += lval
        train_seconds = time.perf_counter() - t_train
        mean_loss = epoch_loss / max(executed, 1)
        logger.log(f"Epoch loss: {mean_loss:7f}")
        logger.log_scalars("epoch_loss", epoch=epoch, loss=mean_loss, steps=nsteps)
        logger.log_scalars("step_times", epoch=epoch, **timer.summary())
        logger.log_scalars("train_wall", epoch=epoch, seconds=train_seconds,
                           images=executed * batch_size, feeder_wait_s=feeder.wait_seconds)
        if every_n and executed >= every_n:
            logger.log_scalars("checkpoint_save", epoch=epoch,
                               save_blocked_s=ckpt_writer.snapshot_seconds,
                               write_s=ckpt_writer.write_seconds)

        eval_begin = time.perf_counter()
        packed = captioner.pack_decoder(params["decoder"], opts)  # once per evaluation
        bleu, distinct, n_captions = _dev_eval(
            lambda p, s, imgs: steps.decode_step(p, s, imgs, packed),
            params,
            model_state,
            data_reader.get_reader(batch_size, "dev", keep_float16=cfg.train.device_convert,
                                   reader_threads=cfg.train.reader_threads),
            data_reader.index_word,
            batch_size,
            cfg.data.stop_idx,
            cfg.data.padding_idx,
        )
        del packed
        eval_seconds = time.perf_counter() - eval_begin
        last_bleu = bleu
        logger.log(f"Dev set: BLEU {bleu:.7f} distinct sentences: {distinct} "
                   f"took: {eval_seconds:.2f}s")
        logger.log_scalars("dev_bleu", epoch=epoch, bleu=bleu, distinct=distinct,
                           seconds=eval_seconds, captions=n_captions)
        save_p, save_o = mesh_mod.gather_state(mesh, params, opt_state)
        if is_main:  # one writer; every process tracks best_bleu
            save_model(cfg, logger, save_p, save_o, model_state, epoch, step, bleu)
        elif cfg.train.save_best_bleu_checkpoint and bleu > logger.best_bleu:
            logger.best_bleu = bleu
        del save_p, save_o
        logger.log(f"Epoch took {time.time() - begin:2f}s")
    distributed.barrier()  # process 0's writes are done when every process returns

    return {
        "epochs": cfg.train.max_epoch,
        "final_step": int(step),
        "last_dev_bleu": last_bleu,
        "best_bleu": logger.best_bleu,
        "last_epoch_loss": mean_loss,
    }

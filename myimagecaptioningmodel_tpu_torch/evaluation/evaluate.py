"""Bundle loading and offline evaluation; port of
``myimagecaptioningmodel_tpu/evaluation/evaluate.py`` on one device.

``load_bundle``: greedy and beam decode, float or int8 decoder weights, both
decoder families, and the transformer's int8 cross-attention memory.
``evaluate``: BLEU-1..4 and their mean, CIDEr-D and the distinct sentences
of a bundle's captions on the dev or test split, the host scoring batch i
while the card decodes batch i+1. Inside a process group
(``parallel/distributed.py``) each process decodes its rows of every global
batch on its own device, the ids are all-gathered, and every process scores
the whole corpus, as the JAX package's multi-host ``evaluate``: the numbers
are the single-process run's on every rank.

Model options come from the bundle's own ``config.json``, as in the
reference: a bundle is a self-contained artifact and its dims, parity mode
and dtype must not change under a caller's config. Paths stay the caller's.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import captioner_from_tree
from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
from myimagecaptioningmodel_tpu_torch.models import captioner
from myimagecaptioningmodel_tpu_torch.models.captioner import (
    Captioner,
    ModelOptions,
    resolve_device,
)
from myimagecaptioningmodel_tpu_torch.parallel import distributed
from myimagecaptioningmodel_tpu_torch.parallel import mesh as mesh_mod
from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt


def load_bundle(
    cfg, bundle: str = "infer", beam_size: int = 0, quantize: bool = False,
    early_stop: bool = False, device=None, length_norm: float = 0.0,
    quantize_kv: bool = False,
) -> Tuple[Captioner, object, ModelOptions, Callable]:
    """-> (model, bundle_cfg, opts, decode) with ``decode(model, images)`` ->
    int32 ids [B, infer_max_length] on ``device``.

    ``beam_size`` 0/1 -> greedy; > 1 -> beam search. ``quantize`` stores the
    decoder weights as int8 (``ops/quantization.py``; a transformer's with
    ``models.transformer.quantize_transformer_decoder``): captions unchanged
    up to quantization noise. ``quantize_kv`` (transformer, greedy only)
    also keeps the cross-attention K/V as per-channel int8, an approximate
    serving mode: captions can differ within the quantization grid. A
    transformer bundle decodes through kernels D (greedy) and E (beam) on
    CUDA, int8 weights and memory included. ``early_stop`` ends
    the decode loop once every row (greedy) or every beam (beam) is finished
    (same captions). ``length_norm`` (beam only) divides the final beam
    scores by ``len ** length_norm``. ``device`` defaults to CUDA, and
    without a card that is an error (``resolve_device``): the CPU runs only
    when asked for with ``device="cpu"``. ``opts.use_kernels`` is on exactly
    when the device is CUDA."""
    device = resolve_device(device)
    directory = os.path.join(cfg.train.checkpoint_path, bundle)
    params, model_state, bundle_cfg = ckpt.load_inference_bundle(directory)
    opts = ModelOptions.from_config(bundle_cfg)._replace(
        use_kernels=device.type == "cuda", early_stop_decode=early_stop
    )
    if quantize_kv:
        if opts.arch != "transformer":
            raise ValueError("quantize_kv is a transformer-family serving mode (the LSTM "
                             "decoder has no streamed cross-attention K/V)")
        if beam_size and beam_size > 1:
            raise ValueError("quantize_kv covers greedy decode only")
        opts = opts._replace(quantize_kv=True)
    model = captioner_from_tree(params, model_state, opts, device, quantize=quantize)

    if beam_size and beam_size > 1:
        def decode(model: Captioner, images) -> torch.Tensor:
            return beam_decode(model, images, opts, beam_size, length_norm=length_norm,
                               stop_idx=opts.stop_idx)[0]
    else:
        def decode(model: Captioner, images) -> torch.Tensor:
            return captioner.greedy_decode(model, images, opts)

    return model, bundle_cfg, opts, decode


def evaluate(cfg=None, bundle: str = "infer", mode: str = "test", beam_size: int = 0,
             quantize: bool = False, early_stop: bool = False, length_norm: float = 0.0,
             quantize_kv: bool = False, device=None) -> Dict[str, object]:
    """-> {'bleu': [b1,b2,b3,b4,mean], 'cider': float, 'distinct_sentences':
    int|None, 'captions': int, 'seconds': float} (the last two: rows decoded
    and the wall time of the decode-and-score loop).

    ``early_stop``: greedy decode ends once every row has emitted <stop>
    (identical captions). Raw storage rows (float16/uint8 NCHW) go to the
    card as they are, converted there (``prepare_images``), where the
    bundle's normalization matches the shards'; otherwise the host
    normalizes them."""
    from myimagecaptioningmodel_tpu_torch import config as config_mod
    from myimagecaptioningmodel_tpu_torch.data import reader as reader_mod
    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
    from myimagecaptioningmodel_tpu_torch.evaluation import metrics
    from myimagecaptioningmodel_tpu_torch.evaluation.cider import CiderD

    cfg = cfg or config_mod.default
    model, _bcfg, opts, decode = load_bundle(
        cfg, bundle, beam_size, quantize, early_stop=early_stop,
        device=distributed.default_device(device), length_norm=length_norm,
        quantize_kv=quantize_kv)
    if distributed.active():  # this rank's rows, then every rank's ids
        decode_one, mesh = decode, mesh_mod.make_mesh(model.device)

        def decode(model, imgs):
            return distributed.all_gather_rows(decode_one(model, mesh_mod.shard_batch(mesh, imgs)))

    dr = DataReader(cfg)
    index_word = dr.index_word
    batch_size = cfg.train.batch_size
    info = dr.shards.storage_info
    raw_ok = bool(info.get("normalized", True))
    if not raw_ok and opts.image_norm is not None:
        mean, std = dr.storage_norm
        raw_ok = np.allclose(mean, opts.image_norm[0]) and np.allclose(std, opts.image_norm[1])
    reader = dr.get_reader(batch_size, mode, keep_float16=raw_ok,
                           reader_threads=cfg.train.reader_threads)

    bleu_score = [0.0] * 5
    sentences = set()
    cider_cands: list = []
    cider_refs: list = []

    def score(ids, refs, _n):
        for i, vec in enumerate(metrics.BLEU_WEIGHT_VECTORS):
            bleu_score[i] += metrics.calc_bleu(
                ids, refs, index_word, vec,
                stop_idx=cfg.data.stop_idx, padding_idx=cfg.data.padding_idx)
        for row, r in zip(ids.tolist(), refs):
            words = metrics.filter_ids(row, index_word, cfg.data.stop_idx,
                                       cfg.data.padding_idx)
            cider_cands.append(words)
            cider_refs.append(list(r))
            if cfg.evaluate.sentence_statistics:
                sentences.add(metrics.words2sentence(words))

    t0 = time.perf_counter()
    batches = reader_mod.decode_and_score(reader, batch_size,
                                          lambda imgs: decode(model, imgs), score)
    seconds = time.perf_counter() - t0

    for i in range(4):
        bleu_score[i] /= max(batches, 1)
    bleu_score[4] = sum(bleu_score[:4]) / 4
    cider, _per_image = CiderD().score(cider_cands, cider_refs)

    print("BLEU [{:.7f}, {:.7f}, {:.7f}, {:.7f}] {:.7f}".format(*bleu_score))
    print(f"CIDEr-D: {cider:.7f}")
    distinct = None
    if cfg.evaluate.sentence_statistics:
        distinct = len(sentences)
        print(f"distinct sentences: {distinct}")
    return {"bleu": bleu_score, "cider": cider, "distinct_sentences": distinct,
            "captions": len(cider_cands), "seconds": seconds}


def load_index_word(cfg, bundle: str = "infer") -> Dict[int, str]:
    """id -> word from ``word_dict.npy``: the bundle's copy, else the
    dataset's (``cfg.data.dict_path``), read as the reference reader does."""
    path = os.path.join(cfg.train.checkpoint_path, bundle, "word_dict.npy")
    if not os.path.exists(path):
        path = os.path.join(cfg.data.dict_path, "word_dict.npy")
    _word_index, index_word = np.load(path, allow_pickle=True)
    return {int(k): v for k, v in index_word.items()}

"""Bundle loading for decode; port of ``load_bundle`` in
``myimagecaptioningmodel_tpu/evaluation/evaluate.py`` (greedy and beam
decode, float or int8 decoder weights, one device; both decoder families,
and the transformer's int8 cross-attention memory).

Model options come from the bundle's own ``config.json``, as in the
reference: a bundle is a self-contained artifact and its dims, parity mode
and dtype must not change under a caller's config. Paths stay the caller's.
"""

from __future__ import annotations

import os
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


def load_index_word(cfg, bundle: str = "infer") -> Dict[int, str]:
    """id -> word from ``word_dict.npy``: the bundle's copy, else the
    dataset's (``cfg.data.dict_path``), read as the reference reader does."""
    path = os.path.join(cfg.train.checkpoint_path, bundle, "word_dict.npy")
    if not os.path.exists(path):
        path = os.path.join(cfg.data.dict_path, "word_dict.npy")
    _word_index, index_word = np.load(path, allow_pickle=True)
    return {int(k): v for k, v in index_word.items()}

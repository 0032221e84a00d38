"""Image-captioning model facade, decode side; port of
``myimagecaptioningmodel_tpu/models/captioner.py``.

Feature path (as the reference's ``img2feature``): encoder NHWC
[B,7,7,1280] -> [B,49,1280] flattened in NHWC order; per-position dense+relu
-> img_embed [B,49,H]; mean over positions -> dense+relu -> global_feat [B,H].

A ``Captioner`` pairs the eval-mode MobileNetV2 module with the dense
params (``img_embed``, ``img_global``, ``decoder``) in the reference's dict
layout, all on one device. ``init`` draws the reference's (params, state)
pytree; ``compat/from_jax.captioner_from_tree`` turns such a pytree into a
``Captioner``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.models import decoder as decoder_mod
from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2
from myimagecaptioningmodel_tpu_torch.models.decoder import DecoderDims
from myimagecaptioningmodel_tpu_torch.ops import layers as L

Params = Dict[str, Any]

TRANSFORMER_TODO = (
    "the transformer decoder family is not ported yet "
    "(ROADMAP.md, queue 1 item 11: models/transformer.py)"
)


class ModelOptions(NamedTuple):
    """Static model options derived from config (decode subset of the
    reference's)."""

    dims: DecoderDims
    infer_max_length: int = 35
    start_idx: int = 2
    padding_idx: int = 0
    encoder_scale: float = 1.0
    parity_mode: bool = False
    compute_dtype: str = "bfloat16"
    use_kernels: bool = False  # hand-written CUDA kernels on the decode path
    early_stop_decode: bool = False
    stop_idx: int = 3
    # ((mean,)*3, (std,)*3) for normalizing raw uint8 image batches
    image_norm: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    arch: str = "lstm"

    @classmethod
    def from_config(cls, cfg) -> "ModelOptions":
        md = cfg.model
        arch = getattr(md.decoder, "arch", "lstm")
        if arch == "transformer":
            raise NotImplementedError(TRANSFORMER_TODO)
        if arch != "lstm":
            raise ValueError(f"unknown model.decoder.arch: {arch!r}")
        return cls(
            dims=DecoderDims.from_config(md),
            infer_max_length=md.decoder.infer_max_length,
            start_idx=cfg.data.start_idx,
            padding_idx=cfg.data.padding_idx,
            encoder_scale=float(getattr(md.encoder, "encoder_scale", 1.0)),
            parity_mode=md.parity_mode,
            compute_dtype=md.compute_dtype,
            stop_idx=cfg.data.stop_idx,
            image_norm=(
                tuple(float(m) for m in cfg.data.image_mean),
                tuple(float(s) for s in cfg.data.image_std),
            ),
            arch=arch,
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class Captioner(NamedTuple):
    encoder: mobilenet_v2.MobileNetV2  # eval mode, BN moving stats as buffers
    params: Params  # {"img_embed", "img_global", "decoder"} tensors

    @property
    def device(self) -> torch.device:
        return self.params["img_embed"]["w"].device


def init(gen: torch.Generator, opts: ModelOptions) -> Tuple[Params, Params]:
    """The reference's ({encoder, img_embed, img_global, decoder} params,
    {encoder} BN state) pytree, as CPU float32 tensors drawn from ``gen``."""
    if opts.arch != "lstm":
        raise NotImplementedError(TRANSFORMER_TODO)
    enc_params, enc_state = mobilenet_v2.init(gen, scale=opts.encoder_scale)
    H, C = opts.dims.hidden_dim, opts.dims.feat_channels
    params = {
        "encoder": enc_params,
        "img_embed": decoder_mod.init_dense(gen, C, H),
        "img_global": decoder_mod.init_dense(gen, C, H),
        "decoder": decoder_mod.init(gen, opts.dims, parity_init=opts.parity_mode),
    }
    return params, {"encoder": enc_state}


def prepare_images(images, opts: ModelOptions, device) -> torch.Tensor:
    """Raw feed batch (numpy or tensor; float NHWC, or storage NCHW, or raw
    uint8) -> normalized float32 NHWC on ``device``."""
    images = torch.as_tensor(images).to(device)
    if images.ndim == 4 and images.shape[1] == 3 and images.shape[-1] != 3:
        images = images.permute(0, 2, 3, 1)  # NCHW storage -> NHWC
    if images.dtype == torch.uint8:
        mean, std = opts.image_norm or ((0.0,) * 3, (1.0,) * 3)
        images = images.float() / 255.0
        images = (images - torch.tensor(mean, device=device)) / torch.tensor(
            std, device=device
        )
    return images.float()


@torch.no_grad()
def img2feature(model: Captioner, images, opts: ModelOptions):
    """-> (img_embed [B,k,H], raw feats [B,k,C], global_feat [B,H])."""
    dt = opts.dtype
    images = prepare_images(images, opts, model.device)
    feat = model.encoder(images, dt)
    B = feat.shape[0]
    feat = feat.reshape(B, -1, feat.shape[-1])  # [B, 49, 1280] (NHWC flatten)
    img_embed = torch.relu(L.dense(model.params["img_embed"], feat, dt))
    global_feat = torch.relu(L.dense(model.params["img_global"], feat.mean(dim=1), dt))
    return img_embed, feat, global_feat


@torch.no_grad()
def greedy_decode(model: Captioner, images, opts: ModelOptions) -> torch.Tensor:
    """Greedy caption ids int32 [B, infer_max_length] (eval-mode BN)."""
    img_embed, _feat, global_feat = img2feature(model, images, opts)
    pre = decoder_mod.precompute(model.params["decoder"], img_embed, global_feat, opts.dtype)
    return decoder_mod.greedy_decode_ids(
        model.params["decoder"],
        pre,
        opts.infer_max_length,
        opts.start_idx,
        opts.parity_mode,
        opts.padding_idx,
        opts.dtype,
        use_kernels=opts.use_kernels,
        early_stop=opts.early_stop_decode,
        stop_idx=opts.stop_idx,
    )

"""Image-captioning model facade; port of
``myimagecaptioningmodel_tpu/models/captioner.py``.

Feature path (as the reference's ``img2feature``): encoder NHWC
[B,7,7,1280] -> [B,49,1280] flattened in NHWC order; per-position dense+relu
-> img_embed [B,49,H]; mean over positions -> dense+relu -> global_feat [B,H].

Serving: a ``Captioner`` pairs the eval-mode MobileNetV2 module with the
dense params (``img_embed``, ``img_global``, ``decoder``) in the reference's
dict layout, all on one device; ``compat/from_jax.captioner_from_tree``
builds one from a reference-layout (params, state) pytree.

Training works on the (params, state) tree itself, as the reference does:
``img2feature_tree`` (train-mode BN, new state; ``bn_stat_rows`` > 0 takes
the statistics of the non-1x1 convs' BN from the first rows only),
``loss_terms`` (masked CE sum and token count over teacher-forced logits of
either decoder family) and ``loss_fn`` (their token mean).
``compat/from_jax.train_tree`` makes the tree: float32 master weights with
``requires_grad``; each op casts to the compute dtype.

``init`` draws the reference's (params, state) pytree. Entry points run on
CUDA unless the caller asks for the CPU (``resolve_device``).

Both decoder families serve and train (``arch``: the LSTM of
``models/decoder.py``, the transformer of ``models/transformer.py``).

``opts.vocab_parallel`` (vocab tensor parallelism, ``parallel/mesh.py``):
the params hold this rank's rows of the tied table and of ``out_bias``;
``loss_terms`` runs the families' forwards on them with the vocab-parallel
lookup, head input and cross-entropy (``parallel/vocab_parallel.py``), and
the greedy decode runs on the full table, gathered once
(``pack_decoder``), with the head on this rank's rows.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.models import decoder as decoder_mod
from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2
from myimagecaptioningmodel_tpu_torch.models import transformer as transformer_mod
from myimagecaptioningmodel_tpu_torch.models.decoder import DecoderDims
from myimagecaptioningmodel_tpu_torch.models.transformer import TransformerDims
from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP

Params = Dict[str, Any]

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card that is an error, never a quiet move to the CPU:
    pass ``device="cpu"`` to run there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on a GPU unless asked for the CPU "
            "(pass device=\"cpu\", or --device cpu on the command line)"
        )
    return device


class ModelOptions(NamedTuple):
    """Static model options derived from config (the LSTM family's fields of
    the reference's)."""

    dims: DecoderDims
    sentence_length: int = 35
    infer_max_length: int = 35
    start_idx: int = 2
    padding_idx: int = 0
    encoder_trainable: bool = True
    encoder_scale: float = 1.0
    parity_mode: bool = False
    compute_dtype: str = "bfloat16"
    use_kernels: bool = False  # hand-written CUDA kernels on the decode path
    # the encoder's stride-1 1x1 convs through kernel F (training only)
    fuse_bn_stats: bool = False
    # > 0: the non-1x1 convs' BN takes its statistics from this many rows
    bn_stat_rows: int = 0
    early_stop_decode: bool = False
    stop_idx: int = 3
    # ((mean,)*3, (std,)*3) for normalizing raw uint8 image batches
    image_norm: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    arch: str = "lstm"
    tdims: Optional[TransformerDims] = None  # arch == "transformer" only
    # transformer greedy only: int8 cross-attention memory (load_bundle)
    quantize_kv: bool = False
    # uniform label smoothing over the real vocab rows; 0 = hard targets
    label_smoothing: float = 0.0
    # the table and out_bias sharded by rows over the model group
    vocab_parallel: bool = False

    @classmethod
    def from_config(cls, cfg) -> "ModelOptions":
        md = cfg.model
        arch = getattr(md.decoder, "arch", "lstm")
        if arch not in ("lstm", "transformer"):
            raise ValueError(f"unknown model.decoder.arch: {arch!r}")
        return cls(
            dims=DecoderDims.from_config(md),
            sentence_length=md.decoder.sentence_length,
            infer_max_length=md.decoder.infer_max_length,
            start_idx=cfg.data.start_idx,
            padding_idx=cfg.data.padding_idx,
            encoder_trainable=md.encoder.encoder_trainable,
            encoder_scale=float(getattr(md.encoder, "encoder_scale", 1.0)),
            parity_mode=md.parity_mode,
            compute_dtype=md.compute_dtype,
            fuse_bn_stats=md.fuse_bn_stats,
            bn_stat_rows=md.bn_stat_rows,
            label_smoothing=float(cfg.train.label_smoothing),
            stop_idx=cfg.data.stop_idx,
            image_norm=(
                tuple(float(m) for m in cfg.data.image_mean),
                tuple(float(s) for s in cfg.data.image_std),
            ),
            arch=arch,
            tdims=TransformerDims.from_config(md) if arch == "transformer" else None,
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class Captioner(NamedTuple):
    encoder: mobilenet_v2.MobileNetV2  # eval mode, BN moving stats as buffers
    params: Params  # {"img_embed", "img_global", "decoder"} tensors
    # the decoder's weights packed once for its kernels (LSTM: kernels B
    # and C, ``fused_step.pack_weights``; transformer: D and E,
    # ``fused_transformer.pack_weights``), else None: packed per decode
    decoder_packed: Any = None

    @property
    def device(self) -> torch.device:
        return self.params["img_embed"]["w"].device


def init(gen: torch.Generator, opts: ModelOptions) -> Tuple[Params, Params]:
    """The reference's ({encoder, img_embed, img_global, decoder} params,
    {encoder} BN state) pytree, as CPU float32 tensors drawn from ``gen``."""
    enc_params, enc_state = mobilenet_v2.init(gen, scale=opts.encoder_scale)
    H, C = opts.dims.hidden_dim, opts.dims.feat_channels
    params = {
        "encoder": enc_params,
        "img_embed": decoder_mod.init_dense(gen, C, H),
        "img_global": decoder_mod.init_dense(gen, C, H),
    }
    if opts.arch == "transformer":
        params["decoder"] = transformer_mod.init(gen, opts.tdims)
    else:
        params["decoder"] = decoder_mod.init(gen, opts.dims, parity_init=opts.parity_mode)
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


def img2feature_tree(params: Params, state: Params, images, opts: ModelOptions,
                     train: bool = True):
    """The reference's ``img2feature`` on a (params, state) tree (OIHW conv
    weights) -> (img_embed [B,k,H], raw feats [B,k,C], global_feat [B,H],
    new state). ``train`` normalizes with batch statistics and returns the
    updated moving statistics; otherwise the state comes back as it was."""
    dt = opts.dtype
    images = prepare_images(images, opts, params["img_embed"]["w"].device)
    feat, enc_state = mobilenet_v2.apply(
        params["encoder"], state["encoder"], images, train=train,
        trainable=opts.encoder_trainable, scale=opts.encoder_scale,
        compute_dtype=dt, fuse_bn_stats=opts.fuse_bn_stats,
        bn_stat_rows=opts.bn_stat_rows,
    )
    B = feat.shape[0]
    feat = feat.reshape(B, -1, feat.shape[-1])  # [B, 49, 1280] (NHWC flatten)
    img_embed = torch.relu(L.dense(params["img_embed"], feat, dt))
    global_feat = torch.relu(L.dense(params["img_global"], feat.mean(dim=1), dt))
    return img_embed, feat, global_feat, {"encoder": enc_state}


def loss_terms(params: Params, state: Params, images, captions: torch.Tensor,
               opts: ModelOptions):
    """Unreduced train-mode loss -> (masked CE sum, non-pad token count, new
    state); the (sum, count) split is what gradient accumulation needs."""
    captions = torch.as_tensor(captions).to(params["img_embed"]["w"].device).long()
    source, target = captions[:, :-1], captions[:, 1:]
    mask = (target != opts.padding_idx).float()
    img_embed, _feat, global_feat, new_state = img2feature_tree(
        params, state, images, opts, train=True)
    dec = params["decoder"]
    if opts.arch == "transformer":
        tpre = transformer_mod.precompute(dec, img_embed, global_feat,
                                          opts.tdims.num_heads, opts.dtype)
        logits = transformer_mod.teacher_forcing_logits(
            dec, tpre, source, opts.tdims, opts.padding_idx, opts.dtype,
            opts.vocab_parallel)  # [B, T, V]
        real_v = opts.tdims.vocab_size
    else:
        pre = decoder_mod.precompute(dec, img_embed, global_feat, opts.dtype)
        logits = decoder_mod.teacher_forcing_logits(
            dec, pre, source, opts.parity_mode, opts.padding_idx, opts.dtype,
            vocab_parallel=opts.vocab_parallel)  # [B, T, V]
        real_v = opts.dims.vocab_size
    if opts.vocab_parallel:  # this rank's columns [B, T, V_local]
        ce = VP.cross_entropy(logits, target, real_v, opts.label_smoothing)
        return (ce * mask).sum(), mask.sum(), new_state
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, target[..., None])[..., 0]
    ce = logz - gold
    if opts.label_smoothing > 0.0:
        # uniform smoothing over the real vocab rows (padded rows excluded)
        eps = opts.label_smoothing
        mean_logit = logits[..., :real_v].mean(dim=-1)
        ce = (1.0 - eps) * ce + eps * (logz - mean_logit)
    return (ce * mask).sum(), mask.sum(), new_state


def loss_fn(params: Params, state: Params, images, captions, opts: ModelOptions):
    """Masked token-mean teacher-forcing cross-entropy -> (scalar, new state)."""
    ce_sum, n_tok, new_state = loss_terms(params, state, images, captions, opts)
    return ce_sum / torch.clamp(n_tok, min=1.0), new_state


def _decode_features(dec: Params, img_embed, global_feat, opts: ModelOptions,
                     packed=None):
    vocab_slice = None
    if opts.vocab_parallel:  # the full table, and the head on this rank's rows
        if not isinstance(packed, VP.DecodePack):
            packed = pack_decoder(dec, opts)
        dec, vocab_slice, packed = packed
    if opts.arch == "transformer" and vocab_slice is not None:
        tpre = transformer_mod.precompute(dec, img_embed, global_feat,
                                          opts.tdims.num_heads, opts.dtype)
        return transformer_mod.greedy_decode_ids(
            dec, tpre, opts.tdims, opts.infer_max_length, opts.start_idx,
            opts.padding_idx, opts.dtype, use_kernels=opts.use_kernels,
            early_stop=opts.early_stop_decode, stop_idx=opts.stop_idx,
            vocab_slice=vocab_slice)
    if opts.arch == "transformer":  # kernel D exactly when use_kernels is set
        tpre = transformer_mod.precompute(dec, img_embed, global_feat,
                                          opts.tdims.num_heads, opts.dtype)
        return transformer_mod.greedy_decode_ids(
            dec, tpre, opts.tdims, opts.infer_max_length, opts.start_idx,
            opts.padding_idx, opts.dtype, use_kernels=opts.use_kernels,
            early_stop=opts.early_stop_decode, stop_idx=opts.stop_idx, packed=packed,
            quantize_kv=opts.quantize_kv,
        )
    pre = decoder_mod.precompute(dec, img_embed, global_feat, opts.dtype)
    return decoder_mod.greedy_decode_ids(
        dec,
        pre,
        opts.infer_max_length,
        opts.start_idx,
        opts.parity_mode,
        opts.padding_idx,
        opts.dtype,
        use_kernels=opts.use_kernels,
        early_stop=opts.early_stop_decode,
        stop_idx=opts.stop_idx,
        packed=packed,
        vocab_slice=vocab_slice,
    )


@torch.no_grad()
def greedy_decode(model: Captioner, images, opts: ModelOptions) -> torch.Tensor:
    """Greedy caption ids int32 [B, infer_max_length] (eval-mode BN)."""
    img_embed, _feat, global_feat = img2feature(model, images, opts)
    return _decode_features(model.params["decoder"], img_embed, global_feat, opts,
                            model.decoder_packed)


@torch.no_grad()
def pack_decoder(dec: Params, opts: ModelOptions):
    """The decoder's weights in its kernels' layout (LSTM: kernels B and C,
    ``fused_step.pack_weights``; transformer: D and E,
    ``fused_transformer.pack_weights``) in the compute dtype, or None when
    ``opts.use_kernels`` is off. A served bundle packs once at load; a dev
    evaluation packs once for all its batches. Under ``opts.vocab_parallel``
    a ``vocab_parallel.DecodePack``: the full table gathered over the model
    group (every rank of it calls this), and kernel B's pack of it for the
    LSTM on a card (D and E are not used: the plain transformer blocks)."""
    if opts.vocab_parallel:
        full, rows = VP.full_decoder(dec)
        packed = None
        if opts.use_kernels and opts.arch != "transformer" and not opts.parity_mode:
            from myimagecaptioningmodel_tpu_torch.ops.kernels.fused_step import pack_weights

            packed = pack_weights(full, opts.dtype)
        return VP.DecodePack(full, rows, packed)
    if not opts.use_kernels:
        return None
    if opts.arch == "transformer":
        from myimagecaptioningmodel_tpu_torch.ops.kernels.fused_transformer import pack_weights
    else:
        from myimagecaptioningmodel_tpu_torch.ops.kernels.fused_step import pack_weights
    return pack_weights(dec, opts.dtype)


@torch.no_grad()
def greedy_decode_tree(params: Params, state: Params, images, opts: ModelOptions,
                       packed=None):
    """Greedy caption ids from a training (params, state) tree (eval-mode BN
    with the moving statistics); ``packed``: ``pack_decoder``'s result for
    these params (packed here, on every call, when None)."""
    img_embed, _feat, global_feat, _ = img2feature_tree(params, state, images, opts,
                                                        train=False)
    return _decode_features(params["decoder"], img_embed, global_feat, opts, packed)

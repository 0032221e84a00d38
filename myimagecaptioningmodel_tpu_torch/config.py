"""Typed configuration with the same knobs as the reference's ``config.py``.

Port of ``myimagecaptioningmodel_tpu/config.py``: the same frozen
dataclasses, field names and defaults, so that a port bundle's
``config.json`` and a JAX bundle's are the same file (a test holds
``Config().to_dict()`` equal to the JAX package's). The port keeps its own
copy: it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class BuildDatasetConfig:
    """Offline dataset-build knobs (reference config.py:2-12)."""

    image_paths: Tuple[str, ...] = ("workdir/images",)
    annotation_path: str = "workdir/annotations.json"
    output_path: str = "workdir/dataset"
    h5_name2idx: str = "workdir/dataset/name2idx.json"
    # max caption length in words, excluding <start>/<stop> (config.py:9)
    sentence_len_limit: int = 33
    compression_opts: int = 5  # gzip level 0-9 (config.py:10)
    max_keep: int = 15000  # vocabulary cap (config.py:11)
    # rebuild-only additions (defaults preserve reference behavior):
    num_workers: int = 0  # 0 = serial ingest like the reference; N>0 = parallel
    shard_max_size: int = 30000  # images per HDF5 shard (hdf5_manager.py:152)
    # Shard storage options. The reference contract is float16 + gzip
    # (hdf5_manager.py:12,152-159) and stays the default; gzip-5 inflate
    # limits the JAX package's train feed (benchmarks/feed_roofline.md), so
    # the rebuild offers:
    #   codec: "gzip" | "lzf" (faster to decode) | "none"
    #   storage_dtype: "float16" (normalized rows, reference contract)
    #                | "uint8" (raw resized pixels, normalized at feed time;
    #                  half the bytes of float16 and no inflate cost)
    codec: str = "gzip"
    storage_dtype: str = "float16"


@dataclass(frozen=True)
class DataConfig:
    """Data-plane knobs (reference config.py:14-29)."""

    image_shape: Tuple[int, int] = (224, 224)
    image_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    image_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    dict_path: str = "workdir/dataset"  # directory of the .npy caption DBs
    h5_path: Tuple[str, ...] = ("workdir/dataset",)  # HDF5 shard directories
    h5_name2idx: str = "workdir/dataset/name2idx.json"

    start_idx: int = 2
    stop_idx: int = 3
    padding_idx: int = 0
    unk_idx: int = 1

    pretrained_mobilenet_path: Optional[str] = None
    sample_count: int = 944996  # training-set size (config.py:27)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (reference config.py:31-46)."""

    seed: Optional[int] = None
    learning_rate: float = 5e-5
    # one of: None | 'cosine_decay' | 'cosine_decay_restart'
    #       | 'cosine_decay_restart_warmup' | 'cosine_decay_warmup'
    lr_decay_strategy: Optional[str] = None
    decay_epoch: int = 0  # only for the *restart* strategies
    warmup_epoch: int = 3
    gradient_clip: Any = False  # False, or a by-value clip bound (train.py:42-43)
    batch_size: int = 128
    data_loader_capacity: int = 128  # prefetch-queue depth
    checkpoint_path: str = "workdir/save"
    checkpoint_backup_every_n_epoch: Any = False  # False or int
    export_params: bool = False
    export_infer_model: bool = True
    max_epoch: int = 10
    log_every_n_step: int = 150
    save_best_bleu_checkpoint: bool = True
    # rebuild-only: False (reference parity: epoch-granular resume only) or
    # N = also checkpoint every N training steps; resume then continues
    # mid-epoch from the exact batch (the reference loses mid-epoch progress,
    # SURVEY §5.3).
    checkpoint_every_n_steps: Any = False
    # rebuild-only: reshuffle the training order each epoch with a
    # deterministic per-epoch seed (the reference trains on the one fixed
    # order baked into train_cap.npy; deterministic seeding keeps mid-epoch
    # resume exact).
    shuffle_each_epoch: bool = False
    # rebuild-only: 0 = single-threaded shard reads inside the feeder worker
    # (reference DataLoader semantics); N>0 = parallel batch reads via
    # data/hdf5.ParallelHdf5Reader (gzip chunks inflate in a thread pool,
    # scaling with host cores; identical batches either way).
    reader_threads: int = 0
    # rebuild-only: ship raw storage batches (float16/uint8 NCHW) to the
    # device and fuse transpose/convert/normalize into the first conv
    # (models/captioner.prepare_images) instead of converting on the host —
    # numerically identical, with uint8 or float16 to copy to the device
    # rather than float32, and the host feed cost reduced to stack+DMA
    # (benchmarks/feed_roofline.md). False restores
    # the host-side native converter path.
    device_convert: bool = True
    # rebuild-only: uniform label smoothing ε over the real vocab rows in the
    # teacher-forcing CE (0.0 = reference-exact hard targets).
    label_smoothing: float = 0.0
    # rebuild-only: decay of an exponential moving average of the params
    # (0.0 = off). The EMA tree rides inside the optimizer state (resume/
    # sharding/checkpointing free); exports add an "infer_ema" bundle.
    ema_decay: float = 0.0
    # rebuild-only: split each batch into N sequential microbatches and
    # average their gradients before the single Adam update — the standard
    # large-effective-batch recipe when HBM can't hold the full batch's
    # activations. BN batch statistics are per-microbatch (state threads
    # through the microbatch scan). batch_size must be divisible by it.
    grad_accum_steps: int = 1
    # rebuild-only (the reference is DP-only, SURVEY §2.5): size of the
    # tensor-parallel `model` mesh axis. >1 shards the tied vocab-head
    # tensors (embedding table [V,E], output bias [V]) over the vocab
    # dimension (parallel/mesh.param_shardings) and GSPMD partitions the
    # tied-head matmul / CE logsumexp / decode argmax accordingly. Requires
    # device_count % model_parallel == 0 and the padded vocab divisible by
    # it (set model.decoder.vocab_pad_multiple to a multiple).
    model_parallel: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """MobileNetV2 encoder knobs (reference config.py:49-53)."""

    encoder_trainable: bool = True
    encoder_dim: int = 7 * 7  # spatial positions k (fixed by MobileNetV2 @224)
    encoder_channel: int = 1280
    # MobileNetV2 width multiplier (reference MobileNetV2.py:24 ``scale``;
    # the reference instantiates x1.0 only, train.py via the model facade).
    # For scale <= 1.0 the final 1x1 conv still emits 1280 channels
    # (MobileNetV2.py:74-81), so encoder_channel stays valid.
    encoder_scale: float = 1.0


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder knobs (reference config.py:54-61). The reference has exactly
    one decoder architecture; ``arch`` selects the rebuild's families."""

    # "lstm" = the reference's adaptive-attention LSTM (models/decoder.py);
    # "transformer" = pre-LN transformer decoder with cross-attention over
    # the same encoder features (models/transformer.py, rebuild-only family)
    arch: str = "lstm"
    vocab_size: int = 12295
    embedding_size: int = 256  # weight tying: output proj is also this size
    sentence_length: int = 35  # training captions incl. <start>/<stop>
    hidden_dim: int = 1024  # lstm hidden / sentinel size; transformer model dim
    infer_max_length: int = 35
    # rebuild-only: embedding/logits rows padded up to a multiple of this
    # (aligned vocab blocks + divisibility for vocab tensor parallelism);
    # padded entries get a -1e9 output bias so they can never be decoded.
    vocab_pad_multiple: int = 128
    # transformer-family knobs (ignored by arch="lstm")
    num_layers: int = 4
    num_heads: int = 8
    mlp_ratio: int = 4


@dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    # --- rebuild-only knobs -------------------------------------------------
    # parity_mode=True reproduces the reference's degenerate attention
    # (fc(...,size=1,act='softmax') over a size-1 axis => alpha==1, and
    # context = reduce_mean over slots; model_adaAttention_aic.py:107,113).
    # False (default) implements true Lu-et-al. adaptive attention:
    # softmax over the k+1 slots and a weighted *sum* context.
    parity_mode: bool = False
    # matmul/conv compute dtype; params and accumulations stay float32.
    compute_dtype: str = "bfloat16"
    # training-only: fold BN batch-stats into the output pass of the
    # encoder's 1x1 convs via the matmul+stats kernel
    # (ops/kernels/matmul_bn.py, kernel F) — eliminates the separate stats
    # read over most of the activation footprint. The same numerics as the
    # unfused path up to summation order.
    fuse_bn_stats: bool = False
    # training-only APPROXIMATION (opt-in): compute BN batch statistics
    # (and the scale/offset gradient estimates) from only the first R
    # images of the batch, with stats treated as constants in backward —
    # cuts the BN activation-pass count at the cost of gradient-estimate
    # noise (ops/layers._BNTrainSubset). 0 = exact reference semantics
    # (MobileNetV2.py:112-117 batch_norm).
    bn_stat_rows: int = 0


@dataclass(frozen=True)
class LogConfig:
    log_path: str = "workdir/log"


@dataclass(frozen=True)
class EvaluateConfig:
    sentence_statistics: bool = True


@dataclass(frozen=True)
class Config:
    """Root config bundling the six reference dict groups."""

    build_dataset: BuildDatasetConfig = field(default_factory=BuildDatasetConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    log: LogConfig = field(default_factory=LogConfig)
    evaluate: EvaluateConfig = field(default_factory=EvaluateConfig)

    # reference aliases: config.dc / config.md (config.py:72-73)
    @property
    def dc(self) -> DataConfig:
        return self.data

    @property
    def md(self) -> ModelConfig:
        return self.model

    # ---- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        import typing

        def build(dc_cls, val):
            if val is None:
                return dc_cls()
            # Resolve string annotations (PEP 563: `from __future__ import
            # annotations` makes f.type a string) to real classes so nested
            # dataclasses of ANY name deserialize recursively.
            hints = typing.get_type_hints(dc_cls)
            kwargs = {}
            for f in dataclasses.fields(dc_cls):
                if f.name not in val:
                    continue
                v = val[f.name]
                ftype = hints.get(f.name, f.type)
                if dataclasses.is_dataclass(ftype) and (
                    isinstance(v, dict) or v is None
                ):
                    # an explicit null section means "all defaults"
                    v = build(ftype, v)
                elif isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
            return dc_cls(**kwargs)

        return build(cls, raw)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


def replace_nested(cfg: Config, path: str, value: Any) -> Config:
    """Return a copy of ``cfg`` with a dotted field (e.g. 'train.batch_size') replaced."""
    parts = path.split(".")
    def rec(node, parts):
        if len(parts) == 1:
            return dataclasses.replace(node, **{parts[0]: value})
        child = getattr(node, parts[0])
        return dataclasses.replace(node, **{parts[0]: rec(child, parts[1:])})
    return rec(cfg, parts)


# The reference's "import config" ergonomics: a process-default instance.
default = Config()

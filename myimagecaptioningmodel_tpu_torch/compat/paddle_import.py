"""Import reference (PaddlePaddle) checkpoints into the port's trees; the
counterpart of ``myimagecaptioningmodel_tpu/compat/paddle_import.py``.

The trees are the reference layout that ``models.captioner.init`` draws and
``training.checkpoint.export_inference_bundle`` writes, as numpy (encoder
convs HWIO): the Paddle OIHW conv weights are transposed once, here, and
``compat.from_jax.captioner_from_tree`` turns the bundle's HWIO back into
the port's OIHW when it loads it (the one other transpose).

The reference saves persistables with one file per variable (train.py:73).
Variable names are fully determined by the reference's graph build:

- Explicit ``ParamAttr`` names: ``word_embedding``
  (model_adaAttention_aic.py:18,31), ``out_fc_bias`` (:23), ``lstm_w`` /
  ``lstm_b`` (:87-88), and the MobileNetV2 layer names
  ``conv{...}_weights`` / ``conv{...}_bn_{scale,offset,mean,variance}``
  (MobileNetV2.py:108-116) — which match this package's encoder layer names
  one-for-one (models/mobilenet_v2.py keeps the reference naming).
- Auto-named fc layers ``fc_N.w_0`` / ``fc_N.b_0``, numbered in graph-build
  order. Both reference programs (train + eval) build the fcs in the same
  order — ``_img2feature`` first (:191-199), then ``Decoder.call``
  (:50-117) — so the numbering below holds for either checkpoint:

      fc_0  img_embed            [1280, H]   (:197, relu)
      fc_1  img_global           [1280, H]   (:199, relu)
      fc_2  img_feat ("img_v")   [H, H]      (:52, tanh)
      fc_3  img_feat_emb ("img_k") [H, H]    (:53)
      fc_4  p_word_emb ("gate_x") [E+H, H]   (:89)
      fc_5  p_hidden ("gate_h")  [H, H]      (:90)
      fc_6  p_hid                [H, H]      (:99, tanh)
      fc_7  hid_emb              [H, H]      (:102)
      fc_8  sentinel_emb ("sent_emb") [H, H] (:104)
      fc_9  alpha score          [H, 1]      (:107)
      fc_10 out                  [H, H]      (:115)
      fc_11 weight-tying proj ("out_proj") [H, E]  (:24)

Layout conversions applied:

- conv weights: Paddle OIHW -> HWIO (transpose 2,3,1,0); grouped/depthwise
  convs keep I/g == 1 so the same transpose applies.
- LSTM gates: Paddle's ``lstm_unit`` is the Caffe2-heritage kernel with gate
  blocks ordered (i, f, o, g) over the 4H axis
  (paddle/fluid/operators/lstm_unit_op.h); this package's
  ``ops/lstm.lstm_from_gates`` uses (i, f, g, o) — blocks 2 and 3 swap.
  The concatenated input rows ([word_emb ; global_feat ; h_prev]) already
  line up: Paddle feeds concat(xt, h_prev) with xt = [word_emb ; global]
  (model_adaAttention_aic.py:86-88) and ``init_lstm`` uses the same order.
- vocab padding: when ``DecoderDims.padded_vocab > vocab_size`` the table
  and bias import into rows [:V]; padded rows keep their -1e9 logit bias.

Optimizer state (``*_moment*``, ``*_beta*_pow_acc*``), LR-schedule counters
(``@LR_DECAY_COUNTER@``, ``learning_rate_*``) and anything else unknown are
reported, not imported — the rebuild re-creates optimizer state on resume.

CLI (writes a port bundle, ``params.npz``, with ``model.parity_mode = true``;
``evaluation.evaluate.load_bundle`` serves it, through kernel A on a card):

    python -m myimagecaptioningmodel_tpu_torch.compat.paddle_import \
        <persistables_dir> <out_bundle_dir> [--config cfg.json] [--vocab dir] [--strict]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from myimagecaptioningmodel_tpu_torch.compat import paddle_fmt

# fc auto-name -> path into the (captioner) params pytree
FC_NAME_MAP: Dict[str, Tuple[str, ...]] = {
    "fc_0": ("img_embed",),
    "fc_1": ("img_global",),
    "fc_2": ("decoder", "img_v"),
    "fc_3": ("decoder", "img_k"),
    "fc_4": ("decoder", "gate_x"),
    "fc_5": ("decoder", "gate_h"),
    "fc_6": ("decoder", "p_hid"),
    "fc_7": ("decoder", "hid_emb"),
    "fc_8": ("decoder", "sent_emb"),
    "fc_9": ("decoder", "attention", "score"),
    "fc_10": ("decoder", "out"),
    "fc_11": ("decoder", "out_proj"),
}

_OPTIMIZER_SUFFIXES = (
    "_moment1_0",
    "_moment2_0",
    "_beta1_pow_acc_0",
    "_beta2_pow_acc_0",
    "_velocity_0",
)


@dataclasses.dataclass
class ImportReport:
    imported: List[str] = dataclasses.field(default_factory=list)
    skipped: List[str] = dataclasses.field(default_factory=list)  # known non-model
    unknown: List[str] = dataclasses.field(default_factory=list)
    missing: List[str] = dataclasses.field(default_factory=list)  # expected, absent

    def summary(self) -> str:
        return (
            f"imported {len(self.imported)} vars, "
            f"skipped {len(self.skipped)} optimizer/LR vars, "
            f"{len(self.unknown)} unknown, {len(self.missing)} missing"
        )


def permute_lstm_gates(arr: np.ndarray, hidden: int, axis: int = -1) -> np.ndarray:
    """Reorder 4H gate blocks from Paddle (i,f,o,g) to ours (i,f,g,o)."""
    if arr.shape[axis] != 4 * hidden:
        raise ValueError(
            f"gate axis has {arr.shape[axis]} units, expected {4 * hidden}"
        )
    i, f, o, g = np.split(arr, 4, axis=axis)
    return np.concatenate([i, f, g, o], axis=axis)


def conv_oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _get(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Any, path: Tuple[str, ...], value: np.ndarray) -> None:
    """In-place graft with shape validation against the existing leaf."""
    parent = _get(tree, path[:-1])
    old = parent[path[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"pytree {tuple(old.shape)} vs paddle {tuple(value.shape)}"
        )
    parent[path[-1]] = np.asarray(value, np.float32)


def graft(
    variables: Dict[str, np.ndarray],
    params: Any,
    state: Any,
    strict: bool = False,
) -> ImportReport:
    """Graft reference-named variables onto (params, state) in place.

    ``params``/``state`` are the reference-layout numpy trees of
    ``models.captioner.init`` (``compat.from_jax.to_numpy``). With
    ``strict=True``, unknown variable names or expected-but-missing model
    variables raise.
    """
    report = ImportReport()
    emb_tbl = params["decoder"]["embedding"]["table"]
    V_pad, E = emb_tbl.shape
    H = params["decoder"]["p_hid"]["w"].shape[0]

    handled = set()

    def take(name: str) -> Optional[np.ndarray]:
        if name in variables:
            handled.add(name)
            report.imported.append(name)
            return np.asarray(variables[name], np.float32)
        report.missing.append(name)
        return None

    # --- named decoder vars -------------------------------------------------
    emb = take("word_embedding")
    if emb is not None:
        V = emb.shape[0]
        if V > V_pad or emb.shape[1] != E:
            raise ValueError(
                f"word_embedding {emb.shape} does not fit table {(V_pad, E)}"
            )
        table = np.array(emb_tbl, np.float32)
        table[:V] = emb
        params["decoder"]["embedding"]["table"] = table
    bias = take("out_fc_bias")
    if bias is not None:
        ob = np.array(params["decoder"]["out_bias"], np.float32)
        ob[: bias.shape[0]] = bias  # padded rows keep their -1e9
        params["decoder"]["out_bias"] = ob
    lstm_w = take("lstm_w")
    if lstm_w is not None:
        _set(params, ("decoder", "lstm", "w"), permute_lstm_gates(lstm_w, H))
    lstm_b = take("lstm_b")
    if lstm_b is not None:
        _set(params, ("decoder", "lstm", "b"), permute_lstm_gates(lstm_b, H))

    # --- auto-named fcs -------------------------------------------------------
    for fc_name, path in FC_NAME_MAP.items():
        w = take(f"{fc_name}.w_0")
        if w is not None:
            _set(params, path + ("w",), w)
        b = take(f"{fc_name}.b_0")
        if b is not None:
            _set(params, path + ("b",), b)

    # --- MobileNetV2 encoder --------------------------------------------------
    for layer in params["encoder"]:
        w = take(f"{layer}_weights")
        if w is not None:
            _set(params, ("encoder", layer, "conv", "w"), conv_oihw_to_hwio(w))
        for ref_suffix, ours, tree in (
            ("scale", "scale", params),
            ("offset", "offset", params),
            ("mean", "mean", state),
            ("variance", "var", state),
        ):
            v = take(f"{layer}_bn_{ref_suffix}")
            if v is not None:
                _set(tree, ("encoder", layer, "bn", ours), v)

    # --- classify the rest ------------------------------------------------------
    for name in variables:
        if name in handled:
            continue
        if name.endswith(_OPTIMIZER_SUFFIXES) or name.startswith(
            ("learning_rate", "@LR_DECAY_COUNTER@")
        ):
            report.skipped.append(name)
        else:
            report.unknown.append(name)

    if strict and (report.unknown or report.missing):
        raise ValueError(
            f"strict import failed: unknown={report.unknown[:8]} "
            f"missing={report.missing[:8]}"
        )
    return report


def import_persistables(
    dirname: str,
    opts,
    params: Any = None,
    state: Any = None,
    strict: bool = False,
) -> Tuple[Any, Any, ImportReport]:
    """Load a reference ``save_persistables`` dir onto fresh (``captioner.init``
    from seed 0) or given reference-layout numpy trees -> (params, state,
    report), numpy."""
    import torch

    from myimagecaptioningmodel_tpu_torch.compat.from_jax import to_numpy
    from myimagecaptioningmodel_tpu_torch.models import captioner

    if params is None or state is None:
        params, state = (to_numpy(t) for t in captioner.init(torch.Generator().manual_seed(0),
                                                             opts))
    skipped: list = []
    variables = paddle_fmt.read_persistables_dir(dirname, skipped=skipped)
    if strict and skipped:
        raise ValueError(f"strict import failed: unparseable files {skipped[:8]}")
    report = graft(variables, params, state, strict=strict)
    report.unknown.extend(f"{name} (unparseable file)" for name in skipped)
    return params, state, report


def main(argv=None) -> None:
    """CLI: convert a reference checkpoint dir to a port inference bundle.

    python -m myimagecaptioningmodel_tpu_torch.compat.paddle_import \
        <persistables_dir> <out_bundle_dir> [--config cfg.json] [--vocab dir]

    The emitted bundle sets ``model.parity_mode = true`` so decode matches
    the reference's (degenerate-attention) captions bit-for-bit.
    """
    from myimagecaptioningmodel_tpu_torch import config as config_mod
    from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions
    from myimagecaptioningmodel_tpu_torch.training import checkpoint

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("persistables_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--config", default=None, help="config JSON (default: defaults)")
    ap.add_argument("--vocab", default=None, help="dir with word_dict.npy etc.")
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args(argv)

    cfg = (
        config_mod.Config.from_json_file(args.config)
        if args.config
        else config_mod.Config()
    )
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, parity_mode=True)
    )
    opts = ModelOptions.from_config(cfg)
    params, state, report = import_persistables(
        args.persistables_dir, opts, strict=args.strict
    )
    print(report.summary())
    if report.missing:
        print(f"missing model vars: {report.missing}")
    checkpoint.export_inference_bundle(
        args.out_dir, params, state, cfg, vocab_src_dir=args.vocab
    )
    print(f"wrote inference bundle: {args.out_dir}")


if __name__ == "__main__":
    main()

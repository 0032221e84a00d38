"""Frozen serving artifact: the decode program with its weights, saved by
``torch.export``; the counterpart of
``myimagecaptioningmodel_tpu/inference/export_stablehlo.py``.

The reference exports a *frozen inference program* (graph plus weights in
one artifact, ``save_inference_model``, train.py:81-82). The JAX package
serializes its decode as StableHLO with ``jax.export``; the port exports
the bundle's plain greedy or beam decode with ``torch.export`` at a fixed
batch shape, its weights baked in, and saves it as a ``.pt2``. A serving
process runs it with ``torch`` alone, no code of this repository:

    ids = torch.export.load("out.pt2").module()(images)

The artifact runs no hand-written kernel, by the JAX package's own choice
(it drops its Pallas kernels so that the artifact is not pinned to one
runtime; a CUDA kernel of the port would pin it to the port's library).

The exported function maps a raw image batch -> caption ids int32 [B, T]
with ``prepare_images`` baked in: float32 NHWC (the reference feed), or
raw float16/uint8 NCHW storage rows (uint8 with the bundle's image_norm).
It is traced under an outer ``torch.no_grad()`` (the decode functions' own
``no_grad`` decorators would otherwise trace as grad-mode regions that
``torch.export.load`` rejects) and inside ``utils.tracing.exporting()``
(a loop that ends early asks the host; the exported loops run every step,
and the early-stop fill gives the same ids).

CLI:
    python -m myimagecaptioningmodel_tpu_torch.inference.export_program \\
        <ckpt>/infer out.pt2 [--config cfg.json] [--batch 8] [--beam N] \\
        [--device cpu|cuda] [--dtype float32|float16|uint8] [--quantize] [--early-stop]
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

IMAGE_DTYPES = ("float32", "float16", "uint8")


class _Decode(torch.nn.Module):
    """The bundle's plain decode as a module of one input (the images)."""

    def __init__(self, model, opts, beam_size: int) -> None:
        super().__init__()
        self.encoder = model.encoder  # its weights become the program's state
        self.model, self.opts, self.beam_size = model, opts, beam_size

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
        from myimagecaptioningmodel_tpu_torch.models import captioner

        if self.beam_size > 1:
            return beam_decode(self.model, images, self.opts, self.beam_size,
                               stop_idx=self.opts.stop_idx)[0]
        return captioner.greedy_decode(self.model, images, self.opts)


def input_spec(cfg, batch_size: int, image_dtype: str):
    """(shape, dtype) of the frozen input contract."""
    h, w = cfg.data.image_shape
    if image_dtype == "float32":  # reference feed contract: NHWC f32
        return (batch_size, h, w, 3), torch.float32
    if image_dtype in ("float16", "uint8"):  # raw storage rows: NCHW
        return (batch_size, 3, h, w), getattr(torch, image_dtype)
    raise ValueError(f"unsupported image_dtype {image_dtype!r}")


def export_decode(cfg, bundle: str = "infer", batch_size: int = 8, beam_size: int = 0,
                  device=None, image_dtype: str = "float32", quantize: bool = False,
                  early_stop: bool = False):
    """-> ``torch.export.ExportedProgram`` of the bundle's plain decode at a
    fixed batch shape, on ``device`` (CUDA unless the caller names another;
    ``resolve_device``). ``image_dtype``: the input contract to freeze
    (``input_spec``); ``quantize``: int8 decoder weights;
    ``early_stop``: the early-stop decode's ids (every step runs)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import captioner_from_tree
    from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions, resolve_device
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt
    from myimagecaptioningmodel_tpu_torch.utils import tracing

    device = resolve_device(device)
    params, state, bcfg = ckpt.load_inference_bundle(
        os.path.join(cfg.train.checkpoint_path, bundle))
    # the plain decode: no kernel, no pack
    opts = ModelOptions.from_config(bcfg)._replace(use_kernels=False,
                                                   early_stop_decode=early_stop)
    model = captioner_from_tree(params, state, opts, device, quantize=quantize)
    shape, dtype = input_spec(cfg, batch_size, image_dtype)
    example = torch.zeros(shape, dtype=dtype, device=device)
    module = _Decode(model, opts, beam_size).eval()
    with torch.no_grad(), tracing.exporting():
        return torch.export.export(module, (example,))


def export_to_file(path: str, exported) -> int:
    """Save ``exported`` (``torch.export.save``) -> the bytes written."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def specs(exported):
    """(inputs, outputs) of an exported program as ``[(shape, dtype)]``."""
    user = {s.arg.name for s in exported.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"}
    nodes = list(exported.graph.nodes)

    def spec(node):
        v = node.meta["val"]
        return tuple(v.shape), str(v.dtype).replace("torch.", "")

    ins = [spec(n) for n in nodes if n.op == "placeholder" and n.name in user]
    out = [n for n in nodes if n.op == "output"][0].args[0]
    return ins, [spec(n) for n in out]


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    from myimagecaptioningmodel_tpu_torch import config as config_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle_dir", help="inference bundle dir (.../infer)")
    ap.add_argument("out", help="output .pt2 path")
    ap.add_argument("--config", help="JSON config file")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=list(IMAGE_DTYPES),
                    help="frozen input contract (f32 NHWC or raw NCHW rows)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8-quantize the decoder weights before freezing")
    ap.add_argument("--early-stop", action="store_true",
                    help="the early-stop decode's ids (<pad> after <stop>)")
    args = ap.parse_args(argv)

    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    # bundle_dir = <checkpoint_path>/<bundle name>
    bundle = os.path.basename(os.path.normpath(args.bundle_dir))
    ckpt_path = os.path.dirname(os.path.normpath(args.bundle_dir))
    if ckpt_path:
        cfg = config_mod.replace_nested(cfg, "train.checkpoint_path", ckpt_path)
    exported = export_decode(cfg, bundle, args.batch, args.beam, args.device, args.dtype,
                             args.quantize, args.early_stop)
    n = export_to_file(args.out, exported)
    ins, outs = specs(exported)
    print(f"wrote {args.out}: {n} bytes, device={args.device or 'cuda'}, in={ins}, out={outs}")


if __name__ == "__main__":
    main()

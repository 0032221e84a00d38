"""Bridge from the JAX package's params/state pytree and bundles.

- ``read_msgpack`` decodes a file written by ``flax.serialization.to_bytes``
  (the JAX package's ``params.msgpack``) into nested dicts of numpy arrays,
  with ``msgpack`` alone: flax stores an array as msgpack ext type 1 holding
  ``(shape, dtype name, C-order bytes)``, a numpy scalar as ext type 3 with
  the same payload, and splits arrays above its chunk size into
  ``{"__msgpack_chunked_array__": True, "shape": .., "chunks": ..}``.
- flax writes a tuple (the transformer's ``decoder/layers``) as a dict keyed
  ``"0"``, ``"1"``, ..., and an npz bundle's flat keys come back the same
  way; ``tree_to_torch`` turns such a dict, and a tuple, into a list in
  index order, so a JAX pytree, a msgpack bundle and an npz bundle give the
  same port tree.
- ``conv_hwio_to_oihw`` converts conv weights: HWIO -> OIHW, which also maps
  a depthwise ``[3,3,1,C]`` to ``[C,1,3,3]``.
- ``captioner_from_tree`` builds a port ``Captioner`` from the reference
  layout: dense ``[in, out]`` weights, embedding ``table`` and ``out_bias``
  stay as they are; conv weights go HWIO -> OIHW; BN ``scale``/``offset``
  and moving ``mean``/``var`` go into the encoder module. With ``quantize``
  it stores the decoder as int8 (``ops/quantization.py``; the transformer's
  through ``models.transformer.quantize_transformer_decoder``), quantizing the
  float32 weights before anything is rounded to the compute dtype, as the
  reference quantizes its float32 params at load.
- ``train_tree`` carries a reference (params, state) across for training:
  float32 tensors (float64 on request) on an explicit device, conv weights
  OIHW, ``requires_grad`` on every param (the transformer's
  ``decoder/layers`` list included). Nothing is rounded to the compute
  dtype (no ``_cast_weights``): the tree holds the master weights, and each
  op casts to the compute dtype as the reference's ``dense`` does.
  ``reference_tree`` is the way back: numpy in the reference layout (HWIO
  convs, lists in index order), as
  ``training/checkpoint.export_inference_bundle`` takes it;
  ``port_layout`` and ``reference_layout`` do the same for any params-shaped
  tree (Adam's moments and the EMA in a checkpoint).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # no numpy bfloat16: widen to float32
        arr = _bf16_to_f32(buf)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape, order="C").copy()


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(src: Union[str, bytes]) -> Dict[str, Any]:
    """flax msgpack (a path or the bytes) -> nested dicts of numpy arrays."""
    import msgpack

    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            src = f.read()
    return _unchunk(msgpack.unpackb(src, ext_hook=_ext_hook, raw=False))


def read_jax_bundle(directory: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A JAX inference bundle's ``params.msgpack`` -> (params, model_state)."""
    payload = read_msgpack(os.path.join(directory, "params.msgpack"))
    return payload["params"], payload["model_state"]


def conv_hwio_to_oihw(w) -> np.ndarray:
    """[kh, kw, I/groups, O] -> [O, I/groups, kh, kw]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def oihw_to_hwio(w) -> np.ndarray:
    """[O, I/groups, kh, kw] -> [kh, kw, I/groups, O]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _is_index_dict(tree) -> bool:
    """A dict keyed "0", "1", ..., "n-1": how flax and the npz bundle store a
    tuple."""
    return bool(tree) and sorted(tree) == sorted(str(i) for i in range(len(tree)))


def tree_to_torch(tree, device=None, dtype=None):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``,
    copies that share no memory with ``tree``; tuples, lists and index-keyed
    dicts become lists in index order."""
    if isinstance(tree, dict) and _is_index_dict(tree):
        tree = [tree[str(i)] for i in range(len(tree))]
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device, dtype) for v in tree]
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().clone()
    else:
        t = torch.from_numpy(np.array(tree))  # a writable copy
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


def _cast_weights(tree, dt):
    """Cast every dense weight ``w`` to the compute dtype once, at load.
    ``dense`` casts its weight per call anyway; rounding once gives the same
    values without a cast per step. int8 ``w_q`` and their float32
    ``scale`` stay as they are."""
    if isinstance(tree, dict):
        return {k: (v.to(dt) if k == "w" else _cast_weights(v, dt))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_weights(v, dt) for v in tree]
    return tree


def captioner_from_tree(params: Dict[str, Any], state: Dict[str, Any], opts,
                        device=None, quantize: bool = False):
    """Reference-layout (params, state) -> a port ``Captioner`` on ``device``
    (CUDA unless the caller passes another; ``resolve_device``);
    ``quantize`` stores the decoder's weights as int8, quantized from the
    float32 tree before the cast to the compute dtype. A decoder served
    through its kernels (``opts.use_kernels``) also keeps its weights packed
    for them, once (``fused_step.pack_weights`` for the LSTM, int8
    dequantized; ``fused_transformer.pack_weights`` for the transformer, whose
    int8 layer streams stay int8)."""
    from myimagecaptioningmodel_tpu_torch.models.captioner import (
        Captioner, pack_decoder, resolve_device,
    )
    from myimagecaptioningmodel_tpu_torch.models.mobilenet_v2 import MobileNetV2

    device = resolve_device(device)
    encoder = MobileNetV2(opts.encoder_scale).load(
        params["encoder"], state["encoder"]
    ).to(device)
    dense = tree_to_torch({k: params[k] for k in ("img_embed", "img_global", "decoder")},
                          device, torch.float32)
    if quantize and opts.arch == "transformer":
        from myimagecaptioningmodel_tpu_torch.models.transformer import (
            quantize_transformer_decoder,
        )

        dense["decoder"] = quantize_transformer_decoder(dense["decoder"])
    elif quantize:
        from myimagecaptioningmodel_tpu_torch.ops.quantization import quantize_decoder

        dense["decoder"] = quantize_decoder(dense["decoder"])
    dense = _cast_weights(dense, opts.dtype)
    # the decoder family's kernel layout, packed once
    return Captioner(encoder=encoder, params=dense,
                     decoder_packed=pack_decoder(dense["decoder"], opts))


def _map_encoder_convs(params, fn):
    """``fn`` on the encoder's conv weights of a params-shaped tree (one
    without an ``encoder`` subtree comes back as it is)."""
    if "encoder" not in params:
        return params
    enc = {name: {**p, "conv": {"w": fn(p["conv"]["w"])}} for name, p in params["encoder"].items()}
    return {**params, "encoder": enc}


def port_layout(tree: Dict[str, Any], device, dtype=torch.float32):
    """A params-shaped reference-layout tree (the params, or an Adam moment
    or the EMA of them) -> tensors on ``device``, encoder convs OIHW, no
    ``requires_grad``."""
    return tree_to_torch(_map_encoder_convs(tree, conv_hwio_to_oihw), device, dtype)


def train_tree(params: Dict[str, Any], state: Dict[str, Any], device=None,
               dtype=torch.float32):
    """Reference-layout (params, state) -> the same trees as ``dtype`` tensors
    on ``device`` (CUDA unless the caller passes another), encoder convs
    OIHW, every param a leaf with ``requires_grad``."""
    from myimagecaptioningmodel_tpu_torch.models.captioner import resolve_device

    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

    device = resolve_device(device)
    p = port_layout(params, device, dtype)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    return p, tree_to_torch(state, device, dtype)


def reference_tree(params: Dict[str, Any], state: Dict[str, Any]):
    """A training tree -> (params, state) as float32 numpy (float64 for a
    float64 tree) in the reference layout (encoder convs HWIO; lists, such
    as the transformer's ``decoder/layers``, stay lists in index order)."""

    return reference_layout(params), to_numpy(state)


def to_numpy(tree):
    """Tensors -> float32 numpy copies (float64 kept), nested the same way;
    a copy shares no memory with the tensor, so a later in-place update of
    the tensor does not reach it."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach()
    return t.to("cpu", torch.float64 if t.dtype == torch.float64 else torch.float32,
                copy=True).numpy()


def reference_layout(tree):
    """A params-shaped training tree (the params, an Adam moment or the EMA)
    -> numpy copies in the reference layout (encoder convs HWIO)."""
    return _map_encoder_convs(to_numpy(tree), oihw_to_hwio)

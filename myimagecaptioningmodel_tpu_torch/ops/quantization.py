"""Post-training int8 weight quantization for the decode path (serving).

Port of ``myimagecaptioningmodel_tpu/ops/quantization.py``, bit for bit: the
same absmax / 127 scale with a 1e-12 floor, ``torch.round`` (half to even, as
``jnp.round``), clipping at +-127.

- dense-like weights ``[I, O]``: a scale per output channel ``[O]``, which
  commutes with the decoder's row slicing of the LSTM and gate weights;
- the tied embedding ``[V, E]``: a scale per row ``[V]``, for the lookup and
  for the tied head's logit columns;
- a quantized leaf is ``{"w_q": int8, "scale": f32}`` (embedding:
  ``{"table_q", "scale"}``); ``layers.dense``/``embed``, the decoder and the
  vocab heads detect them, so ``quantize_decoder``'s output is a drop-in
  param dict for the decode functions. The helpers below are the one place
  that reads a leaf whichever way it is stored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of float32 ``w``; ``axis`` is the axis
    reduced over for the scale (``axis=0`` of an ``[I, O]`` weight gives a
    per-output-channel scale ``[O]``)."""
    absmax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(axis).float()


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, axis: int, dtype) -> torch.Tensor:
    """``w_q * scale`` in ``dtype``, the scale broadcast along ``axis`` (the
    axis ``quantize_weight`` reduced over)."""
    shape = [1] * w_q.ndim
    shape[1 - axis if w_q.ndim == 2 else -1] = scale.shape[0]
    return w_q.to(dtype) * scale.reshape(shape).to(dtype)


_DENSE_KEYS = (
    "img_v", "img_k", "gate_h", "p_hid", "hid_emb", "sent_emb", "out", "out_proj",
    "lstm", "gate_x",
)


def quantize_decoder(decoder_params: Dict[str, Any]) -> Dict[str, Any]:
    """Decoder params with the decode-hot weights stored as int8 (the
    attention score weight, ``[H, 1]``, stays full precision)."""
    q = dict(decoder_params)
    for key in _DENSE_KEYS:
        p = dict(q[key])
        p["w_q"], p["scale"] = quantize_weight(p.pop("w"), axis=0)
        q[key] = p
    emb = dict(q["embedding"])
    emb["table_q"], emb["scale"] = quantize_weight(emb.pop("table"), axis=1)  # per row
    q["embedding"] = emb
    return q


def is_quantized(p: Dict[str, Any]) -> bool:
    return "w_q" in p or "table_q" in p


def dense_in_dim(p: Dict[str, Any]) -> int:
    """Rows ``I`` of a dense ``[I, O]`` weight, int8 or float."""
    return (p["w_q"] if is_quantized(p) else p["w"]).shape[0]


def dense_weight(p: Dict[str, Any]) -> torch.Tensor:
    """``[I, O]`` view of a dense weight, dequantized in float32 if int8."""
    if is_quantized(p):
        return dequantize(p["w_q"], p["scale"], 0, torch.float32)
    return p["w"]


def embedding_table(p: Dict[str, Any]) -> torch.Tensor:
    """``[V, E]`` view of the tied embedding, dequantized in float32 if int8."""
    if is_quantized(p):
        return dequantize(p["table_q"], p["scale"], 1, torch.float32)
    return p["table"]


def head_table(p: Dict[str, Any], dt=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The tied embedding as the vocab heads take it -> (table, scale): the
    int8 table with its float32 per-row scale, or the float table (cast to
    ``dt`` if given) and None."""
    if is_quantized(p):
        return p["table_q"], p["scale"]
    return (p["table"] if dt is None else p["table"].to(dt)), None

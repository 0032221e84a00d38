"""Fused adaptive-attention decode step.

Port of ``myimagecaptioningmodel_tpu/ops/pallas/fused_step.py``. One greedy
decode step (formula in that module's docstring):

    gates    = [word_emb ; h_prev] @ [W_word_cat ; W_hh_cat] + gxb
    c', h'   = LSTM cell;  sentinel = sigmoid(gates[4H:]) * tanh(c')
    p_hid    = tanh(h' @ Wp + bp);  hid_emb = p_hid @ Whe + bhe
    sent_key = sentinel @ Wse + bse
    ctx      = softmax-attention over [img_k ; sent_key] + hid_emb
    out      = tanh((ctx + p_hid) @ Wout + bout);  proj = out @ Wproj + bproj
    word'    = argmax(proj @ head_table^T + head_bias)      (with_head)

On CUDA tensors ``fused_decode_step`` launches the hand-written kernels of
``csrc/fused_step.cu`` from one C call (gate product with the LSTM/sentinel
epilogue, products with bias/activation epilogues, attention; design and
bounds in that file's note) and, for the head, kernel A of ``vocab_head``.
On CPU tensors it runs ``reference_step``, the plain version of the same
math.

Numerics follow the TPU kernel: every product rounds its operands to the
compute dtype and accumulates and returns float32; attention runs in float32.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
    greedy_vocab_argmax,
    greedy_vocab_argmax_reference,
)
from myimagecaptioningmodel_tpu_torch.ops.quantization import (
    dense_in_dim,
    dense_weight,
    embedding_table,
)


class FusedStepParams(NamedTuple):
    """Decode-invariant tensors, prepared once per decode call."""

    emb_table: torch.Tensor  # [V, E] gather table, padding row zeroed
    w_word_cat: torch.Tensor  # [E, 5H] = [W_lstm[:E] ; W_gate_x[:E]]
    w_hh_cat: torch.Tensor  # [H, 5H] = [W_lstm[E+H:] ; W_gate_h]
    gxb: torch.Tensor  # [B, 5H] f32: global-feat gate parts + all gate biases
    w_p: torch.Tensor  # [H, H]
    b_p: torch.Tensor  # [H]
    w_he: torch.Tensor  # [H, H]
    b_he: torch.Tensor  # [H]
    w_se: torch.Tensor  # [H, H]
    b_se: torch.Tensor  # [H]
    w_out: torch.Tensor  # [H, H]
    b_out: torch.Tensor  # [H]
    w_proj: torch.Tensor  # [H, E]
    b_proj: torch.Tensor  # [E]
    w_score: torch.Tensor  # [1, H] attention score row
    b_score: torch.Tensor  # [1] f32
    head_table: torch.Tensor  # [V, E] tied vocab table (compute dtype)
    head_bias: torch.Tensor  # [V] f32


def prepare(params: Dict[str, Any], pre, padding_idx: int, dt) -> FusedStepParams:
    """Slice/concat the decoder params into the kernels' layout. int8 params
    (``ops/quantization.py``) are dequantized here once, in float32, then
    cast to ``dt``; the kernels themselves take only float tables."""
    lw = dense_weight(params["lstm"])
    gw = dense_weight(params["gate_x"])
    w_proj = dense_weight(params["out_proj"])
    E = w_proj.shape[1]
    H = dense_in_dim(params["p_hid"])
    table = embedding_table(params["embedding"])
    emb_table = table.clone()
    emb_table[padding_idx] = 0.0  # embed(padding_idx) == 0

    def w(name):
        return dense_weight(params[name]).to(dt).contiguous()

    def b(name):
        return params[name]["b"].float().contiguous()

    return FusedStepParams(
        emb_table=emb_table,
        w_word_cat=torch.cat([lw[:E], gw[:E]], dim=1).to(dt).contiguous(),
        w_hh_cat=torch.cat(
            [lw[E + H:], dense_weight(params["gate_h"]).to(lw.dtype)], dim=1
        ).to(dt).contiguous(),
        gxb=torch.cat(
            [
                pre.lstm_gx + params["lstm"]["b"],
                pre.gate_gx + params["gate_x"]["b"] + params["gate_h"]["b"],
            ],
            dim=1,
        ).float().contiguous(),
        w_p=w("p_hid"), b_p=b("p_hid"),
        w_he=w("hid_emb"), b_he=b("hid_emb"),
        w_se=w("sent_emb"), b_se=b("sent_emb"),
        w_out=w("out"), b_out=b("out"),
        w_proj=w("out_proj"), b_proj=b("out_proj"),
        w_score=params["attention"]["score"]["w"].T.to(dt).contiguous(),
        b_score=params["attention"]["score"]["b"].float().contiguous(),
        head_table=table.to(dt).contiguous(),
        head_bias=params["out_bias"].float().contiguous(),
    )


def _dot(a, b, dt):
    """a.astype(dt) @ b with float32 accumulation and a float32 result."""
    return torch.matmul(a.to(dt).float(), b.float())


def _step_math(fp: FusedStepParams, word_emb, h, c, imgk, imgv, dt):
    H = h.shape[-1]
    pre_act = _dot(word_emb, fp.w_word_cat, dt) + _dot(h, fp.w_hh_cat, dt) + fp.gxb
    i = torch.sigmoid(pre_act[:, :H])
    f = torch.sigmoid(pre_act[:, H:2 * H])
    g = torch.tanh(pre_act[:, 2 * H:3 * H])
    o = torch.sigmoid(pre_act[:, 3 * H:4 * H])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    sentinel = torch.sigmoid(pre_act[:, 4 * H:]) * torch.tanh(c_new)

    p_hid = torch.tanh(_dot(h_new, fp.w_p, dt) + fp.b_p)
    hid_emb = _dot(p_hid, fp.w_he, dt) + fp.b_he
    sent_key = _dot(sentinel, fp.w_se, dt) + fp.b_se

    ws32 = fp.w_score.float()  # [1, H]
    z_img = torch.tanh(imgk.float() + hid_emb[:, None, :])  # [B, k, H]
    e_img = (z_img * ws32[None]).sum(-1) + fp.b_score  # [B, k]
    z_sent = torch.tanh(sent_key + hid_emb)
    e_sent = (z_sent * ws32).sum(-1, keepdim=True) + fp.b_score  # [B, 1]
    m = torch.maximum(e_img.max(dim=-1, keepdim=True).values, e_sent)
    a_img = torch.exp(e_img - m)
    a_sent = torch.exp(e_sent - m)
    denom = a_img.sum(-1, keepdim=True) + a_sent
    ctx = ((a_img[:, :, None] * imgv.float()).sum(1) + a_sent * sentinel) / denom

    out = torch.tanh(_dot(ctx + p_hid, fp.w_out, dt) + fp.b_out)
    proj = _dot(out, fp.w_proj, dt) + fp.b_proj  # [B, E]
    return h_new, c_new, proj


def reference_step(fp: FusedStepParams, word_emb, h, c, img_k, img_v,
                   with_head: bool = True, compute_dtype=torch.bfloat16):
    """Plain version of the fused step -> (h', c', proj, word')."""
    h_new, c_new, proj = _step_math(fp, word_emb, h, c, img_k, img_v, compute_dtype)
    if with_head:
        word = greedy_vocab_argmax_reference(proj, fp.head_table, fp.head_bias)
    else:
        word = torch.zeros((h.shape[0],), dtype=torch.int32, device=h.device)
    return h_new, c_new, proj, word


def fused_decode_step(
    fp: FusedStepParams,
    word_emb: torch.Tensor,  # [B, E]
    h: torch.Tensor,  # [B, H] f32
    c: torch.Tensor,  # [B, H] f32
    img_k: torch.Tensor,  # [B, k, H] compute dtype
    img_v: torch.Tensor,  # [B, k, H] compute dtype
    with_head: bool = True,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (h', c', proj [B,E] f32, word' [B] int32 — zeros if not with_head)."""
    if h.device.type == "cpu":
        return reference_step(fp, word_emb, h, c, img_k, img_v, with_head,
                              compute_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    dt = compute_dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused step computes in float32 or bfloat16, got {dt}")
    dev = h.device
    B, H = h.shape
    E = fp.w_proj.shape[1]
    S = img_k.shape[1]
    f32 = torch.float32
    word_emb = word_emb.to(dt).contiguous()
    for name, t, dtype, shape in (
        ("word_emb", word_emb, dt, (B, E)),
        ("h", h, f32, (B, H)),
        ("c", c, f32, (B, H)),
        ("img_k", img_k, dt, (B, S, H)),
        ("img_v", img_v, dt, (B, S, H)),
        ("w_word_cat", fp.w_word_cat, dt, (E, 5 * H)),
        ("w_hh_cat", fp.w_hh_cat, dt, (H, 5 * H)),
        ("gxb", fp.gxb, f32, (B, 5 * H)),
        ("w_p", fp.w_p, dt, (H, H)), ("b_p", fp.b_p, f32, (H,)),
        ("w_he", fp.w_he, dt, (H, H)), ("b_he", fp.b_he, f32, (H,)),
        ("w_se", fp.w_se, dt, (H, H)), ("b_se", fp.b_se, f32, (H,)),
        ("w_out", fp.w_out, dt, (H, H)), ("b_out", fp.b_out, f32, (H,)),
        ("w_proj", fp.w_proj, dt, (H, E)), ("b_proj", fp.b_proj, f32, (E,)),
        ("w_score", fp.w_score, dt, (1, H)), ("b_score", fp.b_score, f32, (1,)),
    ):
        _build.require(t, name, dev, dtype, shape)
    if H % 8 or E % 8:
        raise ValueError(f"the kernels take H and E in multiples of 8, got {H}, {E}")

    # h', c', sentinel, p_hid, hid_emb, sent_key, ctx, out [B, H]; proj [B, E]
    ws = torch.empty(8 * B * H + B * E, dtype=f32, device=dev)
    _build.check(_build.load_library().capk_fused_step(
        _build.dtype_code(dt), B, E, H, S, word_emb.data_ptr(), h.data_ptr(),
        c.data_ptr(), img_k.data_ptr(), img_v.data_ptr(),
        fp.w_word_cat.data_ptr(), fp.w_hh_cat.data_ptr(), fp.gxb.data_ptr(),
        fp.w_p.data_ptr(), fp.b_p.data_ptr(), fp.w_he.data_ptr(), fp.b_he.data_ptr(),
        fp.w_se.data_ptr(), fp.b_se.data_ptr(), fp.w_out.data_ptr(),
        fp.b_out.data_ptr(), fp.w_proj.data_ptr(), fp.b_proj.data_ptr(),
        fp.w_score.data_ptr(), fp.b_score.data_ptr(), ws.data_ptr(),
        _build.stream_ptr(dev),
    ), "capk_fused_step")
    fused_decode_step.launches += 1
    h_new = ws[: B * H].view(B, H)
    c_new = ws[B * H: 2 * B * H].view(B, H)
    proj = ws[8 * B * H:].view(B, E)

    if with_head:
        word = greedy_vocab_argmax(proj, fp.head_table, fp.head_bias)
    else:
        word = torch.zeros((B,), dtype=torch.int32, device=dev)
    return h_new, c_new, proj, word


fused_decode_step.launches = 0

"""Adaptive ("visual sentinel") attention forward; port of
``myimagecaptioningmodel_tpu/ops/attention.py::adaptive_attention``.

    z     = tanh(keys + hid_emb)       over the k image slots and the sentinel
    e     = z @ w_a + b_a
    alpha = softmax(e) over the k+1 slots
    ctx   = sum(alpha * values)

``parity_mode=True`` reproduces the reference's degenerate attention
(alpha == 1, context = mean over the k+1 slots).

``attn_scores_fused_bwd`` is the training forward's all-steps image scores
``e[t, b, k] = tanh(img_k[b, k] + h_emb[t, b]) @ w + b`` with a hand-written
backward; port of the JAX package's custom VJP of the same name (its
``_attn_fused_bwd``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as K
from myimagecaptioningmodel_tpu_torch.ops.layers import Params, dense


def adaptive_attention(
    p: Params,
    img_keys: torch.Tensor,  # [B, k, H]
    img_values: torch.Tensor,  # [B, k, H]
    sent_key: torch.Tensor,  # [B, H]
    sentinel: torch.Tensor,  # [B, H]
    hid_emb: torch.Tensor,  # [B, H]
    parity_mode: bool = False,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (context [B, H] float32, alpha [B, k+1] float32)."""
    if parity_mode:
        k1 = img_values.shape[1] + 1
        alpha = torch.ones(
            (img_values.shape[0], k1), dtype=torch.float32, device=img_values.device
        )
        context = (img_values.sum(dim=1).float() + sentinel) / k1
        return context, alpha
    dt = compute_dtype
    z_img = torch.tanh(img_keys.to(dt) + hid_emb.to(dt).unsqueeze(1))
    e_img = dense(p["score"], z_img, dt)[..., 0]  # [B, k]
    z_sent = torch.tanh(sent_key.to(dt) + hid_emb.to(dt))
    e_sent = dense(p["score"], z_sent, dt)  # [B, 1]
    e = torch.cat([e_img, e_sent], dim=-1).float()
    alpha = torch.softmax(e, dim=-1)
    context = (
        torch.einsum("bk,bkh->bh", alpha[:, :-1].to(dt), img_values.to(dt)).float()
        + alpha[:, -1:] * sentinel
    )
    return context, alpha


class AttnScoresFusedBwd(torch.autograd.Function):
    """(dt, w [H, 1], b [1] or None, img_k [B, k, H], h_emb [T, B, H]) ->
    e [T, B, k] in dt; on the CPU its forward is the decoder's default
    path's expression (``attn_scores_reference``), bit for bit. It saves the
    score params and the two inputs, never z: the backward computes dw, db,
    dimg_k and dh_emb from them in one pass (kernel H on a card,
    ``ops/kernels/attention.py``), so no ``[T, B, k, H]`` tensor is written
    on the card."""

    @staticmethod
    def forward(ctx, dt, w, b, img_k, h_emb):
        ctx.dt = dt
        ctx.save_for_backward(w, b, img_k, h_emb)
        return K.attn_scores(img_k, h_emb, w, b, dt)

    @staticmethod
    def backward(ctx, de):
        w, b, img_k, h_emb = ctx.saved_tensors
        dw, db, dk, dh = K.attn_scores_bwd(img_k, h_emb, w, b, de, ctx.dt)
        return None, dw, db, dk, dh


def attn_scores_fused_bwd(dt, score: Params, img_k: torch.Tensor,
                          h_emb: torch.Tensor) -> torch.Tensor:
    """e [T, B, k] for the score params ``{"w": [H, 1], "b": [1]}`` (``"b"``
    optional), through ``AttnScoresFusedBwd``."""
    return AttnScoresFusedBwd.apply(dt, score["w"], score.get("b"), img_k, h_emb)

"""Adaptive ("visual sentinel") attention forward; port of
``myimagecaptioningmodel_tpu/ops/attention.py::adaptive_attention``.

    z     = tanh(keys + hid_emb)       over the k image slots and the sentinel
    e     = z @ w_a + b_a
    alpha = softmax(e) over the k+1 slots
    ctx   = sum(alpha * values)

``parity_mode=True`` reproduces the reference's degenerate attention
(alpha == 1, context = mean over the k+1 slots).
"""

from __future__ import annotations

from typing import Tuple

import torch

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

"""Layer primitives on plain tensors with explicit param dicts.

Port of ``myimagecaptioningmodel_tpu/ops/layers.py`` (eval-mode subset).
Conventions kept from the reference so that tensor-level tests compare like
with like:

- dense weights are ``[in, out]``; a dense layer computes AND returns the
  compute dtype, with the bias added in that dtype;
- ``embed`` returns zeros for lookups of the padding id;
- both take int8 params (``ops/quantization.py``): ``dense`` multiplies the
  product by the per-output-channel scale, ``embed`` the gathered rows by
  their per-row scale;
- BN statistics are float32 and ``BN_EPS`` is 1e-5.

One deliberate layout difference: ``conv2d`` takes PyTorch's NCHW activations
and OIHW weights (``compat/from_jax.py`` converts HWIO). ``batch_norm`` takes
the channel axis as an argument for that reason.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from myimagecaptioningmodel_tpu_torch.ops.quantization import is_quantized

Params = Dict[str, Any]

BN_EPS = 1e-5


def dense(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W (+ b), computed and returned in ``compute_dtype``."""
    dt = compute_dtype
    if is_quantized(p):  # int8: the scale applies after the product, in dt
        y = torch.matmul(x.to(dt), p["w_q"].to(dt)) * p["scale"].to(dt)
    else:
        y = torch.matmul(x.to(dt), p["w"].to(dt))
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def embed(p: Params, ids: torch.Tensor, padding_idx: Optional[int] = 0) -> torch.Tensor:
    """Gather table rows; lookups of ``padding_idx`` return zeros."""
    if is_quantized(p):  # int8: float32 rows times their scale
        out = p["table_q"][ids].float() * p["scale"][ids].unsqueeze(-1)
    else:
        out = p["table"][ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def conv2d(
    w: torch.Tensor,  # [O, I/groups, kh, kw]
    x: torch.Tensor,  # [B, C, H, W]
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Convolution in ``compute_dtype``; ``groups=C`` is the depthwise conv."""
    return F.conv2d(
        x.to(compute_dtype), w.to(compute_dtype), None, stride, padding, 1, groups
    )


def batch_norm(
    p: Params, s: Params, x: torch.Tensor, channel_axis: int = -1
) -> torch.Tensor:
    """Eval-mode BN with the moving statistics: float32 arithmetic, result
    in ``x.dtype``. One ``F.batch_norm`` pass (mixed bf16 input / float32
    statistics on CUDA) instead of a chain of elementwise ops."""
    y = F.batch_norm(
        x.movedim(channel_axis, 1), s["mean"], s["var"], p["scale"], p["offset"],
        False, 0.0, BN_EPS,
    )
    return y.movedim(1, channel_axis)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)

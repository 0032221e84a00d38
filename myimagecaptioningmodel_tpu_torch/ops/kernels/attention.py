"""The batched attention scores of the LSTM training forward and their
backward (kernel H).

``attn_scores(img_k [B, k, H], h_emb [T, B, H], w [H, 1], b [1] or None, dt)``
returns ``e [T, B, k]`` in ``dt``,
``tanh(img_k[None] + h_emb[:, :, None]) @ w + b`` with float32 accumulation;
``attn_scores_bwd`` returns the gradients of ``e`` for a cotangent ``de``,
each computed as the JAX package's ``ops/attention.py::_attn_fused_bwd``
computes it: w, de and the inputs in ``dt``, ``dz = (de w) (1 - z^2)`` in
``dt``, the sums in float32, then cast to each primal's dtype. Together they
are ``ops/attention.attn_scores_fused_bwd``.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/attn_scores.cu`` (design and bound in that file's note): neither
writes a ``[T, B, k, H]`` tensor. On a CPU tensor each runs its plain
version, op by op as the JAX package writes it, which does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.ops.kernels import _build


def _z(img_k: torch.Tensor, h_emb: torch.Tensor, dt) -> torch.Tensor:
    """z [T, B, k, H] = tanh(img_k + h_emb) in ``dt``."""
    return torch.tanh(img_k[None].to(dt) + h_emb.to(dt)[:, :, None, :])


def attn_scores_reference(img_k, h_emb, w, b, dt) -> torch.Tensor:
    """Plain version of the forward, and the expression the decoder's default
    training path checkpoints (``models/decoder.teacher_forcing_logits``)."""
    score = {"w": w} if b is None else {"w": w, "b": b}
    return L.dense(score, _z(img_k, h_emb, dt), dt)[..., 0]


def attn_scores_bwd_reference(img_k, h_emb, w, b, de, dt):
    """Plain version of the backward -> (dw [H, 1], db [1] or None,
    dimg_k [B, k, H], dh_emb [T, B, H]), each in its primal's dtype."""
    f32 = torch.float32
    wd, ded = w[:, 0].to(dt), de.to(dt)
    z = _z(img_k, h_emb, dt)
    dw = torch.sum(z * ded[..., None], dim=(0, 1, 2), dtype=f32).reshape(-1, 1).to(w.dtype)
    db = None if b is None else torch.sum(ded, dtype=f32).reshape(1).to(b.dtype)
    dz = (ded[..., None] * wd) * (1.0 - torch.square(z))
    dh = torch.sum(dz, dim=2, dtype=f32).to(h_emb.dtype)
    dk = torch.sum(dz, dim=0, dtype=f32).to(img_k.dtype)
    return dw, db, dk, dh


def _operands(img_k, h_emb, w, dt):
    """The kernels' common operands in ``dt``, contiguous, and (T, B, K, H)."""
    if img_k.device.type != "cuda":
        raise ValueError(f"no kernel for device {img_k.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel H takes float32 or bfloat16, got {dt}")
    B, K, H = img_k.shape
    T = h_emb.shape[0]
    dev = img_k.device
    ik = img_k.to(dt).contiguous()
    he = h_emb.to(dt).contiguous()
    wd = w.reshape(-1).to(dt).contiguous()
    _build.require(he, "h_emb", dev, dt, (T, B, H))
    _build.require(wd, "w", dev, dt, (H,))
    return ik, he, wd, (T, B, K, H)


def _storage_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel H stores {name} as float32 or bfloat16, not {t.dtype}")
    return _build.dtype_code(t.dtype)


def attn_scores(img_k: torch.Tensor, h_emb: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor], dt) -> torch.Tensor:
    """e [T, B, k] in ``dt``. Launches kernel H's forward for CUDA tensors:
    float32 or bfloat16 compute, any T, B, k, H >= 1."""
    if img_k.device.type == "cpu":
        return attn_scores_reference(img_k, h_emb, w, b, dt)
    ik, he, wd, (T, B, K, H) = _operands(img_k, h_emb, w, dt)
    bd = None if b is None else b.reshape(-1).to(dt).contiguous()
    e = torch.empty((T, B, K), dtype=dt, device=ik.device)
    lib = _build.load_library()
    _build.check(lib.capk_attn_scores(
        _build.dtype_code(dt), T, B, K, H, ik.data_ptr(), he.data_ptr(), wd.data_ptr(),
        None if bd is None else bd.data_ptr(), e.data_ptr(), _build.stream_ptr(ik.device),
    ), "capk_attn_scores")
    attn_scores.launches += 1
    return e


attn_scores.launches = 0


def attn_scores_bwd(img_k: torch.Tensor, h_emb: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], de: torch.Tensor, dt
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(dw [H, 1], db [1] or None, dimg_k [B, k, H], dh_emb [T, B, H]), each in
    its primal's dtype. Launches kernel H's backward (one pass over the
    inputs, then dw's fixed-order sum over B and db's over the images; in
    bf16 with k > 64 also dh_emb's sum over the slot blocks) for CUDA
    tensors: two to four kernels, counted once in ``launches``."""
    if img_k.device.type == "cpu":
        return attn_scores_bwd_reference(img_k, h_emb, w, b, de, dt)
    ik, he, wd, (T, B, K, H) = _operands(img_k, h_emb, w, dt)
    dev = ik.device
    ded = de.to(dt).contiguous()
    _build.require(ded, "de", dev, dt, (T, B, K))
    dh = torch.empty((T, B, H), dtype=h_emb.dtype, device=dev)
    dk = torch.empty((B, K, H), dtype=img_k.dtype, device=dev)
    dw = torch.empty((H, 1), dtype=w.dtype, device=dev)
    db = None if b is None else torch.empty((1,), dtype=b.dtype, device=dev)
    lib = _build.load_library()
    code = _build.dtype_code(dt)
    part = torch.empty((lib.capk_attn_scores_bwd_scratch_rows(code, T, K), B, H),
                       dtype=torch.float32, device=dev)
    _build.check(lib.capk_attn_scores_bwd(
        code, T, B, K, H, ik.data_ptr(), he.data_ptr(), wd.data_ptr(),
        ded.data_ptr(), _storage_code(dh, "dh_emb"), dh.data_ptr(),
        _storage_code(dk, "dimg_k"), dk.data_ptr(), part.data_ptr(),
        _storage_code(dw, "dw"), dw.data_ptr(),
        0 if db is None else _storage_code(db, "db"), None if db is None else db.data_ptr(),
        _build.stream_ptr(dev),
    ), "capk_attn_scores_bwd")
    attn_scores_bwd.launches += 1
    return dw, db, dk, dh


attn_scores_bwd.launches = 0


def kernel_tanh(x: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' tanh of a CUDA bf16 tensor, before they round it:
    tanh.approx.f32 of each element, float32. For reading its error on the
    card; no kernel of the training path."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"kernel_tanh takes a CUDA bf16 tensor, got {x.dtype} on {x.device}")
    x = x.contiguous()
    t = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.check(_build.load_library().capk_attn_tanh_bf16(
        x.data_ptr(), t.data_ptr(), x.numel(), _build.stream_ptr(x.device)), "capk_attn_tanh_bf16")
    return t

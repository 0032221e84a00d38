"""Tied-vocab heads: argmax (greedy) and top-k + logsumexp (beam) over
``proj @ table^T (* scale) + bias``.

Port of ``myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py``. On a CUDA
tensor each wrapper launches its hand-written kernel: ``greedy_vocab_argmax``
the one of ``csrc/vocab_head.cu`` (kernel A), ``topk_vocab_head`` the one of
``csrc/topk_head.cu`` (kernel C). Both multiply on tensor cores (bf16 and
int8 tables) and keep the ``[B, V]`` logits out of device memory (design and
bounds in the files' notes). On a CPU tensor a wrapper runs its plain
version (``*_reference``).

Tables are float32, bfloat16, or int8 with a float32 per-row ``scale``
(``ops/quantization.py``). As in the TPU kernels, ``proj`` is rounded to the
table's dtype, or to bfloat16 for an int8 table whatever the compute dtype;
products accumulate in float32; then ``* scale`` and ``+ bias``, in that
order.

Ties go to the lowest index, as ``jnp.argmax`` and ``jax.lax.top_k`` do:
``topk_vocab_head`` returns ids sorted by value and then ascending index.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

TOPK_MAX_K = 32  # csrc/vocab_block.cuh's kMaxK


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of the last axis -> (values, int64 indices), sorted by value
    and then ascending index, as ``jax.lax.top_k`` orders ties
    (``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _head_dtype(table: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if table.dtype == torch.int8 else table.dtype


def head_logits_reference(proj, table, bias, scale=None) -> torch.Tensor:
    """Float32 ``[B, V]`` logits as the kernels compute them."""
    dt = _head_dtype(table)
    logits = torch.matmul(proj.to(dt).float(), table.to(dt).float().T)
    if scale is not None:
        logits = logits * scale
    return logits + bias


def greedy_vocab_argmax_reference(proj, table, bias, scale=None) -> torch.Tensor:
    """Plain version of kernel A -> int32 ``[B]``."""
    return torch.argmax(head_logits_reference(proj, table, bias, scale), dim=-1).to(torch.int32)


def topk_vocab_head_reference(proj, table, bias, k: int = 4, scale=None):
    """Plain version of kernel C -> (vals [B,k] f32, ids [B,k] int32, lse [B] f32)."""
    logits = head_logits_reference(proj, table, bias, scale)
    vals, ids = topk_stable(logits, k)
    return vals, ids.to(torch.int32), torch.logsumexp(logits, dim=-1)


def _check_operands(proj, table, bias, scale):
    """Validate CUDA operands -> (proj as contiguous float32, table dtype code)."""
    V, E = table.shape
    B = proj.shape[0]
    dev = proj.device
    proj = proj.float().contiguous()
    _build.require(proj, "proj", dev, torch.float32, (B, E))
    code = _build.dtype_code(table.dtype)
    _build.require(table, "table", dev, table.dtype, (V, E))
    _build.require(bias, "bias", dev, torch.float32, (V,))
    if (table.dtype == torch.int8) != (scale is not None):
        raise ValueError("an int8 table needs its float32 scale, and only it")
    if scale is not None:
        _build.require(scale, "scale", dev, torch.float32, (V,))
    if E % 8:
        raise ValueError(f"the kernels take E in multiples of 8, got {E}")
    return proj, code


@functools.lru_cache(maxsize=None)
def _topk_vocab_tile(lib) -> int:
    """Vocab rows of one tile of kernel C, read once from the library."""
    return lib.capk_topk_head_vocab_tile()


def argmax_vocab_tile(rows: int) -> int:
    """Vocab rows of one tile of kernel A for ``rows`` batch rows, read from
    the library."""
    return _build.load_library().capk_vocab_argmax_vocab_tile(rows)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def greedy_vocab_argmax(
    proj: torch.Tensor,  # [B, E]
    table: torch.Tensor,  # [V, E] float32, bfloat16 or int8
    bias: torch.Tensor,  # [V] float32
    scale: Optional[torch.Tensor] = None,  # [V] float32, for an int8 table
) -> torch.Tensor:
    """-> int32 [B] ids. Launches kernel A for CUDA tensors."""
    if proj.device.type == "cpu":
        return greedy_vocab_argmax_reference(proj, table, bias, scale)
    if proj.device.type != "cuda":
        raise ValueError(f"no kernel for device {proj.device}")
    proj, code = _check_operands(proj, table, bias, scale)
    (B, E), V, dev = proj.shape, table.shape[0], proj.device
    lib = _build.load_library()
    nblk = lib.capk_vocab_argmax_nblocks(V)
    part_v = torch.empty((B, nblk), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, nblk), dtype=torch.int32, device=dev)
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.capk_vocab_argmax(
        code, B, V, E, proj.data_ptr(), table.data_ptr(), bias.data_ptr(), _ptr(scale),
        part_v.data_ptr(), part_i.data_ptr(), out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "capk_vocab_argmax")
    greedy_vocab_argmax.launches += 1
    return out


greedy_vocab_argmax.launches = 0


def topk_vocab_head(
    proj: torch.Tensor,  # [B, E]
    table: torch.Tensor,  # [V, E] float32, bfloat16 or int8
    bias: torch.Tensor,  # [V] float32
    k: int = 4,
    scale: Optional[torch.Tensor] = None,  # [V] float32, for an int8 table
    skip: Optional[torch.Tensor] = None,  # [1] int32 device flag
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (vals [B,k] f32 raw logits, ids [B,k] int32, lse [B] f32); the
    log-softmax of pick i is ``vals[:, i] - lse``. Launches kernel C for CUDA
    tensors; with ``skip`` its kernels return at once, their outputs left
    unwritten, when the flag is set on the device (the LSTM beam search's
    early stop). ``1 <= k <= TOPK_MAX_K`` and ``k <= V`` on every device."""
    V = table.shape[0]
    if not 1 <= k <= min(TOPK_MAX_K, V):
        raise ValueError(f"topk_vocab_head takes 1 <= k <= {TOPK_MAX_K} and k <= V={V}, "
                         f"got k={k}")
    if proj.device.type == "cpu":
        return topk_vocab_head_reference(proj, table, bias, k, scale)
    if proj.device.type != "cuda":
        raise ValueError(f"no kernel for device {proj.device}")
    proj, code = _check_operands(proj, table, bias, scale)
    (B, E), dev = proj.shape, proj.device
    if skip is not None:
        _build.require(skip, "skip", dev, torch.int32, (1,))
    lib = _build.load_library()
    nvt = -(-V // _topk_vocab_tile(lib))
    # one int32 buffer: part_v, part_i [B, nvt, k], part_m, part_s [B, nvt],
    # then vals, ids [B, k] and lse [B]; the floats are its bits
    sizes = [B * nvt * k] * 2 + [B * nvt] * 2 + [B * k] * 2 + [B]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    part_v, part_i, part_m, part_s, vals, ids, lse = torch.split(buf, sizes)
    err = lib.capk_topk_head(
        code, B, V, E, k, proj.data_ptr(), table.data_ptr(), bias.data_ptr(), _ptr(scale),
        part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), lse.data_ptr(), _ptr(skip), _build.stream_ptr(dev),
    )
    _build.check(err, "capk_topk_head")
    topk_vocab_head.launches += 1
    f32 = torch.float32
    return vals.view(f32).view(B, k), ids.view(B, k), lse.view(f32)


topk_vocab_head.launches = 0

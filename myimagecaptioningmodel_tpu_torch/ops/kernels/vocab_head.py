"""Greedy tied-vocab head: argmax over ``proj @ table^T + bias``.

Port of ``myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py::
greedy_vocab_argmax``. On a CUDA tensor the wrapper launches the hand-written
kernel of ``csrc/vocab_head.cu`` (design and bounds in that file's note: a
split-vocab tiled product with a fused (max, index) reduction, then a
per-row combine; only ``[B]`` ids reach device memory). On a CPU tensor it
runs ``greedy_vocab_argmax_reference``, the plain version of the same math.

Ties go to the lowest index, as ``jnp.argmax`` does. int8 tables (the TPU
kernel's ``scale`` argument) are not ported yet.
"""

from __future__ import annotations

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import _build


def greedy_vocab_argmax_reference(
    proj: torch.Tensor, table: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``proj`` rounded to the table's dtype, float32 product."""
    logits = torch.matmul(proj.to(table.dtype).float(), table.float().T) + bias
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_vocab_argmax(
    proj: torch.Tensor,  # [B, E]
    table: torch.Tensor,  # [V, E] float32 or bfloat16
    bias: torch.Tensor,  # [V] float32
) -> torch.Tensor:
    """-> int32 [B] ids. Launches the CUDA kernel for CUDA tensors."""
    if proj.device.type == "cpu":
        return greedy_vocab_argmax_reference(proj, table, bias)
    if proj.device.type != "cuda":
        raise ValueError(f"no kernel for device {proj.device}")
    V, E = table.shape
    B = proj.shape[0]
    dev = proj.device
    proj = proj.float().contiguous()
    _build.require(proj, "proj", dev, torch.float32, (B, E))
    _build.require(table, "table", dev, table.dtype, (V, E))
    _build.require(bias, "bias", dev, torch.float32, (V,))
    if E % 8:
        raise ValueError(f"the kernel takes E in multiples of 8, got {E}")
    lib = _build.load_library()
    nblk = lib.capk_vocab_argmax_nblocks(V)
    part_v = torch.empty((B, nblk), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, nblk), dtype=torch.int32, device=dev)
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.capk_vocab_argmax(
        _build.dtype_code(table.dtype), B, V, E, proj.data_ptr(),
        table.data_ptr(), bias.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "capk_vocab_argmax")
    greedy_vocab_argmax.launches += 1
    return out


greedy_vocab_argmax.launches = 0

"""1x1 convolution as a matrix product, with the batch-norm statistics of its
output taken in the same pass (kernel F).

Port of ``myimagecaptioningmodel_tpu/ops/pallas/matmul_bn.py``.
``matmul_stats(x [M, K], w [K, N])`` returns ``y = x @ w`` (float32
accumulation, stored in the input dtype) and the per-column ``sum`` and
``sumsq`` of the *stored, rounded* ``y`` in float32, which is what the
unfused train-mode BN computes from the materialized conv output. On a CUDA
tensor it launches the hand-written kernel of ``csrc/matmul_bn.cu`` (design
and bound in that file's note); on a CPU tensor it runs
``_matmul_stats_reference``, the plain version.

``conv1x1_bn_train`` is the reference's train-mode 1x1 conv + BN over an
NHWC batch, with its hand-written backward: the BN backward of
``ops/layers.bn_backward`` applied to the conv output, then the two matrix
products a 1x1-conv backward is. The backward is plain PyTorch, as the JAX
package leaves it to XLA. Inside a process group the statistics are the
global batch's (``ops/layers.py``): kernel F's sums are all-reduced, and F
itself is unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
from myimagecaptioningmodel_tpu_torch.parallel import distributed


def _matmul_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """Plain version of kernel F: the product accumulated in float32
    (float64 for float64 inputs), rounded to ``x.dtype``, then both sums over
    the rounded values -> (y [M, N], sum [N], sumsq [N])."""
    acc = L.stat_dtype(x)
    y = torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)
    yf = y.to(acc)
    return y, yf.sum(0), (yf * yf).sum(0)


def matmul_stats(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [M, N] in x.dtype, sum [N] f32, sumsq [N] f32) in one output pass.
    Launches kernel F for CUDA tensors: float32 or bfloat16, contiguous, any
    M, K, N >= 1."""
    if x.device.type == "cpu":
        return _matmul_stats_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    M, K = x.shape
    N = w.shape[1]
    dev, dt = x.device, x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel F takes float32 or bfloat16, got {dt}")
    code = _build.dtype_code(dt)
    _build.require(x, "x", dev, dt, (M, K))
    _build.require(w, "w", dev, dt, (K, N))
    if min(M, K, N) < 1:
        raise ValueError(f"kernel F takes M, K, N >= 1, got {M, K, N}")
    lib = _build.load_library()
    rows = lib.capk_matmul_stats_partial_rows(code, M, K, N)
    if rows < 1:
        raise RuntimeError(f"capk_matmul_stats_partial_rows failed for {M, K, N}")
    y = torch.empty((M, N), dtype=dt, device=dev)
    # [sum, sumsq] then the partial rows of each, in one float32 buffer
    buf = torch.empty(2 * (rows + 1) * N, dtype=torch.float32, device=dev)
    p, n4 = buf.data_ptr(), N * 4
    _build.check(lib.capk_matmul_stats(
        code, M, K, N, x.data_ptr(), w.data_ptr(), y.data_ptr(), p + 2 * n4,
        p + (2 + rows) * n4, rows, p, p + n4, _build.stream_ptr(dev),
    ), "capk_matmul_stats")
    matmul_stats.launches += 1
    return y, buf[:N], buf[N:2 * N]


matmul_stats.launches = 0


def row_tile() -> int:
    """Rows of one tile of kernel F, as the built library reports them."""
    return _build.load_library().capk_matmul_stats_row_tile()


class _Conv1x1BN(torch.autograd.Function):
    """(w [K, N], scale, offset, x_flat [M, K]) -> (normalized y [M, N] in
    x's dtype, batch mean [N], batch var [N]); the same triple as conv +
    ``layers._BNTrain``, with the statistics read folded into the product."""

    @staticmethod
    def forward(ctx, w, scale, offset, x_flat):
        y, s, q = matmul_stats(x_flat, w)
        # in a process group, the global batch's sums: kernel F's per-rank
        # sums all-reduced over the data group before the mean and variance
        s, q = L.global_sums(s, q)
        mean, var = L.batch_stats(s, q, x_flat.shape[0] * distributed.data_size())
        yn, inv = L.bn_normalize(y, mean, var, scale, offset)
        ctx.save_for_backward(w, scale, x_flat, y, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return yn, mean, var

    @staticmethod
    def backward(ctx, dyn, _dmean, _dvar):
        w, scale, x_flat, y, mean, inv = ctx.saved_tensors
        dy_conv, dscale, doffset = L.bn_backward(dyn, y, mean, inv, scale)
        dy_conv = dy_conv.to(x_flat.dtype)
        # a 1x1-conv backward is two matrix products
        dw = torch.matmul(x_flat.t(), dy_conv).to(w.dtype)
        dx = torch.matmul(dy_conv, w.t()).to(x_flat.dtype)
        return dw, dscale, doffset, dx


def conv1x1_bn_train(w: torch.Tensor, bn_p, x: torch.Tensor, compute_dtype):
    """Fused train-mode 1x1 conv + BN over an NHWC batch.

    ``w`` is the OIHW ``[Cout, Cin, 1, 1]`` weight. -> (normalized output
    [B, H, W, Cout] in the compute dtype, batch mean, batch var), the triple
    the unfused ``conv2d`` + ``batch_norm_train`` produces, for the caller's
    moving-statistics update."""
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    dt = compute_dtype
    x_flat = x.to(dt).reshape(-1, Cin)
    w_kn = w.reshape(Cout, Cin).t().to(dt).contiguous()
    yn, mean, var = _Conv1x1BN.apply(w_kn, bn_p["scale"], bn_p["offset"], x_flat.contiguous())
    return yn.reshape(B, H, W, Cout), mean, var

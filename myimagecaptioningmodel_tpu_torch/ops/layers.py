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

Train-mode BN (``batch_norm_train``) is the reference's ``_bn_train``: one
pass of float32 statistics (float64 for float64 inputs), ``E[x^2] - mean^2``
clamped at 0, the *biased* variance, and a backward written by hand in two
passes over (x, dy), with the layer's ReLU6 (``act``) inside the normalize
pass and its gradient inside the backward's. The four passes are kernel I
(``ops/kernels/batch_norm.py``) on a CUDA tensor and its plain versions on
the CPU. The moving statistics keep ``BN_MOMENTUM`` of the old
value (``nn.BatchNorm2d``'s momentum and unbiased running variance differ).
With ``stat_rows`` it is the reference's subset-statistics BN
(``_bn_train_subset``, ``model.bn_stat_rows``): statistics from the first R
rows, no gradient through them, dscale and doffset from the R rows scaled
by B / R.

Inside a process group (``parallel/distributed.py``) the train-mode BN is
the JAX package's under a sharded batch: its statistics are those of the
GLOBAL batch, the rows of every process in rank order. Each process
all-reduces its per-channel sums (Σx and Σx² forward, Σdy and Σdy·x̂
backward, one all-reduce each) before it divides by the global count; the
subset BN takes the first R rows of the global batch. The parameter
gradients a BN backward returns stay this rank's share (the train step's
gradient all-reduce sums them), and the moving statistics come from the
global statistics, so every rank holds the same bits. In one process, or
a group of one, the arithmetic is the plain path's, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from myimagecaptioningmodel_tpu_torch.ops.kernels import batch_norm as KBN
from myimagecaptioningmodel_tpu_torch.ops.quantization import is_quantized
from myimagecaptioningmodel_tpu_torch.parallel import distributed

Params = Dict[str, Any]

BN_MOMENTUM = 0.9  # Paddle batch_norm default
BN_EPS = KBN.BN_EPS
stat_dtype = KBN.stat_dtype


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
    statistics on CUDA) instead of a chain of elementwise ops. A float64 ``x``
    beside float32 statistics (a float64 bundle's encoder) is normalized in
    float32 too, as the JAX package's eval BN does."""
    if x.dtype == torch.float64 and s["mean"].dtype != torch.float64:
        return batch_norm(p, s, x.float(), channel_axis).double()
    y = F.batch_norm(
        x.movedim(channel_axis, 1), s["mean"], s["var"], p["scale"], p["offset"],
        False, 0.0, BN_EPS,
    )
    return y.movedim(1, channel_axis)


class _ReLU6(torch.autograd.Function):
    """``clamp(x, 0, 6)`` with the reference's gradient: ``jnp.clip`` is
    ``minimum(maximum(x, 0), 6)``, whose gradient at x == 0 or x == 6 is 1/2
    (``torch.clamp``'s is 1). A tie is a BN output equal to its offset where
    the channel is constant, as dead channels are at init (offset 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        # 1 inside (0, 6), 1/2 at either end, 0 outside; x - 6 is exact near 6
        return (torch.sign(x) - torch.sign(x - 6.0)) * (0.5 * dy)


def relu6(x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _ReLU6.apply(x)
    return torch.clamp(x, 0.0, 6.0)


# ---- train-mode batch norm ----------------------------------------------------


def init_batch_norm(num_ch: int) -> Tuple[Params, Params]:
    """(params, state): scale 1 / offset 0, moving mean 0 / var 1."""
    return ({"scale": torch.ones(num_ch), "offset": torch.zeros(num_ch)},
            {"mean": torch.zeros(num_ch), "var": torch.ones(num_ch)})


def global_sums(*sums: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-channel sums of this process -> their sums over its data group
    (one all-reduce for all of them; under vocab tensor parallelism the
    ranks of a model group hold the same rows, which must count once);
    themselves outside a group."""
    if not distributed.active():
        return sums
    flat = distributed.all_reduce_sum_(torch.cat(sums), distributed.data_group())
    return tuple(flat.split([t.numel() for t in sums]))


class _BNTrain(torch.autograd.Function):
    """(scale, offset, channel-last x[, act]) -> (y, batch mean, batch var),
    with ``act`` the layer's ReLU6 inside the normalize pass and its
    gradient inside the backward's (kernel I's four passes, module
    docstring)."""

    @staticmethod
    def forward(ctx, scale, offset, x, act=False):
        x2 = KBN.rows_of(x, "x")
        m = x.numel() // x.shape[-1]
        s, q = global_sums(*KBN.bn_stats(x2, m))
        n = m * distributed.data_size()
        y, mean, var = KBN.bn_apply(x2, s, q, n, scale, offset, act)
        ctx.save_for_backward(scale, offset, x, mean, var)
        ctx.n, ctx.act = n, act
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        scale, offset, x, mean, var = ctx.saved_tensors
        x2, dy2 = KBN.rows_of(x), KBN.rows_of(dy, "dy")
        doffset, dscale = KBN.bn_grad_sums(dy2, x2, mean, var, scale, offset,
                                           x.numel() // x.shape[-1], ctx.act)
        g_off, g_sc = global_sums(doffset, dscale)  # dx takes the global sums
        dx = KBN.bn_dx(dy2, x2, mean, var, scale, offset, g_off, g_sc, ctx.n, ctx.act, True)
        return dscale.to(scale.dtype), doffset.to(scale.dtype), dx.view(x.shape), None


class _BNTrainSubset(torch.autograd.Function):
    """The reference's ``_bn_train_subset``: (scale, offset, channel-last x,
    R[, act]) -> (y, mean, var) with the statistics of the first R rows of
    the leading axis of the global batch (this rank's rows among them; a
    rank whose rows all lie past R adds zeros), every row normalized with
    them. The backward treats the statistics as constants: dx = dy′ * scale
    * inv elementwise, and dscale, doffset are this rank's sums over its
    rows among the R, times the global B / R. Without ``act`` only those
    rows of x are saved."""

    @staticmethod
    def forward(ctx, scale, offset, x, stat_rows, act=False):
        b = x.shape[0]
        rows = min(max(stat_rows - distributed.data_index() * b, 0), b)
        x2 = KBN.rows_of(x, "x")
        per = x[0].numel() // x.shape[-1]  # rows of [M, C] an image
        s, q = global_sums(*KBN.bn_stats(x2, rows * per))
        y, mean, var = KBN.bn_apply(x2, s, q, stat_rows * per, scale, offset, act)
        # without act a copy of the R rows: a view of x[:rows] would keep
        # all B rows alive until backward; with act dx reads every row of x
        ctx.save_for_backward(scale, offset, x if act else x[:rows].clone(), mean, var)
        ctx.rows, ctx.act = rows * per, act
        ctx.ratio = b * distributed.data_size() / stat_rows
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        scale, offset, xs, mean, var = ctx.saved_tensors
        x2, dy2 = KBN.rows_of(xs), KBN.rows_of(dy, "dy")
        doffset, dscale = KBN.bn_grad_sums(dy2, x2, mean, var, scale, offset, ctx.rows,
                                           ctx.act, ctx.ratio)
        dx = KBN.bn_dx(dy2, x2 if ctx.act else None, mean, var, scale, offset, None, None,
                       1, ctx.act, False)
        return (dscale.to(scale.dtype), doffset.to(scale.dtype), dx.view(dy.shape), None,
                None)


def moving_update(s: Params, mean: torch.Tensor, var: torch.Tensor) -> Params:
    """New moving statistics: ``BN_MOMENTUM * old + (1 - BN_MOMENTUM) * batch``."""
    return {"mean": BN_MOMENTUM * s["mean"] + (1.0 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * s["var"] + (1.0 - BN_MOMENTUM) * var}


def batch_norm_train(p: Params, s: Params, x: torch.Tensor, stat_rows: int = 0,
                     act: bool = False) -> Tuple[torch.Tensor, Params]:
    """Train-mode BN over all but the last (channel) axis of ``x`` ->
    (y in ``x.dtype``, new moving statistics). ``0 < stat_rows < B`` (B the
    global batch in a process group) takes the statistics from the first
    ``stat_rows`` rows (``_BNTrainSubset``); otherwise the exact BN, as the
    reference's ``batch_norm``. ``act``: ``relu6`` of the output, with the
    reference's gradient, inside the BN's own passes."""
    if 0 < stat_rows < x.shape[0] * distributed.data_size():
        y, mean, var = _BNTrainSubset.apply(p["scale"], p["offset"], x, stat_rows, act)
    else:
        y, mean, var = _BNTrain.apply(p["scale"], p["offset"], x, act)
    return y, moving_update(s, mean, var)

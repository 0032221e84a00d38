"""MobileNetV2 encoder; port of
``myimagecaptioningmodel_tpu/models/mobilenet_v2.py``.

Same architecture and parameter names: conv3x3 s2, then the inverted-residual
stages of ``BOTTLENECK_PARAMS``, then a 1x1 conv to 1280 channels, BN after
every conv, ReLU6. Input and output are NHWC like the reference's.

Two forwards:

- ``MobileNetV2``, the serving module (eval mode): activations are NCHW
  tensors inside, kept in channels-last memory on CUDA; BN uses the moving
  statistics (buffers), so features are per-image; no gradient.
- ``apply``, the reference's functional ``apply`` on a (params, state) tree
  whose conv weights are OIHW (``compat/from_jax.train_tree``): in train
  mode BN normalizes with batch statistics and the new moving statistics
  come back as a new state tree, as in the reference. Activations are NHWC
  views of channels-last memory. ``trainable=False`` detaches the params
  (no gradient) while the moving statistics still update.
  ``fuse_bn_stats`` sends every stride-1 1x1 conv through kernel F
  (``ops/kernels/matmul_bn.conv1x1_bn_train``), under the reference's
  condition; ``bn_stat_rows`` > 0 takes the other convs' BN statistics from
  the first rows (``layers.batch_norm_train``), as the reference does.
  Each train-mode BN takes its ReLU6 into its own passes (kernel I on a
  card, ``ops/kernels/batch_norm.py``).
  ``use_fused_irb`` (eval mode only) folds BN into every conv and runs each
  of the 17 inverted-residual blocks as kernel G
  (``ops/kernels/fused_irb.fused_inverted_residual``) on NHWC activations;
  the state comes back unchanged.

``init`` builds the reference's parameter pytree (HWIO conv weights, BN
params and state) from a ``torch.Generator``; ``MobileNetV2.load`` takes that
layout through ``compat/from_jax.py``'s conversion.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from myimagecaptioningmodel_tpu_torch.ops import layers as L

# (expansion t, channels c, repeats n, stride s) — as the reference's table
BOTTLENECK_PARAMS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def layer_specs(scale: float = 1.0) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """(name, in_ch, out_ch, kernel, stride, groups) for every conv+BN, in
    order — the reference's layer names and shapes."""
    yield "conv1_1", 3, int(32 * scale), 3, 2, 1
    in_c = int(32 * scale)
    for stage, (t, c, n, s) in enumerate(BOTTLENECK_PARAMS, start=2):
        c = int(c * scale)
        for i in range(1, n + 1):
            name = f"conv{stage}_{i}"
            exp = int(round(in_c * t))
            yield name + "_expand", in_c, exp, 1, 1, 1
            yield name + "_dwise", exp, exp, 3, (s if i == 1 else 1), exp
            yield name + "_linear", exp, c, 1, 1, 1
            in_c = c
    yield "conv9", in_c, (int(1280 * scale) if scale > 1.0 else 1280), 1, 1, 1


def init(generator: torch.Generator, scale: float = 1.0):
    """(params, state) in the reference layout: Xavier-uniform HWIO conv
    weights, BN scale 1 / offset 0, moving mean 0 / var 1."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for name, cin, cout, k, _stride, groups in layer_specs(scale):
        fan_in = k * k * cin // groups
        fan_out = k * k * cout // groups
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        w = torch.empty((k, k, cin // groups, cout)).uniform_(-lim, lim, generator=generator)
        params[name] = {
            "conv": {"w": w},
            "bn": {"scale": torch.ones(cout), "offset": torch.zeros(cout)},
        }
        state[name] = {"bn": {"mean": torch.zeros(cout), "var": torch.ones(cout)}}
    return params, state


class ConvBN(nn.Module):
    """Conv (OIHW weight) + eval-mode BN (+ ReLU6)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, groups: int,
                 act: bool) -> None:
        super().__init__()
        self.stride, self.padding, self.groups, self.act = stride, (k - 1) // 2, groups, act
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.offset = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x: torch.Tensor, compute_dtype) -> torch.Tensor:
        x = L.conv2d(self.weight, x, self.stride, self.padding, self.groups, compute_dtype)
        x = L.batch_norm(
            {"scale": self.scale, "offset": self.offset},
            {"mean": self.mean, "var": self.var}, x, channel_axis=1,
        )
        return L.relu6(x) if self.act else x


class MobileNetV2(nn.Module):
    """Eval-mode MobileNetV2 x``scale``: NHWC [B, H, W, 3] -> NHWC
    [B, H/32, W/32, 1280]."""

    def __init__(self, scale: float = 1.0) -> None:
        super().__init__()
        self.scale = scale
        self.layers = nn.ModuleDict()
        for name, cin, cout, k, stride, groups in layer_specs(scale):
            act = not name.endswith("_linear")
            self.layers[name] = ConvBN(cin, cout, k, stride, groups, act)
        self.eval()

    @torch.no_grad()
    def load(self, params: Dict[str, Any], state: Dict[str, Any]) -> "MobileNetV2":
        """Copy a reference-layout (params, state) pytree in: HWIO -> OIHW."""
        from myimagecaptioningmodel_tpu_torch.compat.from_jax import conv_hwio_to_oihw

        def t(x):
            return torch.from_numpy(np.array(x, dtype=np.float32))

        for name, layer in self.layers.items():
            p, s = params[name], state[name]["bn"]
            layer.weight.copy_(t(conv_hwio_to_oihw(p["conv"]["w"])))
            layer.scale.copy_(t(p["bn"]["scale"]))
            layer.offset.copy_(t(p["bn"]["offset"]))
            layer.mean.copy_(t(s["mean"]))
            layer.var.copy_(t(s["var"]))
        return self

    @torch.no_grad()
    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        layers = self.layers
        x = layers["conv1_1"](x, compute_dtype)
        for stage, (_t, _c, n, _s) in enumerate(BOTTLENECK_PARAMS, start=2):
            for i in range(1, n + 1):
                name = f"conv{stage}_{i}"
                residual = x
                x = layers[name + "_expand"](x, compute_dtype)
                x = layers[name + "_dwise"](x, compute_dtype)
                x = layers[name + "_linear"](x, compute_dtype)
                if i > 1:  # shortcut on non-first blocks of a stage
                    x = x + residual
        x = layers["conv9"](x, compute_dtype)
        return x.permute(0, 2, 3, 1).contiguous()  # NHWC


# ---- functional forward (training) ---------------------------------------------


def _apply_conv_bn(p, s, x, stride: int, padding: int, groups: int, act: bool,
                   train: bool, compute_dtype, fuse_bn_stats: bool, bn_stat_rows: int = 0):
    """conv + BN (+ ReLU6) on NHWC ``x`` -> (y NHWC, {"bn": new state}); a conv
    through kernel F keeps full-batch statistics whatever ``bn_stat_rows``."""
    w = p["conv"]["w"]  # OIHW
    if (fuse_bn_stats and train and groups == 1 and stride == 1 and padding == 0
            and w.shape[2] == 1 and w.shape[3] == 1):
        from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB

        x, mean, var = MB.conv1x1_bn_train(w, p["bn"], x, compute_dtype, act)
        return x, {"bn": L.moving_update(s["bn"], mean, var)}
    x = L.conv2d(w, x.permute(0, 3, 1, 2), stride, padding, groups,
                 compute_dtype).permute(0, 2, 3, 1)
    if train:  # the ReLU6 inside the BN's passes (kernel I on a card)
        x, bn_s = L.batch_norm_train(p["bn"], s["bn"], x, bn_stat_rows, act)
        return x, {"bn": bn_s}
    x = L.batch_norm(p["bn"], s["bn"], x, channel_axis=-1)
    return (L.relu6(x) if act else x), {"bn": s["bn"]}


def apply(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
          train: bool = True, trainable: bool = True, scale: float = 1.0,
          compute_dtype=torch.bfloat16, fuse_bn_stats: bool = False,
          use_fused_irb: bool = False, bn_stat_rows: int = 0):
    """NHWC [B, H, W, 3] -> (NHWC [B, H/32, W/32, 1280] features, new state).
    ``bn_stat_rows`` (train mode): the subset-statistics BN
    (``layers.batch_norm_train``) on every conv that kernel F does not take."""
    if use_fused_irb and not train:
        return _apply_fused_eval(params, state, x, compute_dtype)
    if not trainable:  # the reference's per-call stop_gradient
        params = {name: {k: {n: t.detach() for n, t in leaf.items()} for k, leaf in p.items()}
                  for name, p in params.items()}
    if x.is_cuda:  # NHWC contiguous == NCHW in channels-last memory
        x = x.contiguous()
    new_state: Dict[str, Any] = {}

    def conv_bn(name, x, stride, padding, groups=1, act=True):
        y, new_state[name] = _apply_conv_bn(
            params[name], state[name], x, stride, padding, groups, act, train,
            compute_dtype, fuse_bn_stats, bn_stat_rows,
        )
        return y

    x = conv_bn("conv1_1", x, 2, 1)
    in_c = int(32 * scale)
    for stage, (t, c, n, s) in enumerate(BOTTLENECK_PARAMS, start=2):
        c = int(c * scale)
        for i in range(1, n + 1):
            name = f"conv{stage}_{i}"
            exp = int(round(in_c * t))
            residual = x
            x = conv_bn(name + "_expand", x, 1, 0)
            x = conv_bn(name + "_dwise", x, s if i == 1 else 1, 1, groups=exp)
            x = conv_bn(name + "_linear", x, 1, 0, act=False)
            if i > 1:  # shortcut on non-first blocks of a stage
                x = x + residual
            in_c = c
    x = conv_bn("conv9", x, 1, 0)
    return x, new_state


def _apply_fused_eval(params: Dict[str, Any], state: Dict[str, Any], x: torch.Tensor,
                      compute_dtype):
    """Eval forward with BN folded into every conv and each inverted-residual
    block as kernel G -> (features, the state unchanged). ``conv1_1`` and
    ``conv9`` are folded convs with a float32 bias, outside the kernel, as in
    the reference. Every block keeps its expanded tensor in the compute
    dtype, the rounding of the reference's chain kernel (which runs 12 of the
    17 blocks at 224 px); the reference's chain layout and its 8 <= H <= 56
    gate are TPU workarounds with no counterpart here. Each block's weights
    are folded and cast once (``prepare_irb``), and the blocks share one
    scratch for kernel G's Cexp-split partials."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    dt = compute_dtype

    def conv_bn_eval(name, x, stride, padding):
        wf, bf = FI.fold_bn(params[name]["conv"]["w"], params[name]["bn"], state[name]["bn"])
        y = L.conv2d(wf, x.permute(0, 3, 1, 2), stride, padding, 1, dt).permute(0, 2, 3, 1)
        return L.relu6((y.float() + bf).to(dt))

    x = conv_bn_eval("conv1_1", x.to(dt), 2, 1).contiguous()
    scratch = FI.SplitScratch()  # the Cexp-split partials of every block
    for stage, (_t, _c, n, s) in enumerate(BOTTLENECK_PARAMS, start=2):
        for i in range(1, n + 1):
            name = f"conv{stage}_{i}"
            folded = FI.fold_irb({k: params[f"{name}_{k}"] for k in ("expand", "dwise", "linear")},
                                 {k: state[f"{name}_{k}"] for k in ("expand", "dwise", "linear")})
            x = FI.fused_inverted_residual(x, FI.prepare_irb(folded, dt, scratch),
                                           s if i == 1 else 1, shortcut=i > 1,
                                           round_expanded=True)
    return conv_bn_eval("conv9", x, 1, 0), state

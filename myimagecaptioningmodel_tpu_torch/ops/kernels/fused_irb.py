"""Eval-mode MobileNetV2 inverted-residual block with batch norm folded into
its convolutions, as one kernel (kernel G).

Port of ``myimagecaptioningmodel_tpu/ops/pallas/fused_irb.py``: 1x1 expand,
ReLU6, 3x3 depthwise at stride 1 or 2, ReLU6, 1x1 project, and the residual
on stride-1 blocks with as many output as input channels. The expanded
tensor (6x the block's input channels) never reaches device memory.

- ``fold_bn`` / ``fold_irb`` fold the eval-mode BN into the weights. The
  port's encoder tree is OIHW (``compat/from_jax.train_tree``), so
  ``fold_irb`` maps the expand and project weights ``[O, I, 1, 1]`` to
  ``[I, O]`` and the depthwise ``[Cexp, 1, 3, 3]`` to ``wd[dy * 3 + dx, c]``,
  the layout of the JAX package's ``FoldedIRB``.
- ``prepare_irb`` casts a block's weights once into the kernel's operands
  (``PreparedIRB``: ``FoldedIRB``'s layout, the products' weights in the
  activation dtype, the biases flat float32), with an optional
  ``SplitScratch`` that every block of one forward shares for the Cexp-split
  partials. The wrappers take a ``PreparedIRB`` or a ``FoldedIRB`` (prepared
  on every call).
- ``fused_inverted_residual`` takes NHWC activations; ``fused_irb_chain``
  takes and gives the JAX package's chain layout ``[B, H + 2, W_pad,
  C_pad128]`` (one zero row above and below, zero W tail and channel pad).
  On CUDA tensors both launch the kernel of ``csrc/fused_irb.cu`` (design
  and bound in its note); on CPU tensors they run the plain versions
  ``fused_inverted_residual_reference`` and ``fused_irb_chain_reference``.
- ``reference_irb`` is the JAX package's XLA block (every intermediate in
  the activation dtype, biases added in it), for the tests.

Rounding points, as the TPU kernels: the expand product accumulates in
float32, adds the float32 bias, applies ReLU6; outside the image the
expanded value is 0 (not ``relu6(be)``). ``fused_inverted_residual`` keeps
the expanded tensor in float32, the chain entry (and the encoder's fused
path, ``round_expanded=True``) rounds it to the activation dtype. The
depthwise accumulates in float32, adds its bias, applies ReLU6 and rounds
to the activation dtype; the project product accumulates in float32, adds
its bias and the residual in float32 and rounds once.

Any B >= 1, any H and W, any Cin, Cexp and Cout (MobileNetV2 x0.35's 5,
11, 22, ... too), stride 1 or 2 (output ``(H - 1) // stride + 1`` rows, as
a padded convolution gives). The
TPU kernel's VMEM row tile (``_pick_row_tile``) and its 128-lane channel
padding inside the plain entry have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.ops.kernels import _build


class FoldedIRB(NamedTuple):
    """BN-folded eval weights of one inverted-residual block."""

    we: torch.Tensor  # [Cin, Cexp] expand 1x1
    be: torch.Tensor  # [1, Cexp]
    wd: torch.Tensor  # [9, Cexp] 3x3 depthwise, (dy * 3 + dx) major
    bd: torch.Tensor  # [1, Cexp]
    wp: torch.Tensor  # [Cexp, Cout] project 1x1
    bp: torch.Tensor  # [1, Cout]


class SplitScratch:
    """The float32 scratch of kernel G's Cexp-split partials, shared by the
    calls of one call site (every block of one encoder forward): allocated
    on first need and grown, never per block."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None

    def get(self, numel: int, device) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < numel or self.buf.device != device:
            self.buf = torch.empty(numel, dtype=torch.float32, device=device)
        return self.buf[:numel]


class PreparedIRB(NamedTuple):
    """One block's weights as kernel G takes them (``prepare_irb``):
    ``FoldedIRB``'s layout, the products' weights in the activation dtype,
    the biases flat."""

    we: torch.Tensor  # [Cin, Cexp] in the activation dtype
    be: torch.Tensor  # [Cexp] float32 (float64 for float64 activations)
    wd: torch.Tensor  # [9, Cexp] float32
    bd: torch.Tensor  # [Cexp]
    wp: torch.Tensor  # [Cexp, Cout] in the activation dtype
    bp: torch.Tensor  # [Cout]
    scratch: Optional[SplitScratch] = None


def prepare_irb(folded: FoldedIRB, dtype: torch.dtype,
                scratch: Optional[SplitScratch] = None) -> PreparedIRB:
    """Cast ``folded`` once for activations of ``dtype``: the products'
    weights rounded to it (as the plain versions round them), the biases and
    the depthwise in float32 (float64 for float64), all contiguous."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    def flat(b):
        return b.reshape(-1).to(acc).contiguous()

    return PreparedIRB(folded.we.to(dtype).contiguous(), flat(folded.be),
                       folded.wd.to(acc).contiguous(), flat(folded.bd),
                       folded.wp.to(dtype).contiguous(), flat(folded.bp), scratch)


def as_folded(w: Union[FoldedIRB, PreparedIRB]) -> FoldedIRB:
    """``FoldedIRB``'s view of prepared weights (the biases [1, C] again)."""
    if isinstance(w, PreparedIRB):
        return FoldedIRB(w.we, w.be[None], w.wd, w.bd[None], w.wp, w.bp[None])
    return w


def fold_bn(w: torch.Tensor, bn_params, bn_state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval BN (``(conv(x) - mean) * scale / sqrt(var + eps) + offset``)
    into an OIHW conv weight (scaled per output channel, axis 0) and a bias."""
    scale = bn_params["scale"] / torch.sqrt(bn_state["var"] + L.BN_EPS)
    return (w * scale.reshape(-1, *([1] * (w.ndim - 1))),
            bn_params["offset"] - bn_state["mean"] * scale)


def fold_irb(block_params, block_state) -> FoldedIRB:
    """Fold one block's three conv + BN pairs (keyed ``expand``, ``dwise``,
    ``linear``) from OIHW weights into ``FoldedIRB``'s layout."""
    def fold(name):
        return fold_bn(block_params[name]["conv"]["w"], block_params[name]["bn"],
                       block_state[name]["bn"])

    we, be = fold("expand")  # [Cexp, Cin, 1, 1]
    wd4, bd = fold("dwise")  # [Cexp, 1, 3, 3]
    wp, bp = fold("linear")  # [Cout, Cexp, 1, 1]
    return FoldedIRB(we[:, :, 0, 0].t(), be[None, :], wd4[:, 0].reshape(-1, 9).t(),
                     bd[None, :], wp[:, :, 0, 0].t(), bp[None, :])


def out_size(n: int, stride: int) -> int:
    """Output rows (columns) of a 3x3 convolution with padding 1."""
    return (n - 1) // stride + 1


def pad_activation(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> chain layout [B, H + 2, W, C_pad128]."""
    c = x.shape[-1]
    return F.pad(x, (0, -(-c // 128) * 128 - c, 0, 0, 1, 1))


def strip_activation(x: torch.Tensor, channels: int, real_w: int) -> torch.Tensor:
    """Chain layout -> [B, H, real_w, channels]."""
    return x[:, 1:-1, :real_w, :channels]


def reference_irb(x: torch.Tensor, folded: FoldedIRB, stride: int, shortcut: bool):
    """The JAX package's XLA block: every intermediate in the activation
    dtype, biases added in it."""
    dt = x.dtype
    e = L.relu6(torch.matmul(x, folded.we.to(dt)) + folded.be[0].to(dt))
    wd = folded.wd.t().reshape(-1, 1, 3, 3).to(dt)
    d = F.conv2d(e.permute(0, 3, 1, 2), wd, None, stride, 1, 1, e.shape[-1]).permute(0, 2, 3, 1)
    d = L.relu6(d + folded.bd[0].to(dt))
    out = torch.matmul(d, folded.wp.to(dt)) + folded.bp[0].to(dt)
    return (out + x if shortcut else out).to(dt)


# ---- plain versions -----------------------------------------------------------


def fused_inverted_residual_reference(x: torch.Tensor, folded: FoldedIRB, stride: int,
                                      shortcut: bool, round_expanded: bool = False):
    """Plain version of kernel G on NHWC ``x``, with the kernel's rounding
    points (float64 inputs compute in float64). ``folded`` may be prepared."""
    folded = as_folded(folded)
    dt = x.dtype
    acc = L.stat_dtype(x)
    e = L.relu6(torch.matmul(x.to(acc), folded.we.to(dt).to(acc)) + folded.be[0].to(acc))
    if round_expanded:
        e = e.to(dt).to(acc)
    wd = folded.wd.t().reshape(-1, 1, 3, 3).to(acc)
    d = F.conv2d(e.permute(0, 3, 1, 2), wd, None, stride, 1, 1, e.shape[-1]).permute(0, 2, 3, 1)
    d = L.relu6(d + folded.bd[0].to(acc)).to(dt)
    out = torch.matmul(d.to(acc), folded.wp.to(dt).to(acc)) + folded.bp[0].to(acc)
    if shortcut:
        out = out + x.to(acc)
    return out.to(dt)


def fused_irb_chain_reference(x: torch.Tensor, folded: FoldedIRB, stride: int,
                              shortcut: bool, real_w: int):
    """Plain version of the chain entry: chain layout in and out (``folded``
    may be prepared)."""
    cin, cout = folded.we.shape[0], folded.wp.shape[1]
    y = fused_inverted_residual_reference(strip_activation(x, cin, real_w), folded, stride,
                                          shortcut, round_expanded=True)
    B, Ho, Wo, _ = y.shape
    out = torch.zeros((B, Ho + 2, -(-Wo // 8) * 8, -(-cout // 128) * 128), dtype=x.dtype,
                      device=x.device)
    out[:, 1:-1, :Wo, :cout] = y
    return out


# ---- kernel ----------------------------------------------------------------------

# csrc/fused_irb.cu's IrbArg fields, in order
_ARG_FIELDS = ("dtype", "batch", "height", "width", "cin", "cexp", "cout", "stride", "shortcut",
               "round_e", "x_row0", "x_row_stride", "x_col_stride", "out_row0", "out_row_stride",
               "out_col_stride", "chain_rows", "chain_cols", "chain_chans")
_PTR_FIELDS = ("x", "we", "be", "wd", "bd", "wp", "bp", "out", "part")


def _launch(x: torch.Tensor, w: Union[FoldedIRB, PreparedIRB], stride: int, shortcut: bool,
            out: torch.Tensor, **geometry) -> None:
    """Validate the operands and make one C call (plan, scratch, launch)."""
    dev, dt = x.device, x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel G takes float32 or bfloat16 activations, got {dt}")
    B, H, W = geometry["batch"], geometry["height"], geometry["width"]
    cin, cexp = w.we.shape
    cout = w.wp.shape[1]
    if stride not in (1, 2):
        raise ValueError(f"kernel G takes stride 1 or 2, got {stride}")
    if min(B, H, W, cin, cexp, cout) < 1:
        raise ValueError(f"kernel G takes B, H, W, Cin, Cexp, Cout >= 1, got B={B}, H={H}, "
                         f"W={W}, Cin={cin}, Cexp={cexp}, Cout={cout}")
    if shortcut and (stride != 1 or cin != cout):
        raise ValueError("the residual needs stride 1 and Cin == Cout")
    if not isinstance(w, PreparedIRB):
        w = prepare_irb(w, dt)
    f32 = torch.float32
    for name, shape, dtype in (("we", (cin, cexp), dt), ("be", (cexp,), f32),
                               ("wd", (9, cexp), f32), ("bd", (cexp,), f32),
                               ("wp", (cexp, cout), dt), ("bp", (cout,), f32)):
        _build.require(getattr(w, name), name, dev, dtype, shape)
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if dt == torch.bfloat16:  # the tensor-core kernel copies 16 bytes at a time
        for name, t in (("x", x), ("out", out), *((f, getattr(w, f)) for f in
                                                   ("we", "be", "wd", "bd", "wp"))):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: must be 16-byte aligned")
    args = dict(geometry, dtype=_build.dtype_code(dt), cin=cin, cexp=cexp, cout=cout,
                stride=stride, shortcut=int(shortcut))
    ints = (ctypes.c_int * len(_ARG_FIELDS))(*[args[f] for f in _ARG_FIELDS])
    lib = _build.load_library()
    splits = lib.capk_fused_irb_splits(ints)
    if splits < 1:
        raise RuntimeError(f"kernel G has no plan for {args}")
    part = None
    if splits > 1:
        numel = splits * B * out_size(H, stride) * out_size(W, stride) * cout
        part = (w.scratch.get(numel, dev) if w.scratch is not None
                else torch.empty(numel, dtype=f32, device=dev))
    ptrs = dict(w._asdict(), x=x, out=out, part=part)
    c_ptrs = (ctypes.c_void_p * len(_PTR_FIELDS))(
        *[0 if ptrs[f] is None else ptrs[f].data_ptr() for f in _PTR_FIELDS])
    _build.check(lib.capk_fused_irb(ints, c_ptrs, _build.stream_ptr(dev)), "capk_fused_irb")


def fused_inverted_residual(x: torch.Tensor, folded: Union[FoldedIRB, PreparedIRB], stride: int,
                            shortcut: bool, round_expanded: bool = False) -> torch.Tensor:
    """One BN-folded block on NHWC ``x`` [B, H, W, Cin] -> [B, Hout, Wout,
    Cout] in x's dtype. ``round_expanded`` keeps the expanded tensor in the
    activation dtype (the chain kernel's rounding) instead of float32.
    ``folded`` may be ``prepare_irb``'s weights. Launches kernel G for CUDA
    tensors."""
    if x.device.type == "cpu":
        return fused_inverted_residual_reference(x, folded, stride, shortcut, round_expanded)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, H, W, cin = x.shape
    if cin != folded.we.shape[0]:
        raise ValueError(f"x has {cin} channels, the block takes {folded.we.shape[0]}")
    cout = folded.wp.shape[1]
    Ho, Wo = out_size(H, stride), out_size(W, stride)
    out = torch.empty((B, Ho, Wo, cout), dtype=x.dtype, device=x.device)
    _launch(x, folded, stride, shortcut, out, batch=B, height=H, width=W,
            round_e=int(round_expanded), x_row0=0, x_row_stride=W * cin, x_col_stride=cin,
            out_row0=0, out_row_stride=Wo * cout, out_col_stride=cout, chain_rows=0,
            chain_cols=0, chain_chans=0)
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0


def fused_irb_chain(x: torch.Tensor, folded: Union[FoldedIRB, PreparedIRB], stride: int,
                    shortcut: bool, real_w: int) -> torch.Tensor:
    """One block in the chain layout: ``x`` [B, H + 2, W_pad, Cin_pad] ->
    [B, Hout + 2, Wout_pad8, Cout_pad128], zero border rows, W tail and
    channel pad. ``folded`` may be ``prepare_irb``'s weights. Launches kernel
    G for CUDA tensors."""
    if x.device.type == "cpu":
        return fused_irb_chain_reference(x, folded, stride, shortcut, real_w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, rows, w_pad, c_pad = x.shape
    cin, cout = folded.we.shape[0], folded.wp.shape[1]
    if not 1 <= real_w <= w_pad or cin > c_pad or rows < 3:
        raise ValueError(f"chain input {tuple(x.shape)} does not hold W={real_w}, Cin={cin}")
    H = rows - 2
    Ho, Wo = out_size(H, stride), out_size(real_w, stride)
    wo_pad, co_pad = -(-Wo // 8) * 8, -(-cout // 128) * 128
    out = torch.empty((B, Ho + 2, wo_pad, co_pad), dtype=x.dtype, device=x.device)
    _launch(x, folded, stride, shortcut, out, batch=B, height=H, width=real_w, round_e=1,
            x_row0=1, x_row_stride=w_pad * c_pad, x_col_stride=c_pad, out_row0=1,
            out_row_stride=wo_pad * co_pad, out_col_stride=co_pad, chain_rows=Ho + 2,
            chain_cols=wo_pad, chain_chans=co_pad)
    fused_irb_chain.launches += 1
    return out


fused_irb_chain.launches = 0

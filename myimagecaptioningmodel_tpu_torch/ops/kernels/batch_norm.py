"""Train-mode batch norm's passes (kernel I): one-pass statistics, the
normalize (+ ReLU6) pass, the backward's two sums and its dx pass.

Not a TPU kernel: the port of the JAX package's hand-written BN VJP,
``myimagecaptioningmodel_tpu/ops/layers.py`` ``_bn_train`` (exact batch
statistics) and ``_bn_train_subset`` (statistics of the first R rows), and
the BN half of ``ops/pallas/matmul_bn.py`` ``_conv1x1_bn_bwd``. XLA fuses
each of those passes, and the ``relu6`` after it, into one read of the
activation; eagerly each pass was ~10 kernels with float32 intermediates.

Every function takes a channel-last ``[M, C]`` activation (M = B·H·W; the
plain versions any layout with the channel last, rows counted in its
``[M, C]`` view and taken as whole slices of its leading axis) and is split
where a process group all-reduces its sums (``layers.global_sums``):

- ``bn_stats(x, rows)`` -> (Σx, Σx²) per channel over the first ``rows``
  rows, in the statistics' dtype (float32; float64 for float64 inputs);
- ``bn_apply(x, s, q, n, scale, offset, act)`` -> (y in x's dtype, mean,
  biased var): ``mean = s / n``, ``var = max(q / n - mean², 0)``, ``y =
  (x - mean)·(inv·scale) + offset`` rounded to x's dtype with ``inv =
  1 / sqrt(var + eps)``, then ``clamp(y, 0, 6)`` when ``act``;
- ``bn_grad_sums(dy, x, mean, var, scale, offset, rows, act, ratio)`` ->
  (Σdy′, Σdy′·x̂) over the first ``rows`` rows, each times ``ratio``, where
  ``dy′ = dy·relu6′(y)`` when ``act`` (1/2 at y == 0 and y == 6, the
  gradient of ``jnp.clip``) with y recomputed from x, else dy;
- ``bn_dx(dy, x, mean, var, scale, offset, g_off, g_sc, n, act, exact)``
  -> dx in x's dtype: ``scale·inv/n·(n·dy′ − g_off − x̂·g_sc)`` for the
  exact BN, ``dy′·scale·inv`` for the subset's (statistics held constant).

Each ``*_reference`` is the plain version, the arithmetic of
``layers.py``'s earlier eager passes, op for op. Each entry runs its plain
version on a CPU tensor and launches its kernel of ``csrc/bn_train.cu`` on a
CUDA tensor (float32, bfloat16 or float64; any other device raises), with
a ``.launches`` count. The kernels round where the plain versions round
(``__f*_rn``), so y, dy′ and dx differ from the plain versions only through
the statistics' and sums' order of addition.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

BN_EPS = 1e-5
# kernel I's dtype codes (csrc/bn_train.cu): float32, bfloat16, float64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 3}
# contiguous copies made of an activation ("x", forward) or a cotangent
# ("dy", backward) handed over strided (``rows_of``): each is one more pass
copies = {"x": 0, "dy": 0}


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BN statistics dtype: float32, float64 for float64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rows_of(t: torch.Tensor, name: str = "") -> torch.Tensor:
    """``t`` as the entries take it: on a card ``[M, C]`` rows, channel
    last, a strided ``t`` copied (counted in ``copies[name]`` when named);
    on the CPU ``t`` as it is (the plain versions reduce over every axis but
    the last, in the layout they are given)."""
    if t.device.type == "cpu":
        return t
    if not t.is_contiguous():
        if name:
            copies[name] += 1
        t = t.contiguous()
    return t.view(-1, t.shape[-1])


def _leading(t: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of ``t``'s ``[M, C]`` view, in ``t``'s own
    layout (whole slices of its leading axis)."""
    return t[: rows // math.prod(t.shape[1:-1])]


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    return t.sum(tuple(range(t.ndim - 1)))


# ---- the plain versions ------------------------------------------------------


def bn_moments(s: torch.Tensor, q: torch.Tensor, n):
    """(Σx, Σx², count) -> (mean, biased variance): ``E[x^2] - mean^2``
    clamped at 0, the reference's one-pass statistics."""
    mean = s / n
    return mean, torch.clamp(q / n - mean.square(), min=0.0)


def bn_inv(var: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(var + BN_EPS)


def bn_normalized(x, mean, inv, scale, offset) -> torch.Tensor:
    """``(x - mean)·(inv·scale) + offset`` in the statistics' dtype, rounded
    to x's dtype: the BN output before its activation."""
    return ((x.to(mean.dtype) - mean) * (inv * scale) + offset).to(x.dtype)


def relu6_slope(y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``jnp.clip(y, 0, 6)``'s gradient in ``dt``: 1 inside (0, 6), 1/2 at
    either end, 0 outside (y - 6 is exact near 6)."""
    y = y.to(dt)
    return (torch.sign(y) - torch.sign(y - 6.0)) * 0.5


def _cotangent(dy, x, mean, inv, scale, offset, act):
    d = dy.to(mean.dtype)
    if act:
        d = d * relu6_slope(bn_normalized(x, mean, inv, scale, offset), mean.dtype)
    return d


def bn_stats_reference(x: torch.Tensor, rows: int):
    xs = _leading(x, rows).to(stat_dtype(x))
    return _sum_rows(xs), _sum_rows(xs.square())


def bn_apply_reference(x, s, q, n, scale, offset, act: bool):
    mean, var = bn_moments(s, q, n)
    y = bn_normalized(x, mean, bn_inv(var), scale, offset)
    return (torch.clamp(y, 0.0, 6.0) if act else y), mean, var


def bn_grad_sums_reference(dy, x, mean, var, scale, offset, rows: int, act: bool,
                           ratio: float = 1.0):
    inv = bn_inv(var)
    dy, x = _leading(dy, rows), _leading(x, rows)
    d = _cotangent(dy, x, mean, inv, scale, offset, act)
    xhat = (x.to(mean.dtype) - mean) * inv
    return _sum_rows(d) * ratio, _sum_rows(d * xhat) * ratio


def bn_dx_reference(dy, x, mean, var, scale, offset, g_off, g_sc, n, act: bool,
                    exact: bool):
    inv = bn_inv(var)
    d = _cotangent(dy, x, mean, inv, scale, offset, act)
    if exact:
        xhat = (x.to(mean.dtype) - mean) * inv
        dx = (scale * inv / n) * (n * d - g_off - xhat * g_sc)
    else:  # the statistics are constants: dx is elementwise in dy
        dx = d * (scale * inv)
    return dx.to(dy.dtype)


# ---- the entries ----------------------------------------------------------------


def _operands(x: torch.Tensor, what: str):
    """(device, dtype code, stat dtype) of a CUDA operand; raises on any
    device but CUDA and on a dtype kernel I does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: kernel I takes float32, bfloat16 or float64, got {x.dtype}")
    if x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"{what}: takes [M, C] with M, C >= 1, got {tuple(x.shape)}")
    return x.device, DTYPE_CODES[x.dtype], stat_dtype(x)


def _channel_vectors(dev, sd, C, **vectors):
    for name, t in vectors.items():
        _build.require(t, name, dev, sd, (C,))


def _align(*ts) -> int:
    """The low bits of the OR of the operands' addresses: kernel I picks its
    vector width (up to 16 bytes) from them and from C."""
    a = 0
    for t in ts:
        a |= t.data_ptr()
    return a & 0xFF


def _partials(lib, code, rows, C, align, x, dev):
    """(partial rows, both sums [2, C] in the statistics' dtype, kernel I's
    per-block partial sums [2, parts, C] in its running sums' dtype: double
    but for bf16 x, whose run in float)."""
    parts = lib.capk_bn_partial_rows(code, rows, C, align)
    if parts < 1:
        raise RuntimeError(f"capk_bn_partial_rows failed for rows={rows}, C={C}")
    run = torch.float32 if x.dtype == torch.bfloat16 else torch.float64
    return (parts, torch.empty(2 * C, dtype=stat_dtype(x), device=dev),
            torch.empty(2 * parts * C, dtype=run, device=dev))


def bn_stats(x: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the first ``rows`` rows of ``x [M, C]`` (0 <= rows <= M)."""
    if x.device.type == "cpu":
        return bn_stats_reference(x, rows)
    dev, code, _sd = _operands(x, "bn_stats")
    M, C = x.shape
    _build.require(x, "x", dev, x.dtype, (M, C))
    if not 0 <= rows <= M:
        raise ValueError(f"bn_stats: rows={rows} outside [0, {M}]")
    lib = _build.load_library()
    align = _align(x)
    parts, buf, part = _partials(lib, code, rows, C, align, x, dev)
    p = buf.data_ptr()
    _build.check(lib.capk_bn_stats(code, M, C, rows, align, x.data_ptr(), part.data_ptr(), parts,
                                   p, p + C * buf.element_size(), _build.stream_ptr(dev)),
                 "capk_bn_stats")
    bn_stats.launches += 1
    return buf[:C], buf[C:2 * C]


def bn_apply(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor, n, scale: torch.Tensor,
             offset: torch.Tensor, act: bool):
    """(y [M, C] in x's dtype, mean, var) from the (global) sums over ``n`` rows."""
    if x.device.type == "cpu":
        return bn_apply_reference(x, s, q, n, scale, offset, act)
    dev, code, sd = _operands(x, "bn_apply")
    M, C = x.shape
    _build.require(x, "x", dev, x.dtype, (M, C))
    _channel_vectors(dev, sd, C, s=s, q=q, scale=scale, offset=offset)
    lib = _build.load_library()
    y = torch.empty_like(x)
    mv = torch.empty(2 * C, dtype=sd, device=dev)
    p = mv.data_ptr()
    _build.check(lib.capk_bn_apply(
        code, M, C, _align(x, y), x.data_ptr(), s.data_ptr(), q.data_ptr(), float(n),
        scale.data_ptr(), offset.data_ptr(), int(act), y.data_ptr(), p,
        p + C * mv.element_size(), _build.stream_ptr(dev)), "capk_bn_apply")
    bn_apply.launches += 1
    return y, mv[:C], mv[C:]


def bn_grad_sums(dy: torch.Tensor, x: torch.Tensor, mean, var, scale, offset, rows: int,
                 act: bool, ratio: float = 1.0):
    """(Σdy′·ratio, Σdy′·x̂·ratio) over the first ``rows`` rows of ``dy`` and
    ``x``, both ``[rows or more, C]``."""
    if dy.device.type == "cpu":
        return bn_grad_sums_reference(dy, x, mean, var, scale, offset, rows, act, ratio)
    dev, code, sd = _operands(dy, "bn_grad_sums")
    C = dy.shape[1]
    _build.require(dy, "dy", dev, dy.dtype, dy.shape)
    _build.require(x, "x", dev, dy.dtype, (x.shape[0], C))
    if not 0 <= rows <= min(dy.shape[0], x.shape[0]):
        raise ValueError(f"bn_grad_sums: rows={rows} past dy's {dy.shape[0]} or x's "
                         f"{x.shape[0]} rows")
    _channel_vectors(dev, sd, C, mean=mean, var=var, scale=scale, offset=offset)
    lib = _build.load_library()
    align = _align(dy, x)
    parts, buf, part = _partials(lib, code, rows, C, align, dy, dev)
    p = buf.data_ptr()
    _build.check(lib.capk_bn_grad_sums(
        code, C, rows, align, dy.data_ptr(), x.data_ptr(), mean.data_ptr(), var.data_ptr(),
        scale.data_ptr(), offset.data_ptr(), int(act), float(ratio), part.data_ptr(), parts, p,
        p + C * buf.element_size(), _build.stream_ptr(dev)), "capk_bn_grad_sums")
    bn_grad_sums.launches += 1
    return buf[:C], buf[C:2 * C]


def bn_dx(dy: torch.Tensor, x: Optional[torch.Tensor], mean, var, scale, offset,
          g_off: Optional[torch.Tensor], g_sc: Optional[torch.Tensor], n, act: bool,
          exact: bool) -> torch.Tensor:
    """dx [M, C] in dy's dtype; ``x`` may be None for the subset's dx
    without ``act``, ``g_off``, ``g_sc`` and ``n`` are read by the exact one."""
    if dy.device.type == "cpu":
        return bn_dx_reference(dy, x, mean, var, scale, offset, g_off, g_sc, n, act, exact)
    dev, code, sd = _operands(dy, "bn_dx")
    M, C = dy.shape
    _build.require(dy, "dy", dev, dy.dtype, (M, C))
    if exact or act:
        if x is None:
            raise ValueError("bn_dx: the exact dx and the ReLU6's slope read x")
        _build.require(x, "x", dev, dy.dtype, (M, C))
    if exact:
        _channel_vectors(dev, sd, C, g_off=g_off, g_sc=g_sc)
    _channel_vectors(dev, sd, C, mean=mean, var=var, scale=scale, offset=offset)
    lib = _build.load_library()
    dx = torch.empty_like(dy)
    x_ptr = x.data_ptr() if (exact or act) else 0
    _build.check(lib.capk_bn_dx(
        code, M, C, _align(dy, dx, *([x] if (exact or act) else [])), dy.data_ptr(), x_ptr,
        mean.data_ptr(), var.data_ptr(), scale.data_ptr(), offset.data_ptr(),
        g_off.data_ptr() if exact else 0, g_sc.data_ptr() if exact else 0,
        float(n) if exact else 1.0, int(act), int(exact), dx.data_ptr(),
        _build.stream_ptr(dev)), "capk_bn_dx")
    bn_dx.launches += 1
    return dx


bn_stats.launches = 0
bn_apply.launches = 0
bn_grad_sums.launches = 0
bn_dx.launches = 0
ENTRIES = (bn_stats, bn_apply, bn_grad_sums, bn_dx)

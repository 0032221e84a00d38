"""Plant faults in kernel F's statistics and in the fused train step, and read
what each scores against ``chip_smoke.py``'s limits, beside the sound path.

    python3 chip_fault_check.py [--seed 0]

Needs one CUDA card. Each fault is patched in at run time, in this process
only; nothing on disk changes. Two parts:

1. Phase 11's check (``chip_smoke.f_stats_errors`` against ``F_STATS_TOL``)
   at every shape of ``F_SHAPES`` in bfloat16, with the kernel's sum and
   sumsq replaced by those of a faulty kernel: taken over the float32
   accumulator instead of the stored, rounded y; missing the last row;
   missing the rows past the last whole 128-row tile.
2. Phase 12 (a)'s check (``chip_smoke.fused_failures`` against
   ``TRAIN_LIMITS``): one float32 B=32 train step at full width with
   ``fuse_bn_stats`` on, its errors against a float64 step beside the
   unfused float32 step's, with the fused conv + BN replaced by a faulty
   one: the unbiased variance; the mean over M-1 rows; the statistics
   missing the rows past the last whole 128-row tile; the backward missing
   the ``xhat * dscale`` term of dx.

Each fault prints one ``[fault]`` line with its readings and whether the
limits catch it; the script exits non-zero if the sound path fails its
limits or a fault of part 2 goes uncaught.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

import chip_smoke as S

TILE_ROWS = 128  # kernel F's row tile


def stats_fault_readings(dev, seed):
    """Part 1 -> {fault: caught at some shape}."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels.matmul_bn import (
        _matmul_stats_reference as plain,
        matmul_stats as kernel,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    caught = {}
    for name, M, K, N in S.F_SHAPES:
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(torch.bfloat16)
        y, s, q = kernel(x, w)
        ry, rs, rq = plain(x, w)
        yf, acc = y.float(), torch.matmul(x.float(), w.float())
        full = M - M % TILE_ROWS
        cases = {"sound": (s, q),
                 "unrounded_y": (acc.sum(0), (acc * acc).sum(0)),
                 "last_row_dropped": (s - yf[-1], q - yf[-1] ** 2)}
        if full < M:
            cases["ragged_tile_dropped"] = (s - yf[full:].sum(0), q - (yf[full:] ** 2).sum(0))
        for fault, (fs, fq) in cases.items():
            errs = S.f_stats_errors(y, fs, fq, ry, rs, rq)
            over = S.f_stats_failures(errs)
            caught[fault] = caught.get(fault, False) or bool(over)
            S.say("fault", check="phase11", dtype="bfloat16", conv=name, M=M, K=K, N=N,
                  fault=fault, **{f"err_{k}": v for k, v in errs.items()}, over_tol=over)
        del x, w, y, ry, yf, acc
    torch.cuda.empty_cache()
    return caught


def faulty_conv_bn(stats=None, drop_dscale=False):
    """The fused conv + BN with a fault in its statistics (``stats(y, s, q,
    n) -> (mean, var)``) or in its backward."""
    from myimagecaptioningmodel_tpu_torch.ops import layers as L
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB

    sound = MB._Conv1x1BN

    class Faulty(sound):
        @staticmethod
        def forward(ctx, w, scale, offset, x_flat):
            if stats is None:
                return sound.forward(ctx, w, scale, offset, x_flat)
            y, s, q = MB.matmul_stats(x_flat, w)
            mean, var = stats(y, s, q, x_flat.shape[0])
            yn, inv = L.bn_normalize(y, mean, var, scale, offset)
            ctx.save_for_backward(w, scale, x_flat, y, mean, inv)
            ctx.mark_non_differentiable(mean, var)
            return yn, mean, var

        @staticmethod
        def backward(ctx, dyn, dmean, dvar):
            if not drop_dscale:
                return sound.backward(ctx, dyn, dmean, dvar)
            w, scale, x_flat, y, mean, inv = ctx.saved_tensors
            n = y.shape[0]
            dy32 = dyn.to(mean.dtype)
            xhat = (y.to(mean.dtype) - mean) * inv
            doffset, dscale = dy32.sum(0), (dy32 * xhat).sum(0)
            dy_conv = ((scale * inv / n) * (n * dy32 - doffset)).to(x_flat.dtype)
            dw = torch.matmul(x_flat.t(), dy_conv).to(w.dtype)
            dx = torch.matmul(dy_conv, w.t()).to(x_flat.dtype)
            return dw, dscale.to(scale.dtype), doffset.to(scale.dtype), dx

    return Faulty


def _moments(s, q, n, n_mean=None):
    mean = s / (n_mean or n)
    return mean, torch.clamp(q / n - mean * mean, min=0.0)


def _unbiased(y, s, q, n):
    mean, var = _moments(s, q, n)
    return mean, var * (n / (n - 1))


def _ragged_dropped(y, s, q, n):
    tail = y[n - n % TILE_ROWS:].float()
    return _moments(s - tail.sum(0), q - (tail * tail).sum(0), n)


TRAIN_FAULTS = {
    "sound": {},
    "unbiased_var": {"stats": _unbiased},
    "mean_over_m_minus_1": {"stats": lambda y, s, q, n: _moments(s, q, n, n - 1)},
    "ragged_tile_dropped": {"stats": _ragged_dropped},
    "backward_without_xhat_dscale": {"drop_dscale": True},
}


def train_fault_readings(dev, seed, root):
    """Part 2 -> {fault: the TRAIN_LIMITS readings that fail}."""
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB

    lr = 1e-3
    cfg32 = S.train_cfg(root, "float32", False, 32, lr)
    ref_params, ref_state = C.init(torch.Generator().manual_seed(seed),
                                   C.ModelOptions.from_config(cfg32))
    images, caps = S.train_batch(cfg32, dev, seed)
    runs = {label: S.one_step_run(S.train_cfg(root, dtype, False, 32, lr), ref_params,
                                  ref_state, dev, images, caps)[0]
            for label, dtype in (("unfused", "float32"), ("float64", "float64"))}
    unfused = S.step_errors(runs["unfused"], runs["float64"], lr)
    S.say("fault", check="phase12a", fault="unfused_reference", **unfused)
    sound_cls, failed = MB._Conv1x1BN, {}
    cfg = S.train_cfg(root, "float32", True, 32, lr)
    for fault, kw in TRAIN_FAULTS.items():
        MB._Conv1x1BN = faulty_conv_bn(**kw)
        try:
            run, launches = S.one_step_run(cfg, ref_params, ref_state, dev, images, caps)
        finally:
            MB._Conv1x1BN = sound_cls
        fused = S.step_errors(run, runs["float64"], lr)
        failed[fault] = S.fused_failures(fused, unfused)
        ratios = {f"ratio_{k}": fused[k] / max(unfused[k], 1e-300) for k in fused
                  if k.startswith(("grad", "bn"))}
        drops = {f"drop_{k}": unfused[k] - fused[k] for k in fused if k.startswith("update")}
        S.say("fault", check="phase12a", fault=fault, kernel_f_launches=launches,
              caught=bool(failed[fault]), failed=failed[fault], **fused, **ratios, **drops)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read what planted faults score against "
                                             "chip_smoke.py's limits on one CUDA card.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    S.phase_card_and_build()
    S.say("limits", F_STATS_TOL=json.dumps(S.F_STATS_TOL).replace(" ", ""),
          TRAIN_LIMITS=json.dumps(S.TRAIN_LIMITS).replace(" ", ""))
    caught11 = stats_fault_readings(dev, args.seed)
    with tempfile.TemporaryDirectory() as root:
        failed12 = train_fault_readings(dev, args.seed, root)
    summary = {"phase11_caught": caught11, "phase12a_failed": failed12}
    print(json.dumps(summary))
    if caught11["sound"] or failed12["sound"]:
        return 1
    return 0 if all(failed12[f] for f in TRAIN_FAULTS if f != "sound") else 1


if __name__ == "__main__":
    sys.exit(main())

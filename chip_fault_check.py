"""Plant faults in kernel F's statistics, in the fused train step, in
kernel E's inputs, and in kernel G and the int8 modes of kernels D and E,
and read what each scores against ``chip_smoke.py``'s limits, beside the
sound path.

    python3 chip_fault_check.py [--seed 0] [--parts 1,2,3,4]

Needs one CUDA card. Each fault is patched in at run time, in this process
only; nothing on disk changes. Four parts:

1. Phase 11's check (``chip_smoke.f_stats_errors`` against ``F_STATS_TOL``)
   at every shape of ``F_SHAPES`` in bfloat16, with the kernel's sum and
   sumsq replaced by those of a faulty kernel: taken over the float32
   accumulator instead of the stored, rounded y; missing the last row;
   missing the rows past the last whole row tile of the kernel
   (``matmul_bn.row_tile()``, 128 rows).
2. Phase 12 (a)'s check (``chip_smoke.fused_failures`` against
   ``TRAIN_LIMITS``): one float32 B=32 train step at full width with
   ``fuse_bn_stats`` on, its errors against a float64 step beside the
   unfused float32 step's, with the fused conv + BN replaced by a faulty
   one: the unbiased variance; the mean over M-1 rows; the statistics
   missing the rows past the last whole row tile; the backward missing
   the ``xhat * dscale`` term of dx.
3. Phase 15's check (``chip_smoke.e_check`` against ``E_RESCORE`` and the
   near-tie gaps): kernel E in bfloat16 at 8 and 128 images x beam 4, with
   and without early stops, run on inputs that plant a fault a kernel could
   make, and held against the plain path on the sound inputs: positions off
   by one step; the v projection's bias dropped (a bias on k would be no
   fault: it shifts every score of a row alike); each row attending to the
   next image's memory; LayerNorm gains 1% high; the last 32-row block of
   the real vocabulary missing from the head; the ``in_proj`` bias dropped.
4. Phases 17-19's checks. Kernel G (``G_TOL``) at the 17 block shapes at
   B=8, float32 and bfloat16, and the fused encoder (``ENC_TOL``) with the
   fault in every block: the expanded halo left at ``relu6(be)`` (a plain
   version of that faulty block stands in for the kernel); the depthwise
   taps transposed (dy <-> dx, the kernel run on the transposed weights);
   the residual dropped. Kernel D's int8 modes (the near-tie rule against
   the plain teacher-forced argmax) at B=8 and 128, and E's int8 weight
   stream (``e_check``) at 8 images, bfloat16: each int8 product's scale
   applied after its bias (the kernels run on biases multiplied by their
   scales, which ``(y + b) s`` is); V's memory scale dropped (int8 memory).

    python3 chip_fault_check.py --parts 3   # part 3 only

Each fault prints one ``[fault]`` line with its readings and whether the
limits catch it; the script exits non-zero if the sound path fails its
limits or a fault of parts 2-4 goes uncaught (but for the LayerNorm
gain, which part 3 reads for the limit's resolution).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

import chip_smoke as S

def tile_rows() -> int:
    """Kernel F's row tile, as the built library reports it."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn

    return matmul_bn.row_tile()


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
        full = M - M % tile_rows()
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
    tail = y[n - n % tile_rows():].float()
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


def _shift_pos(f):
    return f._replace(pos=torch.cat([f.pos[1:], f.pos[-1:]]))


def _v_bias_dropped(f):
    D = f.w_o.shape[1]
    b = f.b_qkv.clone()
    b[:, 2 * D:] = 0.0
    return f._replace(b_qkv=b)


def _ln_gain(f):
    ln = f.ln.clone()
    ln[:, 0::2] *= 1.01
    return f._replace(ln=ln)


def _head_block_dropped(f):
    bias = f.out_bias.clone()
    bias[S.V_REAL - 32:S.V_REAL] = -1e9
    return f._replace(out_bias=bias)


# read for the gate's resolution, not required to fail: 1% on the LayerNorm
# gains moves bf16 beam scores about as much as rounding does
E_BELOW_RESOLUTION = ("ln_gain_plus_1pct",)
E_FAULTS = {
    "sound": lambda f: f,
    "pos_off_by_one": _shift_pos,
    "v_bias_dropped": _v_bias_dropped,
    "memory_of_next_image": lambda f: f._replace(mem_kv=f.mem_kv.roll(1, dims=2)),
    "ln_gain_plus_1pct": _ln_gain,
    "head_block_dropped": _head_block_dropped,
    "in_proj_bias_dropped": lambda f: f._replace(in_proj_b=torch.zeros_like(f.in_proj_b)),
}


def e_fault_readings(dev, seed):
    """Part 3 -> {fault: caught in some case}."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(S.randomize_affine(TTF.init(gen, S.tf_dims()), gen), dev)
    dt, caught = torch.bfloat16, {}
    for n_img in (8, 128):
        pre = S.tf_pre(gen, dev, params, n_img, dt)
        for label in ("none", "mixed"):
            bias = S.stop_biases(params, pre, dt)["mixed"] if label == "mixed" else 0.0
            p = S.with_stop_bias(params, bias)
            ftp = FT.prepare(p, pre, S.TF_HEADS, dt)
            ref = FT.fused_beam_decode_reference(ftp, S.TF_STEPS, S.TF_HEADS, S.BEAM,
                                                 compute_dtype=dt, early_stop=True)
            for fault, plant in E_FAULTS.items():
                ok, readings, _ = S.e_check(p, pre, ftp, dt, ref, kernel_ftp=plant(ftp))
                caught[fault] = caught.get(fault, False) or not ok
                S.say("fault", check="phase15", dtype="bfloat16", images=n_img, stop=label,
                      fault=fault, caught=not ok, **readings)
    return caught


def _halo_at_relu6_be(x, fold, stride, shortcut, round_expanded=False):
    """Kernel G as if it left the expanded halo at ``relu6(be)``: the expand
    over the zero-padded input, unmasked, then a depthwise without padding
    (a plain stand-in for that faulty kernel)."""
    import torch.nn.functional as F

    from myimagecaptioningmodel_tpu_torch.ops import layers as L

    dt = x.dtype
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    e = L.relu6(torch.matmul(xp, fold.we.to(dt).float()) + fold.be[0].float())
    if round_expanded:
        e = e.to(dt).float()
    wd = fold.wd.t().reshape(-1, 1, 3, 3).float()
    d = F.conv2d(e.permute(0, 3, 1, 2), wd, None, stride, 0, 1, e.shape[-1]).permute(0, 2, 3, 1)
    d = L.relu6(d + fold.bd[0].float()).to(dt)
    out = torch.matmul(d.float(), fold.wp.to(dt).float()) + fold.bp[0].float()
    return (out + x.float() if shortcut else out).to(dt)


def _taps_transposed(fold):
    return fold._replace(wd=fold.wd.reshape(3, 3, -1).transpose(0, 1).reshape(9, -1))


def g_faults():
    """{fault: block function (x, fold, stride, shortcut, round_expanded)},
    each but the stand-in running the kernel."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    kernel = FI.fused_inverted_residual

    def taps_transposed(x, fold, stride, shortcut, round_expanded=False):
        return kernel(x, _taps_transposed(fold), stride, shortcut, round_expanded)

    def residual_dropped(x, fold, stride, shortcut, round_expanded=False):
        return kernel(x, fold, stride, False, round_expanded)

    # installed in the kernel's place, each keeps the count the kernel adds to
    for fn in (_halo_at_relu6_be, taps_transposed, residual_dropped):
        fn.launches = 0
    return {"sound": kernel, "halo_at_relu6_be": _halo_at_relu6_be,
            "taps_transposed": taps_transposed, "residual_dropped": residual_dropped}


def g_fault_readings(dev, seed):
    """Part 4, kernel G and the fused encoder -> {fault: caught}."""
    from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as MV
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    faults, caught = g_faults(), {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for dt in (torch.float32, torch.bfloat16):
        readings = {f: [] for f in faults}
        for name, H, W, cin, cexp, cout, stride, sc in S.irb_blocks(S.ENC_SIZE):
            x, fold = S.g_operands(gen, dev, 8, H, W, cin, cexp, cout, dt)
            want = FI.fused_inverted_residual_reference(x, fold, stride, sc, True)
            for fault, fn in faults.items():
                if fault == "residual_dropped" and not sc:
                    continue
                readings[fault].append(S.rel_max_err(fn(x, fold, stride, sc, True), want))
        for fault, r in readings.items():
            over = max(r) > S.G_TOL[dt]
            caught[fault] = caught.get(fault, False) or over
            S.say("fault", check="phase17", dtype=str(dt).split(".")[-1], B=8, fault=fault,
                  blocks=len(r), max_rel_err_max=f"{max(r):.3g}", max_rel_err_min=f"{min(r):.3g}",
                  tol=S.G_TOL[dt], caught=over)
    params, state = S.encoder_tree(torch.Generator().manual_seed(seed), dev)
    x = torch.rand(8, S.ENC_SIZE, S.ENC_SIZE, 3, generator=torch.Generator().manual_seed(seed)).to(dev)
    kernel = FI.fused_inverted_residual
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            FI.fused_inverted_residual = FI.fused_inverted_residual_reference
            ref_g = MV.apply(params, state, x, train=False, compute_dtype=dt, use_fused_irb=True)[0]
            ref = MV.apply(params, state, x, train=False, compute_dtype=dt)[0]
            for fault, fn in faults.items():
                FI.fused_inverted_residual = fn
                try:
                    feat = MV.apply(params, state, x, train=False, compute_dtype=dt,
                                    use_fused_irb=True)[0]
                finally:
                    FI.fused_inverted_residual = kernel
                e_g, e_p = S.rel_l2([feat], [ref_g]), S.rel_l2([feat], [ref])
                over = e_g > S.ENC_TOL["g_plain"][dt] or e_p > S.ENC_TOL["encoder"][dt]
                caught["encoder_" + fault] = over
                S.say("fault", check="phase18", dtype=str(dt).split(".")[-1], B=8, fault=fault,
                      rel_l2_vs_g_plain=f"{e_g:.3g}", rel_l2_vs_plain_encoder=f"{e_p:.3g}",
                      tol=json.dumps({k: v[dt] for k, v in S.ENC_TOL.items()}).replace(" ", ""),
                      caught=over)
    return caught


def _scale_after_bias(f):
    """Every int8 product as ``(x @ w_q + b) * s``: the kernels on biases
    multiplied by their products' scales."""
    D = f.w_o.shape[1]
    b_misc = f.b_misc.clone()
    b_misc[:, :3] *= f.s_misc
    b_misc[:, 3] *= f.s_fc2
    return f._replace(b_qkv=f.b_qkv * f.s_qkv, b_misc=b_misc, b_fc1=f.b_fc1 * f.s_fc1)


def _v_scale_dropped(f):
    s = f.mem_scale.clone()
    s[:, 1] = 1.0
    return f._replace(mem_scale=s)


def de_int8_fault_readings(dev, seed):
    """Part 4, kernels D and E on int8 -> {fault: caught}."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(S.randomize_affine(TTF.init(gen, S.tf_dims()), gen), dev)
    q = TTF.quantize_transformer_decoder(params)
    dt, caught = torch.bfloat16, {}
    for B in (8, 128):
        pre = TTF.precompute(q, torch.rand(B, S.K_SLOTS, S.H, generator=gen).to(dev),
                             torch.rand(B, S.H, generator=gen).to(dev), S.TF_HEADS, dt)
        for kv in (False, True):
            ftp = FT.prepare(q, pre, S.TF_HEADS, dt, quantize_kv=kv)
            mp, _d, mpre = FT._as_model(ftp, S.TF_HEADS, torch.arange(B, device=dev))
            faults = {"sound": lambda f: f, "scale_after_bias": _scale_after_bias}
            if kv:
                faults["v_scale_dropped"] = _v_scale_dropped
            for fault, plant in faults.items():
                ids = FT.fused_greedy_decode(plant(ftp), S.TF_STEPS, S.TF_HEADS, compute_dtype=dt)
                ok, err = S.greedy_tf_check(mp, mpre, ids, dt, False)
                caught[fault] = caught.get(fault, False) or not ok
                S.say("fault", check="phase19_d", dtype="bfloat16", B=B,
                      mode="int8_kv" if kv else "int8", fault=fault, caught=not ok,
                      near_tie_max_gap=err)
    pre = TTF.precompute(q, torch.rand(8, S.K_SLOTS, S.H, generator=gen).to(dev),
                         torch.rand(8, S.H, generator=gen).to(dev), S.TF_HEADS, dt)
    ftp = FT.prepare(q, pre, S.TF_HEADS, dt)
    mp, _d, mpre = FT._as_model(ftp, S.TF_HEADS, torch.arange(8, device=dev))
    ref = FT.fused_beam_decode_reference(ftp, S.TF_STEPS, S.TF_HEADS, S.BEAM, compute_dtype=dt,
                                         early_stop=True)
    for fault, plant in (("sound", lambda f: f), ("scale_after_bias", _scale_after_bias)):
        ok, readings, _ = S.e_check(mp, mpre, ftp, dt, ref, kernel_ftp=plant(ftp))
        caught["e_" + fault] = not ok
        S.say("fault", check="phase19_e", dtype="bfloat16", images=8, fault=fault,
              caught=not ok, **readings)
    return caught


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read what planted faults score against "
                                             "chip_smoke.py's limits on one CUDA card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="1,2,3,4", help="comma-separated parts to run")
    args = ap.parse_args(argv)
    parts = {int(x) for x in args.parts.split(",")}
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    S.phase_card_and_build()
    S.say("limits", F_STATS_TOL=json.dumps(S.F_STATS_TOL).replace(" ", ""),
          TRAIN_LIMITS=json.dumps(S.TRAIN_LIMITS).replace(" ", ""),
          E_RESCORE=S.E_RESCORE[torch.bfloat16], E_GAP=S.E_GAP[torch.bfloat16],
          G_TOL=json.dumps({str(k).split(".")[-1]: v for k, v in S.G_TOL.items()}).replace(" ", ""))
    summary = {}
    if 1 in parts:
        summary["phase11_caught"] = stats_fault_readings(dev, args.seed)
    if 2 in parts:
        with tempfile.TemporaryDirectory() as root:
            summary["phase12a_failed"] = train_fault_readings(dev, args.seed, root)
    if 3 in parts:
        summary["phase15_caught"] = e_fault_readings(dev, args.seed)
    if 4 in parts:
        summary["phase17_18_caught"] = g_fault_readings(dev, args.seed)
        summary["phase19_caught"] = de_int8_fault_readings(dev, args.seed)
    print(json.dumps(summary))
    if any(bool(v.get(f)) for v in summary.values()
           for f in ("sound", "encoder_sound", "e_sound")):
        return 1
    return 0 if all(bool(v[f]) for k, v in summary.items() if k != "phase11_caught"
                    for f in v if f not in ("sound", "encoder_sound", "e_sound")
                    and f not in E_BELOW_RESOLUTION) else 1


if __name__ == "__main__":
    sys.exit(main())

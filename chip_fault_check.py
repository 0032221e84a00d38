"""Plant faults in kernel F's statistics, in the fused train step, in
kernel E's inputs, in kernel G and the int8 modes of kernels D and E, in
kernel A, in kernel B and in the transformer's training, and read what each
scores against ``chip_smoke.py``'s limits, beside the sound path.

    python3 chip_fault_check.py [--seed 0] [--parts 1,2,3,4,5,6,7,8,9,10,11]

Needs one CUDA card. Each fault is patched in at run time, in this process
(or, for part 10's data-parallel faults, in each rank's process) only;
nothing in the checkout changes. Eleven parts:

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
   The stand-in takes ``prepare_irb``'s weights, as the fused encoder
   passes them.
5. Phases 2's and 6's checks of kernel A (``chip_smoke.a_checks``: the
   near-tie rule on random operands, the last vocab row forced to win, equal
   best rows in several tiles to the lowest index) in float32, bfloat16 and
   int8 at B=8 and 128, with the kernel replaced by a faulty one: the last
   vocab tile missing (the kernel on the table without its last tile of
   ``vocab_head.argmax_vocab_tile(B)`` rows); the tie rule inverted (the
   kernel on the table in reverse order, its ids mapped back, so the higher
   index wins a tie); the int8 scale applied after the bias (the kernel on
   ``bias * scale``, which ``(x . t + b) s`` is; int8 only); batch row 8, the
   second n-tile, reading row 0's proj (B=128 only). Each fault must be
   caught in every table dtype; the float32 near-tie gap is 1e-3 of the
   largest |logit| over the real vocabulary.
6. Phases 14's and 15's checks (``greedy_tf_check``'s near-tie rule at
   B=8 and 128, ``e_check`` at 8 images x beam 4), bfloat16, with faults
   the weight-streaming product and the decode graphs could make: the last
   K split of ``w_fc2`` dropped (its rows zeroed, the split as
   ``fused_transformer.stream_splits`` plans it); the last 64-column tile of
   ``w_qkv``'s v block dropped; a decode replayed on the previous batch's
   memory (the graph's copy of the memory left out). Each must be caught
   in every case.

7. Phases 3's and 20's checks of kernel B (the step at 8 and 128 rows with
   its head and at 32 beam rows without it, h', c', proj to 3e-2, their
   mean errors to ``B_MEAN_TOL`` and the word under the near-tie rule; the
   greedy decode at B=8 under the near-tie rule, the beam decode on 8
   images x 4 re-scored within 2e-3 a step), in
   bfloat16, with faults the step could make: the gate weight interleaved
   one hidden unit off; the gate product's last K split dropped (its rows
   zeroed, the split as ``fused_step.product_splits`` plans it at 8, 32 and
   128 rows); the attention's last H-slice left out of the scores (its
   score weights zeroed); the sentinel gate reading h' instead of h_prev
   (a plain stand-in for the step); the finish kernel writing step t's
   words into row t - 1 (the decode's ids shifted). Each must be caught.
8. Phase 21's checks of the transformer's training at full width: the
   optimizer's tree walker skipping what lies under lists (``tree_leaves``
   without its list branch), caught if a float32 B=32 step leaves any leaf under
   ``decoder/layers`` unchanged; after 20 sound bf16 B=128 steps,
   ``decoder/layers`` exported in reversed order, caught if the reloaded
   bundle differs from the trained tree (``bundle_mismatches``); the causal
   mask dropped from ``teacher_forcing_logits``, caught if the served
   greedy ids (kernel D) fail the near-tie rule against its argmax
   (``served_greedy_check``) or the served best beam (kernel E) its
   re-score (``served_beam_check``). Each must be caught, and each sound
   reading pass.
9. Phase 23's checks of the training workflow on its corpus (1,280 images,
   full width): the reader a row off (``ShardManager._locate`` one past),
   caught by the rows read against the rows written; the loop's dev decode
   on the plain path on the card (``use_kernels`` off), caught by B's and
   A's launch counts; ``calc_bleu_rows`` dropping the last row, caught by
   the loop's dev BLEU (an epoch of 8 steps) against the
   sentence-by-sentence one; resume
   skipping ``mid_epoch_batches - 1`` batches, caught by the resumed losses
   against the uninterrupted run's within ``RESUME_NOISE`` x the noise of
   two uninterrupted runs; a checkpoint written without the EMA tree,
   caught by the reload (it refuses a checkpoint that does not match the
   training state). Each must be caught, and each sound reading pass.
10. Phases 24's and 25's checks. Phase 24 (batch captioning, the LSTM
    bundle greedy, 300 images at batch 128, items handed over in shuffled
    order): a padding row leaking into the records (the padded last
    batch's first padding row given a record), caught by the records' count
    and names; records in the order the items arrived instead of path
    order, caught by the names' order. Phase 25 (b) (2 gloo processes on
    the card against one, ``DP_LIMITS``): per-rank BN statistics (every BN
    sum left unreduced: each rank normalizes with its own rows' statistics,
    forward and backward); only the BN backward's sums left unreduced
    (Σdy and Σdy·x̂: the forward, the first loss and the statistics stay
    sound, and the ranks stay equal, since the gradients are summed
    after); a mean of per-rank loss means (each rank divides
    its CE sum by its own token count times the world: the token count's
    all-reduce replaced); ``bn_stat_rows`` taken per rank (each rank's
    subset statistics from its own first rows, at ``bn_stat_rows=96``).
    The exact-BN faults are planted in bf16 and in float32, the subset's in
    bf16. Each must be caught, but for the backward-only fault in bf16,
    which bf16's rounding hides (read, and caught in float32), and each
    sound reading pass. Each case also prints the rounding witness
    (``chip_smoke.dp_witness``) read the same way.
11. Phases 26-28's checks. Phase 26 (vocab tensor parallelism, 2 gloo
    processes of a (data=1, model=2) grid on the card against one process,
    ``TP_LIMITS``, the LSTM and transformer dev decodes against the world-1
    decodes, the merge of a tie planted across the halves): the merge
    without the rank offset; ties merged to the highest index; the
    cross-entropy's sums left unreduced over the model group; the
    vocab-parallel lookup without its mask; BN's sums reduced over every
    process instead of the data group (the rows of a model group counted
    twice). Phase 27 (the imported Paddle bundle against the NumPy oracle):
    Paddle's gate order left unpermuted; the conv weights transposed twice
    (the import's shape check refuses them). Phase 28 (phase 4's LSTM
    bundle exported greedy, in this process): the export traced from the
    kernel path (the trace refuses the kernels' device-pointer calls). Each must
    be caught and each sound reading pass; phase 26's rounding witness
    (``chip_smoke.dp_witness``) is printed beside them.

    python3 chip_fault_check.py --parts 3   # part 3 only

Each fault prints one ``[fault]`` line with its readings and whether the
limits catch it; the script exits non-zero if the sound path fails its
limits or a fault of parts 2-6 goes uncaught (but for the LayerNorm
gain, which part 3 reads for the limit's resolution).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
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
            run, launches, _ = S.one_step_run(cfg, ref_params, ref_state, dev, images, caps)
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
    from myimagecaptioningmodel_tpu_torch.ops.kernels.fused_irb import as_folded

    fold = as_folded(fold)
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


def _a_last_tile_missing(kernel):
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import argmax_vocab_tile

    def fn(proj, table, bias, scale=None):
        V, vt = table.shape[0], argmax_vocab_tile(proj.shape[0])
        cut = V - (V % vt or vt)
        return kernel(proj, table[:cut], bias[:cut], None if scale is None else scale[:cut])
    return fn


def _a_ties_to_higher_index(kernel):
    def fn(proj, table, bias, scale=None):
        def rev(t):
            return None if t is None else t.flip(0).contiguous()
        return (table.shape[0] - 1 - kernel(proj, rev(table), rev(bias), rev(scale))).int()
    return fn


def _a_scale_after_bias(kernel):
    def fn(proj, table, bias, scale=None):
        return kernel(proj, table, bias if scale is None else bias * scale, scale)
    return fn


def _a_row8_reads_row0(kernel):
    def fn(proj, table, bias, scale=None):
        if proj.shape[0] > 8:
            proj = proj.clone()
            proj[8] = proj[0]
        return kernel(proj, table, bias, scale)
    return fn


A_FAULTS = {"sound": lambda k: k, "last_tile_missing": _a_last_tile_missing,
            "ties_to_higher_index": _a_ties_to_higher_index,
            "int8_scale_after_bias": _a_scale_after_bias,
            "row8_reads_row0": _a_row8_reads_row0}


def a_fault_readings(dev, seed):
    """Part 5, kernel A -> {"sound": failed in some case, "fault/dtype":
    caught at B=8 or 128}: every fault must be caught in every table dtype."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import greedy_vocab_argmax

    caught = {}
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        name = str(dt).split(".")[-1]
        for B in (8, 128):
            for fault, plant in A_FAULTS.items():
                if fault == "int8_scale_after_bias" and dt != torch.int8:
                    continue  # a float table has no scale
                ok, err, _ = S.a_checks(plant(greedy_vocab_argmax), dev, dt, B, seed)
                hit = not all(ok.values())
                key = fault if fault == "sound" else f"{fault}/{name}"
                caught[key] = caught.get(key, False) or hit
                S.say("fault", check="phase6" if dt == torch.int8 else "phase2",
                      dtype=name, B=B, fault=fault,
                      **{k + "_ok": v for k, v in ok.items()},
                      max_abs_err_of_picked_logit=err, caught=hit)
    return caught


def _fc2_last_split_dropped(rows):
    """w_fc2's rows of the last K split of the product of ``rows`` rows zeroed."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    def plant(f):
        _L, F_, D = f.w_fc2.shape
        splits, chunks = FT.stream_splits(rows, D, F_), F_ // 32
        w = f.w_fc2.clone()
        w[:, (splits - 1) * chunks // splits * 32:] = 0
        return f._replace(w_fc2=w)
    return plant


def _v_tile_dropped(f):
    w = f.w_qkv.clone()
    w[:, :, -64:] = 0  # the v block's last 64-column tile
    return f._replace(w_qkv=w)


def stream_fault_readings(dev, seed):
    """Part 6 -> {fault: caught in every case}."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(S.randomize_affine(TTF.init(gen, S.tf_dims()), gen), dev)
    dt, caught = torch.bfloat16, {}
    packed = FT.pack_weights(params, dt)
    for kind, n in (("greedy", 8), ("greedy", 128), ("beam", 8)):
        pre_prev, pre = (S.tf_pre(gen, dev, params, n, dt) for _ in range(2))
        ftp_prev, ftp = (FT.prepare(params, x, S.TF_HEADS, dt, packed=packed)
                         for x in (pre_prev, pre))
        rows = n * (S.BEAM if kind == "beam" else 1)
        ref = (FT.fused_beam_decode_reference(ftp, S.TF_STEPS, S.TF_HEADS, S.BEAM,
                                              compute_dtype=dt, early_stop=True)
               if kind == "beam" else None)

        def check(kernel_ftp):
            if kind == "beam":
                ok, readings, _ = S.e_check(params, pre, ftp, dt, ref, kernel_ftp=kernel_ftp)
                return ok, readings
            ids = FT.fused_greedy_decode(kernel_ftp, S.TF_STEPS, S.TF_HEADS, compute_dtype=dt)
            torch.cuda.synchronize()
            ok, err = S.greedy_tf_check(params, pre, ids, dt, False)
            return ok, dict(near_tie_max_gap=err)

        def stale():  # the previous batch decoded, then this one without its memory
            check(ftp_prev)
            load = FT.GRAPHS.load
            FT.GRAPHS.load = lambda work, inputs: None
            try:
                return check(ftp)
            finally:
                FT.GRAPHS.load = load

        faults = {"sound": lambda: check(ftp),
                  "fc2_last_split_dropped": lambda: check(_fc2_last_split_dropped(rows)(ftp)),
                  "v_last_tile_dropped": lambda: check(_v_tile_dropped(ftp)),
                  "previous_batch_memory": stale}
        for fault, run in faults.items():
            ok, readings = run()
            if fault == "sound":  # failed in some case
                caught[fault] = caught.get(fault, False) or not ok
            else:  # caught in every case
                caught[fault] = caught.get(fault, True) and not ok
            S.say("fault", check="phase15" if kind == "beam" else "phase14", dtype="bfloat16",
                  rows=rows, fault=fault, caught=not ok, **readings)
    return caught


# ---- part 7: kernel B -------------------------------------------------------------


def _gate_units_shifted(pk):
    """The gate weight interleaved one hidden unit off: unit j's five gate
    columns hold unit j + 1's."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    K, n5 = pk.w_gate.shape
    w = FS.deinterleave_gates(pk.w_gate).reshape(K, 5, n5 // 5).roll(-1, dims=2)
    return pk._replace(w_gate=FS.interleave_gates(w.reshape(K, n5)).contiguous())


def _gate_last_split_dropped(rows):
    """The gate weight's rows of the last K split of the product of ``rows``
    rows zeroed, the split as ``fused_step.product_splits`` plans it."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    def plant(pk):
        K, n5 = pk.w_gate.shape
        splits, chunks = FS.product_splits(rows, n5, K, gate=True), K // 32
        w = pk.w_gate.clone()
        w[(splits - 1) * chunks // splits * 32:] = 0
        return pk._replace(w_gate=w)
    return plant


def _last_score_slice_dropped(pk):
    """The attention's last H-slice left out of the scores: its score
    weights zeroed, so its partials are 0."""
    w = pk.w_score.clone()
    w[:, -w.shape[1] // 8:] = 0
    return pk._replace(w_score=w)


def _sentinel_reads_new_h(fp, word_emb, h, c, img_k, img_v, with_head=True,
                          compute_dtype=torch.bfloat16):
    """The plain step with its sentinel gate on h' instead of h_prev (a
    stand-in for a kernel with that fault) -> (h', c', proj, word')."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
        greedy_vocab_argmax_reference,
    )

    fp = FS.unpack(fp) if isinstance(fp, FS.PackedStep) else fp
    dt, H, B = compute_dtype, h.shape[1], h.shape[0]
    h_new, c_new, _proj = FS._step_math(fp, word_emb, h, c, FS._per_row(img_k, B),
                                        FS._per_row(img_v, B), dt)
    # the sentinel gate's h-part on h' (the recurrent weight's last H columns)
    gate = (FS._dot(word_emb, fp.w_word_cat[:, 4 * H:], dt) + FS._dot(h_new, fp.w_hh_cat[:, 4 * H:], dt)
            + fp.gxb[:, 4 * H:])
    sentinel = torch.sigmoid(gate) * torch.tanh(c_new)
    p_hid = torch.tanh(FS._dot(h_new, fp.w_p, dt) + fp.b_p)
    hid_emb = FS._dot(p_hid, fp.w_he, dt) + fp.b_he
    sent_key = FS._dot(sentinel, fp.w_se, dt) + fp.b_se
    ctx = FS._attention(fp.w_score, fp.b_score, hid_emb, sent_key, sentinel,
                        FS._per_row(img_k, B), FS._per_row(img_v, B))
    out = torch.tanh(FS._dot(ctx + p_hid, fp.w_out, dt) + fp.b_out)
    proj = FS._dot(out, fp.w_proj, dt) + fp.b_proj
    word = (greedy_vocab_argmax_reference(proj, fp.head_table, fp.head_bias) if with_head
            else torch.zeros((B,), dtype=torch.int32, device=h.device))
    return h_new, c_new, proj, word


def b_fault_readings(dev, seed):
    """Part 7 -> {fault: caught}: phase 3's check (bf16 at 8 and 128 rows
    with the head, 32 beam rows on 8 images without it; h', c', proj to
    3e-2, their mean errors to ``B_MEAN_TOL``, the word under the near-tie
    rule) and phase 20's (greedy B=8 ids
    under the near-tie rule against the plain step teacher-forced, beam 4 on
    8 images re-scored within 2e-3 a step), each fault caught if any of them
    fails, the sound kernel passing all."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.inference import beam as BM
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    gen = torch.Generator().manual_seed(seed)
    dims = D.DecoderDims(vocab_size=12295, embedding_size=S.E, hidden_dim=S.H,
                         vocab_pad_multiple=128)
    params = tree_to_torch(D.init(gen, dims), dev)
    dt, T = torch.bfloat16, S.TF_STEPS
    packed = FS.pack_weights(params, dt)

    def pre_of(n):
        img = torch.randn(n, S.K_SLOTS, S.H, generator=gen).to(dev)
        return D.precompute(params, img, torch.randn(n, S.H, generator=gen).to(dev), dt)

    steps = [(rows, head, S._step_inputs(dev, gen, rows, dt, params, S.b_images(rows, head)))
             for rows, head in ((8, True), (128, True), (32, False))]
    pre_g, pre_b = pre_of(8), pre_of(8)

    def readings(plant=None, step=None, ids_fault=None):
        """(ok, readings) of every check, the kernel's packed weights planted
        by ``plant``, or ``step`` standing in for the kernel's step."""
        out, ok = {}, True
        for rows, head, args in steps:
            pk = args[0] if plant is None else plant(args[0])
            run = step or FS.fused_decode_step
            got = run(pk, *args[1:], with_head=head, compute_dtype=dt)
            torch.cuda.synchronize()
            ref = FS.reference_step(*args, with_head=head, compute_dtype=dt)
            errs, means = S.b_errors(got, ref)
            err = max(errs)
            good = err <= 3e-2 and max(means) <= S.B_MEAN_TOL[dt]
            if head:
                logits = torch.matmul(ref[2].to(dt).float(), args[0].table.float().T) + \
                    args[0].head_bias
                good = good and S.near_tie_ok(got[3], logits, dt)
            out[f"step_{rows}_err"] = err
            out[f"step_{rows}_mean_err"] = max(means)
            ok = ok and good
        pk = packed if plant is None else plant(packed)
        if step is None:
            ids = D.greedy_decode_ids(params, pre_g, T, compute_dtype=dt, use_kernels=True,
                                      packed=pk)
        else:  # the stand-in step's greedy decode
            fp = FS.with_batch(pk, params, pre_g)
            h = torch.zeros(8, S.H, device=dev)
            c, word, cols = torch.zeros_like(h), torch.full((8,), 2, device=dev), []
            for _t in range(T):
                h, c, _p, word = step(fp, FS.gather_words(fp.table, word, 0), h, c,
                                      pre_g.img_k.to(dt), pre_g.img_v.to(dt), compute_dtype=dt)
                cols.append(word)
            ids = torch.stack(cols, dim=1)
        if ids_fault is not None:
            ids = ids_fault(ids)
        torch.cuda.synchronize()
        good = S.lstm_greedy_ok(params, pre_g, ids, dt, False)
        out["greedy_ok"] = good
        ok = ok and good
        if step is None and ids_fault is None:
            bids, score = BM.beam_search_ids(params, pre_b, T, S.BEAM, compute_dtype=dt,
                                             use_kernels=True, early_stop=True, packed=pk)
            good, err = S.lstm_beam_ok(params, pre_b, bids, score, dt)
            out.update(beam_ok=good, beam_rescore_err=err)
            ok = ok and good
        return ok, out

    def finish_writes_row_before(ids):  # step t's words in row t - 1
        return torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)

    faults = {"sound": lambda: readings(),
              "gate_interleave_off_by_one_unit": lambda: readings(_gate_units_shifted),
              "gate_last_k_split_dropped": None,  # planted for each checked row count
              "last_h_slice_score_dropped": lambda: readings(_last_score_slice_dropped),
              "sentinel_gate_reads_new_h": lambda: readings(step=_sentinel_reads_new_h),
              "finish_writes_row_t_minus_1": lambda: readings(ids_fault=finish_writes_row_before)}
    caught = {}
    for fault, run in faults.items():
        if run is None:
            oks, out = [], {}
            for rows in (8, 32, 128):
                ok, r = readings(_gate_last_split_dropped(rows))
                oks.append(ok)
                out.update({f"{k}_planted_for_{rows}": v for k, v in r.items()})
            ok = all(oks)
        else:
            ok, out = run()
        caught[fault] = not ok
        S.say("fault", check="phase3_20", dtype="bfloat16", fault=fault, caught=not ok, **out)
    return caught


def _lists_skipped(tree):
    """``tree_leaves`` that skips what lies under lists and tuples."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _lists_skipped(tree[k])]
    return [] if isinstance(tree, (list, tuple)) else [tree]


def _causal_mask_dropped(fn):
    """``teacher_forcing_logits`` whose self-attention sees every position."""
    def logits(params, pre, source, dims, padding_idx=0, compute_dtype=torch.bfloat16):
        from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

        dt, T = compute_dtype, source.shape[1]
        x = TTF._embed_in(params, source, torch.arange(T, device=source.device), padding_idx, dt)
        for layer, mk, mv in zip(params["layers"], pre.mem_k, pre.mem_v):
            x = TTF._block(layer, x, mk, mv, dims.num_heads, dt, None)
        return TTF.head_logits(params, x, dt)

    del fn
    return logits


def tf_train_fault_readings(dev, seed, root):
    """Part 8 -> {fault: caught}: phase 21's checks with faults in this
    slice's code: the optimizer's walker skipping lists (every
    ``decoder/layers`` leaf must change in a step, 21 (a)); ``decoder/layers``
    exported in reversed order (the reloaded bundle must equal the trained
    tree, 21 (c)); the causal mask dropped from ``teacher_forcing_logits``
    (the served greedy ids against the teacher-forced argmax, 21 (c))."""
    from myimagecaptioningmodel_tpu_torch.compat import from_jax as FJ
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.parallel import train_step as TS
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    lr = 1e-3
    cfg32 = S.train_cfg(root, "float32", False, 32, lr, S.TF_ARCH)
    ref_params, ref_state = C.init(torch.Generator().manual_seed(seed),
                                   C.ModelOptions.from_config(cfg32))
    images, caps = S.train_batch(cfg32, dev, seed)
    caught = {}
    n_layer = len(S.layer_leaves(ref_params))
    for fault in ("walker_sound", "walker_skips_lists"):
        sound = TS.tree_leaves
        if fault != "walker_sound":
            TS.tree_leaves = _lists_skipped
        try:
            _run, _launches, unchanged = S.one_step_run(cfg32, ref_params, ref_state, dev,
                                                        images, caps)
        finally:
            TS.tree_leaves = sound
        caught[fault] = unchanged > 0
        S.say("fault", check="phase21a", fault=fault, layer_leaves=n_layer,
              layer_leaves_unchanged=unchanged, caught=caught[fault])

    # 20 sound bf16 steps, as phase 21 (b), then export and serve
    cfg = S.train_cfg(root, "bfloat16", True, 128, S.TF_LR, S.TF_ARCH)
    images, caps = S.train_batch(cfg, dev, seed + 1)
    step, params, opt_state, state = S.trainer(cfg, ref_params, ref_state, dev)
    for i in range(20):
        params, opt_state, state, _n, _loss, _lr = step(params, opt_state, state, i, images, caps)
    for fault in ("export_sound", "layers_reversed_on_export"):
        p_np, s_np = FJ.reference_tree(params, state)
        if fault != "export_sound":
            p_np["decoder"]["layers"] = p_np["decoder"]["layers"][::-1]
        ckpt.export_inference_bundle(f"{cfg.train.checkpoint_path}/{fault}", p_np, s_np, cfg)
        model, _bcfg, _opts, _decode = load_bundle(cfg, fault, device=dev)
        bad = S.bundle_mismatches(model, params, state)
        caught[fault] = bool(bad)
        S.say("fault", check="phase21c_bundle", fault=fault, leaves_differing=len(bad),
              caught=caught[fault])
    model, _bcfg, opts, _decode = load_bundle(cfg, "export_sound", device=dev)
    for fault in ("served_sound", "causal_mask_dropped"):
        sound = TTF.teacher_forcing_logits
        if fault != "served_sound":
            TTF.teacher_forcing_logits = _causal_mask_dropped(sound)
        try:
            ok, gap, _ids = S.served_greedy_check(model, opts, images[:8])
            beam_ok, per_step, _ids = S.served_beam_check(model, opts, images[:8])
        finally:
            TTF.teacher_forcing_logits = sound
        caught[fault] = not (ok and beam_ok)
        S.say("fault", check="phase21c_served", fault=fault, near_tie_ok=ok,
              near_tie_max_gap=gap, beam_ok=beam_ok, tf_rescore_per_sqrt_step=per_step,
              caught=caught[fault])
    return caught


def trainer_fault_readings(dev, seed, root):
    """Part 9 -> {fault: caught}: phase 23's checks with faults in the data
    plane, the loop and the metrics: the reader a row off (the rows read
    against the rows written, ``reader_rows_failures``); the dev decode on
    the plain path on the card (the loop's launches, ``loop_launches_want``);
    resume skipping one batch less than it ran
    (``resume_readings``' losses); a checkpoint written without the EMA tree
    (the resume's reload); ``calc_bleu_rows`` dropping the last row (the
    loop's dev BLEU after 8 steps against ``dev_bleu_errors``)."""
    from myimagecaptioningmodel_tpu_torch.data import shards as SH
    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
    from myimagecaptioningmodel_tpu_torch.evaluation import metrics as M
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt
    from myimagecaptioningmodel_tpu_torch.training import loop

    base, _summary, rows = S.trainer_base(root, seed)
    caught = {}
    locate = SH.ShardManager._locate
    for fault in ("reader_sound", "reader_off_by_one_row"):
        if fault != "reader_sound":
            SH.ShardManager._locate = lambda self, i: locate(self, min(i + 1, len(self) - 1))
        try:
            bad = S.reader_rows_failures(base, rows)
        finally:
            SH.ShardManager._locate = locate
        caught[fault] = bool(bad)
        S.say("fault", check="phase23a_rows", fault=fault, rows_differing=len(bad),
              caught=caught[fault])
    del rows

    build = loop.build_steps
    for fault in ("decode_sound", "dev_decode_plain"):
        if fault != "decode_sound":
            loop.build_steps = lambda opts, *a, **k: build(opts._replace(use_kernels=False),
                                                           *a, **k)
        cfg = S.loop_cfg(base, root, fault, S.NO_EXPORTS + (
            ("train.max_epoch", 1), ("train.checkpoint_every_n_steps", False)))
        try:
            with S.counting() as c:
                loop.train(cfg, device=dev, max_steps_per_epoch=2)
        finally:
            loop.build_steps = build
        want = S.loop_launches_want(2, 1, 1)
        caught[fault] = c.counts != want
        S.say("fault", check="phase23b_launches", fault=fault,
              launches=json.dumps(c.counts).replace(" ", ""), caught=caught[fault])

    cfg_a = S.loop_cfg(base, root, "a", (("train.ema_decay", 0.999),))
    with S.loop_probe() as probe_a:
        loop.train(cfg_a, device=dev, max_steps_per_epoch=S.TRAINER_STEPS)
    rows_sum = M.calc_bleu_rows
    for fault in ("bleu_sound", "bleu_rows_drop_last"):
        if fault != "bleu_sound":
            def dropped(pred, real, *a, **k):
                total, n = rows_sum(pred[:-1], real[:-1], *a, **k)
                return total, n + 1
            M.calc_bleu_rows = dropped
        cfg = S.loop_cfg(base, root, fault, S.NO_EXPORTS + (
            ("train.max_epoch", 1), ("train.checkpoint_every_n_steps", False)))
        try:
            with S.loop_probe() as probe:
                loop.train(cfg, device=dev, max_steps_per_epoch=S.TRAINER_STEPS)
        finally:
            M.calc_bleu_rows = rows_sum
        pairs = S.dev_bleu_errors(cfg, probe, 1)
        caught[fault] = any(abs(a - b) > 1e-12 for a, b in pairs)
        S.say("fault", check="phase23b_dev_bleu", fault=fault, logged_and_by_sentence=pairs,
              caught=caught[fault])

    cfg_a2 = S.loop_cfg(base, root, "a2", (("train.ema_decay", 0.999),
                                          ("train.checkpoint_every_n_steps", False)) + S.NO_EXPORTS)
    with S.loop_probe() as probe_a2:
        loop.train(cfg_a2, device=dev, max_steps_per_epoch=S.TRAINER_STEPS)
    get_reader, arrays = DataReader.get_reader, ckpt.checkpoint_arrays

    def skip_one_less(self, batch_size=None, mode="train", keep_float16=False,
                      shuffle_seed=None, skip_samples=0, **k):
        return get_reader(self, batch_size, mode, keep_float16, shuffle_seed,
                          max(0, skip_samples - (batch_size or 0)), **k)

    def without_ema(*a):
        return {k: v for k, v in arrays(*a).items() if not k.startswith("opt_state/ema/")}

    for fault in ("resume_sound", "resume_skips_one_batch_less", "checkpoint_without_ema"):
        if fault == "resume_skips_one_batch_less":
            DataReader.get_reader = skip_one_less
        elif fault == "checkpoint_without_ema":
            ckpt.checkpoint_arrays = without_ema
        try:
            r = S.resume_readings(dev, base, root, fault, probe_a.loss_values(),
                                  probe_a2.loss_values())
            caught[fault] = not r["ok"]
        except ValueError as e:  # the reload refuses a checkpoint that does not match
            r, caught[fault] = {"error": str(e)[:160]}, True
        finally:
            DataReader.get_reader, ckpt.checkpoint_arrays = get_reader, arrays
        S.say("fault", check="phase23c_resume", fault=fault, caught=caught[fault],
              **{k: v for k, v in r.items() if not k.startswith("losses")})
    return caught


# ---- part 10: batch captioning and data parallelism ---------------------------------
# The plants below run in each rank's process (``chip_smoke.dp_rank``), before
# its steps.


def _bn_per_rank():
    """Every BN sum left unreduced: this rank's sums scaled by the world, so
    that over the global count they are this rank's own statistics."""
    from myimagecaptioningmodel_tpu_torch.ops import layers as L
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    world = distributed.process_count()
    L.global_sums = lambda *sums: tuple(t * world for t in sums)


def _mean_of_rank_means():
    """The token count's all-reduce replaced by this rank's count times the
    world: each rank's CE over its own tokens, the ranks' means averaged."""
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    reduce, world = distributed.dist.all_reduce, distributed.process_count()

    def all_reduce(t, *a, **k):
        if t.ndim == 0:  # the token count (the loss share rides in the bucket)
            t.mul_(world)
            return None
        return reduce(t, *a, **k)

    distributed.dist.all_reduce = all_reduce


def _subset_rows_per_rank():
    """``bn_stat_rows`` per rank: each rank's subset statistics from its own
    first min(R, rows) rows, unreduced."""
    from myimagecaptioningmodel_tpu_torch.ops import layers as L

    orig = L._BNTrainSubset.forward
    dist = L.distributed

    def forward(ctx, scale, offset, x, stat_rows):
        index, sums = dist.process_index, L.global_sums
        dist.process_index, L.global_sums = (lambda: 0), (lambda *s: s)
        try:
            return orig(ctx, scale, offset, x, min(stat_rows, x.shape[0]))
        finally:
            dist.process_index, L.global_sums = index, sums

    L._BNTrainSubset.forward = staticmethod(forward)


def _bn_backward_per_rank():
    """Only the BN backward's sums (Σdy, Σdy·x̂) left unreduced: dx from
    this rank's own backward statistics, the forward's still global."""
    from myimagecaptioningmodel_tpu_torch.ops import layers as L
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    world, orig = distributed.process_count(), L.bn_backward

    def bn_backward(*args):
        sums = L.global_sums
        L.global_sums = lambda *s: tuple(t * world for t in s)
        try:
            return orig(*args)
        finally:
            L.global_sums = sums

    L.bn_backward = bn_backward


DP_FAULTS = {"exact_bn": (_bn_per_rank, _bn_backward_per_rank, _mean_of_rank_means),
             "subset_bn_r96": (_subset_rows_per_rank,),
             "exact_bn_f32": (_bn_per_rank, _bn_backward_per_rank, _mean_of_rank_means)}
# read, and not required to be caught: bf16's rounding hides this fault
# (``chip_smoke.DP_LIMITS``' note); the float32 case must catch it
DP_BELOW_RESOLUTION = ("exact_bn/bn_backward_per_rank",)


def dp_fault_readings(dev, seed, root, card):
    """Part 10 -> {fault: caught}."""
    from myimagecaptioningmodel_tpu_torch.inference import batch_caption as BC

    caught = {}
    cfg = S.write_bundle(os.path.join(root, "part10_lstm"), seed)
    orig = BC.caption_arrays

    def padding_row_leaks(cfg_, items, *a, **k):
        items = list(items)
        pad = (S.BC_IMAGES, "pad.jpg", np.zeros_like(items[0][2]))
        return orig(cfg_, items + [pad], *a, **k)

    def records_in_arrival_order(cfg_, items, *a, **k):
        items = list(items)
        by_name = {r["image"]: r for r in orig(cfg_, items, *a, **k)}
        return [by_name[name] for _i, name, _a in items]

    for fault, fn in (("bc_sound", orig), ("bc_padding_row_leaks", padding_row_leaks),
                      ("bc_records_out_of_order", records_in_arrival_order)):
        BC.caption_arrays = fn
        try:
            S.phase_batch_caption(dev, seed, {"lstm": cfg}, card, modes=S.BC_MODES[:1])
            caught[fault], detail = False, ""
        except AssertionError as e:
            caught[fault], detail = True, str(e)[:160]
        finally:
            BC.caption_arrays = orig
        S.say("fault", check="phase24", fault=fault, caught=caught[fault], detail=detail)

    for case, plants in DP_FAULTS.items():
        dcfg = S.dp_cfg(root, case)
        one = S.dp_run(dcfg, seed, dev)
        S.say("fault", check="phase25b", case=case, fault="rounding_witness",
              **{f"{k}_err": v for k, v in S.dp_witness(dcfg, seed, dev, one).items()})
        torch.cuda.empty_cache()
        for plant in (None,) + plants:
            name = f"dp_{case}_sound" if plant is None else f"{case}/{plant.__name__.strip('_')}"
            r, failed = S.dp_readings(dcfg, seed, dev, one, plant)
            caught[name] = bool(failed)
            S.say("fault", check="phase25b", case=case, fault=name, failed=failed,
                  caught=caught[name], **{k: v for k, v in r.items()
                                          if k.endswith("_err") or k in (
                                              "ranks_bit_equal", "collectives_per_step",
                                              "gloo_cuda")})
    return caught


# ---- part 11: vocab tensor parallelism, the Paddle import, the export -----------------
# The first five plants run in each rank's process (``chip_smoke.tp_rank``),
# before its steps and decodes.


def _merge_without_offset():
    """Each rank's argmax merged as a global id without its rank's offset."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import greedy_vocab_argmax
    from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP

    def greedy_head(proj, table, bias, logits_fn=None):
        ids, val = greedy_vocab_argmax(proj, table, bias, with_value=True)
        return VP.merge_argmax(val, ids.long())

    VP.greedy_head = greedy_head


def _ties_to_highest_index():
    """The merge's ties to the highest global index."""
    from myimagecaptioningmodel_tpu_torch.parallel import distributed
    from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP

    def merge_argmax(value, index):
        both = torch.stack([value.double(), index.double()])
        got = distributed.all_gather_rows(both, distributed.model_group())
        vals, idx = got[0::2], got[1::2]
        cand = torch.where(vals == vals.max(dim=0).values, idx, torch.full_like(idx, -1.0))
        return cand.max(dim=0).values.to(torch.int32)

    VP.merge_argmax = merge_argmax


def _ce_sums_unreduced():
    """The cross-entropy's sums (of exp, the gold logit, the smoothing mean)
    left unreduced over the model group: each rank's CE over its columns."""
    from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP

    orig, dist = VP._CrossEntropy.forward, VP.distributed

    def forward(ctx, *args):
        reduce = dist.all_reduce_sum_
        dist.all_reduce_sum_ = lambda t, group=None: t
        try:
            return orig(ctx, *args)
        finally:
            dist.all_reduce_sum_ = reduce

    VP._CrossEntropy.forward = staticmethod(forward)


def _embed_unmasked():
    """The vocab-parallel lookup without its mask: every rank adds the row
    its clamped local index reads."""
    from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP

    def embed(p, ids, padding_idx=0):
        table = p["table"]
        vl = table.shape[0]
        local = (ids - VP.vocab_offset(vl)).clamp(0, vl - 1)
        rows = table[local] * (ids != padding_idx).unsqueeze(-1).to(table.dtype)
        return VP._ReduceForward.apply(rows)

    VP.embed = embed


def _bn_over_the_world():
    """BN's sums reduced over every process instead of the data group: the
    ranks of a model group hold the same rows, which count twice."""
    from myimagecaptioningmodel_tpu_torch.ops import layers as L
    from myimagecaptioningmodel_tpu_torch.parallel import distributed

    def global_sums(*sums):
        flat = distributed.all_reduce_sum_(torch.cat(sums))
        return tuple(flat.split([t.numel() for t in sums]))

    L.global_sums = global_sums


TP_FAULTS = (_merge_without_offset, _ties_to_highest_index, _ce_sums_unreduced,
             _embed_unmasked, _bn_over_the_world)


def _gates_unpermuted(timp):
    timp.permute_lstm_gates = lambda arr, hidden, axis=-1: arr


def _conv_transposed_twice(timp):
    orig = timp.conv_oihw_to_hwio
    timp.conv_oihw_to_hwio = lambda w: orig(orig(w))


def _export_from_the_kernel_path(EP):
    """The export traced with ``use_kernels`` on (the kernels' path, whose
    C calls read device pointers)."""
    from myimagecaptioningmodel_tpu_torch.models import captioner as C

    orig = C.greedy_decode

    def greedy_decode(model, images, opts):
        return orig(model, images, opts._replace(use_kernels=True))

    C.greedy_decode = greedy_decode
    return lambda: setattr(C, "greedy_decode", orig)


def tp_fault_readings(dev, seed, root, card):
    """Part 11 -> {fault: caught}: phase 26's (data=1, model=2) readings
    (``tp_readings``) sound and with each of ``TP_FAULTS``; phase 27 sound,
    with the Paddle gates left unpermuted and with the conv weights
    transposed twice; phase 28 on phase 4's bundle sound and with the export
    traced from the kernel path."""
    from myimagecaptioningmodel_tpu_torch.compat import paddle_import as timp
    from myimagecaptioningmodel_tpu_torch.inference import export_program as EP

    caught = {}
    cfg, tf_cfg = S.tp_cfgs(root)
    one = S.tp_one(cfg, tf_cfg, seed, dev)
    S.say("fault", check="phase26", fault="rounding_witness",
          **{f"{k}_err": v for k, v in S.dp_witness(cfg, seed, dev, one).items()})
    torch.cuda.empty_cache()
    for plant in (None,) + TP_FAULTS:
        name = "tp_sound" if plant is None else plant.__name__.strip("_")
        r, failed = S.tp_readings(cfg, tf_cfg, seed, dev, one, plant)
        caught[name] = bool(failed)
        S.say("fault", check="phase26", fault=name, failed=failed, caught=caught[name],
              **{k: v for k, v in r.items() if k.endswith("_err") or k in (
                  "replicated_bit_equal", "lstm_decode_bit_equal_each",
                  "tf_rows_equal_plain_each", "tie_to_lowest_each", "lookup_exact_each")})
    for name, plant in (("paddle_sound", None), ("gates_unpermuted", _gates_unpermuted),
                        ("conv_transposed_twice", _conv_transposed_twice)):
        saved = (timp.permute_lstm_gates, timp.conv_oihw_to_hwio)
        if plant is not None:
            plant(timp)
        try:
            S.phase_paddle_import(dev, seed, os.path.join(root, name), card)
            caught[name], detail = False, ""
        except (AssertionError, ValueError) as e:
            caught[name], detail = True, str(e)[:160]
        finally:
            timp.permute_lstm_gates, timp.conv_oihw_to_hwio = saved
        S.say("fault", check="phase27", fault=name, caught=caught[name], detail=detail)
    lstm = S.write_bundle(os.path.join(root, "part11_lstm"), seed)
    for name in ("export_sound", "export_from_the_kernel_path"):
        undo = _export_from_the_kernel_path(EP) if name != "export_sound" else None
        out = os.path.join(root, "part11_lstm", name)
        try:  # in this process, where the plant reaches the trace
            started = S.start_exports(out, {"lstm": lstm}, [("lstm", 0)], in_process=True)
            S.phase_export(dev, seed, out, started, card)
            caught[name], detail = False, ""
        except Exception as e:  # the trace itself may refuse the kernels' calls
            caught[name], detail = True, f"{type(e).__name__}: {str(e)[:160]}"
        finally:
            if undo is not None:
                undo()
        S.say("fault", check="phase28", fault=name, caught=caught[name], detail=detail)
    return caught


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read what planted faults score against "
                                             "chip_smoke.py's limits on one CUDA card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="comma-separated parts to run")
    args = ap.parse_args(argv)
    parts = {int(x) for x in args.parts.split(",")}
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = S.phase_card_and_build()
    S.say("limits", F_STATS_TOL=json.dumps(S.F_STATS_TOL).replace(" ", ""),
          TRAIN_LIMITS=json.dumps(S.TRAIN_LIMITS).replace(" ", ""),
          E_RESCORE=S.E_RESCORE[torch.bfloat16], E_GAP=S.E_GAP[torch.bfloat16],
          G_TOL=json.dumps({str(k).split(".")[-1]: v for k, v in S.G_TOL.items()}).replace(" ", ""),
          DP_LIMITS=json.dumps(S.DP_LIMITS).replace(" ", ""),
          TP_LIMITS=json.dumps(S.TP_LIMITS).replace(" ", ""))
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
    if 5 in parts:
        summary["phase2_6_caught"] = a_fault_readings(dev, args.seed)
    if 6 in parts:
        summary["phase14_15_caught"] = stream_fault_readings(dev, args.seed)
    if 7 in parts:
        summary["phase3_20_caught"] = b_fault_readings(dev, args.seed)
    if 8 in parts:
        with tempfile.TemporaryDirectory() as root:
            summary["phase21_caught"] = tf_train_fault_readings(dev, args.seed, root)
    if 9 in parts:
        with tempfile.TemporaryDirectory() as root:
            summary["phase23_caught"] = trainer_fault_readings(dev, args.seed, root)
    if 10 in parts:
        with tempfile.TemporaryDirectory() as root:
            summary["phase24_25_caught"] = dp_fault_readings(dev, args.seed, root, card)
    if 11 in parts:
        with tempfile.TemporaryDirectory() as root:
            summary["phase26_28_caught"] = tp_fault_readings(dev, args.seed, root, card)
    print(json.dumps(summary))
    sound = ("sound", "encoder_sound", "e_sound", "walker_sound", "export_sound", "served_sound",
             "reader_sound", "decode_sound", "bleu_sound", "resume_sound", "bc_sound",
             "dp_exact_bn_sound", "dp_subset_bn_r96_sound", "dp_exact_bn_f32_sound",
             "tp_sound", "paddle_sound", "export_sound")
    if any(bool(v.get(f)) for v in summary.values() for f in sound):
        return 1
    return 0 if all(bool(v[f]) for k, v in summary.items() if k != "phase11_caught"
                    for f in v if f not in sound
                    and f not in E_BELOW_RESOLUTION + DP_BELOW_RESOLUTION) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port's serving and training paths once on one CUDA card:
the LSTM family served and trained, the transformer family served (float and
int8), and the fused-IRB eval encoder.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failure exits non-zero with no result):

1. the card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``myimagecaptioningmodel_tpu_torch/csrc`` (nvcc, sm_90a);
2. kernel A (``greedy_vocab_argmax``) against its plain version at
   B in {8, 128}, V=12416, E=256, float32 and bfloat16 tables, plus a forced
   tie that must resolve to the lowest index;
3. kernel B (``fused_decode_step``) against ``reference_step`` at
   B in {1, 8, 128} with its head and, as beam search calls it, at
   M in {32, 512} rows (8 and 128 images x beam 4) without it; H=1024,
   E=256, k=49, V=12416: h', c', proj to atol 1e-4 in float32 and 3e-2 in
   bfloat16, the word under the near-tie rule;
4. the slice: a full-width LSTM captioner (MobileNetV2 x1.0 at 224 px,
   H=1024, E=256, vocab 12295 padded to 12416, 35 steps, bfloat16) with
   random weights from ``--seed``, written as a port bundle, served by
   ``CaptionService(device="cuda", batch_size=8)`` to 24 requests from 8
   threads; the kernels' launch counts must equal 35 x dispatches; the
   kernel path's ids are held against the plain path's step by step; then
   the single-image ``infer`` path (B=1);
5. timings with CUDA events after warm-up: ms per greedy batch and
   captions/s at B=8 and B=128, kernel path and plain path;
6. kernel A with an int8 table and its per-row scale against its plain
   version at B in {8, 128}, V=12416, E=256, under the near-tie rule, plus
   the forced tie on an int8 table;
7. kernel C (``topk_vocab_head``) against ``topk_vocab_head_reference`` at
   M in {32, 512} rows (8 and 128 images x beam 4), k in {1, 4, 8}, float32,
   bfloat16 and int8 + scale tables (V=12416, E=256, 12295 real rows): lse
   and the picked ids' logits (re-read from the plain float32 logits) to
   1e-4 for every table dtype (the plain version rounds as the kernel does;
   on an H100 the errors read 9.5e-7 for lse and 2.1e-6 for the values),
   ids under the near-tie rule at every rank; a forced tie across blocks
   must come out in ascending index order; µs per call (wall, CUDA events)
   and device µs per call (``device_us``: the call's kernels in
   torch.profiler) for the kernel and ``logits_addmm``, the bound
   (``bound_c``) and the share of it the kernel's device time reaches;
8. the served beam: ``CaptionService(batch_size=8, beam_size=4)`` on phase
   4's bundle, 24 requests from 8 threads: kernels B and C launch 35 x
   dispatches times, A none; the same with ``quantize=True``; then a greedy
   ``quantize=True`` service, where A and B launch 35 x dispatches times;
   each service's stored decoder size and its peak device memory above what
   was allocated before it loaded;
9. beam correctness on one batch of 8, in bfloat16 and float32: the kernel
   path's best beam, teacher-forced through the plain versions of the same
   branch (``reference_step(with_head=False)`` and the plain head's float32
   logits), re-scores to its reported score within 1e-3 (float32) and
   2e-3 x steps (bfloat16); in float32 its score is at least the plain beam
   path's less 1e-3; then the single-image ``infer`` path with beam 4 (B=1);
10. timings: beam-4 ms per batch and captions/s at B=8 and B=128, float and
   int8 weights, kernel path and plain path;
11. kernel F (``matmul_stats``) against ``_matmul_stats_reference`` at the
   training path's 1x1-conv shapes (B=128, 224 px), a ragged M and an
   unaligned K, N, in float32 (TF32 off) and bfloat16: y, and sum / sumsq
   against float64 sums of the kernel's own y and against the plain
   version's sums (limits at ``F_STATS_TOL``); us per call for the
   kernel, its plain version and ``torch.mm`` alone, device µs per call
   (``device_us``) for the kernel and ``torch.mm``, and each shape's bound
   and the share of it the kernel's device time reaches;
12. the training slice at full width (MobileNetV2 x1.0 at 224 px, H=1024,
   E=256, vocab 12295 padded to 12416, sentence length 35), random weights
   from ``--seed`` through ``compat/from_jax.train_tree``: (a) one B=32
   step in float32 fused and unfused, each held against a float64 step
   (limits at ``TRAIN_LIMITS``); (b) kernel F launches 35 times per forward
   fused and never unfused; (c) 20 bfloat16 fused steps at B=128 on one
   batch (lr 1e-3): the loss is finite and falls, F launches 700 times;
   (d) the trained model exported with ``export_inference_bundle`` and
   served greedily by ``load_bundle`` on CUDA: A and B launch 35 times;
13. train-step timing with CUDA events, bfloat16, B=128, unfused (plain)
   and fused (kernel) in the order plain, kernel, kernel, plain, 5 steps a
   window: ms per step over all 10 timed steps of each path (each window's
   beside it), images/s, peak device memory above base; then one profiled
   step of each, device time by kernel kind and the top kernels;
14. kernel D (``fused_greedy_decode``) against its plain version at full
   width (the default config with ``arch="transformer"``: D=1024, 4 layers, 8
   heads, MLP 4096, E=256, vocab 12295 padded to 12416, 50 memory slots, 35
   steps; random weights and image features): float32 at B=8 with ids equal,
   bfloat16 at B=8 and B=128; fixed length and early stop, with a bias on
   <stop> that stops rows at different steps and one that stops every row
   at step 0 (the device-side flag then skips the rest). Every id must be
   the plain argmax of ``teacher_forcing_logits`` on the kernel's own ids
   under the near-tie rule, with <pad> after <stop>; µs per decode for the
   kernel and the plain version, the kernel launches per decode, the bound,
   and a profile of one bf16 decode at each B;
15. kernel E (``fused_beam_decode``, beam 4, early stop on) at 8 and 128
   images (32 and 512 rows; 128 images give each warp of ``beam_select``
   16 images), float32 and bfloat16, with no <stop> bias (beams run 35
   steps) and the "mixed" one. E's beams are replayed through the plain
   KV-cached step (``beam_replay``): at every step each chosen candidate
   must lie within the plain top 4 of the 4 x V candidates on E's own
   prefixes, up to the step's near-tie gap (``beam_gap``), with no
   candidate chosen twice, and in the plain order where no near tie is;
   lengths equal, <pad> and identity back-pointers after the early stop;
   every beam's score, and the best beam's teacher-forced re-score, within
   ``E_RESCORE`` x sqrt(live steps) of the plain one; every image with no
   near tie at any step has words, back-pointers and lengths equal to the
   plain version's (float32: and scores to 1e-4). The transformer weights
   get random biases and LayerNorm parameters (``randomize_affine``).
   Times, bound and profile;
16. a full-width random transformer bundle from ``--seed`` served greedy and
   beam 4 by ``CaptionService(batch_size=8)`` to 24 requests from 8 threads:
   D (greedy) or E (beam) launches once per dispatch and no LSTM kernel
   launches; the served model's greedy ids held against the plain
   teacher-forced logits; ms per batch and captions/s at B=8 and B=128,
   kernel path (weights packed once at load, and, beside it, packed on
   every batch) and plain path (the plain KV-cached loop of
   ``models/transformer.py``);
17. kernel G (``fused_inverted_residual`` and ``fused_irb_chain``) against
   its plain version at the 17 inverted-residual block shapes of
   MobileNetV2 x1.0 at 224 px, B in {8, 128}, float32 (TF32 off) and
   bfloat16: the NHWC entry with the expanded tensor in float32 and in the
   activation dtype, and the chain entry, whose border rows, W tail and
   channel pad must be exactly 0; max |kernel - plain| / max |plain| to
   ``G_TOL``; µs per call of the kernel, its plain version and the folded
   block as three cuDNN convolutions, and the bound (``bound_g``);
18. the fused eval encoder at full width (MobileNetV2 x1.0, 224 px, B in
   {8, 128}, float32 and bfloat16, random weights and random BN statistics
   from ``--seed``): ``mobilenet_v2.apply(train=False, use_fused_irb=True)``
   launches G 17 times a forward, and its features hold against the same
   forward on G's plain version and against the plain eval encoder
   (``ENC_TOL``); ms per forward of both encoders and a profile of one bf16
   B=128 fused forward;
19. int8 transformer serving: kernel D with the int8 weight stream, and
   with int8 cross-attention memory too, at B=8 and B=128 bf16 (float32
   B=8 ids equal to the plain version), each id the plain teacher-forced
   argmax under the near-tie rule; kernel E with the int8 weight stream at
   8 images through ``beam_replay`` and at 128 images by the best beam's
   re-score, under ``E_RESCORE``; then phase 16's bundle served with
   ``CaptionService(quantize=True)`` greedy and beam 4 (D or E launches
   once per dispatch) and through ``load_bundle(quantize=True,
   quantize_kv=True)``: the packed weights' size (the layer streams int8),
   the peak device memory, ms per batch and captions/s, kernel and plain
   path.

Near-tie rule: ids must agree wherever the plain version's top-2 logit gap
exceeds 1e-3 x max|logit| (float32) or 2e-2 (bfloat16 and int8 tables); for
the top-k head, at every rank whose plain sorted value is clear of both
neighbouring ranks by that gap. Float32 products are compared with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False).

The line before the last is one JSON object describing each kernel (the
launches of A and B are phase 4's, those of C phase 8's beam service, those
of F phase 12 (c)'s, those of D and E phase 16's services, one per decode,
those of D's and E's int8 modes phase 19's services, and G's phase 18's
first forward, 17; ``bound_ms`` from the inputs' bytes at 3.35 TB/s and
their operations at the peak rate of their type, whichever is longer (for D
and E the bytes each step must read again, ``bound_tf``); G's numbers are
sums over the 17 blocks of one bf16 B=8 forward; ``library_ms`` one
``torch.addmm`` of the logits for A and C, ``torch.mm`` for F, each doing
less than the kernel, the three cuDNN convolutions of each block for G,
none for B, D and E), after a line with the script's own seconds; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

V_PAD, E, H, K_SLOTS = 12416, 256, 1024, 49
REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_A_SRC = "myimagecaptioningmodel_tpu_torch/csrc/vocab_head.cu"
KERNEL_B_SRC = "myimagecaptioningmodel_tpu_torch/csrc/fused_step.cu"
KERNEL_A_TPU = "myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py:89"
KERNEL_B_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_step.py:219"
KERNEL_C_SRC = "myimagecaptioningmodel_tpu_torch/csrc/topk_head.cu"
KERNEL_C_TPU = "myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py:206"
V_REAL, BEAM = 12295, 4
KERNEL_F_SRC = "myimagecaptioningmodel_tpu_torch/csrc/matmul_bn.cu"
KERNEL_F_TPU = "myimagecaptioningmodel_tpu/ops/pallas/matmul_bn.py:72"
KERNEL_DE_SRC = "myimagecaptioningmodel_tpu_torch/csrc/fused_transformer.cu"
KERNEL_D_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py:1061"
KERNEL_E_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py:1198"
# the int8 branches inside the same pallas_calls: D's int8_stream, int8_kv; E's
KERNEL_D_INT8_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py:1088"
KERNEL_D_INT8KV_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py:1089"
KERNEL_E_INT8_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py:1234"
TF_STEPS, TF_HEADS, STOP = 35, 8, 3


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def near_tie_ok(ids, logits, dt) -> bool:
    """ids == plain argmax wherever the plain top-2 gap is clear."""
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    if dt == torch.float32:
        clear = gap > 1e-3 * logits.abs().amax(dim=-1)
    else:
        clear = gap > 2e-2
    ref = logits.argmax(dim=-1).to(torch.int32)
    return bool(((ids.to(torch.int32) == ref) | ~clear).all())


def near_tie_gap(logits, dt):
    if dt == torch.float32:
        return 1e-3 * logits.abs().amax(dim=-1, keepdim=True)
    return 2e-2


def ranks_clear(logits, k, dt):
    """[B, k] bool: the plain sorted value at rank i is clear of ranks i-1
    and i+1 by the near-tie gap (a near tie may swap two ranks, and then
    only)."""
    v = torch.sort(logits, dim=-1, descending=True).values[:, : k + 1]
    after = (v[:, :-1] - v[:, 1:]) > near_tie_gap(logits, dt)
    before = torch.cat([torch.ones_like(after[:, :1]), after[:, :-1]], dim=1)
    return after & before


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the device, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int = 10) -> float:
    """Device µs per call: the summed device time of the kernels ``reps``
    calls launch, read by torch.profiler, over ``reps`` (after one warm-up
    call). ``time_ms`` of a µs-scale call reads the host's enqueue rate."""
    fn()
    for _attempt in range(3):  # a profile now and then comes back empty
        _wall, events = profile_events(lambda: [fn() for _ in range(reps)])
        total = sum(dev_us(e) for e in events)
        if total > 0:
            return total / reps
    raise AssertionError("torch.profiler saw no device time in three profiles")


def logits_addmm(proj, table, bias):
    """The yardstick beside kernels A and C: one ``torch.addmm`` of the
    [rows, V] logits in the table's dtype. It does less than either kernel
    (no argmax, no top-k, no logsumexp)."""
    dt = table.dtype
    return torch.addmm(bias.to(dt), proj.to(dt), table.t())


# ---- phase 1 ----------------------------------------------------------------


def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    regs = [ln.strip() for ln in _build.ptxas_log.splitlines() if "Used" in ln]
    for ln in regs:
        print(ln, file=sys.stderr)
    say("build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_seconds=_build.build_seconds, library=_build.library_path().name)
    return smi


# ---- phase 2 ----------------------------------------------------------------


def phase_kernel_a(dev, gen):
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
        greedy_vocab_argmax as kernel,
        greedy_vocab_argmax_reference as plain,
    )

    worst = 0.0
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        for B in (8, 128):
            proj = torch.randn(B, E, generator=gen).to(dev)
            table = (torch.rand(V_PAD, E, generator=gen) * 2 - 1).div(16).to(dev, dt)
            bias = torch.randn(V_PAD, generator=gen).mul(0.1).to(dev)
            bias[12295:] = -1e9
            ids = kernel(proj, table, bias)
            torch.cuda.synchronize()
            logits = torch.matmul(proj.to(dt).float(), table.float().T) + bias
            ok = near_tie_ok(ids, logits, dt)
            ref = plain(proj, table, bias)
            pick = logits.gather(1, ids.long()[:, None]) - logits.gather(1, ref.long()[:, None])
            err = float(pick.abs().max())
            worst = max(worst, err) if dt == torch.bfloat16 else worst
            t_k = time_ms(lambda: kernel(proj, table, bias))
            t_p = time_ms(lambda: plain(proj, table, bias))
            t_l = time_ms(lambda: logits_addmm(proj, table, bias))
            times[(dt, B)] = (t_k, t_p, t_l)
            say("kernel_a", dtype=str(dt).split(".")[-1], B=B, near_tie_ok=ok,
                max_abs_err_of_picked_logit=err, kernel_us=round(t_k * 1e3, 2),
                plain_us=round(t_p * 1e3, 2), addmm_logits_us=round(t_l * 1e3, 2))
            if not ok:
                raise AssertionError(f"kernel A disagrees with its plain version ({dt}, B={B})")
    # forced tie: identical rows in different blocks -> lowest index wins
    for dt in (torch.float32, torch.bfloat16):
        B = 8
        proj = torch.rand(B, E, generator=gen).to(dev)
        table = (torch.rand(V_PAD, E, generator=gen) / 64).to(dev, dt)
        bias = torch.full((V_PAD,), -5.0, device=dev)
        winners = [12000, 9000, 4097, 4096, 65, 64, 63, 10]
        table[winners] = 0.25
        bias[winners] = 0.0
        ids = kernel(proj, table, bias)
        ref = plain(proj, table, bias)
        if not (bool((ids == 10).all()) and bool((ref == 10).all())):
            raise AssertionError(f"tie rule broken ({dt}): {ids.tolist()} vs {ref.tolist()}")
    say("kernel_a_tie", lowest_index_ok=True)
    return worst, times


# ---- phases 6 and 7 ----------------------------------------------------------


def head_operands(gen, dev, rows, dt):
    """proj [rows, E], a float or int8 table (int8 with its per-row scale,
    from the port's quantize_weight) and a bias whose rows >= V_REAL are
    -1e9, as the padded vocab's."""
    from myimagecaptioningmodel_tpu_torch.ops.quantization import quantize_weight

    proj = torch.randn(rows, E, generator=gen).to(dev)
    t = (torch.rand(V_PAD, E, generator=gen) * 2 - 1).div(16)
    if dt == torch.int8:
        table, scale = (x.to(dev) for x in quantize_weight(t, axis=1))
    else:
        table, scale = t.to(dev, dt), None
    bias = torch.randn(V_PAD, generator=gen).mul(0.1).to(dev)
    bias[V_REAL:] = -1e9
    return proj, table, bias, scale


def tie_operands(gen, dev, dt, winners):
    """Rows ``winners`` equal and best by far, in several vocab blocks."""
    from myimagecaptioningmodel_tpu_torch.ops.quantization import quantize_weight

    proj = torch.rand(8, E, generator=gen).to(dev)
    t = torch.rand(V_PAD, E, generator=gen) / 64
    t[winners] = 0.25
    if dt == torch.int8:
        table, scale = (x.to(dev) for x in quantize_weight(t, axis=1))
    else:
        table, scale = t.to(dev, dt), None
    bias = torch.full((V_PAD,), -5.0, device=dev)
    bias[winners] = 0.0
    return proj, table, bias, scale


TIE_WINNERS = [12000, 9000, 4097, 4096, 65, 64, 63, 10]


def phase_kernel_a_int8(dev, gen):
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
        greedy_vocab_argmax as kernel,
        greedy_vocab_argmax_reference as plain,
        head_logits_reference,
    )

    worst, times = 0.0, {}
    for B in (8, 128):
        proj, table, bias, scale = head_operands(gen, dev, B, torch.int8)
        ids = kernel(proj, table, bias, scale)
        torch.cuda.synchronize()
        logits = head_logits_reference(proj, table, bias, scale)
        ok = near_tie_ok(ids, logits, torch.int8)
        ref = plain(proj, table, bias, scale)
        err = float((logits.gather(1, ids.long()[:, None])
                     - logits.gather(1, ref.long()[:, None])).abs().max())
        worst = max(worst, err)
        t_k = time_ms(lambda: kernel(proj, table, bias, scale))
        t_p = time_ms(lambda: plain(proj, table, bias, scale))
        times[B] = (t_k, t_p)
        say("kernel_a_int8", B=B, near_tie_ok=ok, max_abs_err_of_picked_logit=err,
            kernel_us=round(t_k * 1e3, 2), plain_us=round(t_p * 1e3, 2))
        if not ok:
            raise AssertionError(f"kernel A (int8) disagrees with its plain version (B={B})")
    proj, table, bias, scale = tie_operands(gen, dev, torch.int8, TIE_WINNERS)
    ids, ref = kernel(proj, table, bias, scale), plain(proj, table, bias, scale)
    if not (bool((ids == 10).all()) and bool((ref == 10).all())):
        raise AssertionError(f"tie rule broken (int8): {ids.tolist()} vs {ref.tolist()}")
    say("kernel_a_int8_tie", lowest_index_ok=True)
    return worst, times


def phase_kernel_c(dev, gen):
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
        head_logits_reference,
        topk_vocab_head as kernel,
        topk_vocab_head_reference as plain,
    )

    worst, times = 0.0, {}
    tol = 1e-4
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        for M in (8 * BEAM, 128 * BEAM):
            proj, table, bias, scale = head_operands(gen, dev, M, dt)
            logits = head_logits_reference(proj, table, bias, scale)
            for k in (1, 4, 8):
                vals, ids, lse = kernel(proj, table, bias, k, scale)
                torch.cuda.synchronize()
                _rv, ri, rlse = plain(proj, table, bias, k, scale)
                err_lse = float((lse - rlse).abs().max())
                err_v = float((vals - logits.gather(1, ids.long())).abs().max())
                ids_ok = bool(((ids == ri) | ~ranks_clear(logits, k, dt)).all())
                ok = err_lse <= tol and err_v <= tol and ids_ok and int(ids.max()) < V_REAL
                if dt != torch.float32:
                    worst = max(worst, err_lse, err_v)
                t_k = time_ms(lambda: kernel(proj, table, bias, k, scale))
                t_p = time_ms(lambda: plain(proj, table, bias, k, scale))
                t_l = (time_ms(lambda: logits_addmm(proj, table, bias))
                       if dt != torch.int8 else None)
                d_k = device_us(lambda: kernel(proj, table, bias, k, scale))
                d_l = (device_us(lambda: logits_addmm(proj, table, bias))
                       if dt != torch.int8 else None)
                b_ms, b_by = bound_c(M, k, dt)
                times[(dt, M, k)] = (t_k, t_p, t_l, d_k, d_l)
                say("kernel_c", dtype=str(dt).split(".")[-1], M=M, k=k, tol=tol,
                    err_lse=err_lse, err_vals=err_v, ids_near_tie_ok=ids_ok,
                    kernel_us=round(t_k * 1e3, 2), kernel_device_us=round(d_k, 2),
                    plain_us=round(t_p * 1e3, 2),
                    addmm_logits_us=None if t_l is None else round(t_l * 1e3, 2),
                    addmm_logits_device_us=None if d_l is None else round(d_l, 2),
                    bound_us=round(b_ms * 1e3, 2), bound_by=b_by,
                    bound_share=round(b_ms * 1e3 / d_k, 4))
                if not ok:
                    raise AssertionError(
                        f"kernel C disagrees with its plain version ({dt}, M={M}, k={k})")
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        proj, table, bias, scale = tie_operands(gen, dev, dt, TIE_WINNERS)
        vals, ids, _lse = kernel(proj, table, bias, 8, scale)
        _rv, ri, _rl = plain(proj, table, bias, 8, scale)
        want = [sorted(TIE_WINNERS)] * 8
        if ids.tolist() != want or ri.tolist() != want or bool((vals != vals[:, :1]).any()):
            raise AssertionError(f"top-k tie order broken ({dt}): {ids.tolist()}")
    say("kernel_c_tie", ascending_index_ok=True)
    return worst, times


# ---- phase 3 ----------------------------------------------------------------


def _step_inputs(dev, gen, B, dt, params):
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    img = torch.rand(B, K_SLOTS, H, generator=gen).to(dev)
    gf = torch.rand(B, H, generator=gen).to(dev)
    pre = D.precompute(params, img, gf, dt)
    fp = FS.prepare(params, pre, 0, dt)
    word = torch.randint(0, 12295, (B,), generator=gen).to(dev)
    h = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
    c = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
    return fp, fp.emb_table[word], h, c, pre.img_k.contiguous(), pre.img_v.contiguous()


def phase_kernel_b(dev, gen, params32):
    """Greedy rows (with the head) and beam rows (without it, as beam search
    calls it on 8 and 128 images x beam 4)."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    worst = 0.0
    times = {}
    cases = [(B, True) for B in (1, 8, 128)] + [(M, False) for M in (8 * BEAM, 128 * BEAM)]
    for dt in (torch.float32, torch.bfloat16):
        tol = 1e-4 if dt == torch.float32 else 3e-2
        for B, head in cases:
            args = _step_inputs(dev, gen, B, dt, params32)
            out = FS.fused_decode_step(*args, with_head=head, compute_dtype=dt)
            torch.cuda.synchronize()
            ref = FS.reference_step(*args, with_head=head, compute_dtype=dt)
            errs = [float((o - r).abs().max()) for o, r in zip(out[:3], ref[:3])]
            ok = max(errs) <= tol
            if head:
                fp = args[0]
                logits = (torch.matmul(ref[2].to(dt).float(), fp.head_table.float().T)
                          + fp.head_bias)
                ok = ok and near_tie_ok(out[3], logits, dt)
            if dt == torch.bfloat16:
                worst = max(worst, *errs)
            t_k = time_ms(lambda: FS.fused_decode_step(*args, with_head=head, compute_dtype=dt))
            t_p = time_ms(lambda: FS.reference_step(*args, with_head=head, compute_dtype=dt))
            times[(dt, B, head)] = (t_k, t_p)
            say("kernel_b", dtype=str(dt).split(".")[-1], rows=B, with_head=head, atol=tol,
                tf32=torch.backends.cuda.matmul.allow_tf32,
                err_h=errs[0], err_c=errs[1], err_proj=errs[2], ok=ok,
                kernel_us=round(t_k * 1e3, 2), plain_us=round(t_p * 1e3, 2))
            if not ok:
                raise AssertionError(
                    f"kernel B disagrees with reference_step ({dt}, rows={B}, head={head})")
    return worst, times


# ---- phase 4 ----------------------------------------------------------------


def write_bundle(root, seed, overrides=()):
    """Random LSTM captioner at the default (full) config, with dotted-path
    ``overrides``, plus a synthetic vocab -> a port bundle under ``root``."""
    from myimagecaptioningmodel_tpu_torch.config import Config, replace_nested
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    cfg = Config()
    for path, value in (("train.checkpoint_path", os.path.join(root, "save")),
                        ("data.dict_path", os.path.join(root, "dataset")),
                        *overrides):
        cfg = replace_nested(cfg, path, value)
    opts = C.ModelOptions.from_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    params, state = C.init(gen, opts)
    # spread the BN moving statistics so that images give distinct features
    for name, s in state["encoder"].items():
        n = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = torch.randn(n, generator=gen) * 0.1
        s["bn"]["var"] = torch.rand(n, generator=gen) * 0.3 + 0.3
    words = ["<pad>", "<unk>", "<start>", "<stop>"] + [
        f"w{i}" for i in range(4, cfg.model.decoder.vocab_size)
    ]
    vocab_dir = cfg.data.dict_path
    os.makedirs(vocab_dir)
    np.save(os.path.join(vocab_dir, "word_dict.npy"),
            np.array([{w: i for i, w in enumerate(words)}, dict(enumerate(words))],
                     dtype=object), allow_pickle=True)
    ckpt.export_inference_bundle(os.path.join(cfg.train.checkpoint_path, "infer"),
                                 params, state, cfg, vocab_src_dir=vocab_dir)
    return cfg


def plain_teacher_forced_ok(model, opts, images, ids):
    """Run the plain (unfused) step fed with the kernel path's own ids and
    check each step's argmax under the near-tie rule -> (ok, steps checked)."""
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.quantization import dense_in_dim

    dt = opts.dtype
    prm = model.params["decoder"]
    with torch.no_grad():
        img_embed, _f, gf = C.img2feature(model, images, opts)
        pre = D.precompute(prm, img_embed, gf, dt)
        B = ids.shape[0]
        h = torch.zeros(B, dense_in_dim(prm["p_hid"]), device=ids.device)
        c = torch.zeros_like(h)
        word = torch.full((B,), opts.start_idx, dtype=torch.long, device=ids.device)
        for t in range(ids.shape[1]):
            h, c, proj = D.step_core(prm, pre, word, h, c, opts.parity_mode,
                                     opts.padding_idx, dt)
            logits = D.head_logits(prm, proj, dt)
            if not near_tie_ok(ids[:, t], logits, dt):
                return False, t
            word = ids[:, t].long()
    return True, ids.shape[1]


def phase_slice(dev, seed, root, overrides=()):
    from myimagecaptioningmodel_tpu_torch.inference import infer
    from myimagecaptioningmodel_tpu_torch.inference.server import CaptionService
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    cfg = write_bundle(root, seed, overrides)
    steps = cfg.model.decoder.infer_max_length
    shape = tuple(cfg.data.image_shape)
    t0 = time.perf_counter()
    svc = CaptionService(cfg, batch_size=8, max_wait_ms=50.0, device=dev)
    say("service", load_and_warmup_s=round(time.perf_counter() - t0, 2),
        use_kernels=svc.opts.use_kernels, dtype=svc.opts.compute_dtype)
    try:
        rng = np.random.RandomState(seed)
        images = rng.rand(24, *shape, 3).astype(np.float32)
        VH.greedy_vocab_argmax.launches = 0
        FS.fused_decode_step.launches = 0
        with ThreadPoolExecutor(max_workers=8) as pool:
            results = list(pool.map(svc.caption_array, images))
        launches = {"fused_decode_step": FS.fused_decode_step.launches,
                    "greedy_vocab_argmax": VH.greedy_vocab_argmax.launches}
        st = svc.stats()
    finally:
        svc.close()
    for r in results:
        if len(r["ids"]) != steps or not isinstance(r["caption"], str):
            raise AssertionError(f"bad answer: {r}")
    d = st["dispatches"]
    if st["served"] != 24 or not 3 <= d <= 24 or round(st["mean_batch_fill"] * d) != 24:
        raise AssertionError(f"counters do not reconcile: {st}")
    expect = steps * d if dev.type == "cuda" else 0  # CPU tensors launch nothing
    for name, n in launches.items():
        if n != expect:
            raise AssertionError(f"{name}: {n} launches for {d} dispatches")
    say("slice_serve", requests=24, dispatches=d, mean_batch_fill=st["mean_batch_fill"],
        decode_ms_p50=st["decode_ms_p50"], launches=json.dumps(launches).replace(" ", ""),
        distinct_captions=len({tuple(r["ids"]) for r in results}))

    # kernel path vs plain path on one batch, step by step
    model, opts = svc.model, svc.opts
    batch = images[:8]
    ids = C.greedy_decode(model, batch, opts)
    ok, steps = plain_teacher_forced_ok(model, opts._replace(use_kernels=False), batch, ids)
    # (informational: cuDNN may pick other conv algorithms at other batch
    # sizes, so the served batches need not reproduce bit for bit)
    served = np.array([r["ids"] for r in results[:8]])
    same_as_served = bool((ids.cpu().numpy() == served).all())
    say("slice_vs_plain", near_tie_ok=ok, steps_checked=steps,
        served_ids_reproduced=same_as_served)
    if not ok:
        raise AssertionError(f"kernel path disagrees with the plain path at step {steps}")

    # single-image CLI path (B=1)
    one, sentence = infer.caption_array(cfg, images[0], device=dev)
    if len(one) != steps or not isinstance(sentence, str):
        raise AssertionError(f"infer (B=1) gave {one!r}")
    say("slice_infer", B=1, ids_len=len(one), matches_served=one == results[0]["ids"])
    return launches, model, opts, cfg


# ---- phases 8 and 9 -----------------------------------------------------------


SERVED = (  # (label, CaptionService options, kernels that launch once per step)
    ("beam", dict(beam_size=BEAM), ("fused_decode_step", "topk_vocab_head")),
    ("beam_int8", dict(beam_size=BEAM, quantize=True), ("fused_decode_step", "topk_vocab_head")),
    ("greedy_int8", dict(quantize=True), ("fused_decode_step", "greedy_vocab_argmax")),
)


def phase_served_beam(dev, seed, cfg):
    """-> (launch counts of the float beam service, {label: model}, the
    float beam service's options)."""
    from myimagecaptioningmodel_tpu_torch.inference.server import CaptionService
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    def stored_bytes(tree):
        return sum(stored_bytes(v) if isinstance(v, dict) else v.nbytes for v in tree.values())

    counters = {"fused_decode_step": FS.fused_decode_step,
                "greedy_vocab_argmax": VH.greedy_vocab_argmax,
                "topk_vocab_head": VH.topk_vocab_head}
    steps = cfg.model.decoder.infer_max_length
    images = np.random.RandomState(seed).rand(24, *cfg.data.image_shape, 3).astype(np.float32)
    models, beam_launches = {}, None
    for label, kw, per_step in SERVED:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        svc = CaptionService(cfg, batch_size=8, max_wait_ms=50.0, device=dev, **kw)
        load_s = round(time.perf_counter() - t0, 2)
        try:
            for fn in counters.values():
                fn.launches = 0
            with ThreadPoolExecutor(max_workers=8) as pool:
                results = list(pool.map(svc.caption_array, images))
            launches = {name: fn.launches for name, fn in counters.items()}
            st = svc.stats()
        finally:
            svc.close()
        for r in results:
            if len(r["ids"]) != steps or not isinstance(r["caption"], str):
                raise AssertionError(f"{label}: bad answer: {r}")
        d = st["dispatches"]
        if st["served"] != 24 or not 3 <= d <= 24 or round(st["mean_batch_fill"] * d) != 24:
            raise AssertionError(f"{label}: counters do not reconcile: {st}")
        # CPU tensors launch nothing
        want = {name: steps * d if name in per_step and dev.type == "cuda" else 0
                for name in counters}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want} "
                                 f"for {d} dispatches")
        say("served_" + label, load_and_warmup_s=load_s, requests=24, dispatches=d,
            decode_ms_p50=st["decode_ms_p50"],
            decoder_stored_mib=round(stored_bytes(svc.model.params["decoder"]) / 2**20, 2),
            peak_mib_above_base=round((torch.cuda.max_memory_allocated(dev) - base) / 2**20, 1),
            launches=json.dumps(launches).replace(" ", ""),
            distinct_captions=len({tuple(r["ids"]) for r in results}))
        models[label] = svc.model
        if label == "beam":
            beam_launches, opts = launches, svc.opts
    return beam_launches, models, opts


def teacher_forced_scores(model, opts, images, ids):
    """Sum of log-softmax of ``ids`` until <stop>, through the plain versions
    of the fused-head branch: ``reference_step(with_head=False)`` and the
    plain head's float32 logits -> (scores [B], steps [B])."""
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import head_logits_reference
    from myimagecaptioningmodel_tpu_torch.ops.quantization import head_table

    dt = opts.dtype
    prm = model.params["decoder"]
    table, scale = head_table(prm["embedding"], dt)
    img_embed, _f, gf = C.img2feature(model, images, opts)
    pre = D.precompute(prm, img_embed, gf, dt)
    fp = FS.prepare(prm, pre, opts.padding_idx, dt)
    img_k, img_v = pre.img_k.to(dt).contiguous(), pre.img_v.to(dt).contiguous()
    B = ids.shape[0]
    h = torch.zeros(B, img_k.shape[-1], device=ids.device)
    c = torch.zeros_like(h)
    word = torch.full((B,), opts.start_idx, dtype=torch.long, device=ids.device)
    total = torch.zeros(B, device=ids.device)
    steps = torch.zeros(B, device=ids.device)
    alive = torch.ones(B, dtype=torch.bool, device=ids.device)
    for t in range(ids.shape[1]):
        h, c, proj, _w = FS.reference_step(fp, fp.emb_table[word], h, c, img_k, img_v,
                                           with_head=False, compute_dtype=dt)
        logp = torch.log_softmax(head_logits_reference(proj, table, prm["out_bias"], scale), -1)
        word = ids[:, t].long()
        total += torch.where(alive, logp.gather(1, word[:, None])[:, 0], 0.0)
        steps += alive.float()
        alive &= word != opts.stop_idx
    return total, steps


@torch.no_grad()
def phase_beam_correct(dev, model, opts, cfg, seed):
    from myimagecaptioningmodel_tpu_torch.inference import infer
    from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode

    rng = np.random.RandomState(seed + 2)
    images = torch.as_tensor(rng.rand(8, *cfg.data.image_shape, 3).astype(np.float32)).to(dev)
    for dtype in ("bfloat16", "float32"):
        o = opts._replace(compute_dtype=dtype, use_kernels=True)
        ids, score = beam_decode(model, images, o, BEAM, stop_idx=o.stop_idx)
        rescore, steps = teacher_forced_scores(model, o, images, ids)
        tol = 1e-3 if dtype == "float32" else 2e-3 * steps
        err = (rescore - score).abs()
        ok = bool((err <= tol).all())
        p_ids, p_score = beam_decode(model, images, o._replace(use_kernels=False), BEAM,
                                     stop_idx=o.stop_idx)
        line = dict(dtype=dtype, rescore_max_abs_err=float(err.max()),
                    steps=[int(x) for x in steps.tolist()], rescore_ok=ok,
                    rows_equal_to_plain=float((ids == p_ids).all(dim=1).float().mean()))
        if dtype == "float32":
            not_worse = bool((score >= p_score - 1e-3).all())
            ok = ok and not_worse
            line.update(score_not_below_plain=not_worse,
                        min_score_minus_plain=float((score - p_score).min()))
        say("beam_vs_plain", **line)
        if not ok:
            raise AssertionError(f"beam kernel path disagrees with the plain versions ({dtype})")
    one, sentence = infer.caption_array(cfg, images[0].cpu().numpy(), beam_size=BEAM, device=dev)
    steps = cfg.model.decoder.infer_max_length
    if len(one) != steps or not isinstance(sentence, str):
        raise AssertionError(f"infer (B=1, beam {BEAM}) gave {one!r}")
    say("beam_infer", B=1, beam=BEAM, ids_len=len(one))


# ---- phase 5 ----------------------------------------------------------------


def phase_timing(model, opts, seed):
    from myimagecaptioningmodel_tpu_torch.models import captioner as C

    rng = np.random.RandomState(seed + 1)
    out = {}
    for B in (8, 128):
        imgs = torch.as_tensor(rng.rand(B, 224, 224, 3).astype(np.float32)).cuda()
        t = {}
        for path in ("plain", "kernel", "kernel", "plain"):
            o = opts._replace(use_kernels=(path == "kernel"))
            ms = time_ms(lambda: C.greedy_decode(model, imgs, o), reps=5, warmup=2)
            t.setdefault(path, []).append(ms)
        k, p = min(t["kernel"]), min(t["plain"])
        out[B] = (k, p)
        say("timing", B=B, kernel_ms_per_batch=round(k, 3), plain_ms_per_batch=round(p, 3),
            kernel_captions_per_s=round(B / k * 1e3, 1),
            plain_captions_per_s=round(B / p * 1e3, 1),
            runs_kernel=[round(x, 3) for x in t["kernel"]],
            runs_plain=[round(x, 3) for x in t["plain"]])
    return out


# ---- phase 10 ---------------------------------------------------------------


def phase_beam_timing(models, opts, seed):
    from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode

    rng = np.random.RandomState(seed + 3)
    for label in ("beam", "beam_int8"):
        model = models[label]
        for B in (8, 128):
            imgs = torch.as_tensor(rng.rand(B, 224, 224, 3).astype(np.float32)).to(model.device)
            t = {}
            for path in ("plain", "kernel", "kernel", "plain"):
                o = opts._replace(use_kernels=(path == "kernel"))
                ms = time_ms(lambda: beam_decode(model, imgs, o, BEAM, stop_idx=o.stop_idx),
                             reps=3, warmup=1)
                t.setdefault(path, []).append(ms)
            k, p = min(t["kernel"]), min(t["plain"])
            say("timing_" + label, beam=BEAM, B=B, kernel_ms_per_batch=round(k, 3),
                plain_ms_per_batch=round(p, 3), kernel_captions_per_s=round(B / k * 1e3, 1),
                plain_captions_per_s=round(B / p * 1e3, 1),
                runs_kernel=[round(x, 3) for x in t["kernel"]],
                runs_plain=[round(x, 3) for x in t["plain"]])


# ---- bounds ------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def bound(nbytes: float, ops: float, dt) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of the inputs' type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def head_bytes(rows, dt, out_bytes_per_row):
    """proj [rows, E] f32 + table [V, E] + bias [V] f32 + the outputs."""
    es = torch.tensor([], dtype=dt).element_size()
    return rows * E * 4 + V_PAD * E * es + V_PAD * 4 + rows * out_bytes_per_row


def bound_a(B, dt):
    return bound(head_bytes(B, dt, 4), 2 * B * V_PAD * E, dt)


def bound_c(M, k, dt):
    return bound(head_bytes(M, dt, 8 * k + 4), 2 * M * V_PAD * E, dt)


def bound_b(B, dt):
    """The fused step with its head: the step's operands and outputs
    (fused_step.py's list) plus kernel A's table and bias."""
    es = torch.tensor([], dtype=dt).element_size()
    weights = E * 5 * H + H * 5 * H + 4 * H * H + H * E + H  # in the compute dtype
    step = (weights * es + (4 * H + E + 1) * 4  # + the f32 biases
            + B * (E * es + 2 * H * 4 + 2 * K_SLOTS * H * es + 5 * H * 4)  # per-row inputs
            + B * (2 * H * 4 + E * 4 + 4))  # h', c', proj, word
    ops = 2 * B * weights + 4 * B * K_SLOTS * H + 2 * B * V_PAD * E
    return bound(step + head_bytes(B, dt, 0), ops, dt)


def bound_f(M, K, N, dt):
    es = torch.tensor([], dtype=dt).element_size()
    return bound((M * K + K * N + M * N) * es + 2 * N * 4, 2 * M * K * N, dt)


# ---- phase 11 ----------------------------------------------------------------

# (conv, M, K, N): kernel F's shapes on the training path at B=128, 224 px,
# then a ragged M, and rows that are not whole 16-byte vectors
F_SHAPES = (
    ("conv2_1_expand", 1605632, 32, 32),
    ("conv3_1_expand", 1605632, 16, 96),
    ("conv3_2_expand", 401408, 24, 144),
    ("conv6_2_linear", 25088, 576, 96),
    ("conv9", 6272, 320, 1280),
    ("ragged", 1000, 24, 144),
    ("ragged_unaligned", 1000, 11, 37),
)
# Limits on kernel F's statistics (readings of ``f_stats_errors``), set
# between what the sound kernel and planted faults read on an H100
# (``chip_fault_check.py``, bf16, every shape above). sum, relative to
# sum|y|: the sound kernel at most 1.4e-8 (the inputs are zero-mean, so its
# float32 partial sums stay small); sums over the float32 accumulator
# instead of the rounded y, or missing one row, at least 1.7e-6 at every
# shape. sumsq, relative to itself: the sound kernel at most 3.3e-6; the
# accumulator's at least 8.7e-6 and 3e-5 at M <= 401,408.
F_STATS_TOL = {"sum": 5e-7, "sumsq": 1e-5}


def f_stats_failures(errs):
    """The ``f_stats_errors`` readings over their limit."""
    return [k for k, v in errs.items() if v > F_STATS_TOL[k.split("_")[0]]]


def forward_f_shapes(B=128, size=224, scale=1.0):
    """(conv, M, K, N) of every stride-1 1x1 conv of one MobileNetV2 forward,
    the convs that go through kernel F, in order."""
    from myimagecaptioningmodel_tpu_torch.models.mobilenet_v2 import BOTTLENECK_PARAMS

    hw, in_c, shapes = size // 2, int(32 * scale), []
    for stage, (t, c, n, s) in enumerate(BOTTLENECK_PARAMS, start=2):
        c = int(c * scale)
        for i in range(1, n + 1):
            exp = int(round(in_c * t))
            shapes.append((f"conv{stage}_{i}_expand", B * hw * hw, in_c, exp))
            hw //= s if i == 1 else 1
            shapes.append((f"conv{stage}_{i}_linear", B * hw * hw, exp, c))
            in_c = c
    shapes.append(("conv9", B * hw * hw, in_c, 1280))
    return shapes


def say_forward_bound(dt=torch.bfloat16):
    """The summed bound of kernel F over one forward at B=128, 224 px."""
    shapes = forward_f_shapes()
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = sum((M * K + K * N + M * N) * es + 2 * N * 4 for _c, M, K, N in shapes)
    ops = sum(2 * M * K * N for _c, M, K, N in shapes)
    bounds = [(bound_f(M, K, N, dt), c) for c, M, K, N in shapes]
    largest = max(bounds)
    say("kernel_f_forward_bound", dtype=str(dt).split(".")[-1], launches=len(shapes),
        gbytes=round(nbytes / 1e9, 4), gflop=round(ops / 1e9, 2),
        bound_us_sum=round(sum(b[0][0] for b in bounds) * 1e3, 2),
        all_by_bytes=all(b[0][1] == "bytes" for b in bounds),
        largest=largest[1], largest_bound_us=round(largest[0][0] * 1e3, 2))
    return shapes


def bf16_ulp(mag):
    """One bf16 ulp (8 significant bits) of each magnitude."""
    return torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)


def accumulation_bound(x, w):
    """How far two float32 sums of the same K products, in other orders, may
    lie apart: 2 K 2^-24 sum_k |x w| (where y cancels to near zero, that is
    more than a bf16 ulp of y)."""
    K = x.shape[1]
    return 2 * K * 2.0 ** -24 * torch.matmul(x.float().abs(), w.float().abs())


def f_stats_errors(y, s, q, ry, rs, rq):
    """Kernel F's statistics, each as a relative error to hold to its
    F_STATS_TOL: against float64 sums of the kernel's own stored y
    (``sum``, ``sumsq``), and against the plain version's sums (``*_vs_plain``)
    less what the y values that differ from the plain version's move them,
    as ``tests/test_torch_matmul_bn.py`` allows."""
    y64, ry64 = y.double(), ry.double()
    mag, q64 = y64.abs().sum(0).clamp_min(1e-30), (y64 * y64).sum(0)
    moved_s = (y64 - ry64).abs().sum(0)
    moved_q = (y64 * y64 - ry64 * ry64).abs().sum(0)
    rmag, rq64 = ry64.abs().sum(0).clamp_min(1e-30), (ry64 * ry64).sum(0).clamp_min(1e-30)
    return {
        "sum": float(((s.double() - y64.sum(0)).abs() / mag).max()),
        "sumsq": float(((q.double() - q64).abs() / q64.clamp_min(1e-30)).max()),
        "sum_vs_plain": float((((s.double() - rs.double()).abs() - moved_s) / rmag).max()),
        "sumsq_vs_plain": float((((q.double() - rq.double()).abs() - moved_q) / rq64).max()),
    }


def phase_kernel_f(dev, seed):
    """Kernel F against its plain version. y: float32 (TF32 off) to 1e-4 x
    max|y|, bfloat16 to one bf16 ulp of the larger magnitude (the two
    accumulate in other orders, so a value may round to the neighbouring bf16
    number) plus ``accumulation_bound``. sum and sumsq by ``f_stats_errors``,
    to F_STATS_TOL."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels.matmul_bn import (
        _matmul_stats_reference as plain,
        matmul_stats as kernel,
    )

    shapes = {c: (M, K, N) for c, M, K, N in say_forward_bound()}
    if any(shapes[c] != (M, K, N) for c, M, K, N in F_SHAPES if c in shapes):
        raise AssertionError("F_SHAPES disagree with the forward's 1x1 convs")
    g = torch.Generator(device=dev).manual_seed(seed)
    worst, times = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        for name, M, K, N in F_SHAPES:
            x = torch.randn(M, K, device=dev, generator=g).to(dt)
            w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dt)
            y, s, q = kernel(x, w)
            torch.cuda.synchronize()
            ry, rs, rq = plain(x, w)
            yf, ryf = y.float(), ry.float()
            diff = (yf - ryf).abs()
            err_y = float(diff.max())
            beyond_one_ulp = None
            if dt == torch.float32:
                ok_y = err_y <= 1e-4 * float(ryf.abs().max())
            else:
                over = diff - bf16_ulp(torch.maximum(yf.abs(), ryf.abs()))
                ok_y = bool((over <= accumulation_bound(x, w)).all())
                beyond_one_ulp = int((over > 0).sum())
                worst = max(worst, err_y)
            errs = f_stats_errors(y, s, q, ry, rs, rq)
            ok = ok_y and not f_stats_failures(errs)
            t_k = time_ms(lambda: kernel(x, w), reps=10)
            t_p = time_ms(lambda: plain(x, w), reps=10)
            t_l = time_ms(lambda: torch.mm(x, w), reps=10)
            d_k = device_us(lambda: kernel(x, w), reps=5)
            d_l = device_us(lambda: torch.mm(x, w), reps=5)
            b_ms, b_by = bound_f(M, K, N, dt)
            times[(dt, name)] = (t_k, t_p, t_l, b_ms, b_by, d_k, d_l)
            say("kernel_f", dtype=str(dt).split(".")[-1], conv=name, M=M, K=K, N=N,
                err_y=err_y, y_ok=ok_y, beyond_one_ulp=beyond_one_ulp,
                **{f"err_{k}": v for k, v in errs.items()},
                stats_tol=json.dumps(F_STATS_TOL).replace(" ", ""),
                kernel_us=round(t_k * 1e3, 2), kernel_device_us=round(d_k, 2),
                plain_us=round(t_p * 1e3, 2), mm_us=round(t_l * 1e3, 2),
                mm_device_us=round(d_l, 2), bound_us=round(b_ms * 1e3, 2), bound_by=b_by,
                bound_share=round(b_ms * 1e3 / d_k, 4))
            if not ok:
                raise AssertionError(f"kernel F disagrees with its plain version ({dt}, {name})")
            del x, w, y, ry, yf, ryf, diff
    torch.cuda.empty_cache()
    return worst, times


# ---- phases 12 and 13 ----------------------------------------------------------

GROUPS = ("decoder", "encoder", "img_embed", "img_global")  # tree_leaves order


def train_cfg(root, dtype, fuse, batch, lr):
    from myimagecaptioningmodel_tpu_torch.config import Config, replace_nested

    cfg = Config()
    for path, value in (("train.checkpoint_path", os.path.join(root, "save")),
                        ("data.dict_path", os.path.join(root, "dataset")),
                        ("model.compute_dtype", dtype), ("model.fuse_bn_stats", fuse),
                        ("train.batch_size", batch), ("train.learning_rate", lr)):
        cfg = replace_nested(cfg, path, value)
    return cfg


def train_batch(cfg, dev, seed):
    """Random images and captions: <start>, words, <stop>, then padding."""
    rng = np.random.RandomState(seed)
    B, T = cfg.train.batch_size, cfg.model.decoder.sentence_length
    images = rng.rand(B, *cfg.data.image_shape, 3).astype(np.float32)
    caps = np.zeros((B, T), np.int64)
    caps[:, 0] = cfg.data.start_idx
    for b in range(B):
        n = rng.randint(8, T)
        caps[b, 1:n] = rng.randint(4, cfg.model.decoder.vocab_size, n - 1)
        caps[b, n] = cfg.data.stop_idx
    return torch.as_tensor(images).to(dev), torch.as_tensor(caps).to(dev)


def trainer(cfg, ref_params, ref_state, dev):
    """-> (train step, params, optimizer state, BN state) on ``dev`` from a
    reference-layout tree, through compat/from_jax's float32 path."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import build_steps, make_optimizer
    from myimagecaptioningmodel_tpu_torch.training import lr_schedules

    opts = C.ModelOptions.from_config(cfg)
    schedule = lr_schedules.from_config(cfg)
    optimizer = make_optimizer(cfg, schedule)
    dtype = torch.float64 if opts.compute_dtype == "float64" else torch.float32
    params, state = train_tree(ref_params, ref_state, device=dev, dtype=dtype)
    steps = build_steps(opts, optimizer, schedule, cfg.train.grad_accum_steps)
    return steps.train_step, params, optimizer.init(params), state


def rel_l2(a, b):
    num = sum(float(((x.double() - y.double()) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def bn_state_errors(fused, unfused, momentum=0.9):
    """(worst mean error in units of the batch std, worst relative var
    error) over every BN channel. Both runs start from mean 0, var 1, so the
    batch statistics are the new state less ``momentum`` x the old."""
    def pairs(a, b):
        if "mean" in b:
            yield a, b
        else:
            for k in b:
                yield from pairs(a[k], b[k])

    worst_m = worst_v = 0.0
    for a, b in pairs(fused, unfused):
        var = ((b["var"].double() - momentum) / (1 - momentum)).clamp_min(0)
        dm = (a["mean"].double() - b["mean"].double()).abs() / (1 - momentum)
        dv = (a["var"].double() - b["var"].double()).abs() / (1 - momentum)
        worst_m = max(worst_m, float((dm / (var.sqrt() + 1e-6)).max()))
        worst_v = max(worst_v, float((dv / (var + 1e-6)).max()))
    return worst_m, worst_v


# Phase 12 (a) holds the fused float32 step as close to a float64 step (the
# unfused path with float64 weights and compute, float32 only where the
# reference casts to it) as the unfused float32 step is. The two float32
# steps differ by the order of the BN sums and of the 1x1 products only, but
# float32 rounding noise grows through the backward of the encoder's 52 BN
# layers (the JAX package checks its fused path in float64 for that reason),
# and Adam's first update is close to lr x sign(g), so where g is within the
# noise its sign is arbitrary. Against the float64 step, for each parameter
# group: the gradient's relative L2 error and the BN statistics' errors
# (means in units of the channel's std, variances relative) at most
# ``error_ratio`` x the unfused step's plus 1e-6, the share of updates that
# agree to 1e-3 x lr at most ``update_agree_drop`` below it, and the loss's
# relative error. Each limit sits between what the sound fused step and
# planted faults read on an H100 (``chip_fault_check.py``, seed 0): the
# sound step reads ratios 0.90-1.09, drops of at most 5.4e-4 and a loss
# error of 1.4e-8; each fault (the unbiased variance, the mean over M-1
# rows, the rows past the last whole tile dropped, the backward without
# its xhat * dscale term) reads a ratio of 10.8 or more on some reading,
# the last three drops of 0.031 or more, and the unbiased variance a loss
# error of 5.2e-7.
TRAIN_LIMITS = {"loss_rel": 1e-7, "error_ratio": 3.0, "error_floor": 1e-6,
                "update_agree_drop": 0.005}


def step_errors(run, ref, lr):
    """A float32 run's errors against the float64 run, by group."""
    loss, grads, updates, state = run
    rloss, rgrads, rupdates, rstate = ref
    out = {"loss_rel": abs(loss - rloss) / abs(rloss)}
    for g in GROUPS:
        out[f"grad_rel_l2_{g}"] = rel_l2(grads[g], rgrads[g])
        agree = sum(int(((a.double() - b).abs() <= 1e-3 * lr).sum())
                    for a, b in zip(updates[g], rupdates[g]))
        out[f"update_agree_share_{g}"] = agree / sum(b.numel() for b in rupdates[g])
    out["bn_mean_in_std"], out["bn_var_rel"] = bn_state_errors(state, rstate)
    return out


def one_step_run(cfg, ref_params, ref_state, dev, images, caps):
    """One train step from the reference tree -> ((loss, gradients, updates,
    new BN state), kernel F's launches). The gradients are read back from
    Adam's first moment, (1 - b1) x the gradient after one step."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

    step, params, opt_state, state = trainer(cfg, ref_params, ref_state, dev)
    before = {g: [p.detach().clone() for p in tree_leaves(params[g])] for g in GROUPS}
    MB.matmul_stats.launches = 0
    params, opt_state, new_state, _n, loss, _lr = step(params, opt_state, state, 0,
                                                       images, caps)
    torch.cuda.synchronize()
    launches = MB.matmul_stats.launches
    grads, i = {}, 0
    for g in GROUPS:
        n = len(before[g])
        grads[g] = opt_state.adam.mu[i:i + n]
        i += n
    updates = {g: [p.detach() - b for p, b in zip(tree_leaves(params[g]), before[g])]
               for g in GROUPS}
    return (float(loss), grads, updates, new_state), launches


def fused_failures(fused, unfused):
    """The TRAIN_LIMITS readings on which the fused step's errors against
    float64 (``step_errors``) fail, given the unfused step's."""
    lim = TRAIN_LIMITS
    bad = [k for k in fused if k.startswith(("grad", "bn"))
           and fused[k] > lim["error_ratio"] * unfused[k] + lim["error_floor"]]
    bad += [k for k in fused if k.startswith("update")
            and fused[k] < unfused[k] - lim["update_agree_drop"]]
    return bad + (["loss_rel"] if fused["loss_rel"] > lim["loss_rel"] else [])


def phase_train(dev, seed, root):
    """(a) fused against unfused, (b) kernel F's launches per forward, (c)
    the loss falls, (d) the trained model exported and served. -> (launches
    of (c), the trained (params, state, cfg), timing inputs)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    lr = 1e-3
    cfg32 = train_cfg(root, "float32", False, 32, lr)
    ref_params, ref_state = C.init(torch.Generator().manual_seed(seed),
                                   C.ModelOptions.from_config(cfg32))
    n_params = sum(p.numel() for p in tree_leaves(ref_params))
    images, caps = train_batch(cfg32, dev, seed)

    # (a) + (b): one step from the same weights, float32 fused and unfused,
    # and the float64 reference
    runs = {}
    for label, dtype, fuse in (("unfused", "float32", False), ("fused", "float32", True),
                               ("float64", "float64", False)):
        cfg = train_cfg(root, dtype, fuse, 32, lr)
        runs[label], launches = one_step_run(cfg, ref_params, ref_state, dev, images, caps)
        want = 35 if fuse else 0
        if launches != want:
            raise AssertionError(f"kernel F launched {launches} times in one forward, "
                                 f"expected {want} (fuse_bn_stats={fuse})")
        say("train_step_one", B=32, dtype=dtype, fuse_bn_stats=fuse, loss=runs[label][0],
            kernel_f_launches=launches)
    errs = {label: step_errors(runs[label], runs["float64"], lr) for label in ("unfused", "fused")}
    for label in ("unfused", "fused"):
        say("train_vs_float64", path=label, **errs[label])
    bad = fused_failures(errs["fused"], errs["unfused"])
    say("train_fused_vs_unfused", limits=json.dumps(TRAIN_LIMITS).replace(" ", ""),
        failed=bad, ok=not bad)
    if bad:
        raise AssertionError(f"the fused train step is further from float64 than the "
                             f"unfused one: {bad}")
    del runs
    torch.cuda.empty_cache()

    # (c) bf16, B=128, fused: 20 steps on one fixed batch, the main path
    cfg = train_cfg(root, "bfloat16", True, 128, lr)
    images, caps = train_batch(cfg, dev, seed + 1)
    step, params, opt_state, state = trainer(cfg, ref_params, ref_state, dev)
    MB.matmul_stats.launches = 0
    losses, t0 = [], time.perf_counter()
    for i in range(20):
        params, opt_state, state, _n, loss, _lr = step(params, opt_state, state, i,
                                                       images, caps)
        losses.append(float(loss))
    seconds = time.perf_counter() - t0
    launches = {"matmul_stats": MB.matmul_stats.launches}
    finite = all(np.isfinite(losses))
    say("train_bf16", B=128, steps=20, params=n_params, first_loss=losses[0],
        last_loss=losses[-1], losses=[round(x, 4) for x in losses], finite=finite,
        seconds=round(seconds, 2), launches=json.dumps(launches).replace(" ", ""))
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches["matmul_stats"] != 35 * 20:
        raise AssertionError(f"kernel F: {launches} launches in 20 steps, expected 700")

    # (d) export the trained model and serve it greedily from the bundle
    p_np, s_np = reference_tree(params, state)
    ckpt.export_inference_bundle(os.path.join(cfg.train.checkpoint_path, "trained"),
                                 p_np, s_np, cfg, vocab_src_dir=cfg.data.dict_path)
    model, _bcfg, opts, decode = load_bundle(cfg, "trained", device=dev)
    FS.fused_decode_step.launches = 0
    VH.greedy_vocab_argmax.launches = 0
    ids = decode(model, images[:8])
    torch.cuda.synchronize()
    served = {"fused_decode_step": FS.fused_decode_step.launches,
              "greedy_vocab_argmax": VH.greedy_vocab_argmax.launches}
    steps = cfg.model.decoder.infer_max_length
    if served != {k: steps for k in served} or tuple(ids.shape) != (8, steps):
        raise AssertionError(f"serving the trained bundle: launches {served}, "
                             f"ids {tuple(ids.shape)}")
    ok, checked = plain_teacher_forced_ok(model, opts._replace(use_kernels=False),
                                          images[:8], ids)
    say("train_then_serve", bundle="trained", B=8, launches=json.dumps(served).replace(" ", ""),
        near_tie_ok=ok, steps_checked=checked,
        distinct_captions=len({tuple(r) for r in ids.tolist()}))
    if not ok:
        raise AssertionError(f"the served trained model disagrees with the plain path "
                             f"at step {checked}")
    del model
    return launches, (ref_params, ref_state, params, opt_state, state, images, caps)


def dev_us(e):
    """A profiled kernel's own device time, µs."""
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def profile_events(fn):
    """Run ``fn`` once under torch.profiler -> (wall ms up to a synchronize,
    its device-kernel events by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def kernel_kind(name: str) -> str:
    """A coarse class of a device kernel, from its name."""
    n = name.lower()
    for kind, marks in (("kernel_f", ("matmul_stats", "stats_reduce")),
                        ("conv", ("conv", "cudnn", "dgrad", "wgrad", "fprop")),
                        ("gemm", ("gemm", "cutlass", "xmma", "cublas")),
                        ("reduce", ("reduce",)),
                        ("elementwise", ("elementwise", "copy", "fill", "cat", "index"))):
        if any(m in n for m in marks):
            return kind
    return "other"


def phase_train_timing(dev, root, trained):
    """ms per bf16 train step at B=128, unfused (plain) and fused (kernel),
    in turns: each path's figure is its time over all its timed steps (two
    windows of ``reps``), the windows listed beside it; then one profiled
    step of each."""
    ref_params, ref_state, params, opt_state, state, images, caps = trained
    step_fns = {}
    for path, fuse in (("plain", False), ("kernel", True)):
        cfg = train_cfg(root, "bfloat16", fuse, 128, 1e-3)
        step_fns[path] = trainer(cfg, ref_params, ref_state, dev)[0]
    B, reps = images.shape[0], 5
    n = [0]

    def run(path, k):
        nonlocal params, opt_state, state
        for _ in range(k):
            params, opt_state, state, _s, _l, _lr = step_fns[path](
                params, opt_state, state, n[0], images, caps)
            n[0] += 1

    t, peak = {}, {}
    for path in ("plain", "kernel", "kernel", "plain"):
        run(path, 1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(path, reps)
        end.record()
        torch.cuda.synchronize()
        t.setdefault(path, []).append(start.elapsed_time(end))
        peak.setdefault(path, []).append((torch.cuda.max_memory_allocated(dev) - base) / 2**20)
    out = {}
    for path in ("plain", "kernel"):
        steps = reps * len(t[path])
        ms = sum(t[path]) / steps
        out[path] = ms
        say("train_timing", path=path, fuse_bn_stats=path == "kernel", B=B, dtype="bfloat16",
            timed_steps=steps, total_ms=round(sum(t[path]), 3), ms_per_step=round(ms, 3),
            images_per_s=round(B / ms * 1e3, 1),
            windows_ms_per_step=[round(x / reps, 3) for x in t[path]],
            peak_mib_above_base=round(max(peak[path]), 1))

    # where a step's device time goes, unfused and fused
    for path in ("plain", "kernel"):
        wall_ms, events = profile_events(lambda: run(path, 1))
        busy_ms = sum(dev_us(e) for e in events) / 1e3
        by_kind = {}
        for e in events:
            kind = kernel_kind(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + dev_us(e) / 1e3
        say("train_profile", path=path, wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
            device_idle_share=round(max(0.0, 1 - busy_ms / wall_ms), 4),
            busy_share_of_timed_step=round(busy_ms / out[path], 4),
            kernel_launches=sum(e.count for e in events),
            **{f"{k}_ms": round(v, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])})
        for e in sorted(events, key=dev_us, reverse=True)[:8]:
            print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:110]}", flush=True)
    return out


# ---- phases 14-16: the transformer family -------------------------------------


def tf_dims():
    """The default config with ``arch="transformer"``: D=1024, 4 layers, 8
    heads, MLP 4096, E=256, vocab 12295 padded to 12416, 35 positions."""
    from myimagecaptioningmodel_tpu_torch.models.transformer import TransformerDims

    return TransformerDims(vocab_size=V_REAL, embedding_size=E, model_dim=H, num_layers=4,
                           num_heads=TF_HEADS, mlp_ratio=4, max_positions=TF_STEPS,
                           vocab_pad_multiple=128)


def randomize_affine(tree, gen):
    """Random biases (0.02 N) and LayerNorm gains (1 + 0.1 N) and offsets in
    place of init's zeros and ones, in place, so that the checks read the
    kernels' bias and norm paths. ``out_bias`` (the padded rows' -1e9)
    stays."""
    if isinstance(tree, list):
        for v in tree:
            randomize_affine(v, gen)
    elif isinstance(tree, dict):
        if "b" in tree and ("w" in tree or "g" in tree):
            tree["b"] = 0.02 * torch.randn(tree["b"].shape, generator=gen)
        if "g" in tree:
            tree["g"] = 1.0 + 0.1 * torch.randn(tree["g"].shape, generator=gen)
        for k, v in tree.items():
            if k not in ("b", "g"):
                randomize_affine(v, gen)
    return tree


def tf_pre(gen, dev, params, n_img, dt):
    """Random image features [n_img, 49, H] and [n_img, H] -> the memory."""
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

    img = torch.rand(n_img, K_SLOTS, H, generator=gen).to(dev)
    gf = torch.rand(n_img, H, generator=gen).to(dev)
    return TTF.precompute(params, img, gf, TF_HEADS, dt)


def with_stop_bias(params, bias):
    p = dict(params)
    p["out_bias"] = params["out_bias"].clone()
    p["out_bias"][STOP] += bias
    return p


def stop_biases(params, pre, dt):
    """Biases on <stop> that put it first at step 0 in about half the rows
    ("mixed": rows stop at different steps) and, by a margin of 1, in every
    row ("all": the decode ends after one step)."""
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

    start = torch.full((pre.batch, 1), 2, dtype=torch.long, device=params["pos"].device)
    logits = TTF.teacher_forcing_logits(params, pre, start, tf_dims(), 0, dt)[:, 0]
    gap = logits.max(dim=-1).values - logits[:, STOP]
    return {"mixed": float(gap.median()) + 1e-3, "all": float(gap.max()) + 1.0}


def tf_token_logits(params, pre, ids, dt):
    """Teacher-forced float32 logits [B, T, V] on ``ids`` (inputs <start> +
    ids[:, :-1]) and the mask of the positions up to each row's first
    <stop>."""
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

    ids = ids.long()
    src = torch.cat([torch.full_like(ids[:, :1], 2), ids[:, :-1]], dim=1)
    logits = TTF.teacher_forcing_logits(params, pre, src, tf_dims(), 0, dt)
    after_stop = torch.cumsum((ids == STOP).int(), dim=1) - (ids == STOP).int() > 0
    return logits, ~after_stop


def greedy_tf_check(params, pre, ids, dt, early):
    """Kernel D's ids against the plain argmax of the teacher-forced logits
    on its own ids, under the near-tie rule, at every position up to the
    first <stop> (``early``: <pad> after it) -> (ok, max gap of a picked id
    below the plain maximum)."""
    logits, live = tf_token_logits(params, pre, ids, dt)
    B, T, V = logits.shape
    if not early:
        live = torch.ones_like(live)
    flat = logits[live]
    ok = near_tie_ok(ids[live], flat, dt) if flat.numel() else True
    picked = flat.gather(1, ids[live].long()[:, None])[:, 0] if flat.numel() else flat
    err = float((flat.max(dim=-1).values - picked).max()) if flat.numel() else 0.0
    if early:
        ok = ok and bool((ids[~live] == 0).all())
    return ok, err


def beam_rescore(params, pre, ids, dt):
    """Sum of the teacher-forced log-softmax of ``ids`` up to and including
    each row's first <stop> -> (scores [B], steps [B])."""
    logits, live = tf_token_logits(params, pre, ids, dt)
    tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
    return (tok * live).sum(dim=1), live.sum(dim=1)


def bound_tf(rows, n_img, steps, dims, dt, T=TF_STEPS, int8=False, int8_kv=False):
    """Least ms of one decode of ``steps`` steps (the steps this run's data
    needed): each step reads the layer weights (117 MB in bf16, 59 MB as
    int8 with their scales; more than the 50 MB L2 holds, so a step cannot
    reuse the previous step's), the head and embedding weights, the table,
    every image's memory once (int8 with ``int8_kv``) and each row's cache
    prefix, and writes each row's new k, v; the ids once. The products'
    operations at the peak rate of the compute dtype they run in."""
    es = torch.tensor([], dtype=dt).element_size()
    D, L, F, V = dims.model_dim, dims.num_layers, dims.model_dim * dims.mlp_ratio, V_PAD
    layer, head = L * (6 * D * D + 2 * D * F), 2 * D * E + V * E
    small = 4 * (L * (3 * D + 4 * D + F + 6 * D) + V + 2 * D + E + TF_STEPS * D)
    small += 4 * (L * (7 * D + F) * int8 + L * 2 * D * int8_kv)  # the int8 scales
    per_step = (layer * (1 if int8 else es) + head * es + small
                + n_img * L * 2 * (K_SLOTS + 1) * D * (1 if int8_kv else es))
    caches = sum(rows * L * 2 * (t + 2) * D * es for t in range(steps))  # read t+1, write 1
    nbytes = steps * per_step + caches + rows * T * 4
    ops = steps * 2 * rows * (layer + head + L * 2 * (K_SLOTS + 1 + T) * D)
    return bound(nbytes, ops, dt)


def device_profile(label, fn, top=6):
    """One profiled call of ``fn``: wall ms, device busy ms (the sum of its
    kernels' device time), kernel launches, and the kernels that took the
    most device time."""
    wall_ms, events = profile_events(fn)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    say(label + "_profile", wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
        device_idle_share=round(max(0.0, 1 - busy_ms / wall_ms), 4),
        kernel_launches=sum(e.count for e in events))
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:110]}", flush=True)


def phase_kernel_d(dev, gen, params):
    """Kernel D against its plain version at full width: bf16 at B=8 and
    B=128, fixed length and early stop (a <stop> bias that stops rows at
    different steps, and one that stops every row at step 0); float32 at
    B=8, ids equal."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    worst, times = 0.0, {}
    for dt, B in ((torch.float32, 8), (torch.bfloat16, 8), (torch.bfloat16, 128)):
        pre = tf_pre(gen, dev, params, B, dt)
        biases = stop_biases(params, pre, dt)
        for label, bias in (("fixed", 0.0), ("mixed", biases["mixed"]), ("all", biases["all"])):
            early = label != "fixed"
            p = with_stop_bias(params, bias)
            ftp = FT.prepare(p, pre, TF_HEADS, dt)
            ids = FT.fused_greedy_decode(ftp, TF_STEPS, TF_HEADS, compute_dtype=dt,
                                         early_stop=early)
            torch.cuda.synchronize()
            ref = FT.fused_greedy_decode_reference(ftp, TF_STEPS, TF_HEADS, compute_dtype=dt,
                                                   early_stop=early)
            ok, err = greedy_tf_check(p, pre, ids, dt, early)
            same = float((ids == ref).all(dim=1).float().mean())
            if dt == torch.float32:
                ok = ok and same == 1.0
            else:
                worst = max(worst, err)
            steps = int((ids != 0).any(dim=0).sum()) if early else TF_STEPS
            line = dict(dtype=str(dt).split(".")[-1], B=B, stop=label, ok=ok,
                        near_tie_max_gap=err, rows_equal_to_plain=same, steps_run=steps,
                        kernel_launches_per_decode=FT.fused_greedy_decode.kernel_launches)
            if label != "mixed":
                t_k = time_ms(lambda: FT.fused_greedy_decode(
                    ftp, TF_STEPS, TF_HEADS, compute_dtype=dt, early_stop=early), reps=3, warmup=1)
                t_p = time_ms(lambda: FT.fused_greedy_decode_reference(
                    ftp, TF_STEPS, TF_HEADS, compute_dtype=dt, early_stop=early), reps=2,
                    warmup=1)
                b = bound_tf(B, B, steps, tf_dims(), dt)
                times[(dt, B, label)] = (t_k, t_p, *b)
                line.update(kernel_us=round(t_k * 1e3, 1), plain_us=round(t_p * 1e3, 1),
                            bound_us=round(b[0] * 1e3, 1), bound_by=b[1])
            say("kernel_d", **line)
            if dt == torch.bfloat16 and label == "fixed":
                device_profile(f"kernel_d_B{B}", lambda: FT.fused_greedy_decode(
                    ftp, TF_STEPS, TF_HEADS, compute_dtype=dt))
            if not ok:
                raise AssertionError(f"kernel D disagrees with the plain path ({dt}, B={B}, "
                                     f"{label})")
    return worst, times


# Limits of phase 15 (kernel E against the plain path along E's own beams,
# ``beam_replay``). A beam's score may differ from the plain score of the
# same words by ``E_RESCORE[dt]`` x sqrt(the steps it was live): the kernel
# and the plain step round their activations after sums taken in other
# orders, and those errors are independent from step to step. Set between
# what the sound kernel and planted faults read on an H100
# (``chip_fault_check.py`` part 3, bf16 at 8 and 128 images): the sound
# kernel at most 0.0175; a dropped v bias at least 0.055, the head missing
# its last 32-row vocabulary block 0.031-0.035 without early stops; LayerNorm
# gains 1% high read 0.023 at most and pass (the bf16 resolution). float32:
# at most 1.03e-5 (two float32 ulps of a 35-step score). At step t two
# candidates' plain cumulative scores are a near tie within the per-step
# gap (bf16: 2e-2, as for A and C) plus what both beams may have drifted.
E_RESCORE = {torch.float32: 3e-5, torch.bfloat16: 2.5e-2}
E_GAP = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def beam_gap(dt, t: int) -> float:
    """The near-tie gap between two candidates' cumulative scores at step t."""
    return E_GAP[dt] + 2 * E_RESCORE[dt] * t ** 0.5


def beam_replay(params, pre, quad, dt):
    """Replay kernel E's beams (words and back-pointers [T, n_img, W]) through
    the plain KV-cached step of ``models/transformer.py``: at every step the
    plain cumulative score of each of the W x V candidates on E's own
    prefixes. -> readings: ``shortfall``, the most by which a chosen
    candidate fell below the plain W-th best less the step's near-tie gap
    (> 0 fails); ``repeats``, candidates chosen twice at one step;
    ``order_bad``, image-steps clear of near ties whose choices are not the
    plain top-W in order; ``tail_ok``, <pad> words and identity
    back-pointers after the early stop; ``lengths_ok``; ``rescore``
    [n_img, W], |E's score - the plain score of its beam|; ``live`` [n_img,
    W], the steps each beam was unfinished; ``clear`` [n_img], images with no
    near tie at any step."""
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

    words, srcs, scores, lens = quad
    T, n, W = words.shape
    dev, dims = words.device, tf_dims()
    V = dims.padded_vocab
    pre_r = TTF.TransformerPre([k.repeat_interleave(W, 0) for k in pre.mem_k],
                               [v.repeat_interleave(W, 0) for v in pre.mem_v])
    caches = TTF._init_cache(dims, n * W, T, dt, dev)
    layers = TTF.prepare_decode_layers(params)
    word = torch.full((n * W,), 2, dtype=torch.long, device=dev)
    score = torch.full((n, W), -1e9, device=dev)
    score[:, 0] = 0.0
    fin = torch.zeros((n, W), dtype=torch.bool, device=dev)
    length = torch.zeros((n, W), dtype=torch.int32, device=dev)
    pad_only = torch.full((V,), -1e9, device=dev)
    pad_only[0] = 0.0
    offs = (torch.arange(n, device=dev) * W)[:, None]
    ident = torch.arange(W, device=dev)
    clear = torch.ones(n, dtype=torch.bool, device=dev)
    out = dict(shortfall=-float("inf"), repeats=0, order_bad=0, tail_ok=True)
    for t in range(T):
        if bool(fin.all()):
            out["tail_ok"] = bool((words[t:] == 0).all() and (srcs[t:] == ident).all())
            break
        x = TTF._decode_step(params, pre_r, dims, word, caches, t, 0, dt, layers)
        logp = torch.log_softmax(TTF.head_logits(params, x, dt), dim=-1).reshape(n, W, V)
        cand = (score[..., None] + torch.where(fin[..., None], pad_only, logp)).reshape(n, -1)
        top, top_i = torch.topk(cand, W + 1, dim=1)
        src, wd = srcs[t].long(), words[t].long()
        pick = src * V + wd
        chosen = cand.gather(1, pick)
        gap = beam_gap(dt, t)
        out["shortfall"] = max(out["shortfall"], float((top[:, W - 1:W] - chosen).max()) - gap)
        srt = pick.sort(dim=1).values
        out["repeats"] += int((srt[:, 1:] == srt[:, :-1]).sum())
        step_clear = ((top[:, :-1] - top[:, 1:]) > gap).all(dim=1)
        out["order_bad"] += int(((pick != top_i[:, :W]).any(dim=1) & step_clear).sum())
        clear &= step_clear
        rows = (offs + src).reshape(-1)
        caches = [(ck[rows], cv[rows]) for ck, cv in caches]
        prev = fin.gather(1, src)
        fin = prev | (wd == STOP)
        length = length.gather(1, src) + (~prev).int()
        score, word = chosen, wd.reshape(-1)
    out.update(lengths_ok=bool((length == lens).all()), rescore=(score - scores).abs(),
               live=length, clear=clear)
    return out


def e_check(p, pre, ftp, dt, ref, kernel_ftp=None):
    """Kernel E (on ``kernel_ftp``, else ``ftp``) held against the plain path
    on the sound ``p``/``ftp``: ``beam_replay``'s readings, every beam's
    score within ``E_RESCORE`` x sqrt(live steps) of the replay's, the best
    beam re-scored with ``teacher_forcing_logits`` the same way, and,
    for every image with no near tie, words, back-pointers and lengths
    equal to the plain version's ``ref`` (float32: scores to 1e-4 too).
    -> (ok, readings, quad)."""
    from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    quad = FT.fused_beam_decode(ftp if kernel_ftp is None else kernel_ftp, TF_STEPS, TF_HEADS,
                                BEAM, compute_dtype=dt, early_stop=True)
    torch.cuda.synchronize()
    r = beam_replay(p, pre, quad, dt)
    limit = E_RESCORE[dt]
    live = r["live"].clamp(min=1).float().sqrt()
    ids, score = beam_backtrack(*quad, 0.0)
    tf_score, tf_steps = beam_rescore(p, pre, ids, dt)
    tf_err = (tf_score - score).abs()
    same = ((quad[0] == ref[0]).all(dim=0).all(dim=1) & (quad[1] == ref[1]).all(dim=0).all(dim=1)
            & (quad[3] == ref[3]).all(dim=1))
    if dt == torch.float32:
        same &= ((quad[2] - ref[2]).abs() <= 1e-4).all(dim=1)
    clear = r["clear"]
    readings = dict(
        selection_shortfall=r["shortfall"], repeats=r["repeats"], order_bad=r["order_bad"],
        tail_ok=r["tail_ok"], lengths_ok=r["lengths_ok"],
        rescore_per_sqrt_step=float((r["rescore"] / live).max()),
        rescore_max_abs_err=float(r["rescore"].max()),
        tf_rescore_per_sqrt_step=float((tf_err / tf_steps.clamp(min=1).sqrt()).max()),
        images_clear=int(clear.sum()),
        clear_images_equal_to_plain=bool((same | ~clear).all()),
        rows_equal_to_plain=float(same.float().mean()))
    ok = (r["shortfall"] <= 0 and r["repeats"] == 0 and r["order_bad"] == 0 and r["tail_ok"]
          and r["lengths_ok"] and readings["rescore_per_sqrt_step"] <= limit
          and readings["tf_rescore_per_sqrt_step"] <= limit
          and readings["clear_images_equal_to_plain"])
    return ok, readings, quad


def phase_kernel_e(dev, gen, params):
    """Kernel E against its plain path at full width, beam 4, early stop on,
    float32 and bf16 at 8 and 128 images (``e_check``), with no bias on
    <stop> (beams run all 35 steps) and with the "mixed" one (beams finish at
    different steps)."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    worst, times = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        for n_img in (8, 128):
            pre = tf_pre(gen, dev, params, n_img, dt)
            for label in ("none", "mixed"):
                bias = stop_biases(params, pre, dt)["mixed"] if label == "mixed" else 0.0
                p = with_stop_bias(params, bias)
                ftp = FT.prepare(p, pre, TF_HEADS, dt)
                ref = FT.fused_beam_decode_reference(ftp, TF_STEPS, TF_HEADS, BEAM,
                                                     compute_dtype=dt, early_stop=True)
                ok, readings, quad = e_check(p, pre, ftp, dt, ref)
                if dt == torch.bfloat16:
                    worst = max(worst, readings["rescore_max_abs_err"])
                steps_run = int((quad[0] != 0).any(dim=2).any(dim=1).sum())
                line = dict(dtype=str(dt).split(".")[-1], images=n_img, beam=BEAM, stop=label,
                            ok=ok, **readings, steps_run=steps_run,
                            kernel_launches_per_decode=FT.fused_beam_decode.kernel_launches)
                if label == "none":
                    t_k = time_ms(lambda: FT.fused_beam_decode(
                        ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt, early_stop=True),
                        reps=3, warmup=1)
                    t_p = time_ms(lambda: FT.fused_beam_decode_reference(
                        ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt, early_stop=True),
                        reps=2, warmup=1)
                    b = bound_tf(n_img * BEAM, n_img, steps_run, tf_dims(), dt)
                    times[(dt, n_img)] = (t_k, t_p, *b)
                    line.update(kernel_us=round(t_k * 1e3, 1), plain_us=round(t_p * 1e3, 1),
                                bound_us=round(b[0] * 1e3, 1), bound_by=b[1])
                say("kernel_e", **line)
                if dt == torch.bfloat16 and label == "none":
                    device_profile(f"kernel_e_{n_img}x{BEAM}", lambda: FT.fused_beam_decode(
                        ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt, early_stop=True))
                if not ok:
                    raise AssertionError(f"kernel E disagrees with the plain path ({dt}, "
                                         f"{n_img} images, {label})")
    return worst, times


TF_SERVED = (("greedy", dict(), "fused_greedy_decode"),
             ("beam", dict(beam_size=BEAM), "fused_beam_decode"))


def phase_tf_served(dev, seed, root):
    """A full-width random transformer bundle served greedy and beam 4 by
    ``CaptionService(batch_size=8)``: D or E launches once per dispatch and
    no LSTM kernel launches; the served greedy ids hold against the plain
    teacher-forced logits; then ms per batch and captions/s, kernel path and
    plain path. -> (launch counts {D, E}, the bundle's config)."""
    from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
    from myimagecaptioningmodel_tpu_torch.inference.server import CaptionService
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    cfg = write_bundle(os.path.join(root, "transformer"), seed,
                       (("model.decoder.arch", "transformer"),))
    counters = {"fused_greedy_decode": FT.fused_greedy_decode,
                "fused_beam_decode": FT.fused_beam_decode,
                "fused_decode_step": FS.fused_decode_step,
                "greedy_vocab_argmax": VH.greedy_vocab_argmax,
                "topk_vocab_head": VH.topk_vocab_head}
    images = np.random.RandomState(seed).rand(24, *cfg.data.image_shape, 3).astype(np.float32)
    out, models = {}, {}
    for label, kw, kernel in TF_SERVED:
        t0 = time.perf_counter()
        svc = CaptionService(cfg, batch_size=8, max_wait_ms=50.0, device=dev, **kw)
        load_s = round(time.perf_counter() - t0, 2)
        try:
            for fn in counters.values():
                fn.launches = 0
            with ThreadPoolExecutor(max_workers=8) as pool:
                results = list(pool.map(svc.caption_array, images))
            launches = {name: fn.launches for name, fn in counters.items()}
            st = svc.stats()
        finally:
            svc.close()
        d = st["dispatches"]
        if any(len(r["ids"]) != TF_STEPS or not isinstance(r["caption"], str) for r in results):
            raise AssertionError(f"transformer {label}: bad answer")
        if st["served"] != 24 or not 3 <= d <= 24 or round(st["mean_batch_fill"] * d) != 24:
            raise AssertionError(f"transformer {label}: counters do not reconcile: {st}")
        want = {name: d if name == kernel else 0 for name in counters}
        if launches != want:
            raise AssertionError(f"transformer {label}: launches {launches}, expected {want}")
        say("tf_served_" + label, load_and_warmup_s=load_s, requests=24, dispatches=d,
            decode_ms_p50=st["decode_ms_p50"], launches=json.dumps(launches).replace(" ", ""),
            kernel_launches_per_decode=counters[kernel].kernel_launches,
            packed_weights_mib=round(packed_mib(svc.model.decoder_packed), 2),
            distinct_captions=len({tuple(r["ids"]) for r in results}))
        out[kernel] = launches[kernel]
        models[label] = (svc.model, svc.opts)

    # the served model's greedy ids against the plain teacher-forced logits
    model, opts = models["greedy"]
    dt = opts.dtype
    batch = torch.as_tensor(images[:8]).to(dev)
    with torch.no_grad():
        ids = C.greedy_decode(model, batch, opts)
        img_embed, _f, gf = C.img2feature(model, batch, opts)
        pre = TTF.precompute(model.params["decoder"], img_embed, gf, TF_HEADS, dt)
        ok, err = greedy_tf_check(model.params["decoder"], pre, ids, dt, False)
    say("tf_served_vs_plain", B=8, near_tie_ok=ok, near_tie_max_gap=err)
    if not ok:
        raise AssertionError("the served transformer disagrees with the plain path")

    rng = np.random.RandomState(seed + 4)
    for label, kw, _kernel in TF_SERVED:
        model, opts = models[label]
        for B in (8, 128):
            imgs = torch.as_tensor(rng.rand(B, 224, 224, 3).astype(np.float32)).to(dev)
            t = {}
            # "repack": the kernel path packing the weights on every batch
            for path in ("plain", "kernel", "repack", "kernel", "repack", "plain"):
                o = opts._replace(use_kernels=path != "plain")
                m = model._replace(decoder_packed=None) if path == "repack" else model
                if label == "beam":
                    fn = lambda: beam_decode(m, imgs, o, BEAM, stop_idx=o.stop_idx)  # noqa: E731
                else:
                    fn = lambda: C.greedy_decode(m, imgs, o)  # noqa: E731
                t.setdefault(path, []).append(time_ms(fn, reps=2, warmup=1))
            k, p = min(t["kernel"]), min(t["plain"])
            say("tf_timing_" + label, B=B, kernel_ms_per_batch=round(k, 3),
                plain_ms_per_batch=round(p, 3), kernel_captions_per_s=round(B / k * 1e3, 1),
                plain_captions_per_s=round(B / p * 1e3, 1),
                repack_ms_per_batch=round(min(t["repack"]), 3),
                runs_kernel=[round(x, 3) for x in t["kernel"]],
                runs_repack=[round(x, 3) for x in t["repack"]],
                runs_plain=[round(x, 3) for x in t["plain"]])
    return out, cfg


# ---- phases 17 and 18: kernel G and the fused eval encoder ---------------------

KERNEL_G_SRC = "myimagecaptioningmodel_tpu_torch/csrc/fused_irb.cu"
KERNEL_G_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_irb.py:187"
# Limits on kernel G against its plain version (phase 17), the largest
# |kernel - plain| over max|plain| of a block: float32 sums in other orders;
# in bfloat16 a sum on the other side of a rounding moves an expanded or
# depthwise value by one bf16 ulp (2^-8 relative). Set between what the sound
# kernel and planted faults read on an H100 (``chip_fault_check.py`` part 4).
G_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Limits of phase 18, the fused encoder's features against (a) the same
# forward with every block on G's plain version (the same rounding points)
# and (b) the plain eval encoder (cuDNN convs, BN after each conv), as the
# relative L2 error of the [B, 7, 7, 1280] features.
ENC_TOL = {"g_plain": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
           "encoder": {torch.float32: 1e-5, torch.bfloat16: 5e-2}}
ENC_SIZE, BATCHES = 224, (8, 128)  # phases 17-19's image size and batches


def irb_blocks(size=224, scale=1.0):
    """(name, H, W, Cin, Cexp, Cout, stride, shortcut) of the 17 inverted-
    residual blocks of MobileNetV2 x``scale`` at ``size`` px."""
    from myimagecaptioningmodel_tpu_torch.models.mobilenet_v2 import BOTTLENECK_PARAMS

    h, in_c, out = size // 2, int(32 * scale), []
    for stage, (t, c, n, s) in enumerate(BOTTLENECK_PARAMS, start=2):
        c = int(c * scale)
        for i in range(1, n + 1):
            stride = s if i == 1 else 1
            out.append((f"conv{stage}_{i}", h, h, in_c, int(round(in_c * t)), c, stride, i > 1))
            h, in_c = (h - 1) // stride + 1, c
    return out


def bound_g(B, H, W, cin, cexp, cout, stride, dt):
    """The block's input and output once, its weights once; the expand on
    every input pixel, the depthwise and the project on every output pixel."""
    es = torch.tensor([], dtype=dt).element_size()
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    nbytes = (B * H * W * cin + B * ho * wo * cout + cin * cexp + cexp * cout) * es \
        + (11 * cexp + cout) * 4
    ops = 2 * B * (H * W * cin * cexp + ho * wo * cexp * (9 + cout))
    return bound(nbytes, ops, dt)


def irb_cudnn(x, fold, stride, shortcut):
    """The folded block as three cuDNN convolutions in the activation dtype,
    channels-last (the yardstick beside kernel G; the port never calls it)."""
    dt = x.dtype
    cin, cexp = fold.we.shape
    xn = x.permute(0, 3, 1, 2)
    e = torch.nn.functional.conv2d(xn, fold.we.t().reshape(cexp, cin, 1, 1).to(dt),
                                   fold.be[0].to(dt)).clamp_(0, 6)
    d = torch.nn.functional.conv2d(e, fold.wd.t().reshape(cexp, 1, 3, 3).to(dt),
                                   fold.bd[0].to(dt), stride, 1, 1, cexp).clamp_(0, 6)
    o = torch.nn.functional.conv2d(d, fold.wp.t().reshape(-1, cexp, 1, 1).to(dt),
                                   fold.bp[0].to(dt))
    return (o + xn if shortcut else o).permute(0, 2, 3, 1)


def g_operands(gen, dev, B, H, W, cin, cexp, cout, dt):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    x = (torch.randn(B, H, W, cin, generator=gen, device=dev) * 0.5).to(dt)
    fold = FI.FoldedIRB(
        torch.randn(cin, cexp, generator=gen, device=dev) / cin ** 0.5,
        torch.randn(1, cexp, generator=gen, device=dev) * 0.1,
        torch.randn(9, cexp, generator=gen, device=dev) * 0.3,
        torch.randn(1, cexp, generator=gen, device=dev) * 0.1,
        torch.randn(cexp, cout, generator=gen, device=dev) / cexp ** 0.5,
        torch.randn(1, cout, generator=gen, device=dev) * 0.1)
    return x.contiguous(memory_format=torch.contiguous_format), fold


def rel_max_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def phase_kernel_g(dev, seed):
    """Kernel G against its plain version at the 17 block shapes at 224 px,
    B in {8, 128}, float32 (TF32 off) and bfloat16, both entries (the NHWC
    entry with the expanded tensor in float32 and in the activation dtype,
    and the chain entry, whose pad must be exactly 0): errors to ``G_TOL``;
    µs per call of the kernel (the encoder's rounding), its plain version and
    the cuDNN composition, and the bound. -> (worst bf16 |kernel - plain|,
    {(dt, B): sums over the 17 blocks of (kernel, plain, cudnn, bound ms),
    and what bounds most of that sum})."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    gen = torch.Generator(device=dev).manual_seed(seed)
    worst, sums = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        for B in BATCHES:
            tot = [0.0, 0.0, 0.0, 0.0]
            errs, by = [], {"bytes": 0.0, "operations": 0.0}
            for name, H, W, cin, cexp, cout, stride, sc in irb_blocks(ENC_SIZE):
                x, fold = g_operands(gen, dev, B, H, W, cin, cexp, cout, dt)
                err = 0.0
                for round_e in (False, True):
                    got = FI.fused_inverted_residual(x, fold, stride, sc, round_expanded=round_e)
                    torch.cuda.synchronize()
                    want = FI.fused_inverted_residual_reference(x, fold, stride, sc, round_e)
                    err = max(err, rel_max_err(got, want))
                    if dt == torch.bfloat16:
                        worst = max(worst, float((got.float() - want.float()).abs().max()))
                xc = FI.pad_activation(x)
                got = FI.fused_irb_chain(xc, fold, stride, sc, real_w=W)
                torch.cuda.synchronize()
                want = FI.fused_irb_chain_reference(xc, fold, stride, sc, real_w=W)
                ho, wo = FI.out_size(H, stride), FI.out_size(W, stride)
                pad_zero = bool((got[:, 0] == 0).all() and (got[:, -1] == 0).all()
                                and (got[:, :, wo:] == 0).all() and (got[..., cout:] == 0).all())
                err = max(err, rel_max_err(got[:, 1:ho + 1, :wo, :cout],
                                           want[:, 1:ho + 1, :wo, :cout]))
                del xc, got, want
                reps = 10 if B == 128 else 30
                t_k = time_ms(lambda: FI.fused_inverted_residual(x, fold, stride, sc, True), reps)
                t_p = time_ms(lambda: FI.fused_inverted_residual_reference(x, fold, stride, sc,
                                                                           True), reps)
                t_l = time_ms(lambda: irb_cudnn(x, fold, stride, sc), reps)
                b_ms, b_by = bound_g(B, H, W, cin, cexp, cout, stride, dt)
                for i, v in enumerate((t_k, t_p, t_l, b_ms)):
                    tot[i] += v
                by[b_by] += b_ms
                errs.append(err)
                ok = err <= G_TOL[dt] and pad_zero
                say("kernel_g", dtype=str(dt).split(".")[-1], B=B, block=name, H=H, cin=cin,
                    cexp=cexp, cout=cout, stride=stride, max_rel_err=f"{err:.3g}",
                    chain_pad_zero=pad_zero, kernel_us=round(t_k * 1e3, 1),
                    plain_us=round(t_p * 1e3, 1), cudnn_us=round(t_l * 1e3, 1),
                    bound_us=round(b_ms * 1e3, 1), bound_by=b_by)
                if not ok:
                    raise AssertionError(f"kernel G disagrees with its plain version ({dt}, "
                                         f"B={B}, {name}): {err}")
                del x
            sums[(dt, B)] = (*tot, max(by, key=by.get))
            say("kernel_g_sum", dtype=str(dt).split(".")[-1], B=B, blocks=17,
                max_rel_err=f"{max(errs):.3g}", tol=G_TOL[dt],
                kernel_ms=round(tot[0], 3), plain_ms=round(tot[1], 3),
                cudnn_ms=round(tot[2], 3), bound_ms=round(tot[3], 4))
            torch.cuda.empty_cache()
    return worst, sums


def encoder_tree(gen, dev):
    """MobileNetV2 x1.0 (params, state) with OIHW convs on ``dev``, random
    weights and random BN scales, offsets and moving statistics (init's
    scale 1, offset 0, mean 0, var 1 would hide the fold)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import conv_hwio_to_oihw
    from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as MV

    params, state = MV.init(gen)
    for name, p in params.items():
        c = p["conv"]["w"].shape[-1]
        p["conv"]["w"] = torch.from_numpy(conv_hwio_to_oihw(p["conv"]["w"].numpy())).to(dev)
        p["bn"] = {"scale": (torch.rand(c, generator=gen) + 0.5).to(dev),
                   "offset": (torch.randn(c, generator=gen) * 0.1).to(dev)}
        state[name]["bn"] = {"mean": (torch.randn(c, generator=gen) * 0.1).to(dev),
                             "var": (torch.rand(c, generator=gen) + 0.5).to(dev)}
    return params, state


def phase_fused_encoder(dev, seed):
    """MobileNetV2 x1.0 at 224 px, B in {8, 128}, float32 and bfloat16,
    random weights and BN statistics: ``apply(train=False,
    use_fused_irb=True)`` launches kernel G 17 times a forward, and its
    features hold against the same forward on G's plain version and against
    the plain eval encoder (``ENC_TOL``); ms per forward of both encoders
    (plain, kernel, kernel, plain) and a profile of one bf16 B=128 fused
    forward. -> G's launches in the first forward."""
    from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as MV
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    gen = torch.Generator().manual_seed(seed)
    params, state = encoder_tree(gen, dev)
    kernel = FI.fused_inverted_residual
    launches = None
    for dt in (torch.float32, torch.bfloat16):
        for B in BATCHES:
            x = torch.rand(B, ENC_SIZE, ENC_SIZE, 3, generator=gen).to(dev)

            def fused():
                return MV.apply(params, state, x, train=False, compute_dtype=dt,
                                use_fused_irb=True)[0]

            def plain():
                return MV.apply(params, state, x, train=False, compute_dtype=dt)[0]

            with torch.no_grad():
                kernel.launches = 0
                feat = fused()
                torch.cuda.synchronize()
                n = kernel.launches
                launches = n if launches is None else launches
                FI.fused_inverted_residual = FI.fused_inverted_residual_reference
                try:
                    ref_g = fused()
                finally:
                    FI.fused_inverted_residual = kernel
                ref = plain()
                e_g, e_p = rel_l2([feat], [ref_g]), rel_l2([feat], [ref])
                ok = (n == 17 and bool(torch.isfinite(feat).all())
                      and tuple(feat.shape) == (B, ENC_SIZE // 32, ENC_SIZE // 32, 1280)
                      and e_g <= ENC_TOL["g_plain"][dt] and e_p <= ENC_TOL["encoder"][dt])
                t = {}
                for path in ("plain", "kernel", "kernel", "plain"):
                    t.setdefault(path, []).append(
                        time_ms(fused if path == "kernel" else plain, reps=5, warmup=1))
            k, pl = min(t["kernel"]), min(t["plain"])
            say("fused_encoder", dtype=str(dt).split(".")[-1], B=B, ok=ok, g_launches=n,
                rel_l2_vs_g_plain=f"{e_g:.3g}", rel_l2_vs_plain_encoder=f"{e_p:.3g}",
                max_rel_vs_plain_encoder=f"{rel_max_err(feat, ref):.3g}",
                tol=json.dumps({k2: v[dt] for k2, v in ENC_TOL.items()}).replace(" ", ""),
                fused_ms=round(k, 3), plain_encoder_ms=round(pl, 3),
                runs_fused=[round(v, 3) for v in t["kernel"]],
                runs_plain=[round(v, 3) for v in t["plain"]])
            if not ok:
                raise AssertionError(f"the fused encoder disagrees ({dt}, B={B})")
            if dt == torch.bfloat16 and B == BATCHES[-1]:
                with torch.no_grad():
                    device_profile(f"fused_encoder_B{B}", fused)
            del x, feat, ref_g, ref
            torch.cuda.empty_cache()
    return launches


# ---- phase 19: int8 transformer serving ----------------------------------------


def packed_mib(ftp):
    """MiB of the packed decoder weights (every tensor but the memory)."""
    return sum(t.numel() * t.element_size() for f, t in zip(ftp._fields, ftp)
               if t is not None and f not in ("mem_kv", "mem_scale")) / 2 ** 20


def phase_kernel_de_int8(dev, gen, params):
    """Kernels D (int8 weight stream; and with int8 memory) and E (int8
    weight stream) at full width: D at B=8 and B=128 bf16 (and float32 B=8,
    ids equal), each id the plain teacher-forced argmax under the near-tie
    rule on the packed tensors seen as the model (the kernels' own
    dequantized head); E beam 4 at 8 images through ``beam_replay`` under
    ``E_RESCORE`` and at 128 images with the best beam's re-score. µs per
    decode, kernel and plain, and the bound. -> (worst D gap, worst E
    re-score error, {mode: times})."""
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    q = TTF.quantize_transformer_decoder({k: v for k, v in params.items()})
    worst_d, worst_e, times = 0.0, 0.0, {}
    for dt, B in ((torch.float32, BATCHES[0]), (torch.bfloat16, BATCHES[0]),
                  (torch.bfloat16, BATCHES[1])):
        pre = TTF.precompute(q, torch.rand(B, K_SLOTS, H, generator=gen).to(dev),
                             torch.rand(B, H, generator=gen).to(dev), TF_HEADS, dt)
        for mode, kv in (("int8", False), ("int8_kv", True)):
            ftp = FT.prepare(q, pre, TF_HEADS, dt, quantize_kv=kv)
            ids = FT.fused_greedy_decode(ftp, TF_STEPS, TF_HEADS, compute_dtype=dt)
            torch.cuda.synchronize()
            ref = FT.fused_greedy_decode_reference(ftp, TF_STEPS, TF_HEADS, compute_dtype=dt)
            mp, _dims, mpre = FT._as_model(ftp, TF_HEADS, torch.arange(B, device=dev))
            ok, err = greedy_tf_check(mp, mpre, ids, dt, False)
            same = float((ids == ref).all(dim=1).float().mean())
            if dt == torch.float32:
                ok = ok and same == 1.0
            else:
                worst_d = max(worst_d, err)
            t_k = time_ms(lambda: FT.fused_greedy_decode(ftp, TF_STEPS, TF_HEADS,
                                                         compute_dtype=dt), reps=3, warmup=1)
            t_p = time_ms(lambda: FT.fused_greedy_decode_reference(
                ftp, TF_STEPS, TF_HEADS, compute_dtype=dt), reps=1, warmup=0)
            b = bound_tf(B, B, TF_STEPS, tf_dims(), dt, int8=True, int8_kv=kv)
            times[(mode, dt, B)] = (t_k, t_p, *b)
            say("kernel_d_" + mode, dtype=str(dt).split(".")[-1], B=B, ok=ok,
                near_tie_max_gap=err, rows_equal_to_plain=same,
                packed_weights_mib=round(packed_mib(ftp), 2),
                kernel_launches_per_decode=FT.fused_greedy_decode.kernel_launches,
                kernel_us=round(t_k * 1e3, 1), plain_us=round(t_p * 1e3, 1),
                bound_us=round(b[0] * 1e3, 1), bound_by=b[1])
            if dt == torch.bfloat16 and B == BATCHES[0] and not kv:
                device_profile(f"kernel_d_int8_B{B}", lambda: FT.fused_greedy_decode(
                    ftp, TF_STEPS, TF_HEADS, compute_dtype=dt))
            if not ok:
                raise AssertionError(f"kernel D ({mode}) disagrees with the plain path ({dt}, "
                                     f"B={B})")
    dt = torch.bfloat16
    for n_img in BATCHES:
        pre = TTF.precompute(q, torch.rand(n_img, K_SLOTS, H, generator=gen).to(dev),
                             torch.rand(n_img, H, generator=gen).to(dev), TF_HEADS, dt)
        ftp = FT.prepare(q, pre, TF_HEADS, dt)
        mp, _dims, mpre = FT._as_model(ftp, TF_HEADS, torch.arange(n_img, device=dev))
        ref = FT.fused_beam_decode_reference(ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt,
                                             early_stop=True)
        if n_img == BATCHES[0]:
            ok, readings, quad = e_check(mp, mpre, ftp, dt, ref)
        else:  # the best beam's teacher-forced re-score
            quad = FT.fused_beam_decode(ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt,
                                        early_stop=True)
            torch.cuda.synchronize()
            bids, score = beam_backtrack(*quad, 0.0)
            tf_score, tf_steps = beam_rescore(mp, mpre, bids, dt)
            per = float(((tf_score - score).abs() / tf_steps.clamp(min=1).sqrt()).max())
            readings = dict(tf_rescore_per_sqrt_step=per,
                            rescore_max_abs_err=float((tf_score - score).abs().max()))
            ok = per <= E_RESCORE[dt]
        worst_e = max(worst_e, readings["rescore_max_abs_err"])
        steps_run = int((quad[0] != 0).any(dim=2).any(dim=1).sum())
        t_k = time_ms(lambda: FT.fused_beam_decode(ftp, TF_STEPS, TF_HEADS, BEAM,
                                                   compute_dtype=dt, early_stop=True),
                      reps=3, warmup=1)
        t_p = time_ms(lambda: FT.fused_beam_decode_reference(
            ftp, TF_STEPS, TF_HEADS, BEAM, compute_dtype=dt, early_stop=True), reps=1, warmup=0)
        b = bound_tf(n_img * BEAM, n_img, steps_run, tf_dims(), dt, int8=True)
        times[("int8", "beam", n_img)] = (t_k, t_p, *b)
        say("kernel_e_int8", dtype="bfloat16", images=n_img, beam=BEAM, ok=ok, **readings,
            steps_run=steps_run, kernel_launches_per_decode=FT.fused_beam_decode.kernel_launches,
            kernel_us=round(t_k * 1e3, 1), plain_us=round(t_p * 1e3, 1),
            bound_us=round(b[0] * 1e3, 1), bound_by=b[1])
        if not ok:
            raise AssertionError(f"kernel E (int8) disagrees with the plain path ({n_img} "
                                 f"images)")
    return worst_d, worst_e, times


def phase_tf_served_int8(dev, seed, cfg):
    """Phase 16's transformer bundle served with ``quantize=True`` greedy and
    beam 4 by ``CaptionService(batch_size=8)``, then greedy with int8 memory
    too through ``load_bundle(quantize=True, quantize_kv=True)`` in batches
    of 8: D or E launches once per dispatch; the packed weights' stored size
    and the peak device memory; ms per batch and captions/s at B=8 and
    B=128, kernel and plain path. -> launch counts {"int8": {D, E},
    "int8_kv": D's}."""
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
    from myimagecaptioningmodel_tpu_torch.inference.server import CaptionService
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    images = np.random.RandomState(seed).rand(24, *cfg.data.image_shape, 3).astype(np.float32)
    counters = {"fused_greedy_decode": FT.fused_greedy_decode,
                "fused_beam_decode": FT.fused_beam_decode}
    out, models = {}, {}
    for label, kw, kernel in TF_SERVED:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        svc = CaptionService(cfg, batch_size=8, max_wait_ms=50.0, device=dev, quantize=True,
                             **kw)
        try:
            for fn in counters.values():
                fn.launches = 0
            with ThreadPoolExecutor(max_workers=8) as pool:
                results = list(pool.map(svc.caption_array, images))
            launches = {name: fn.launches for name, fn in counters.items()}
            st = svc.stats()
        finally:
            svc.close()
        d = st["dispatches"]
        want = {name: d if name == kernel else 0 for name in counters}
        if launches != want or st["served"] != 24 or any(
                len(r["ids"]) != TF_STEPS for r in results):
            raise AssertionError(f"int8 transformer {label}: launches {launches}, expected "
                                 f"{want}; {st}")
        packed = svc.model.decoder_packed
        say("tf_served_int8_" + label, requests=24, dispatches=d,
            decode_ms_p50=st["decode_ms_p50"], launches=json.dumps(launches).replace(" ", ""),
            layer_streams=str(packed.w_qkv.dtype).split(".")[-1],
            packed_weights_mib=round(packed_mib(packed), 2),
            peak_mib_above_base=round((torch.cuda.max_memory_allocated() - base) / 2 ** 20, 1),
            distinct_captions=len({tuple(r["ids"]) for r in results}))
        out[kernel] = launches[kernel]
        models[label] = (svc.model, svc.opts)

    model, _bc, opts, decode = load_bundle(cfg, quantize=True, quantize_kv=True, device=dev)
    FT.fused_greedy_decode.launches = 0
    ids = [decode(model, torch.as_tensor(images[i:i + 8]).to(dev)) for i in range(0, 24, 8)]
    torch.cuda.synchronize()
    out["int8_kv"] = FT.fused_greedy_decode.launches
    if out["int8_kv"] != 3 or any(tuple(x.shape) != (8, TF_STEPS) for x in ids):
        raise AssertionError(f"int8 memory: {out['int8_kv']} launches of D for 3 batches")
    say("tf_served_int8_kv", batches=3, launches=out["int8_kv"], opts_quantize_kv=opts.quantize_kv,
        distinct_captions=len({tuple(r.tolist()) for x in ids for r in x}))
    models["greedy_kv"] = (model, opts)
    rng = np.random.RandomState(seed + 5)
    for label in ("greedy", "greedy_kv", "beam"):
        model, opts = models[label]
        for B in BATCHES:
            imgs = torch.as_tensor(rng.rand(B, *cfg.data.image_shape, 3).astype(np.float32)).to(dev)
            t = {}
            for path in ("plain", "kernel", "kernel", "plain"):
                o = opts._replace(use_kernels=path == "kernel")
                if label == "beam":
                    fn = lambda: beam_decode(model, imgs, o, BEAM, stop_idx=o.stop_idx)  # noqa: E731
                else:
                    fn = lambda: C.greedy_decode(model, imgs, o)  # noqa: E731
                t.setdefault(path, []).append(time_ms(fn, reps=2, warmup=1))
            k, p = min(t["kernel"]), min(t["plain"])
            say("tf_timing_int8_" + label, B=B, kernel_ms_per_batch=round(k, 3),
                plain_ms_per_batch=round(p, 3), kernel_captions_per_s=round(B / k * 1e3, 1),
                plain_captions_per_s=round(B / p * 1e3, 1),
                runs_kernel=[round(x, 3) for x in t["kernel"]],
                runs_plain=[round(x, 3) for x in t["plain"]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import myimagecaptioningmodel_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    t_start = time.perf_counter()

    phase_card_and_build()
    err_a, t_a = phase_kernel_a(dev, gen)
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import decoder as D

    dims = D.DecoderDims(vocab_size=12295, embedding_size=E, hidden_dim=H,
                         vocab_pad_multiple=128)
    err_b, t_b = phase_kernel_b(dev, gen, tree_to_torch(D.init(gen, dims), dev))
    with tempfile.TemporaryDirectory() as root:
        launches, model, opts, cfg = phase_slice(dev, args.seed, root)
        phase_timing(model, opts, args.seed)
        err_a8, _t_a8 = phase_kernel_a_int8(dev, gen)
        err_c, t_c = phase_kernel_c(dev, gen)
        beam_launches, models, beam_opts = phase_served_beam(dev, args.seed, cfg)
        phase_beam_correct(dev, models["beam"], beam_opts, cfg, args.seed)
        phase_beam_timing(models, beam_opts, args.seed)
        del models
        torch.cuda.empty_cache()
        err_f, t_f = phase_kernel_f(dev, args.seed)
        train_launches, trained = phase_train(dev, args.seed, root)
        phase_train_timing(dev, root, trained)
        del trained
        torch.cuda.empty_cache()
        from myimagecaptioningmodel_tpu_torch.models import transformer as TTF

        tf_params = tree_to_torch(randomize_affine(TTF.init(gen, tf_dims()), gen), dev)
        err_d, t_d = phase_kernel_d(dev, gen, tf_params)
        err_e, t_e = phase_kernel_e(dev, gen, tf_params)
        err_d8, err_e8, t_8 = phase_kernel_de_int8(dev, gen, tf_params)
        del tf_params
        torch.cuda.empty_cache()
        tf_launches, tf_cfg = phase_tf_served(dev, args.seed, root)
        int8_launches = phase_tf_served_int8(dev, args.seed, tf_cfg)
        torch.cuda.empty_cache()
        err_g, t_g = phase_kernel_g(dev, args.seed)
        g_launches = phase_fused_encoder(dev, args.seed)

    bf16 = torch.bfloat16
    f_key = (bf16, "conv3_1_expand")
    b_a, b_b, b_c = bound_a(8, bf16), bound_b(8, bf16), bound_c(8 * BEAM, BEAM, bf16)
    kernels = [
        {"name": "greedy_vocab_argmax", "route": "cuda", "source": KERNEL_A_SRC,
         "replaces": KERNEL_A_TPU, "launches": launches["greedy_vocab_argmax"],
         "max_abs_err": max(err_a, err_a8), "ms": t_a[(bf16, 8)][0],
         "plain_ms": t_a[(bf16, 8)][1], "bound_ms": b_a[0], "bound_by": b_a[1],
         "library_ms": t_a[(bf16, 8)][2]},
        {"name": "fused_decode_step", "route": "cuda", "source": KERNEL_B_SRC,
         "replaces": KERNEL_B_TPU, "launches": launches["fused_decode_step"],
         "max_abs_err": err_b, "ms": t_b[(bf16, 8, True)][0],
         "plain_ms": t_b[(bf16, 8, True)][1], "bound_ms": b_b[0], "bound_by": b_b[1],
         "library_ms": None},
        {"name": "topk_vocab_head", "route": "cuda", "source": KERNEL_C_SRC,
         "replaces": KERNEL_C_TPU, "launches": beam_launches["topk_vocab_head"],
         "max_abs_err": err_c, "ms": t_c[(bf16, 8 * BEAM, BEAM)][0],
         "plain_ms": t_c[(bf16, 8 * BEAM, BEAM)][1], "bound_ms": b_c[0], "bound_by": b_c[1],
         "library_ms": t_c[(bf16, 8 * BEAM, BEAM)][2]},
        {"name": "matmul_stats", "route": "cuda", "source": KERNEL_F_SRC,
         "replaces": KERNEL_F_TPU, "launches": train_launches["matmul_stats"],
         "max_abs_err": err_f, "ms": t_f[f_key][0], "plain_ms": t_f[f_key][1],
         "bound_ms": t_f[f_key][3], "bound_by": t_f[f_key][4], "library_ms": t_f[f_key][2]},
    ]
    for name, tpu, err, (t_k, t_p, b_ms, b_by) in (
            ("fused_greedy_decode", KERNEL_D_TPU, err_d, t_d[(bf16, 8, "fixed")]),
            ("fused_beam_decode", KERNEL_E_TPU, err_e, t_e[(bf16, 8)])):
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_DE_SRC, "replaces": tpu,
                        "launches": tf_launches[name], "max_abs_err": err, "ms": t_k,
                        "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    for name, tpu, launches8, err, (t_k, t_p, b_ms, b_by) in (
            ("fused_greedy_decode[int8]", KERNEL_D_INT8_TPU, int8_launches["fused_greedy_decode"],
             err_d8, t_8[("int8", bf16, 8)]),
            ("fused_greedy_decode[int8+int8_kv]", KERNEL_D_INT8KV_TPU, int8_launches["int8_kv"],
             err_d8, t_8[("int8_kv", bf16, 8)]),
            ("fused_beam_decode[int8]", KERNEL_E_INT8_TPU, int8_launches["fused_beam_decode"],
             err_e8, t_8[("int8", "beam", 8)])):
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_DE_SRC, "replaces": tpu,
                        "launches": launches8, "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    t_k, t_p, t_l, b_ms, b_by = t_g[(bf16, 8)]
    kernels.append({"name": "fused_inverted_residual", "route": "cuda", "source": KERNEL_G_SRC,
                    "replaces": KERNEL_G_TPU, "launches": g_launches, "max_abs_err": err_g,
                    "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t_l})
    say("chip_smoke", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

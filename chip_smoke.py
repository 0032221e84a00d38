"""Drive the PyTorch port's serving path once on one CUDA card.

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
   must come out in ascending index order;
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
   int8 weights, kernel path and plain path.

Near-tie rule: ids must agree wherever the plain version's top-2 logit gap
exceeds 1e-3 x max|logit| (float32) or 2e-2 (bfloat16 and int8 tables); for
the top-k head, at every rank whose plain sorted value is clear of both
neighbouring ranks by that gap. Float32 products are compared with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False).

The line before the last is one JSON object describing each kernel (the
launches of A and B are phase 4's, those of C phase 8's beam service); the
last line is ``{"ok": true, "device": {...}}``.
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
            times[(dt, B)] = (t_k, t_p)
            say("kernel_a", dtype=str(dt).split(".")[-1], B=B, near_tie_ok=ok,
                max_abs_err_of_picked_logit=err, kernel_us=round(t_k * 1e3, 2),
                plain_us=round(t_p * 1e3, 2))
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
                times[(dt, M, k)] = (t_k, t_p)
                say("kernel_c", dtype=str(dt).split(".")[-1], M=M, k=k, tol=tol,
                    err_lse=err_lse, err_vals=err_v, ids_near_tie_ok=ids_ok,
                    kernel_us=round(t_k * 1e3, 2), plain_us=round(t_p * 1e3, 2))
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

    bf16 = torch.bfloat16
    kernels = [
        {"name": "greedy_vocab_argmax", "route": "cuda", "source": KERNEL_A_SRC,
         "replaces": KERNEL_A_TPU, "launches": launches["greedy_vocab_argmax"],
         "max_abs_err": max(err_a, err_a8), "ms": t_a[(bf16, 8)][0],
         "plain_ms": t_a[(bf16, 8)][1]},
        {"name": "fused_decode_step", "route": "cuda", "source": KERNEL_B_SRC,
         "replaces": KERNEL_B_TPU, "launches": launches["fused_decode_step"],
         "max_abs_err": err_b, "ms": t_b[(bf16, 8, True)][0],
         "plain_ms": t_b[(bf16, 8, True)][1]},
        {"name": "topk_vocab_head", "route": "cuda", "source": KERNEL_C_SRC,
         "replaces": KERNEL_C_TPU, "launches": beam_launches["topk_vocab_head"],
         "max_abs_err": err_c, "ms": t_c[(bf16, 8 * BEAM, BEAM)][0],
         "plain_ms": t_c[(bf16, 8 * BEAM, BEAM)][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failure exits non-zero with no result):

1. the card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``myimagecaptioningmodel_tpu_torch/csrc`` (nvcc, sm_90a);
2. kernel A (``greedy_vocab_argmax``) against its plain version at
   B in {8, 128}, V=12416, E=256, float32 and bfloat16 tables, plus a forced
   tie that must resolve to the lowest index;
3. kernel B (``fused_decode_step``) against ``reference_step`` at
   B in {1, 8, 128}, H=1024, E=256, k=49, V=12416: h', c', proj to atol 1e-4
   in float32 and 3e-2 in bfloat16, the word under the near-tie rule;
4. the slice: a full-width LSTM captioner (MobileNetV2 x1.0 at 224 px,
   H=1024, E=256, vocab 12295 padded to 12416, 35 steps, bfloat16) with
   random weights from ``--seed``, written as a port bundle, served by
   ``CaptionService(device="cuda", batch_size=8)`` to 24 requests from 8
   threads; the kernels' launch counts must equal 35 x dispatches; the
   kernel path's ids are held against the plain path's step by step; then
   the single-image ``infer`` path (B=1);
5. timings with CUDA events after warm-up: ms per greedy batch and
   captions/s at B=8 and B=128, kernel path and plain path.

Near-tie rule: ids must agree wherever the plain version's top-2 logit gap
exceeds 1e-3 x max|logit| (float32) or 2e-2 (bfloat16). Float32 products
are compared with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set False).

The line before the last is one JSON object describing each kernel; the last
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

import numpy as np
import torch

V_PAD, E, H, K_SLOTS = 12416, 256, 1024, 49
REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_A_SRC = "myimagecaptioningmodel_tpu_torch/csrc/vocab_head.cu"
KERNEL_B_SRC = "myimagecaptioningmodel_tpu_torch/csrc/fused_step.cu"
KERNEL_A_TPU = "myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py:89"
KERNEL_B_TPU = "myimagecaptioningmodel_tpu/ops/pallas/fused_step.py:219"


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
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    worst = 0.0
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = 1e-4 if dt == torch.float32 else 3e-2
        for B in (1, 8, 128):
            args = _step_inputs(dev, gen, B, dt, params32)
            out = FS.fused_decode_step(*args, with_head=True, compute_dtype=dt)
            torch.cuda.synchronize()
            ref = FS.reference_step(*args, with_head=True, compute_dtype=dt)
            errs = [float((o - r).abs().max()) for o, r in zip(out[:3], ref[:3])]
            fp = args[0]
            logits = torch.matmul(ref[2].to(dt).float(), fp.head_table.float().T) + fp.head_bias
            ok = near_tie_ok(out[3], logits, dt) and max(errs) <= tol
            if dt == torch.bfloat16:
                worst = max(worst, *errs)
            t_k = time_ms(lambda: FS.fused_decode_step(*args, with_head=True, compute_dtype=dt))
            t_p = time_ms(lambda: FS.reference_step(*args, with_head=True, compute_dtype=dt))
            times[(dt, B)] = (t_k, t_p)
            say("kernel_b", dtype=str(dt).split(".")[-1], B=B, atol=tol,
                tf32=torch.backends.cuda.matmul.allow_tf32,
                err_h=errs[0], err_c=errs[1], err_proj=errs[2], word_near_tie_ok=ok,
                kernel_us=round(t_k * 1e3, 2), plain_us=round(t_p * 1e3, 2))
            if not ok:
                raise AssertionError(f"kernel B disagrees with reference_step ({dt}, B={B})")
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

    dt = opts.dtype
    prm = model.params["decoder"]
    with torch.no_grad():
        img_embed, _f, gf = C.img2feature(model, images, opts)
        pre = D.precompute(prm, img_embed, gf, dt)
        B = ids.shape[0]
        h = torch.zeros(B, prm["p_hid"]["w"].shape[0], device=ids.device)
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
    return launches, model, opts


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
        launches, model, opts = phase_slice(dev, args.seed, root)
        phase_timing(model, opts, args.seed)

    bf16 = torch.bfloat16
    kernels = [
        {"name": "greedy_vocab_argmax", "route": "cuda", "source": KERNEL_A_SRC,
         "replaces": KERNEL_A_TPU, "launches": launches["greedy_vocab_argmax"],
         "max_abs_err": err_a, "ms": t_a[(bf16, 8)][0], "plain_ms": t_a[(bf16, 8)][1]},
        {"name": "fused_decode_step", "route": "cuda", "source": KERNEL_B_SRC,
         "replaces": KERNEL_B_TPU, "launches": launches["fused_decode_step"],
         "max_abs_err": err_b, "ms": t_b[(bf16, 8)][0], "plain_ms": t_b[(bf16, 8)][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

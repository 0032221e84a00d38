"""Probe kernels F, C, A, G, D, E and B on one CUDA card, beyond
``chip_smoke.py``'s checks: each call's device time split by kernel, the
phases of C's, A's and G's tile kernels in SM cycles, and D's, E's and the
LSTM decodes.

    python3 chip_probe.py [--trace-only] [--parts fc,ag,ab,enc,de,b,train,attn_train,h,loop,bc] [--package-root DIR]

1. Kernel F (``matmul_stats``) at every ``chip_smoke.F_SHAPES`` shape and
   kernel C (``topk_vocab_head``) at M in {32, 512}, k in {1, 4, 8, 32},
   bfloat16, int8 and float32 tables: the worst error against the plain
   version, µs per call (CUDA events), device µs per call and per kernel
   (torch.profiler), the same for ``torch.mm`` / ``chip_smoke.logits_addmm``,
   and the bound. Then each kernel instance's registers from the build log.
2. A copy of ``csrc/topk_head.cu`` with clock reads at the phase edges of
   ``topk_tile`` (thread 0 of each block: staged, product done, selection
   done, for the first two batch sub-tiles; inside the first, the end of the
   product's loop, the selection's loads and max, its exp sums and its
   offers), built into the package's ``build/`` directory and run at
   M in {32, 512}, k=4, bf16: per-phase cycles (median, max), the blocks'
   start times (waves) and blocks per SM.
3. (part ``ag``) Kernel A (``greedy_vocab_argmax``) at B in {8, 128},
   bfloat16, int8 and float32 tables, and kernel G (``fused_inverted_
   residual``, the encoder's rounding, prepared weights) at the 17 blocks'
   shapes, bfloat16, B in {8, 128}: device µs per call and per kernel
   beside ``logits_addmm`` / ``chip_smoke.irb_cudnn``; the registers and
   spills of their instances.
4. (part ``ag``) Copies of ``csrc/vocab_head.cu`` and ``csrc/fused_irb.cu``
   with clock reads (thread 0 of each block), run through the port's
   wrappers: A's tile kernel, bf16 and int8 at B in {8, 128} (the first E
   chunk staged, every chunk multiplied, the epilogue, the partials
   written); G's bf16 tile kernel ``irb_tc`` at five
   block shapes at B=128, summed over the block's Cexp chunks (waiting for
   the chunk's weights, prefetched during the previous chunk; the first
   also waits for the input window; expand, depthwise, project, the
   epilogue): per-phase cycles a block (median), block µs, waves and blocks
   per SM.

5. (part ``ab``) ``probe_ab``: A's and G's device times alone, for this
   checkout's package or, with ``--package-root DIR``, another's (the
   parent commit's, unpacked under ``workdir/``), so that a call can hold
   the two side by side.
6. (part ``enc``) ``probe_encoder``: the fused and plain eval encoders'
   ms a forward, and where the fused forward's host time goes (enqueue,
   BN folding, weight casts, G's wrapper calls), for this checkout's or
   ``--package-root``'s package.
7. (part ``de``) ``probe_de``: kernels D's and E's device busy ms and host
   enqueue µs per decode (B=8 / 128, 8 / 128 images x beam 4, bf16 and int8
   weights) for this checkout's or ``--package-root``'s package; for this
   checkout's also where the critical path of a bf16 decode goes, by the
   kernel's role in the step, and the per-product table
   (``probe_products``). It reads the profiler's timeline only: no traced
   copy of a source.

8. (part ``b``) ``probe_b``: kernel B per step at PERF.md's rows
   (``chip_smoke.B_PERF_ROWS``: µs, device µs, the bound) and the LSTM
   greedy and beam decodes (B=8, 128; 8, 128 images x beam 4: device busy
   ms, host enqueue µs, wall ms) for this checkout's or
   ``--package-root``'s package, each as its main path calls it; for this
   checkout's also the decodes' critical path by role (gate, p_hid, he+se,
   attention, out, proj, head, finish; the beam's PyTorch selection as
   "torch") and each bf16 product alone and 20 in a row with programmatic
   dependent launch, beside ``torch.mm`` and the byte bound
   (``probe_b_products``).

9. (part ``train``) ``probe_train``: bf16 B=128 train steps at full width,
   variants in turns over four rounds of 5-step windows (median, quartiles,
   range, peak MiB, device busy and kernels of one profiled step): the
   LSTM with ``fuse_bn_stats`` off and on (kernel I's BN in every layer,
   F's sums feeding 35 of them), the LSTM (fused) at bn_stat_rows 0, 16
   and 32, the transformer unfused and fused,
   the LSTM (fused) with ``fused_attn_bwd`` off and on (kernel H; part
   ``attn_train`` runs this set alone).
10. (part ``loop``) ``probe_loop``: ``loop.train`` on phase 23's corpus
   and config, one epoch of 8 steps a run, in turns after a warm-up run:
   the reader serial or
   one gather a batch, rolling saves every 4 steps or none; images/s over
   the epoch, the host ms a step takes to queue, the feeder's wait share.
11. (part ``bc``) ``probe_batch_caption``: ``caption_arrays`` over phase
   24's 300 items at batch 128, phase 24's modes, for this checkout's or
   ``--package-root``'s package: images/s in 5 warm runs, and the decode
   alone on rows already on the card.
12. (part ``h``) ``probe_h``: what holds kernel H's bf16 backward: cycles
   a round of tanh, ``mma`` and bf16x2 fma (alone and together) on one
   quarter SM, and the backward's main kernel at full width with its
   tanh, its ``mma`` or its slot groups taken out of a copy of the source.
13. (part ``quality_bn``) ``probe_quality_bn``: phase 30's LSTM arm (the
   kit's config on its corpus, float32, kernel F on, under
   ``cudnn_deterministic``) trained one epoch (14 steps) from each of
   seeds 0-4, three times: through kernel I, again through kernel I, and
   with kernel I's entries running their plain versions on the card; each
   step's loss, the kernel's rerun bit for bit, and where the kernel's and
   the plain path's losses part.
14. (part ``kink``) ``probe_kink``: phase 22 (a) (``chip_smoke.py``'s
   ``subset_step_errors``) from each of seeds 0-4, its float32 steps through
   kernel I and through I's plain versions, every float64 step on the plain
   versions: each step's errors, the ``img_global`` ReLU's flipped signs
   and the checks it would fail.

Each traced copy is built by ``traced_library`` (every anchor must occur
once in the source, or the probe stops) and run through the port's own
wrapper by ``trace_words``.

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as S

TRACE_HEAD = r'''
__device__ long long* g_trace;
#define TRBASE (g_trace + (blockIdx.y * gridDim.x + blockIdx.x) * 16)
#define TR0 int si = 0; if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); unsigned sm; \
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); \
  TRBASE[0] = t; TRBASE[1] = sm; TRBASE[2] = clock64(); }
#define TRP(n) if (threadIdx.x == 0 && g_trace && si < 2) TRBASE[3 + si * 3 + n] = clock64();
#define TRQ(n) if (threadIdx.x == 0 && g_trace && si == 0) TRBASE[9 + n] = clock64();
#define TRM if (threadIdx.x == 0 && g_trace) { long long* p_ = TRBASE + 13; \
  if (*p_ == 0) *p_ = clock64(); }
#define TREND if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); TRBASE[15] = t; TRBASE[14] = clock64(); }
'''

# (anchor in topk_head.cu, its replacement in the traced copy)
_PROD_END = ("  __syncthreads();  // every warp is done with proj, which lg overwrites\n"
             "#pragma unroll\n  for (int i = 0; i < 2; ++i)")
_TILE_END = "      part_s[base] = s;\n    }\n  }\n}\n"
TRACE_POINTS = [
    ('#include "mma.cuh"\n', '#include "mma.cuh"\n' + TRACE_HEAD),
    ("  const int b = threadIdx.x / QT, q = threadIdx.x % QT;\n",
     "  const int b = threadIdx.x / QT, q = threadIdx.x % QT;\n  TR0\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();\n",
     "    cp_async_wait<0>();\n    __syncthreads();\n    TRP(0)\n"),
    ("    tile_logits<T>(tab, pj, lg, bias, scale, V, E, v0);\n    __syncthreads();\n",
     "    tile_logits<T>(tab, pj, lg, bias, scale, V, E, v0);\n    __syncthreads();\n"
     "    TRP(1)\n"),
    (_PROD_END, "  TRM\n" + _PROD_END),
    ("    const float mx = group_max<QT>(t1);\n",
     "    const float mx = group_max<QT>(t1);\n    TRQ(0)\n"),
    ("    float s = (se[0] + se[1]) + (se[2] + se[3]);\n",
     "    float s = (se[0] + se[1]) + (se[2] + se[3]);\n    TRQ(1)\n"),
    ("    s = group_sum<QT>(s);\n", "    TRQ(2)\n    s = group_sum<QT>(s);\n"),
    (_TILE_END, "      part_s[base] = s;\n    }\n    TRP(2)\n    ++si;\n  }\n  TREND\n}\n"),
]


def device_split(fn, reps=10):
    """(device µs per call, {kernel: device µs per call})."""
    fn()
    torch.cuda.synchronize()
    _wall, events = S.profile_events(lambda: [fn() for _ in range(reps)])
    return (sum(S.dev_us(e) for e in events) / reps,
            {e.key[:48]: round(S.dev_us(e) / reps, 2) for e in events})


def probe_kernels(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
    from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as MB
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for name, M, K, N in S.F_SHAPES:
            x = torch.randn(M, K, device=dev, generator=g).to(dt)
            w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dt)
            y, s, q = MB.matmul_stats(x, w)
            torch.cuda.synchronize()
            ry, rs, rq = MB._matmul_stats_reference(x, w)
            errs = S.f_stats_errors(y, s, q, ry, rs, rq)
            t_k = S.time_ms(lambda: MB.matmul_stats(x, w), reps=10)
            t_l = S.time_ms(lambda: torch.mm(x, w), reps=10)
            d_k, parts = device_split(lambda: MB.matmul_stats(x, w), reps=5)
            d_l, _ = device_split(lambda: torch.mm(x, w), reps=5)
            b_us = S.bound_f(M, K, N, dt)[0] * 1e3
            S.say("probe_f", dtype=str(dt).split(".")[-1], conv=name,
                  err_y=float((y.float() - ry.float()).abs().max()),
                  err_sumsq=errs["sumsq"], kernel_us=round(t_k * 1e3, 2),
                  kernel_device_us=round(d_k, 2), mm_us=round(t_l * 1e3, 2),
                  mm_device_us=round(d_l, 2), bound_us=round(b_us, 2),
                  bound_share=round(b_us / d_k, 3), kernels=parts)
            del x, w, y, ry
    gen = torch.Generator().manual_seed(0)
    for dt in (torch.bfloat16, torch.int8, torch.float32):
        for M in (32, 512):
            proj, table, bias, scale = S.head_operands(gen, dev, M, dt)
            logits = VH.head_logits_reference(proj, table, bias, scale)
            for k in (1, 4, 8, 32):
                vals, ids, lse = VH.topk_vocab_head(proj, table, bias, k, scale)
                torch.cuda.synchronize()
                _rv, ri, rlse = VH.topk_vocab_head_reference(proj, table, bias, k, scale)
                ok = bool(((ids == ri) | ~S.ranks_clear(logits, k, dt)).all())
                t_k = S.time_ms(lambda: VH.topk_vocab_head(proj, table, bias, k, scale))
                d_k, parts = device_split(
                    lambda: VH.topk_vocab_head(proj, table, bias, k, scale))
                d_l = (device_split(lambda: S.logits_addmm(proj, table, bias))[0]
                       if dt != torch.int8 else None)
                S.say("probe_c", dtype=str(dt).split(".")[-1], M=M, k=k, ids_ok=ok,
                      err_lse=float((lse - rlse).abs().max()),
                      err_vals=float((vals - logits.gather(1, ids.long())).abs().max()),
                      kernel_us=round(t_k * 1e3, 2), kernel_device_us=round(d_k, 2),
                      addmm_device_us=None if d_l is None else round(d_l, 2),
                      bound_us=round(S.bound_c(M, k, dt)[0] * 1e3, 2), kernels=parts)
    name = ""
    for ln in _build.ptxas_log.splitlines():  # registers of F's and C's instances
        if "Compiling entry" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif "Used" in ln and ("mbn" in name or "topk4" in name):
            print(f"  {name[:90]} {ln.split('info    :')[-1].strip()}", flush=True)


def traced_library(name: str, points, out_name: str, trace: bool = True):
    """Build a copy of csrc/``name`` with each anchor of ``points`` (found
    once) replaced and (``trace``) an entry ``capk_set_trace``, into
    ``build/trace/`` -> the loaded library, with the package's C signatures."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / name).read_text()
    for anchor, replacement in points:
        if src.count(anchor) != 1:
            raise AssertionError(f"trace anchor not found once in {name}: {anchor!r}")
        src = src.replace(anchor, replacement)
    if trace:
        src += ('\nextern "C" int capk_set_trace(long long* p) {\n'
                "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n")
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{out_name}.cu").write_text(src)
    lib_path = out / f"lib{out_name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                        str(_build.CSRC_DIR), "-o", str(lib_path), str(out / f"{out_name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the traced copy:\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    if trace:
        lib.capk_set_trace.argtypes = [ctypes.c_void_p]
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def trace_words(dev, lib, call, warm: int = 3, words: int = 1 << 20):
    """``call()`` run through the port's wrapper with ``lib`` in place of
    the package's library: ``warm`` calls untraced, then one traced -> the
    trace words [blocks that ran, 16] (word 0 the start ns, 1 the SM, 15 the
    end ns)."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

    sound = _build.load_library()
    trace = torch.zeros(words, dtype=torch.int64, device=dev)
    _build._lib = lib  # the wrapper's next calls go through the traced copy
    try:
        lib.capk_set_trace(None)
        for _ in range(warm):
            call()
        torch.cuda.synchronize()
        lib.capk_set_trace(trace.data_ptr())
        call()
        torch.cuda.synchronize()
        lib.capk_set_trace(None)
    finally:
        _build._lib = sound
    t = trace.view(-1, 16).cpu().numpy()
    return t[t[:, 0] > 0]


def block_summary(t):
    """The traced blocks' span, median block µs, last start and most blocks
    on one SM."""
    start, end = (t[:, 0] - t[:, 0].min()) / 1e3, (t[:, 15] - t[:, 0].min()) / 1e3
    return dict(blocks=len(t), span_us=round(float(end.max()), 3),
                block_us_p50=round(float(np.median(end - start)), 3),
                last_start_us=round(float(start.max()), 3),
                blocks_per_sm_max=int(np.bincount(t[:, 1].astype(int)).max()))


def trace_c(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    lib = traced_library("topk_head.cu", TRACE_POINTS, "topk_trace")
    gen = torch.Generator().manual_seed(0)
    k, dt = 4, torch.bfloat16
    for M in (32, 512):
        proj, table, bias, _scale = S.head_operands(gen, dev, M, dt)
        t = trace_words(dev, lib, lambda: VH.topk_vocab_head(proj, table, bias, k))
        S.say("trace_c", M=M, k=k, **block_summary(t))
        prev = t[:, 2]
        for i, phase in enumerate(("stage0", "product0", "select0",
                                   "stage1", "product1", "select1")):
            col = t[:, 3 + i]
            if not col.any():
                break
            d = col - prev
            print(f"  {phase}: cycles p50={np.median(d):.0f} max={d.max():.0f}", flush=True)
            prev = col
        for label, col in (("product loop", 13), ("selection loads + max", 9),
                           ("selection exp sums", 10), ("selection offers", 11)):
            print(f"  first sub-tile, {label} ends at cycle p50="
                  f"{np.median(t[:, col] - t[:, 3]):.0f} after staging", flush=True)


G_TRACE_HEAD = r"""
__device__ long long* g_trace;
#define TRBASE (g_trace + ((long)blockIdx.y * gridDim.x + blockIdx.x) * 16)
#define TR0 long long tr_prev = 0; if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); unsigned sm; \
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); TRBASE[0] = t; TRBASE[1] = sm; \
  tr_prev = clock64(); }
#define TRP(n) if (threadIdx.x == 0 && g_trace) { long long t_ = clock64(); \
  TRBASE[n] += t_ - tr_prev; tr_prev = t_; }
#define TREND if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); TRBASE[15] = t; TRP(7) }
"""
# (anchor in fused_irb.cu, its replacement in the traced copy); trace words:
# 0 start ns, 1 SM, 3 weights, 4 expand, 5 depthwise, 6 project, 7 epilogue,
# 15 end ns
G_TRACE_POINTS = [
    ('#include "mma.cuh"\n', '#include "mma.cuh"\n' + G_TRACE_HEAD),
    ("  // 1. the input window, bf16", "  TR0\n  // 1. the input window, bf16"),
    ("    const int buf = (ch - ch0) & 1;\n",
     "    const int buf = (ch - ch0) & 1;\n    TRP(6)\n"),
    ("    // expand: e[w][c]", "    TRP(3)\n    // expand: e[w][c]"),
    ("    // depthwise: d[px][c]", "    TRP(4)\n    // depthwise: d[px][c]"),
    ("    // project: acc += d", "    TRP(5)\n    // project: acc += d"),
    ("  // 3. the epilogue, or this split's", "  TRP(6)\n  // 3. the epilogue, or this split's"),
    ("    return;\n  }\n  bf16* os", "    TREND\n    return;\n  }\n  bf16* os"),
    ("        *reinterpret_cast<const uint4*>(os + px * pl.ldo + n);\n  }\n}\n",
     "        *reinterpret_cast<const uint4*>(os + px * pl.ldo + n);\n  }\n  TREND\n}\n"),
]
G_TRACE_BLOCKS = ("conv2_1", "conv3_1", "conv6_2", "conv7_2", "conv8_1")


A_TRACE_HEAD = r"""
__device__ long long* g_trace;
#define TRBASE (g_trace + ((long)blockIdx.y * gridDim.x + blockIdx.x) * 16)
#define TRA0 if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); unsigned sm; \
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm)); TRBASE[0] = t; TRBASE[1] = sm; \
  TRBASE[2] = clock64(); }
#define TRA(n) if (threadIdx.x == 0 && g_trace) TRBASE[n] = clock64();
#define TRAEND if (threadIdx.x == 0 && g_trace) { long long t; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); TRBASE[15] = t; TRBASE[7] = clock64(); }
"""
# kernel A's tile kernel (bf16 and int8 tables): clock stamps 2 start, 3 the
# first E chunk staged, 4 every chunk multiplied, 5 the bests in shared
# memory, 7 the partials written
A_TRACE_POINTS = [
    ('#include "mma.cuh"\n', '#include "mma.cuh"\n' + A_TRACE_HEAD),
    ("  if (pdl_enter(skip)) return;\n  // the vocab groups that meet",
     "  if (pdl_enter(skip)) return;\n  TRA0\n  // the vocab groups that meet"),
    ("    __syncthreads();  // chunk c's table (and float32 proj) copies are in\n",
     "    __syncthreads();  // chunk c's table (and float32 proj) copies are in\n"
     "    if (c == 0) TRA(3)\n"),
    ("  float bv[NTW][2];\n", "  TRA(4)\n  float bv[NTW][2];\n"),
    ("  __syncthreads();\n  for (int t = threadIdx.x; t < Sh::MB && m0 + t < M;",
     "  TRA(5)\n  __syncthreads();\n  for (int t = threadIdx.x; t < Sh::MB && m0 + t < M;"),
    ("    part_i[(long)(m0 + t) * pstride + blockIdx.x] = bi;\n  }\n}\n",
     "    part_i[(long)(m0 + t) * pstride + blockIdx.x] = bi;\n  }\n  TRAEND\n}\n"),
]


def trace_a(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    lib = traced_library("vocab_head.cu", A_TRACE_POINTS, "argmax_trace")
    for dt in (torch.bfloat16, torch.int8):
        for B in (8, 128):
            proj, table, bias, scale = S.head_operands(torch.Generator().manual_seed(B), dev, B, dt)
            t = trace_words(dev, lib, lambda: VH.greedy_vocab_argmax(proj, table, bias, scale))
            S.say("trace_a", dtype=str(dt).split(".")[-1], B=B, **block_summary(t),
                  **{f"{ph}_cycles_p50": int(np.median(t[:, j] - t[:, i])) for i, j, ph in
                     ((2, 3, "first_chunk_staged"), (3, 4, "chunks"), (4, 5, "epilogue"),
                      (5, 7, "written"))})


def probe_a_g(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    for dt in (torch.bfloat16, torch.int8, torch.float32):
        for B in (8, 128):
            ok, err, (proj, table, bias, scale) = S.a_checks(VH.greedy_vocab_argmax, dev, dt, B, 0)
            d_k, parts = device_split(lambda: VH.greedy_vocab_argmax(proj, table, bias, scale))
            d_l, lparts = ((None, None) if dt == torch.int8 else
                           device_split(lambda: S.logits_addmm(proj, table, bias)))
            S.say("probe_a", dtype=str(dt).split(".")[-1], B=B, checks_ok=all(ok.values()),
                  kernel_device_us=round(d_k, 2), kernels=parts,
                  addmm_device_us=None if d_l is None else round(d_l, 2), addmm_kernels=lparts,
                  bound_us=round(S.bound_a(B, dt)[0] * 1e3, 2))
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16
    for B in (8, 128):
        for name, H, W, cin, cexp, cout, stride, sc in S.irb_blocks(S.ENC_SIZE):
            x, fold = S.g_operands(gen, dev, B, H, W, cin, cexp, cout, dt)
            prep = FI.prepare_irb(fold, dt)
            d_k, parts = device_split(lambda: FI.fused_inverted_residual(x, prep, stride, sc, True),
                                      reps=3)
            d_l, _ = device_split(lambda: S.irb_cudnn(x, fold, stride, sc), reps=3)
            S.say("probe_g", B=B, block=name, kernel_device_us=round(d_k, 1), kernels=parts,
                  cudnn_device_us=round(d_l, 1),
                  bound_us=round(S.bound_g(B, H, W, cin, cexp, cout, stride, dt)[0] * 1e3, 1))
    name = ""
    for ln in _build.ptxas_log.splitlines():  # registers and spills of A's and G's instances
        if "Compiling entry" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif ("Used" in ln or "spill" in ln) and ("argmax" in name or "irb" in name):
            print(f"  {name[:90]} {ln.split('info    :')[-1].strip()}", flush=True)


def trace_g(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    lib = traced_library("fused_irb.cu", G_TRACE_POINTS, "irb_trace")
    gen = torch.Generator(device=dev).manual_seed(0)
    dt, B = torch.bfloat16, 128
    blocks = {b[0]: b for b in S.irb_blocks(S.ENC_SIZE)}
    for name in G_TRACE_BLOCKS:
        _n, H, W, cin, cexp, cout, stride, sc = blocks[name]
        x, fold = S.g_operands(gen, dev, B, H, W, cin, cexp, cout, dt)
        prep = FI.prepare_irb(fold, dt)
        t = trace_words(dev, lib, lambda: FI.fused_inverted_residual(x, prep, stride, sc, True),
                        warm=2)
        S.say("trace_g", block=name, B=B, **block_summary(t),
              waves=round(len(t) / max(1, len(np.unique(t[:, 1]))), 2),
              **{f"{ph}_cycles_p50": int(np.median(t[:, i])) for i, ph in
                 ((3, "weights"), (4, "expand"), (5, "depthwise"), (6, "project"),
                  (7, "epilogue"))})


def probe_ab(dev):
    """Kernel A's and G's device times for the ``myimagecaptioningmodel_
    tpu_torch`` first on sys.path (``--package-root`` puts another
    checkout's there, e.g. the parent commit's, so that both run in one
    call): A at B in {8, 128} with bf16, int8 and float32 tables beside
    ``logits_addmm`` (device µs a call); G summed over the 17 blocks at
    B in {8, 128}, bf16 and float32, beside ``irb_cudnn`` (device ms), on
    weights already in the activation dtype, so that no cast runs in the
    call. The operands come from fixed seeds: both packages see the same."""
    import myimagecaptioningmodel_tpu_torch as pkg
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI
    from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as VH

    S.say("ab_package", root=os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))))
    for dt in (torch.bfloat16, torch.int8, torch.float32):
        for B in (8, 128):
            proj, table, bias, scale = S.head_operands(torch.Generator().manual_seed(B), dev, B, dt)
            ids = VH.greedy_vocab_argmax(proj, table, bias, scale)
            ok = S.near_tie_ok(ids, VH.head_logits_reference(proj, table, bias, scale), dt)
            d_k = S.device_us(lambda: VH.greedy_vocab_argmax(proj, table, bias, scale))
            d_l = (None if dt == torch.int8 else
                   S.device_us(lambda: S.logits_addmm(proj, table, bias)))
            S.say("ab_a", dtype=str(dt).split(".")[-1], B=B, near_tie_ok=ok,
                  kernel_device_us=round(d_k, 2),
                  addmm_logits_device_us=None if d_l is None else round(d_l, 2))
    for dt in (torch.bfloat16, torch.float32):
        for B in (8, 128):
            gen = torch.Generator(device=dev).manual_seed(B)
            worst, kernels, cudnn = 0.0, [], []
            for _name, H, W, cin, cexp, cout, stride, sc in S.irb_blocks(S.ENC_SIZE):
                x, fold = S.g_operands(gen, dev, B, H, W, cin, cexp, cout, dt)
                w = fold._replace(we=fold.we.to(dt), wp=fold.wp.to(dt))
                w = FI.prepare_irb(w, dt) if hasattr(FI, "prepare_irb") else w
                want = FI.fused_inverted_residual_reference(x, fold, stride, sc, True)
                worst = max(worst, S.rel_max_err(FI.fused_inverted_residual(x, w, stride, sc, True),
                                                 want))
                kernels.append(lambda x=x, w=w, s=stride, c=sc:
                               FI.fused_inverted_residual(x, w, s, c, True))
                cudnn.append(lambda x=x, f=fold, s=stride, c=sc: S.irb_cudnn(x, f, s, c))
            d_k, d_l = S.device_us_each(kernels), S.device_us_each(cudnn)
            S.say("ab_g_sum", dtype=str(dt).split(".")[-1], B=B, blocks=17,
                  max_rel_err=f"{worst:.3g}", kernel_device_ms=round(sum(d_k) / 1e3, 4),
                  cudnn_device_ms=round(sum(d_l) / 1e3, 4),
                  blocks_device_us=[round(v, 1) for v in d_k])
            del kernels, cudnn
            torch.cuda.empty_cache()


def probe_encoder(dev, reps: int = 20, batches=(8, 128)):
    """(part ``enc``) The fused eval encoder (``apply(use_fused_irb=True)``)
    and the plain one, MobileNetV2 x1.0 at 224 px, random weights and BN
    statistics (``chip_smoke.encoder_tree``), B in {8, 128}, bfloat16 and
    float32, for the package first on sys.path: ms a forward (CUDA events
    over ``reps`` forwards after 3), the host's ms to enqueue one forward
    (no synchronize inside the loop: near the first where the host sets the
    pace), and the host's ms a forward to fold the 17 blocks' BN
    (``fold_irb``), to cast the folded weights (``prepare_irb``, where the
    package has it) and to make the 17 calls of kernel G's wrapper on
    operands already on the card (folded weights for a package without
    ``prepare_irb``, which casts them in the call)."""
    from myimagecaptioningmodel_tpu_torch.models import mobilenet_v2 as MV
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as FI

    params, state = S.encoder_tree(torch.Generator().manual_seed(0), dev)
    names = [f"conv{stage}_{i}" for stage, (_t, _c, n, _s) in
             enumerate(MV.BOTTLENECK_PARAMS, start=2) for i in range(1, n + 1)]
    prepare = getattr(FI, "prepare_irb", None)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return t

    def fold_all():
        return [FI.fold_irb({k: params[f"{n}_{k}"] for k in ("expand", "dwise", "linear")},
                            {k: state[f"{n}_{k}"] for k in ("expand", "dwise", "linear")})
                for n in names]

    folds = fold_all()
    for dt in (torch.bfloat16, torch.float32):
        for B in batches:
            x = torch.rand(B, S.ENC_SIZE, S.ENC_SIZE, 3, generator=torch.Generator().manual_seed(B))
            x = x.to(dev)
            ops = []
            for (_n, H, W, cin, _e, _o, stride, sc), f in zip(S.irb_blocks(S.ENC_SIZE), folds):
                xb = torch.rand(B, H, W, cin, device=dev).to(dt)
                ops.append((xb, prepare(f, dt) if prepare else f, stride, sc))

            def g_calls():
                for xb, w, stride, sc in ops:
                    FI.fused_inverted_residual(xb, w, stride, sc, True)

            with torch.no_grad():
                fused = lambda: MV.apply(params, state, x, train=False, compute_dtype=dt,
                                         use_fused_irb=True)[0]
                plain = lambda: MV.apply(params, state, x, train=False, compute_dtype=dt)[0]
                t = {"plain": [], "fused": []}
                for path in ("plain", "fused", "fused", "plain"):
                    t[path].append(S.time_ms(fused if path == "fused" else plain, reps=reps))
                S.say("enc", dtype=str(dt).split(".")[-1], B=B,
                      fused_ms=[round(v, 3) for v in t["fused"]],
                      plain_ms=[round(v, 3) for v in t["plain"]],
                      fused_host_ms=round(host_ms(fused), 3),
                      fold_host_ms=round(host_ms(fold_all), 3),
                      prepare_host_ms=(None if prepare is None else round(
                          host_ms(lambda: [prepare(f, dt) for f in folds]), 3)),
                      g_calls_host_ms=round(host_ms(g_calls), 3))
            del ops, x
            torch.cuda.empty_cache()


# the kernels of a greedy step at 4 layers, in launch order (embed: the next
# word's, launched last in a step)
D_STEP = (["qkv", "attn", "wo", "xq", "xattn", "xo", "fc1", "fc2"] * 4
          + ["out_proj", "head_tile", "head_merge", "finish", "embed"])
E_STEP = D_STEP[:-2] + ["select", "reorder", "embed"]
# beyond 16 rows each LayerNorm product's rows come from tf_layernorm first
LN_BEFORE = {"qkv": "ln1", "xq": "ln2", "fc1": "ln3", "out_proj": "lnf"}


def with_ln(step):
    return [r for role in step for r in ([LN_BEFORE[role]] if role in LN_BEFORE else []) + [role]]
STREAM_BYTES = {"rows": 2, "layernorm": 4, "gather": 2}  # A's bytes an element
OUT_BYTES = {"store": 2, "gelu": 2, "qkv": 2, "store_f32": 4, "residual": 8, "embed": 4}


def de_decodes(dev):
    """The decodes part ``de`` times: (label, rows, decode function) for
    kernel D at B in {8, 128} and E on 8 and 128 images x beam 4, bf16, float
    and int8 weight streams, and D at B=8 and E on 8 images in float32, full
    width, early stop off (all 35 steps)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    gen = torch.Generator().manual_seed(0)
    params = tree_to_torch(S.randomize_affine(TTF.init(gen, S.tf_dims()), gen), dev)
    bf = torch.bfloat16
    for mode, p in (("bf16", params), ("int8", TTF.quantize_transformer_decoder(params))):
        packed = FT.pack_weights(p, bf)
        for kind, n in (("greedy", 8), ("greedy", 128), ("beam", 8), ("beam", 128)):
            pre = S.tf_pre(torch.Generator().manual_seed(n), dev, p, n, bf)
            ftp = FT.prepare(p, pre, S.TF_HEADS, bf, packed=packed)
            if kind == "greedy":
                fn = lambda ftp=ftp: FT.fused_greedy_decode(ftp, S.TF_STEPS, S.TF_HEADS,
                                                            compute_dtype=bf)
            else:
                fn = lambda ftp=ftp: FT.fused_beam_decode(ftp, S.TF_STEPS, S.TF_HEADS, S.BEAM,
                                                          compute_dtype=bf)
            yield f"{kind}_{mode}", n * (S.BEAM if kind == "beam" else 1), fn
        del packed
    f32 = torch.float32
    packed = FT.pack_weights(params, f32)
    for kind in ("greedy", "beam"):
        pre = S.tf_pre(torch.Generator().manual_seed(8), dev, params, 8, f32)
        ftp = FT.prepare(params, pre, S.TF_HEADS, f32, packed=packed)
        if kind == "greedy":
            fn = lambda ftp=ftp: FT.fused_greedy_decode(ftp, S.TF_STEPS, S.TF_HEADS,
                                                        compute_dtype=f32)
        else:
            fn = lambda ftp=ftp: FT.fused_beam_decode(ftp, S.TF_STEPS, S.TF_HEADS, S.BEAM,
                                                      compute_dtype=f32)
        yield f"{kind}_f32", 8 * (S.BEAM if kind == "beam" else 1), fn


def decode_spans(fn):
    """One profiled decode -> (wall ms, its capk kernels' (name, start, end)
    in launch order, the busy µs of all its device activities)."""
    from torch.autograd import DeviceType

    wall, _events, prof = S.profile_events(fn, keep=True)
    acts = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in acts)
    return (wall, [(n, a, b) for a, b, n in spans if "capk::" in n],
            S.busy_us([(a, b) for a, b, _n in spans]))


def probe_de(dev, reps: int = 3):
    """(part ``de``) Kernels D and E for the package first on sys.path (this
    checkout's, or ``--package-root``'s): per decode of ``de_decodes``, the
    device busy ms (the union of its device activities' intervals, ``reps``
    profiled decodes), the kernels it launched and the host's µs to enqueue
    it (the median of 5, each after a synchronize). For this checkout's
    package also: where the bf16 decodes' critical path goes (each kernel's
    end minus the end of the kernel before it, by its role in the step,
    summed over the steps: with programmatic dependent launch a kernel's own
    device time overlaps its neighbours'), and the per-product table
    (``probe_products``)."""
    import myimagecaptioningmodel_tpu_torch as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    S.say("de_package", root=root)
    for label, rows, fn in de_decodes(dev):
        fn()
        torch.cuda.synchronize()
        busy, n_kernels, path = [], 0, None
        for _ in range(reps):
            _wall, spans, b = decode_spans(fn)
            busy.append(round(b / 1e3, 3))
            n_kernels, path = len(spans), spans
        S.say("de", decode=label, rows=rows, device_busy_ms=busy,
              host_enqueue_us=round(S.enqueue_us(fn), 1), capk_kernels=n_kernels)
        roles = D_STEP if label.startswith("greedy") else E_STEP
        if any("tf_layernorm" in name for name, _a, _b in path):
            roles = with_ln(roles)
        if os.path.abspath(root) == os.path.dirname(os.path.abspath(__file__)) and \
                label.endswith("bf16"):
            inc, dur, prev_end = {}, {}, path[0][1]
            for i, (name, a, b) in enumerate(path):
                role = "embed0" if i == 0 else roles[(i - 1) % len(roles)]
                inc[role] = inc.get(role, 0.0) + max(0.0, b - prev_end)
                dur[role] = dur.get(role, 0.0) + (b - a)
                prev_end = max(prev_end, b)
            S.say("de_path", decode=label, rows=rows,
                  span_ms=round((prev_end - path[0][1]) / 1e3, 3),
                  critical_ms_by_role={k: round(v / 1e3, 3) for k, v in inc.items()},
                  kernel_ms_by_role={k: round(v / 1e3, 3) for k, v in dur.items()})
    if os.path.abspath(root) == os.path.dirname(os.path.abspath(__file__)):
        probe_products(dev)


def chained_us(fn, n: int = 20) -> float:
    """Device µs a call of ``fn`` takes in a row of ``n``, queued behind a
    spin kernel so that the card runs them back to back (CUDA events from
    the end of one call before the row to the end of the row)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(5_000_000)  # the host queues the row meanwhile
    fn()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def probe_products(dev):
    """The bf16 decode's products one at a time (``stream_product``, no
    programmatic dependent launch), each (N, K) of a full-width step with its
    A operand and epilogue (``tests/test_torch_cuda.py``'s STREAM_SHAPES), at
    8, 32, 128 and 512 rows, bf16 and int8 weights: the product kernel's
    device µs (its LayerNorm statistics kernel left out), the device µs a
    product of 20 in a row takes when each is launched as a decode launches
    it (``chained_us``; programmatic dependent launch: the next one's
    weights stream in under this one; a LayerNorm product up to 16 rows
    also runs ``capk_tile_stats``, launched plainly, before each call),
    ``torch.mm``'s on bf16 operands of the same shapes, and the byte bound
    (the weight, A and the output once, at 3.35 TB/s) with its share of the
    chained time."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

    shapes = [(3072, 1024, "layernorm", "qkv"), (1024, 1024, "rows", "residual"),
              (1024, 1024, "layernorm", "store"), (4096, 1024, "layernorm", "gelu"),
              (1024, 4096, "rows", "residual"), (256, 1024, "layernorm", "store_f32"),
              (1024, 256, "gather", "embed")]
    bf = torch.bfloat16
    for N, K, a_mode, mode in shapes:
        for int8 in (False, True):
            for rows in (8, 32, 128, 512):
                g = torch.Generator(device=dev).manual_seed(rows)
                w = torch.randn(K, N, device=dev, generator=g) / K ** 0.5
                scale = None
                if int8:
                    scale = w.abs().amax(dim=0) / 127
                    w = torch.round(w / scale).to(torch.int8)
                else:
                    w = w.to(bf)
                bias = torch.zeros(N, device=dev)
                kw = dict(w_scale=scale)
                if a_mode == "gather":
                    a = torch.randn(1000, K, device=dev, generator=g).to(bf)
                    kw.update(word=torch.randint(0, 1000, (rows,), device=dev, generator=g,
                                                 dtype=torch.int32), pad=0)
                elif a_mode == "layernorm":
                    a = torch.randn(rows, K, device=dev, generator=g)
                    kw.update(ln_g=torch.ones(K, device=dev), ln_b=torch.zeros(K, device=dev))
                else:
                    a = torch.randn(rows, K, device=dev, generator=g).to(bf)
                if mode == "residual":
                    kw["out"] = torch.zeros(rows, N, device=dev)
                elif mode == "embed":
                    kw["pos"] = torch.zeros(N, device=dev)
                elif mode == "qkv":
                    kw.update(out=torch.empty(rows, N // 3, dtype=bf, device=dev),
                              kc=torch.empty(rows, 2, N // 3, dtype=bf, device=dev),
                              vc=torch.empty(rows, 2, N // 3, dtype=bf, device=dev))
                _total, parts = device_split(lambda: FT.stream_product(a, w, bias, mode, a_mode,
                                                                       **kw), reps=10)
                k_us = sum(v for n, v in parts.items() if "tf_stream" in n)
                chain_us = chained_us(lambda: FT.stream_product(a, w, bias, mode, a_mode,
                                                                pdl=True, **kw))
                x = torch.randn(rows, K, device=dev).to(bf)
                wb = torch.randn(K, N, device=dev).to(bf)
                mm_us = S.device_us(lambda: torch.mm(x, wb))
                nbytes = K * N * (1 if int8 else 2) + rows * K * STREAM_BYTES[a_mode] + rows * N * \
                    OUT_BYTES[mode]
                b_us = nbytes / S.HBM_BYTES_PER_S * 1e6
                S.say("de_product", N=N, K=K, a=a_mode, epilogue=mode, rows=rows,
                      weights="int8" if int8 else "bf16", kernel_device_us=round(k_us, 2),
                      chained_device_us=round(chain_us, 2),
                      mm_device_us=round(mm_us, 2), bound_us=round(b_us, 2),
                      bound_share=round(b_us / chain_us, 3))


# ---- part b: kernel B --------------------------------------------------------------

def b_params(dev):
    """Full-width random LSTM decoder params (``decoder.init``, seed 0)."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
    from myimagecaptioningmodel_tpu_torch.models import decoder as D

    dims = D.DecoderDims(vocab_size=12295, embedding_size=S.E, hidden_dim=S.H,
                         vocab_pad_multiple=128)
    return tree_to_torch(D.init(torch.Generator().manual_seed(0), dims), dev)


def b_pre(params, n, dev, seed):
    from myimagecaptioningmodel_tpu_torch.models import decoder as D

    g = torch.Generator().manual_seed(seed)
    img = torch.randn(n, S.K_SLOTS, S.H, generator=g).to(dev)
    return D.precompute(params, img, torch.randn(n, S.H, generator=g).to(dev), torch.bfloat16)


def b_steps(dev, params):
    """(rows, with the head, images, one step as the package's main path
    calls it) at ``chip_smoke.B_PERF_ROWS``, bf16: a checkout with packed
    weights (``fused_step.pack_step``) gathers the word rows in the gate
    product and shares each image's memory among its beam rows; an older
    one takes ``prepare``'s tensors and ``emb_table[word]``, the memory
    repeated per row, as its decode loops did."""
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    bf, packed = torch.bfloat16, hasattr(FS, "pack_step")
    for rows, head in S.B_PERF_ROWS:
        n_img = S.b_images(rows, head)
        pre = b_pre(params, n_img, dev, rows)
        pre_rows = D.Precomputed(*(t.repeat_interleave(rows // n_img, dim=0) for t in pre))
        fp = FS.prepare(params, pre_rows, 0, bf)
        g = torch.Generator().manual_seed(1)
        word = torch.randint(0, 12295, (rows,), generator=g).to(dev)
        h = (torch.randn(rows, S.H, generator=g) * 0.5).to(dev)
        c = (torch.randn(rows, S.H, generator=g) * 0.5).to(dev)
        if packed:
            pk, w32 = FS.pack_step(fp), word.to(torch.int32)
            img_k, img_v = pre.img_k.to(bf).contiguous(), pre.img_v.to(bf).contiguous()

            def fn(pk=pk, w32=w32, h=h, c=c, img_k=img_k, img_v=img_v, head=head):
                return FS.fused_decode_step(pk, None, h, c, img_k, img_v, with_head=head,
                                            compute_dtype=bf, word=w32)
        else:
            emb = fp.emb_table[word]
            img_k, img_v = pre_rows.img_k.to(bf).contiguous(), pre_rows.img_v.to(bf).contiguous()

            def fn(fp=fp, emb=emb, h=h, c=c, img_k=img_k, img_v=img_v, head=head):
                return FS.fused_decode_step(fp, emb, h, c, img_k, img_v, with_head=head,
                                            compute_dtype=bf)
        yield rows, head, n_img, fn


def b_decodes(dev, params):
    """(label, rows, one whole decode) for greedy B=8 and 128 and beam 4 on 8
    and 128 images, bf16, 35 steps, early stop off, through the package's
    own entry points (weights packed once where the package packs)."""
    import inspect

    from myimagecaptioningmodel_tpu_torch.inference import beam as BM
    from myimagecaptioningmodel_tpu_torch.models import decoder as D
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    bf = torch.bfloat16
    kw = {}
    if "packed" in inspect.signature(D.greedy_decode_ids).parameters:
        kw["packed"] = FS.pack_weights(params, bf)
    for beam, n in ((False, 8), (False, 128), (True, 8), (True, 128)):
        pre = b_pre(params, n, dev, 100 + n)
        if beam:
            fn = lambda pre=pre: BM.beam_search_ids(  # noqa: E731
                params, pre, S.TF_STEPS, S.BEAM, compute_dtype=bf, use_kernels=True, **kw)
        else:
            fn = lambda pre=pre: D.greedy_decode_ids(  # noqa: E731
                params, pre, S.TF_STEPS, compute_dtype=bf, use_kernels=True, **kw)
        yield f"{'beam' if beam else 'greedy'}_{n}", n * (S.BEAM if beam else 1), fn


def b_role(name: str, nth_product: int) -> str:
    """A device kernel's role in an LSTM decode step, from its name (the
    gate product is the 80-column instance; the step's other products come
    in the order p_hid, he+se, out, proj)."""
    if "capk::" not in name:
        return "torch"  # beam: the selection and reorder; both: input copies
    for role, mark in (("attention", "lstm_attention"), ("head_tile", "argmax_tile"),
                       ("head_merge", "argmax_merge"), ("head_tile", "topk_tile"),
                       ("head_merge", "topk_merge"), ("finish", "greedy_finish"),
                       ("gate", ", 5, true>"), ("gate", "Li5ELb1E"), ("gate", "gate_kernel")):
        if mark in name:
            return role
    return ("p_hid", "he+se", "out", "proj")[nth_product % 4]


def probe_b(dev, reps: int = 3):
    """(part ``b``) Kernel B for the package first on sys.path (this
    checkout's, or ``--package-root``'s): per step at PERF.md's rows, bf16,
    the µs per call (CUDA events) and device µs per call (torch.profiler,
    the union of the call's kernels' intervals; each kernel's own summed
    time beside it) beside ``chip_smoke.bound_b``; per decode (``b_decodes``) the device
    busy ms (the union of its device activities, ``reps`` profiled
    decodes), the host's µs to enqueue it (median of 5, each after a
    synchronize) and the wall ms (CUDA events). For this checkout's
    package also the bf16 decodes' critical path by role (each device
    kernel's end minus the latest end before it, summed over the steps;
    ``b_role``) and the per-product table (``probe_b_products``)."""
    from torch.autograd import DeviceType

    import myimagecaptioningmodel_tpu_torch as pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    S.say("b_package", root=root)
    params = b_params(dev)
    bf = torch.bfloat16
    for rows, head, n_img, fn in b_steps(dev, params):
        _sum, parts = device_split(fn)
        d_k = S.device_us(fn, busy=True)
        b_ms, b_by = S.bound_b(rows, bf, head, n_img)
        S.say("b_step", rows=rows, with_head=head, images=n_img,
              kernel_us=round(S.time_ms(fn) * 1e3, 2), device_us=round(d_k, 2),
              bound_us=round(b_ms * 1e3, 2), bound_by=b_by, bound_share=round(b_ms * 1e3 / d_k, 4),
              kernels=parts)
    this = os.path.abspath(root) == os.path.dirname(os.path.abspath(__file__))
    for label, rows, fn in b_decodes(dev, params):
        fn()
        torch.cuda.synchronize()
        busy, spans = [], []
        for _ in range(reps):
            wall, _events, prof = S.profile_events(fn, keep=True)
            acts = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                          if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)
            busy.append(round(S.busy_us([(a, b) for a, b, _n in acts]) / 1e3, 3))
            spans = acts
        S.say("b_decode", decode=label, rows=rows, device_busy_ms=busy,
              busy_us_per_step=round(min(busy) * 1e3 / S.TF_STEPS, 2),
              wall_ms=round(S.time_ms(fn, reps=5, warmup=1), 3),
              host_enqueue_us=round(S.enqueue_us(fn), 1), device_kernels=len(spans))
        if this:
            inc, prev_end, nth = {}, spans[0][0], 0
            for a, b, name in spans:
                role = b_role(name, nth)
                nth += role in ("p_hid", "he+se", "out", "proj")
                inc[role] = inc.get(role, 0.0) + max(0.0, b - prev_end)
                prev_end = max(prev_end, b)
            S.say("b_path", decode=label, rows=rows,
                  span_ms=round((prev_end - spans[0][0]) / 1e3, 3),
                  critical_ms_by_role={k: round(v / 1e3, 3) for k, v in inc.items()})
    if this:
        probe_b_products(dev)


def probe_b_products(dev):
    """The bf16 step's products one at a time (``fused_step.step_product``),
    each at its full-width shape with its A operand and epilogue, at 8, 32,
    128 and 512 rows: the kernel's device µs, the device µs a product of 20
    in a row takes when each is launched with programmatic dependent
    launch (``chained_us``), ``torch.mm``'s on bf16 operands of the same
    shape, and the byte bound (the weight, A and the outputs once, at 3.35
    TB/s) with its share of the chained time."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    bf, H, E = torch.bfloat16, S.H, S.E
    # (name, problems, N, K, k_split (the gathered word rows), mode)
    shapes = [("gate", 1, 5 * H, E + H, E, "lstm"), ("p_hid", 1, H, H, 0, "tanh"),
              ("he+se", 2, H, H, 0, "f32"), ("out", 1, H, H, 0, "tanh"),
              ("proj", 1, E, H, 0, "f32")]
    for name, P, N, K, k_split, mode in shapes:
        for rows in (8, 32, 128, 512):
            g = torch.Generator(device=dev).manual_seed(rows)
            w = (torch.randn(P, K, N, device=dev, generator=g) / K ** 0.5).to(bf)
            bias = torch.zeros(P, N, device=dev)
            a2 = torch.randn(P, rows, K - k_split, device=dev, generator=g)
            kw = {}
            if mode == "lstm":
                kw = dict(a=torch.randn(1000, E, device=dev, generator=g).to(bf),
                          word=torch.randint(0, 1000, (rows,), device=dev, generator=g,
                                             dtype=torch.int32),
                          k_split=k_split, gxb=torch.zeros(rows, N, device=dev),
                          c=torch.zeros(rows, H, device=dev))
            if P == 1:
                w, bias, a2 = w[0], bias[0], a2[0]

            def call(pdl=False, w=w, bias=bias, a2=a2, kw=kw, mode=mode):
                return FS.step_product(a2, w, None if mode == "lstm" else bias, mode, pdl=pdl,
                                       **kw)
            _total, parts = device_split(call, reps=10)
            k_us = sum(v for n, v in parts.items() if "tf_stream" in n)
            chain_us = chained_us(lambda: call(True))
            x = torch.randn(rows, K, device=dev).to(bf)
            wb = torch.randn(K, P * N, device=dev).to(bf)
            mm_us = S.device_us(lambda: torch.mm(x, wb))
            out_cols = 3 * H if mode == "lstm" else P * N  # h', c', sentinel
            nbytes = P * K * N * 2 + P * rows * (K - k_split) * 4 + rows * k_split * 2 + \
                rows * out_cols * 4 + (rows * (N + H) * 4 if mode == "lstm" else P * N * 4)
            b_us = nbytes / S.HBM_BYTES_PER_S * 1e6
            S.say("b_product", product=name, N=P * N, K=K, epilogue=mode, rows=rows,
                  kernel_device_us=round(k_us, 2), chained_device_us=round(chain_us, 2),
                  mm_device_us=round(mm_us, 2), bound_us=round(b_us, 2),
                  bound_share=round(b_us / chain_us, 3))


def probe_train(dev, rounds: int = 4, reps: int = 5, only=None):
    """Part ``train``: bf16 B=128 train steps at full width, variants in
    turns (each round runs them in order, then in reverse) over ``rounds``
    rounds of ``reps``-step windows: the median, quartiles and range of each
    variant's ms per step (CUDA events), its peak MiB above base, and its
    device busy ms and device kernels in one profiled step. Four sets
    (``only``: these alone): the LSTM with ``fuse_bn_stats`` off and on;
    the LSTM, fused, at bn_stat_rows 0, 16 and 32; the transformer, unfused and fused; the LSTM,
    fused, with the decoder's ``fused_attn_bwd`` off (the default) and on
    (kernel H; the step's call of ``teacher_forcing_logits`` patched, no
    default changed)."""
    import functools
    import tempfile

    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.models import decoder as D

    tf_logits = D.teacher_forcing_logits
    sets = {
        "fuse_bn_stats": {"off": (False, ()), "on": (True, ())},
        "bn_stat_rows": {f"R{r}": (True, (("model.bn_stat_rows", r),)) for r in (0, 16, 32)},
        "transformer": {"plain": (False, S.TF_ARCH), "kernel": (True, S.TF_ARCH)},
        "fused_attn_bwd": {"off": (True, ()), "on": (True, ())},
    }
    if only is not None:
        sets = {k: v for k, v in sets.items() if k in only}
    with tempfile.TemporaryDirectory() as root:
        for name, variants in sets.items():
            cfgs = {v: S.train_cfg(root, "bfloat16", fuse, 128, 1e-4, extra)
                    for v, (fuse, extra) in variants.items()}
            first = next(iter(cfgs.values()))
            ref = C.init(torch.Generator().manual_seed(0), C.ModelOptions.from_config(first))
            images, caps = S.train_batch(first, dev, 1)
            steps = {v: S.trainer(cfg, *ref, dev) for v, cfg in cfgs.items()}
            _fn, params, opt_state, state = steps[next(iter(steps))]
            fns = {v: st[0] for v, st in steps.items()}
            del steps
            n = [0]

            def run(v, k):
                nonlocal params, opt_state, state
                if name == "fused_attn_bwd" and v == "on":
                    D.teacher_forcing_logits = functools.partial(tf_logits, fused_attn_bwd=True)
                try:
                    for _ in range(k):
                        params, opt_state, state, _s, _l, _lr = fns[v](
                            params, opt_state, state, n[0], images, caps)
                        n[0] += 1
                finally:
                    D.teacher_forcing_logits = tf_logits

            order = list(variants)
            ms, peak = {v: [] for v in order}, {v: 0.0 for v in order}
            for r in range(rounds):
                for v in (order if r % 2 == 0 else order[::-1]):
                    run(v, 1)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    run(v, reps)
                    b.record()
                    torch.cuda.synchronize()
                    ms[v].append(a.elapsed_time(b) / reps)
                    peak[v] = max(peak[v], (torch.cuda.max_memory_allocated(dev) - base) / 2**20)
            for v in order:
                _wall, events = S.profile_events(lambda: run(v, 1))
                q1, med, q3 = np.percentile(ms[v], [25, 50, 75])
                S.say("probe_train", set=name, variant=v, B=128, dtype="bfloat16",
                      windows=len(ms[v]), steps_a_window=reps, median_ms_per_step=round(med, 3),
                      q1_ms=round(q1, 3), q3_ms=round(q3, 3), min_ms=round(min(ms[v]), 3),
                      max_ms=round(max(ms[v]), 3),
                      images_per_s_at_median=round(128 / med * 1e3, 1),
                      peak_mib_above_base=round(peak[v], 1),
                      device_busy_ms=round(sum(S.dev_us(e) for e in events) / 1e3, 3),
                      device_kernels=sum(e.count for e in events),
                      windows_ms=[round(x, 3) for x in ms[v]])
            del fns, params, opt_state, state
            torch.cuda.empty_cache()


@contextlib.contextmanager
def cudnn_without_tf32():
    """cuDNN's float32 convolutions in full float32 while active, as
    ``chip_smoke.py`` runs every phase (this script leaves cuDNN's TF32 on
    for its bf16 timings)."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def probe_quality_bn(dev, seeds=(0, 1, 2, 3, 4), epochs=1):
    """Part ``quality_bn`` (the module docstring's 13): each step's loss of
    phase 30's LSTM arm through kernel I (twice) and through its plain
    versions on the card, from each seed."""
    import tempfile

    from myimagecaptioningmodel_tpu_torch.config import replace_nested
    from myimagecaptioningmodel_tpu_torch.training import loop

    for seed in seeds:
        losses = {}
        with (tempfile.TemporaryDirectory() as root, S.cudnn_deterministic(),
              cudnn_without_tf32()):
            _path, cfg = S.quality_corpus(os.path.join(root, "quality"), seed)
            for run in ("kernel", "kernel_again", "plain"):
                c = cfg
                for path, value in (("train.max_epoch", epochs),
                                    ("train.checkpoint_path", os.path.join(root, run, "save")),
                                    ("log.log_path", os.path.join(root, run, "log")),
                                    ("train.checkpoint_every_n_steps", False), *S.NO_EXPORTS):
                    c = replace_nested(c, path, value)
                plain = S.plain_in_float64(i_every_dtype=True)
                with (plain if run == "plain" else contextlib.nullcontext(),
                      S.loop_probe() as probe, contextlib.redirect_stdout(io.StringIO())):
                    loop.train(c, device=dev)
                losses[run] = probe.loss_values()
        k, p = np.array(losses["kernel"]), np.array(losses["plain"])
        rel = np.abs(k - p) / np.abs(p)
        apart = [i for i, r in enumerate(rel) if r > 1e-6]
        S.say("probe_quality_bn", seed=seed, steps=len(k), dtype="float32",
              kernel_rerun_bit_equal=losses["kernel"] == losses["kernel_again"],
              first_step_apart_1e6=apart[0] + 1 if apart else None,
              rel_diff=[float(f"{r:.3g}") for r in rel],
              kernel=[round(x, 7) for x in losses["kernel"]],
              plain=[round(x, 7) for x in losses["plain"]])
        torch.cuda.empty_cache()


def probe_kink(dev, seeds=(0, 1, 2, 3, 4)):
    """Part ``kink`` (the module docstring's 14)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root, cudnn_without_tf32():
        for seed in seeds:
            for plain in (False, True):
                errs, _ref = S.subset_step_errors(dev, seed, root, plain_i=plain)
                for path, e in errs.items():
                    S.say("probe_kink", seed=seed, path=path, plain_i=plain,
                          failed=S.step_failures(e), **e)
                torch.cuda.empty_cache()


# Microbenchmarks of one quarter SM's pipes: each warp runs rounds of
# independent instructions on registers; kind 0: 8 tanh.approx.f32, 1: 8
# tanh.approx.bf16x2, 2: 3 mma.sync m16n8k16 (bf16 -> float32), 3: 2 and 0,
# 4: 40 fma.rn.bf16x2, 5: 4 and 0.
H_PIPES_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void pipes(float* out, int iters, long long* cycles) {
  float a[8], acc[3][4] = {};
  uint32_t u[8];
  for (int i = 0; i < 8; ++i) { a[i] = threadIdx.x * 1e-3f + i * 0.1f; u[i] = 0x3e003e00u + i; }
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (KIND == 2 || KIND == 3)
      for (int q = 0; q < 3; ++q)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                     "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                     : "+f"(acc[q][0]), "+f"(acc[q][1]), "+f"(acc[q][2]), "+f"(acc[q][3])
                     : "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3]), "r"(u[4]), "r"(u[5]));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (KIND == 0 || KIND == 3 || KIND == 5) asm volatile("tanh.approx.f32 %0, %0;" : "+f"(a[i]));
      if (KIND == 1) asm volatile("tanh.approx.bf16x2 %0, %0;" : "+r"(u[i]));
      if (KIND == 4 || KIND == 5)
        for (int q = 0; q < 5; ++q) asm volatile("fma.rn.bf16x2 %0, %0, %0, %0;" : "+r"(u[i]));
    }
  }
  const long long t1 = clock64();
  float s = acc[0][0] + acc[1][1] + acc[2][2];
  for (int i = 0; i < 8; ++i) s += a[i] + __uint_as_float(u[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run_pipes(int kind, int blocks, int threads, int iters, float* out, long long* cyc) {
  void (*k[])(float*, int, long long*) = {pipes<0>, pipes<1>, pipes<2>, pipes<3>, pipes<4>, pipes<5>};
  k[kind]<<<blocks, threads>>>(out, iters, cyc);
  return (int)cudaDeviceSynchronize();
}
"""
H_PIPE_KINDS = ("8 tanh.approx.f32", "8 tanh.approx.bf16x2", "3 mma", "3 mma + 8 tanh",
                "40 bf16x2 fma", "40 bf16x2 fma + 8 tanh")
# Ablations of kernel H's bf16 backward (anchors of csrc/attn_scores.cu):
# the tanh a multiply, the three mma of a tile an xor into the sums, no
# slot group at all (what is left: staging, stores, the epilogue)
H_NO_TANH = ('asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x * 0.5f;")
H_NO_MMA = ("""        mma_bf16(dk_acc[j], dz, sel_k, sel_k);
        mma_bf16(dh_acc, dz, sel_t0, sel_t1);
        mma_bf16(dw_acc, zde, kOnes, kOnes);""",
            """        dk_acc[j][0] += __uint_as_float(dz[0] ^ dz[1] ^ dz[2] ^ dz[3]);
        dh_acc[0] += __uint_as_float(zde[0] ^ zde[1] ^ zde[2] ^ zde[3]);""")
H_NO_GROUPS = ("groups = min(kBwdGroups, (K - k0 + 7) >> 3);",
               "groups = 0 * min(kBwdGroups, (K - k0 + 7) >> 3);")


def probe_h(dev):
    """Part ``h``: what holds kernel H's bf16 backward. (1) The pipes of one
    quarter SM (``H_PIPES_SRC``, one block of 1024 threads an SM): cycles a
    round of each kind's instructions a warp, the median over the SMs. (2)
    The backward at (34, 128, 49, 1024) through copies of
    ``csrc/attn_scores.cu`` with parts taken out (``H_NO_*``; their results
    are wrong, only their time is read): its main kernel's device µs, three
    profiled calls each, beside the sound copy's."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
    from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH

    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "h_pipes.cu").write_text(H_PIPES_SRC)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out / "libh_pipes.so"), str(out / "h_pipes.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the pipes' probe:\n{r.stderr[-4000:]}")
    pipes = ctypes.CDLL(str(out / "libh_pipes.so"))
    pipes.run_pipes.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms, threads, iters = torch.cuda.get_device_properties(dev).multi_processor_count, 1024, 4096
    buf = torch.empty(sms * threads, device=dev)
    cyc = torch.empty(sms, dtype=torch.int64, device=dev)
    for kind, name in enumerate(H_PIPE_KINDS):
        for n in (256, iters):
            _build.check(pipes.run_pipes(kind, sms, threads, n, buf.data_ptr(), cyc.data_ptr()),
                         "run_pipes")
        per_round = 4 * float(cyc.double().median()) / (threads // 32 * iters)
        S.say("probe_h_pipes", kind=name, cycles_a_round_a_quarter_sm=round(per_round, 2))

    ops = S.h_operands(torch.Generator().manual_seed(0), dev, *S.H_SHAPES[0], torch.bfloat16)
    ik, he, w, b, de = ops
    sound = _build.load_library()
    variants = {"sound": (), "no_tanh": (H_NO_TANH,), "no_mma": (H_NO_MMA,),
                "no_tanh_no_mma": (H_NO_TANH, H_NO_MMA), "no_groups": (H_NO_GROUPS,)}
    for name, points in variants.items():
        _build._lib = traced_library("attn_scores.cu", points, f"h_{name}", trace=False)
        try:
            for _ in range(3):
                KH.attn_scores_bwd(ik, he, w, b, de, torch.bfloat16)
            reads = []
            for _ in range(3):
                _wall, events = S.profile_events(
                    lambda: KH.attn_scores_bwd(ik, he, w, b, de, torch.bfloat16))
                reads.append(sum(S.dev_us(e) for e in events if "attn_scores_bwd_bf16" in e.key))
        finally:
            _build._lib = sound
        S.say("probe_h_backward", variant=name, T_B_k_H="34,128,49,1024",
              main_kernel_device_us=[round(x, 2) for x in reads])


def probe_loop(dev, rounds: int = 3):
    """Part ``loop``: where ``loop.train``'s wall goes beyond the bare step,
    on phase 23's corpus and config (full-width LSTM, bf16, B=128, kernel
    F, 1 epoch of ``chip_smoke.TRAINER_STEPS`` steps a run): four variants
    in turns (in order, then in reverse, ``rounds`` times, after one
    unrecorded warm-up run: a process's first run is cold), the reader
    serial or one gather a batch (``train.reader_threads`` 0 or 1), rolling
    saves every 4 steps or none. Each run's images/s over the epoch (the
    ``train_wall`` record), the median host ms a step takes to queue
    (``step_times``) and the feeder's queue-wait share."""
    import tempfile

    from myimagecaptioningmodel_tpu_torch.training import loop

    variants = {"serial_saves": (0, 4), "gather_saves": (1, 4),
                "serial_nosaves": (0, False), "gather_nosaves": (1, False)}
    with tempfile.TemporaryDirectory() as root:
        base, _summary, rows = S.trainer_base(root, 0)
        del rows
        reads = {v: [] for v in variants}
        order = list(variants)

        def run(v, label):
            threads, every = variants[v]
            cfg = S.loop_cfg(base, root, label, S.NO_EXPORTS + (
                ("train.max_epoch", 1), ("train.reader_threads", threads),
                ("train.checkpoint_every_n_steps", every)))
            loop.train(cfg, device=dev, max_steps_per_epoch=S.TRAINER_STEPS)
            return cfg

        run(order[0], "warm_up")
        for r in range(rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                cfg = run(v, f"{v}_{r}")
                wall = S.read_scalars(cfg, "train_wall")[-1]
                host = S.read_scalars(cfg, "step_times")[-1]
                reads[v].append((wall["images"] / wall["seconds"], host["p50_ms"],
                                 wall["feeder_wait_s"] / wall["seconds"]))
        for v in order:
            ips = [x[0] for x in reads[v]]
            S.say("probe_loop", variant=v, reader_threads=variants[v][0],
                  checkpoint_every_n_steps=variants[v][1], steps=S.TRAINER_STEPS, B=128,
                  images_per_s=[round(x, 1) for x in ips],
                  median_images_per_s=round(float(np.median(ips)), 1),
                  step_host_ms_p50=[round(x[1], 2) for x in reads[v]],
                  feeder_wait_share=[round(x[2], 4) for x in reads[v]])


def probe_batch_caption(dev, rounds: int = 5):
    """Part ``bc``: ``batch_caption.caption_arrays`` (phase 24's device half)
    of this checkout's or ``--package-root``'s package over phase 24's
    ``BC_IMAGES`` items at batch ``BC_BATCH``, each of phase 24's modes on
    random full-width bundles: images/s of ``rounds`` warm runs (after one
    that captures the graphs), and the same batches' decode alone on rows
    already on the card (CUDA events): the rate the host half leaves. The
    records are held to the service's decode (``bc_mismatches``)."""
    import tempfile

    import myimagecaptioningmodel_tpu_torch as pkg
    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.inference.batch_caption import caption_arrays

    with tempfile.TemporaryDirectory() as root:
        cfgs = {"lstm": S.write_bundle(os.path.join(root, "lstm"), 0),
                "transformer": S.write_bundle(os.path.join(root, "transformer"), 0,
                                              (("model.decoder.arch", "transformer"),))}
        for label, family, beam, _per in S.BC_MODES:
            cfg = cfgs[family]
            items = S.bc_items(0, tuple(cfg.data.image_shape))
            model, _bcfg, _opts, decode = load_bundle(cfg, beam_size=beam, early_stop=True,
                                                      device=dev)
            index_word = DataReader(cfg).index_word
            caption_arrays(cfg, items[:S.BC_BATCH], model, decode, index_word, S.BC_BATCH)
            ips = []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                records = caption_arrays(cfg, items, model, decode, index_word, S.BC_BATCH)
                ips.append(S.BC_IMAGES / (time.perf_counter() - t0))
            batch = torch.rand(S.BC_BATCH, *cfg.data.image_shape, 3, device=dev)
            decode_ms = S.time_ms(lambda: decode(model, batch), reps=rounds, warmup=1)
            bad = S.bc_mismatches(cfg, items, model, decode, records)
            S.say("probe_bc", package=os.path.dirname(pkg.__file__), mode=label,
                  images=S.BC_IMAGES, batch=S.BC_BATCH,
                  images_per_s=[round(x, 1) for x in ips],
                  median_images_per_s=round(float(np.median(ips)), 1),
                  decode_ms_per_batch=round(decode_ms, 3),
                  decode_only_images_per_s=round(S.BC_BATCH / decode_ms * 1e3, 1),
                  mismatches=bad)
            if bad:
                raise AssertionError(f"batch captioning ({label}): mismatches {bad}")
            del model
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Probe kernels F, C, A and G on one CUDA card.")
    ap.add_argument("--trace-only", action="store_true")
    ap.add_argument("--parts", default="fc,ag",
                    help="fc: kernels F and C; ag: A and G; ab: A's and G's device times only; "
                         "enc: the fused and plain eval encoders' forward times; de: kernels "
                         "D's and E's decodes and products; b: kernel B's steps, decodes and "
                         "products; train: bf16 train steps (fuse_bn_stats off and on, bn_stat_rows, "
                         "the transformer, the LSTM's fused_attn_bwd); attn_train: the last "
                         "set alone; h: what holds kernel H's backward; loop: loop.train's wall (reader, rolling saves); "
                         "bc: batch captioning's images/s; quality_bn: phase 30's LSTM losses "
                         "through kernel I and its plain versions; kink: phase 22 (a) from "
                         "seeds 0-4, its float32 steps through kernel I and its plain versions")
    ap.add_argument("--package-root", default=None,
                    help="(parts ab, enc, de, b, bc) measure the package of this checkout "
                         "instead")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if "fc" in parts:
        if not args.trace_only:
            probe_kernels(dev)
        trace_c(dev)
    if "ag" in parts:
        if not args.trace_only:
            probe_a_g(dev)
        trace_a(dev)
        trace_g(dev)
    if "ab" in parts:
        probe_ab(dev)
    if "enc" in parts:
        probe_encoder(dev)
    if "de" in parts:
        probe_de(dev)
    if "b" in parts:
        probe_b(dev)
    if "train" in parts:
        probe_train(dev)
    elif "attn_train" in parts:
        probe_train(dev, only=("fused_attn_bwd",))
    if "h" in parts:
        probe_h(dev)
    if "loop" in parts:
        probe_loop(dev)
    if "bc" in parts:
        probe_batch_caption(dev)
    if "quality_bn" in parts:
        probe_quality_bn(dev)
    if "kink" in parts:
        probe_kink(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

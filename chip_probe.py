"""Probe kernels F and C on one CUDA card, beyond ``chip_smoke.py``'s checks:
each call's device time split by kernel, and the phases of kernel C's tile
kernel in SM cycles.

    python3 chip_probe.py [--trace-only]

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

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

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
    ('#include "vocab_block.cuh"\n', '#include "vocab_block.cuh"\n' + TRACE_HEAD),
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


def traced_source(src: str) -> str:
    """topk_head.cu with clock reads at topk_tile's phase edges and an entry
    that sets the trace buffer."""
    for anchor, replacement in TRACE_POINTS:
        if src.count(anchor) != 1:
            raise AssertionError(f"trace anchor not found once in topk_head.cu: {anchor!r}")
        src = src.replace(anchor, replacement)
    return src + ('\nextern "C" int capk_set_trace(long long* p) {\n'
                  "  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n")


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


def trace_c(dev):
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build

    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "topk_trace.cu"
    src.write_text(traced_source((_build.CSRC_DIR / "topk_head.cu").read_text()))
    lib_path = out / "libtopk_trace.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                        str(_build.CSRC_DIR), "-o", str(lib_path), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the traced copy:\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.capk_topk_head.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 12
    lib.capk_set_trace.argtypes = [ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    k, dt = 4, torch.bfloat16
    for M in (32, 512):
        proj, table, bias, _scale = S.head_operands(gen, dev, M, dt)
        V, E = table.shape
        nvt, nb = -(-V // 128), -(-V // 128) * -(-M // 128)
        trace = torch.zeros(nb * 16, dtype=torch.int64, device=dev)
        f32, i32 = torch.float32, torch.int32
        bufs = [torch.empty(n, dtype=t, device=dev) for n, t in (
            (M * nvt * k, f32), (M * nvt * k, i32), (M * nvt, f32), (M * nvt, f32),
            (M * k, f32), (M * k, i32), (M, f32))]

        def call():
            err = lib.capk_topk_head(_build.dtype_code(dt), M, V, E, k, proj.data_ptr(),
                                     table.data_ptr(), bias.data_ptr(), None,
                                     *[b.data_ptr() for b in bufs],
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"traced capk_topk_head: CUDA error {err}")

        lib.capk_set_trace(None)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        lib.capk_set_trace(trace.data_ptr())
        call()
        torch.cuda.synchronize()
        lib.capk_set_trace(None)
        t = trace.view(nb, 16).cpu().numpy()
        start, end = (t[:, 0] - t[:, 0].min()) / 1e3, (t[:, 15] - t[:, 0].min()) / 1e3
        S.say("trace_c", M=M, k=k, blocks=nb, span_us=round(float(end.max()), 2),
              block_us_p50=round(float(np.median(end - start)), 2),
              blocks_after_1us=int((start > 1.0).sum()),
              blocks_per_sm_max=int(np.bincount(t[:, 1].astype(int)).max()))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Probe kernels F and C on one CUDA card.")
    ap.add_argument("--trace-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if not args.trace_only:
        probe_kernels(dev)
    trace_c(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

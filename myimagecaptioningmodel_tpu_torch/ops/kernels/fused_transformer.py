"""Whole-decode transformer kernels: greedy (kernel D) and beam search
(kernel E).

Port of ``myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py``
(``prepare`` :149; ``fused_greedy_decode`` :1061; ``fused_beam_decode``
:1198). One call decodes all ``T`` steps: every layer
(LayerNorm, the fused ``wqkv`` product writing k/v into the KV cache,
self-attention over slots <= t, ``wo``, cross-attention over the image
memory, ``fc1`` + GELU, ``fc2``), then the tied head, the next word and its
embedding. D takes the argmax; E takes each row's top-W words and the
logsumexp, then each image's top-W of its W^2 candidates, reorders the
caches and keeps the finished/length bookkeeping. Early stop ends the decode
once every row (every beam) is done.

On CUDA tensors ``fused_greedy_decode`` and ``fused_beam_decode`` replay a
CUDA graph of the C call that enqueues every kernel of the decode
(``csrc/fused_transformer.cu``, design and bounds in its note): the first
call of a ``decode_key`` (the C call's ints, the device and the packed
weights' addresses) allocates the decode's own tensors and captures the
call; every call copies its batch's image memory into the graph's copy and
replays it on PyTorch's current stream (``decode_graphs.GRAPHS``, shared with
kernel B's LSTM decodes: at most 8 graphs and 3 GiB of their tensors, the
least recently used dropped first). Early
stop is a device-side flag, so a decode never synchronizes with the host.
A shape the kernels cannot take raises; a failed launch or capture raises
too (there is no eager or plain path for CUDA tensors). On CPU tensors they
run the plain versions
``fused_greedy_decode_reference`` and ``fused_beam_decode_reference`` on the
same packed tensors, built from ``models/transformer.py``'s own step (the
packed tensors viewed as its params), so the decode's mathematics has one
home. ``pack_weights`` packs the weights once per loaded bundle; ``prepare``
adds each batch's image memory.

Numerics: the rounding points of ``models/transformer.py`` (dense products
round operands and result to the compute dtype and add the bias there;
LayerNorm, softmax, the residual stream, attention scores and vocab logits
in float32; GELU's tanh form on the rounded product). The TPU kernel also
rounds each ``k * q`` element to bfloat16 before summing; here the sum is
float32, in the kernels and their plain versions alike.

Beam rows are slot-major: beam slot w owns rows ``[w * n_img, (w + 1) *
n_img)``, so the cross-attention memory is indexed by ``row % n_img`` and
never repeated. The outputs are the quadruple ``ops.backtrack.
beam_backtrack`` takes: words and source beams ``[T, n_img, W]``, scores and
lengths ``[n_img, W]``.

int8 serving, as the TPU kernel's ``prepare``: from a decoder whose every
layer weight is int8 (``models.transformer.quantize_transformer_decoder``)
``pack_weights`` keeps the four layer streams (``w_qkv``, ``w_o | w_xq |
w_xo``, ``w_fc1``, ``w_fc2``) int8 with their per-output-channel float32
scales, and each product is ``(x @ w_q) * scale`` in the compute dtype,
before the bias (the int8 -> compute-dtype convert is exact); ``in_proj``,
``out_proj`` and the tied table are dequantized at pack (so the head and
the embedding differ from the plain int8 path, which scales after each
product). ``prepare(quantize_kv=True)`` (greedy only) stores the
cross-attention memory as int8 with a scale per (layer, K|V, channel) over
the batch's positions: K's scale multiplies the query (float32, then
rounded), V's the float32 context.

The TPU kernel's VMEM-budget gates (``fused_dims_ok``,
``fused_beam_dims_ok``) and its pad-to-8 rows have no counterpart: the
kernels take any batch >= 1 and beam widths 1 to 8.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.models import transformer as TM
from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
from myimagecaptioningmodel_tpu_torch.ops.kernels.decode_graphs import (  # noqa: F401
    GRAPHS,
    DecodeGraphs,
)
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
    topk_stable,
    topk_vocab_head_reference,
)
from myimagecaptioningmodel_tpu_torch.ops.quantization import (
    dense_weight,
    embedding_table,
    is_quantized,
)

NEG_INF = TM.NEG_INF  # beam score floor
BEAM_MAX = 8  # csrc/fused_transformer.cu's kMaxBeam
STREAM_TILE = 64  # csrc/fused_transformer.cu's wsp::kNT: output columns of a block
HEAD_TILE = 32  # the head's narrower blocks (wsp::Cols<2>), where E is not a multiple of 64
LN_ROWS = 16  # its wsp::kLnRows: beyond, a LayerNorm product's rows are normalized first
LN_MAX_DIM = 1024  # by tf_layernorm, which takes D <= 1024


class FusedTransformerDecode(NamedTuple):
    """Decode-invariant tensors: the weights (``pack_weights``) and one
    batch's image memory (``prepare``). Dense weights ``[in, out]``
    row-major in the compute dtype, or the layer streams int8 with their
    scales; biases, norms, positions and scales float32."""

    w_qkv: torch.Tensor  # [L, D, 3D] self-attention q | k | v
    w_o: torch.Tensor  # [L, D, D]
    w_xq: torch.Tensor  # [L, D, D]
    w_xo: torch.Tensor  # [L, D, D]
    w_fc1: torch.Tensor  # [L, D, F]
    w_fc2: torch.Tensor  # [L, F, D]
    s_qkv: Optional[torch.Tensor]  # int8 streams' per-output-channel scales: [L, 3D]
    s_misc: Optional[torch.Tensor]  # [L, 3, D]: w_o, w_xq, w_xo
    s_fc1: Optional[torch.Tensor]  # [L, F]
    s_fc2: Optional[torch.Tensor]  # [L, D]
    b_qkv: torch.Tensor  # [L, 3D]: q_b | 0 (wk has no bias) | v_b
    b_misc: torch.Tensor  # [L, 4, D]: wo_b, xq_b, xo_b, fc2_b
    b_fc1: torch.Tensor  # [L, F]
    ln: torch.Tensor  # [L, 6, D]: ln1 g, b, ln2 g, b, ln3 g, b
    mem_kv: Optional[torch.Tensor]  # [L, 2, n_img, M, D] cross-attention K | V
    mem_scale: Optional[torch.Tensor]  # int8 memory's [L, 2, D] scales, else None
    table: torch.Tensor  # [V, E] tied embedding / head table
    out_bias: torch.Tensor  # [V]
    in_proj_w: torch.Tensor  # [E, D]
    in_proj_b: torch.Tensor  # [D]
    pos: torch.Tensor  # [P, D] learned positions
    lnf: torch.Tensor  # [2, D] final LayerNorm g, b
    out_proj_w: torch.Tensor  # [D, E]
    out_proj_b: torch.Tensor  # [E]

    @property
    def dims(self) -> Tuple[int, int, int, int, int, int, int]:
        """(L, D, F, M, n_img, V, E)"""
        L, D, F_ = self.w_fc1.shape
        n_img, M = self.mem_kv.shape[2:4]
        V, E = self.table.shape
        return L, D, F_, M, n_img, V, E

    @property
    def int8_stream(self) -> bool:
        return self.s_qkv is not None


def pack_weights(params, compute_dtype=torch.bfloat16) -> FusedTransformerDecode:
    """Pack the decoder params into the kernels' layout, all but the image
    memory (``mem_kv`` is None). A loaded bundle packs once and hands the
    result to ``prepare`` on every decode. If every layer weight is int8 the
    four layer streams stay int8 with their scales; other int8 leaves are
    dequantized."""
    dt = compute_dtype
    layers = params["layers"]
    int8 = all(is_quantized(p) for layer in layers
               for sub in (layer["attn"], layer["xattn"], layer["mlp"]) for p in sub.values())
    f32 = torch.float32
    dev = params["pos"].device

    def w(p):  # a layer stream's weight: int8 as stored, else in dt
        return p["w_q"] if int8 else dense_weight(p).to(dt)

    def sc(p):
        return p["scale"].float()

    def b(p, n):
        return p["b"].float() if "b" in p else torch.zeros(n, dtype=f32, device=dev)

    D = params["pos"].shape[1]
    F_ = w(layers[0]["mlp"]["fc1"]).shape[1]

    def stack(fn):
        return torch.stack([fn(layer) for layer in layers]).contiguous()

    def scales(fn):
        return stack(fn) if int8 else None

    out_proj_w = dense_weight(params["out_proj"]).to(dt).contiguous()
    return FusedTransformerDecode(
        w_qkv=stack(lambda ly: torch.cat([w(ly["attn"][k]) for k in ("wq", "wk", "wv")], 1)),
        w_o=stack(lambda ly: w(ly["attn"]["wo"])),
        w_xq=stack(lambda ly: w(ly["xattn"]["wq"])),
        w_xo=stack(lambda ly: w(ly["xattn"]["wo"])),
        w_fc1=stack(lambda ly: w(ly["mlp"]["fc1"])),
        w_fc2=stack(lambda ly: w(ly["mlp"]["fc2"])),
        s_qkv=scales(lambda ly: torch.cat([sc(ly["attn"][k]) for k in ("wq", "wk", "wv")])),
        s_misc=scales(lambda ly: torch.stack([sc(ly["attn"]["wo"]), sc(ly["xattn"]["wq"]),
                                              sc(ly["xattn"]["wo"])])),
        s_fc1=scales(lambda ly: sc(ly["mlp"]["fc1"])),
        s_fc2=scales(lambda ly: sc(ly["mlp"]["fc2"])),
        b_qkv=stack(lambda ly: torch.cat([b(ly["attn"][k], D) for k in ("wq", "wk", "wv")])),
        b_misc=stack(lambda ly: torch.stack([b(ly["attn"]["wo"], D), b(ly["xattn"]["wq"], D),
                                            b(ly["xattn"]["wo"], D), b(ly["mlp"]["fc2"], D)])),
        b_fc1=stack(lambda ly: b(ly["mlp"]["fc1"], F_)),
        ln=stack(lambda ly: torch.stack([ly[n][k].float() for n in ("ln1", "ln2", "ln3")
                                        for k in ("g", "b")])),
        mem_kv=None,
        mem_scale=None,
        table=embedding_table(params["embedding"]).to(dt).contiguous(),
        out_bias=params["out_bias"].float().contiguous(),
        in_proj_w=dense_weight(params["in_proj"]).to(dt).contiguous(),
        in_proj_b=b(params["in_proj"], D).contiguous(),
        pos=params["pos"].float().contiguous(),
        lnf=torch.stack([params["ln_f"]["g"], params["ln_f"]["b"]]).float().contiguous(),
        out_proj_w=out_proj_w,
        out_proj_b=b(params["out_proj"], out_proj_w.shape[1]).contiguous(),
    )


def prepare(params, pre, n_heads: int, compute_dtype=torch.bfloat16,
            packed=None, quantize_kv: bool = False) -> FusedTransformerDecode:
    """The decoder params and ``models.transformer.precompute``'s per-layer
    memory K/V ([B, M, heads, dh]) in the kernels' layout; ``packed``, if
    given, is ``pack_weights(params, compute_dtype)`` made earlier.
    ``quantize_kv``: the memory as int8, a symmetric absmax / 127 scale per
    (layer, K|V, channel) over the batch's (image, slot) positions."""
    packed = pack_weights(params, compute_dtype) if packed is None else packed

    def mem(x):  # [B, M, heads, dh] -> [B, M, D]
        return x.reshape(*x.shape[:2], -1).to(compute_dtype)

    mem_kv = torch.stack([torch.stack([mem(k), mem(v)])
                          for k, v in zip(pre.mem_k, pre.mem_v)]).contiguous()
    mem_scale = None
    if quantize_kv:
        m32 = mem_kv.float()
        s = torch.clamp(m32.abs().amax(dim=(2, 3), keepdim=True) / 127.0, min=1e-12)
        mem_kv = torch.clamp(torch.round(m32 / s), -127, 127).to(torch.int8).contiguous()
        mem_scale = s[:, :, 0, 0, :].contiguous()  # [L, 2, D]
    return packed._replace(mem_kv=mem_kv, mem_scale=mem_scale)


# ---- plain versions -----------------------------------------------------------


def _as_model(ftp: FusedTransformerDecode, n_heads: int, img: torch.Tensor):
    """The packed tensors seen as ``models.transformer`` params (slices, no
    copies; int8 streams as int8 leaves with their scales), its dims, and
    the memory of each row's image ``img`` (int8 with its scales) ->
    (params, dims, pre)."""
    L, D, F_, M, n_img, V, E = ftp.dims
    q = ftp.int8_stream

    def dense(w, b=None, s=None):
        p = {"w_q": w, "scale": s} if q else {"w": w}
        return p if b is None else {**p, "b": b}

    def sq(t, l, *ix):  # a stream's scale slice, None for float weights
        return t[l][ix] if q else None

    def norm(l, i):
        return {"g": ftp.ln[l, 2 * i], "b": ftp.ln[l, 2 * i + 1]}

    layers = [{
        "ln1": norm(l, 0), "ln2": norm(l, 1), "ln3": norm(l, 2),
        "attn": {"wq": dense(ftp.w_qkv[l, :, :D], ftp.b_qkv[l, :D], sq(ftp.s_qkv, l, slice(0, D))),
                 "wk": dense(ftp.w_qkv[l, :, D:2 * D], None,  # no bias, as the model
                             sq(ftp.s_qkv, l, slice(D, 2 * D))),
                 "wv": dense(ftp.w_qkv[l, :, 2 * D:], ftp.b_qkv[l, 2 * D:],
                             sq(ftp.s_qkv, l, slice(2 * D, 3 * D))),
                 "wo": dense(ftp.w_o[l], ftp.b_misc[l, 0], sq(ftp.s_misc, l, 0))},
        "xattn": {"wq": dense(ftp.w_xq[l], ftp.b_misc[l, 1], sq(ftp.s_misc, l, 1)),
                  "wo": dense(ftp.w_xo[l], ftp.b_misc[l, 2], sq(ftp.s_misc, l, 2))},
        "mlp": {"fc1": dense(ftp.w_fc1[l], ftp.b_fc1[l], sq(ftp.s_fc1, l, slice(None))),
                "fc2": dense(ftp.w_fc2[l], ftp.b_misc[l, 3], sq(ftp.s_fc2, l, slice(None)))},
    } for l in range(L)]
    params = {"embedding": {"table": ftp.table},
              "in_proj": {"w": ftp.in_proj_w, "b": ftp.in_proj_b},
              "pos": ftp.pos, "layers": layers, "ln_f": {"g": ftp.lnf[0], "b": ftp.lnf[1]},
              "out_proj": {"w": ftp.out_proj_w, "b": ftp.out_proj_b}, "out_bias": ftp.out_bias}
    dims = TM.TransformerDims(vocab_size=V, embedding_size=E, model_dim=D, num_layers=L,
                              num_heads=n_heads, mlp_ratio=F_ // D,
                              max_positions=ftp.pos.shape[0])
    pre = TM.TransformerPre(*([TM._split_heads(ftp.mem_kv[l, i][img], n_heads)
                               for l in range(L)] for i in (0, 1)),
                            kv_scale=None if ftp.mem_scale is None else list(ftp.mem_scale))
    return params, dims, pre


def fused_greedy_decode_reference(ftp: FusedTransformerDecode, max_length: int, n_heads: int,
                                  start_idx: int = 2, padding_idx: int = 0,
                                  compute_dtype=torch.bfloat16, early_stop: bool = False,
                                  stop_idx: int = 3) -> torch.Tensor:
    """Plain version of kernel D: ``models.transformer``'s KV-cached greedy
    decode on the packed tensors -> int32 ids [B, max_length]."""
    n_img = ftp.mem_kv.shape[2]
    params, dims, pre = _as_model(ftp, n_heads, torch.arange(n_img, device=ftp.table.device))
    return TM.greedy_decode_ids(params, pre, dims, max_length, start_idx, padding_idx,
                                compute_dtype, early_stop=early_stop, stop_idx=stop_idx)


def fused_beam_decode_reference(ftp: FusedTransformerDecode, max_length: int, n_heads: int,
                                beam_size: int, start_idx: int = 2, padding_idx: int = 0,
                                stop_idx: int = 3, compute_dtype=torch.bfloat16,
                                early_stop: bool = False):
    """Plain version of kernel E on slot-major rows: ``models.transformer``'s
    KV-cached step, each row's top-W words and logsumexp, each image's top-W
    of its W^2 candidates -> (words [T, n_img, W], srcs [T, n_img, W] int32,
    scores [n_img, W] float32, lengths [n_img, W] int32)."""
    dt, T, W = compute_dtype, max_length, beam_size
    n_img, dev = ftp.mem_kv.shape[2], ftp.table.device
    B = n_img * W
    rows = torch.arange(B, device=dev)
    params, dims, pre = _as_model(ftp, n_heads, rows % n_img)
    layers = TM.prepare_decode_layers(params)
    caches = TM._init_cache(dims, B, T, dt, dev)
    word = torch.full((B,), start_idx, dtype=torch.long, device=dev)
    scores = torch.where(rows < n_img, 0.0, NEG_INF)
    fin = torch.zeros((B,), dtype=torch.bool, device=dev)
    lens = torch.zeros((B,), dtype=torch.int32, device=dev)
    words = torch.full((T, B), padding_idx, dtype=torch.int32, device=dev)
    srcs = (rows // n_img).to(torch.int32).expand(T, B).clone()  # identity back-pointers
    pad_row = torch.full((W,), NEG_INF, device=dev)
    pad_row[0] = 0.0

    def per_image(a):  # [B, W] slot-major -> [n_img, W (source slot) * W (k)]
        return a.reshape(W, n_img, W).permute(1, 0, 2).reshape(n_img, W * W)

    for t in range(T):
        if early_stop and bool(fin.all()):
            break
        x = TM._decode_step(params, pre, dims, word, caches, t, padding_idx, dt, layers)
        vals, ids, lse = topk_vocab_head_reference(TM.head_proj(params, x, dt), ftp.table,
                                                   ftp.out_bias, W)
        logp = torch.where(fin[:, None], pad_row, vals - lse[:, None])
        cid = torch.where(fin[:, None], padding_idx, ids)
        top, flat = topk_stable(per_image(scores[:, None] + logp), W)  # ties: lowest w * W + k
        src = flat // W  # [n_img, W]
        src_rows = (src * n_img + torch.arange(n_img, device=dev)[:, None]).T.reshape(-1)
        new_word = per_image(cid).gather(1, flat).T.reshape(-1)
        prev_fin = fin[src_rows]
        fin = prev_fin | (new_word == stop_idx)
        lens = lens[src_rows] + (~prev_fin).to(torch.int32)
        scores = top.T.reshape(-1)
        caches = [(ck[src_rows], cv[src_rows]) for ck, cv in caches]
        words[t], srcs[t] = new_word, src.T.reshape(-1).to(torch.int32)
        word = new_word.long()

    def per_image_tm(a):  # [T, B] slot-major -> [T, n_img, W]
        return a.reshape(T, W, n_img).permute(0, 2, 1)

    return (per_image_tm(words), per_image_tm(srcs), scores.reshape(W, n_img).T,
            lens.reshape(W, n_img).T)


# ---- kernels --------------------------------------------------------------------


def _check(ftp: FusedTransformerDecode, max_length: int, n_heads: int, dt, rows: int):
    """Validate the packed operands on CUDA -> (L, D, F, M, n_img, V, E, P)."""
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels D and E compute in float32 or bfloat16, got {dt}")
    L, D, F_, M, n_img, V, E = ftp.dims
    P = ftp.pos.shape[0]
    dev, f32 = ftp.table.device, torch.float32
    wt = torch.int8 if ftp.int8_stream else dt
    mt = dt if ftp.mem_scale is None else torch.int8
    operands = [
        ("w_qkv", (L, D, 3 * D), wt), ("w_o", (L, D, D), wt), ("w_xq", (L, D, D), wt),
        ("w_xo", (L, D, D), wt), ("w_fc1", (L, D, F_), wt), ("w_fc2", (L, F_, D), wt),
        ("b_qkv", (L, 3 * D), f32), ("b_misc", (L, 4, D), f32), ("b_fc1", (L, F_), f32),
        ("ln", (L, 6, D), f32), ("mem_kv", (L, 2, n_img, M, D), mt), ("table", (V, E), dt),
        ("out_bias", (V,), f32), ("in_proj_w", (E, D), dt), ("in_proj_b", (D,), f32),
        ("pos", (P, D), f32), ("lnf", (2, D), f32), ("out_proj_w", (D, E), dt),
        ("out_proj_b", (E,), f32),
    ]
    if ftp.int8_stream:
        operands += [("s_qkv", (L, 3 * D), f32), ("s_misc", (L, 3, D), f32),
                     ("s_fc1", (L, F_), f32), ("s_fc2", (L, D), f32)]
    if ftp.mem_scale is not None:
        operands.append(("mem_scale", (L, 2, D), f32))
    for name, shape, dtype in operands:
        _build.require(getattr(ftp, name), name, dev, dtype, shape)
    if D % 8 or E % 8 or F_ % 8 or D % n_heads:
        raise ValueError(f"kernels D and E take D, E, F in multiples of 8 and D a multiple "
                         f"of heads, got D={D}, E={E}, F={F_}, heads={n_heads}")
    # E not a multiple of STREAM_TILE: the head's 32-column blocks read rows
    # tf_layernorm normalized, at any row count
    ln_rows = rows > LN_ROWS or E % STREAM_TILE
    if dt == torch.bfloat16 and (D % STREAM_TILE or E % HEAD_TILE or F_ % STREAM_TILE or
                                 (ln_rows and D > LN_MAX_DIM)):
        raise ValueError(f"the bfloat16 products take D and F in multiples of {STREAM_TILE}, E "
                         f"in multiples of {HEAD_TILE} (and D <= {LN_MAX_DIM} beyond "
                         f"{LN_ROWS} rows or at E not a multiple of {STREAM_TILE}), got D={D}, "
                         f"E={E}, F={F_}, rows={rows}")
    if not 1 <= max_length <= P:
        raise ValueError(f"max_length {max_length} outside 1..{P} (learned positions)")
    if rows < 1 or M < 1:
        raise ValueError(f"no rows ({rows}) or memory slots ({M}) to decode")
    return L, D, F_, M, n_img, V, E, P


# pointer order of csrc/fused_transformer.cu's TfPtrs (the scales null for
# float weights and memory)
_PTR_FIELDS = ("w_qkv", "w_o", "w_xq", "w_xo", "w_fc1", "w_fc2", "b_qkv", "b_misc",
               "b_fc1", "ln", "mem_kv", "table", "out_bias", "in_proj_w", "in_proj_b",
               "pos", "lnf", "out_proj_w", "out_proj_b", "s_qkv", "s_misc", "s_fc1", "s_fc2",
               "mem_scale")
_WORK_FIELDS = ("x", "q", "ctx", "hmid", "proj", "word", "kc0", "vc0", "kc1", "vc1",
                "part_v", "part_i", "part_m", "part_s", "vals", "ids_k", "lse", "done",
                "flag", "scores", "lens", "src_rows", "words_tm", "srcs_tm", "stats", "xn")
# the batch's inputs: copied into the graph's own tensors before each replay
_INPUT_FIELDS = ("mem_kv", "mem_scale")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(entry: str, ftp, work: dict, ints, dev) -> int:
    """One C call that enqueues a decode on the current stream, reading the
    batch's inputs from ``work``'s copies -> the number of kernels it
    enqueued."""
    lib = _build.load_library()
    ptrs = [_ptr(work.get(f) if f in _INPUT_FIELDS else getattr(ftp, f)) for f in _PTR_FIELDS]
    ptrs += [_ptr(work.get(f)) for f in _WORK_FIELDS]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    n = ctypes.c_int(0)
    _build.check(getattr(lib, entry)(c_ints, c_ptrs, _build.stream_ptr(dev), ctypes.byref(n)),
                 entry)
    return n.value


def _work(ftp, rows, T, k, dt, beam: bool):
    """A decode's own tensors on ``rows`` rows: scratch, caches, state, the
    outputs and the copies of the batch's inputs (the CUDA graph's static
    tensors), allocated before the capture."""
    L, D, F_, M, n_img, V, E = ftp.dims
    dev, f32, i32 = ftp.table.device, torch.float32, torch.int32
    lib = _build.load_library()

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    work = dict(
        x=empty(rows, D, dtype=f32), q=empty(rows, D), ctx=empty(rows, D), hmid=empty(rows, F_),
        proj=empty(rows, E, dtype=f32), word=empty(rows, dtype=i32),
        kc0=empty(L, rows, T, D), vc0=empty(L, rows, T, D),
        done=empty(rows, dtype=i32), flag=empty(1, dtype=i32), words_tm=empty(T, rows, dtype=i32),
        stats=empty(D // STREAM_TILE, rows, 2, dtype=f32),  # x's row statistics, bf16 only
        xn=empty(rows, D),  # LayerNorm rows, bf16 beyond LN_ROWS rows
        mem_kv=torch.empty_like(ftp.mem_kv),
        mem_scale=None if ftp.mem_scale is None else torch.empty_like(ftp.mem_scale),
    )
    if beam:  # kernel C's partial buffers: ceil(V / its vocab tile) tiles a row
        nvt = -(-V // lib.capk_topk_head_vocab_tile())
        b_rows = torch.arange(rows, device=dev)
        work.update(kc1=empty(L, rows, T, D), vc1=empty(L, rows, T, D),
                    part_v=empty(rows, nvt, k, dtype=f32), part_i=empty(rows, nvt, k, dtype=i32),
                    part_m=empty(rows, nvt, dtype=f32), part_s=empty(rows, nvt, dtype=f32),
                    vals=empty(rows, k, dtype=f32), ids_k=empty(rows, k, dtype=i32),
                    lse=empty(rows, dtype=f32), lens=empty(rows, dtype=i32),
                    src_rows=empty(rows, dtype=i32), scores=empty(rows, dtype=f32),
                    srcs_tm=empty(T, rows, dtype=i32),
                    scores0=torch.where(b_rows < n_img, 0.0, NEG_INF).float(),
                    srcs0=(b_rows // n_img).to(i32).expand(T, rows).contiguous())
    else:  # kernel A's
        nblk = lib.capk_vocab_argmax_nblocks(V)
        work.update(part_v=empty(rows, nblk, dtype=f32), part_i=empty(rows, nblk, dtype=i32))
    return work


def _reset(work: dict, start_idx: int, padding_idx: int) -> None:
    """A decode's start state (captured in the graph, before the kernels)."""
    work["word"].fill_(start_idx)
    work["words_tm"].fill_(padding_idx)
    work["done"].zero_()
    work["flag"].zero_()
    if "scores0" in work:
        work["scores"].copy_(work["scores0"])
        work["srcs_tm"].copy_(work["srcs0"])
        work["lens"].zero_()


def decode_key(entry: str, ftp: FusedTransformerDecode, ints) -> tuple:
    """What fixes a captured decode: the entry, every int the C call takes
    (dtype, dims, rows, beam, steps, heads, the start / pad / stop ids, early
    stop, the int8 modes), the device, and the packed weights' addresses (a
    bundle packs once; the graph reads them where they lie). The batch's
    memory is not in it: each replay copies it in."""
    weights = tuple((f, _ptr(getattr(ftp, f))) for f in _PTR_FIELDS if f not in _INPUT_FIELDS)
    return (entry, str(ftp.table.device), tuple(int(i) for i in ints), weights)




def _run(entry: str, fn, ftp, ints, rows, T, k, dt, beam, start_idx, padding_idx, outputs):
    """One decode through the graph cache; sets ``fn``'s counters."""
    dev = ftp.table.device
    out, cap, captured = GRAPHS.run(
        decode_key(entry, ftp, ints),
        lambda: _work(ftp, rows, T, k, dt, beam),
        lambda work: (_reset(work, start_idx, padding_idx),
                      _launch(entry, ftp, work, ints, dev))[1],
        {f: getattr(ftp, f) for f in _INPUT_FIELDS}, outputs, dev)
    fn.kernel_launches = cap.kernel_launches
    fn.capture_ms = cap.capture_ms if captured else None
    fn.launches += 1
    return out


def fused_greedy_decode(ftp: FusedTransformerDecode, max_length: int, n_heads: int,
                        start_idx: int = 2, padding_idx: int = 0,
                        compute_dtype=torch.bfloat16, early_stop: bool = False,
                        stop_idx: int = 3) -> torch.Tensor:
    """Whole greedy decode -> int32 ids [B, max_length] (B = the memory's
    image count). Launches kernel D for CUDA tensors, through a CUDA graph
    captured once per ``decode_key``."""
    dev = ftp.table.device
    if dev.type == "cpu":
        return fused_greedy_decode_reference(ftp, max_length, n_heads, start_idx, padding_idx,
                                             compute_dtype, early_stop, stop_idx)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dt, T = compute_dtype, max_length
    L, D, F_, M, B, V, E, P = _check(ftp, T, n_heads, dt, ftp.mem_kv.shape[2])
    ints = [_build.dtype_code(dt), L, D, F_, M, B, 0, V, E, T, n_heads, start_idx,
            padding_idx, stop_idx, int(early_stop), int(ftp.int8_stream),
            int(ftp.mem_scale is not None)]
    return _run("capk_fused_greedy_decode", fused_greedy_decode, ftp, ints, B, T, 1, dt, False,
                start_idx, padding_idx, lambda work: work["words_tm"].T.contiguous())


fused_greedy_decode.launches = 0
fused_greedy_decode.kernel_launches = 0  # kernels a decode of the last call's key runs
fused_greedy_decode.capture_ms = None  # ms the last call spent capturing, None if it replayed


def fused_beam_decode(ftp: FusedTransformerDecode, max_length: int, n_heads: int,
                      beam_size: int, start_idx: int = 2, padding_idx: int = 0,
                      stop_idx: int = 3, compute_dtype=torch.bfloat16,
                      early_stop: bool = False):
    """Whole beam search -> (words [T, n_img, W], srcs [T, n_img, W] int32,
    scores [n_img, W] float32, lengths [n_img, W] int32) for
    ``ops.backtrack.beam_backtrack``. Launches kernel E for CUDA
    tensors, through a CUDA graph captured once per ``decode_key``.
    ``1 <= beam_size <= 8`` and float memory on every device."""
    W = beam_size
    if not 1 <= W <= min(BEAM_MAX, ftp.table.shape[0]):
        raise ValueError(f"kernel E takes beam sizes 1 to {BEAM_MAX}, got {W}")
    if ftp.mem_scale is not None:
        raise ValueError("int8 cross-attention memory (quantize_kv) covers greedy decode only")
    dev = ftp.table.device
    if dev.type == "cpu":
        return fused_beam_decode_reference(ftp, max_length, n_heads, W, start_idx, padding_idx,
                                           stop_idx, compute_dtype, early_stop)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dt, T = compute_dtype, max_length
    n_img = ftp.mem_kv.shape[2]
    B = n_img * W
    L, D, F_, M, n_img, V, E, P = _check(ftp, T, n_heads, dt, B)
    ints = [_build.dtype_code(dt), L, D, F_, M, n_img, W, V, E, T, n_heads, start_idx,
            padding_idx, stop_idx, int(early_stop), int(ftp.int8_stream), 0]

    def outputs(work):  # copies: the next replay rewrites the graph's tensors
        def per_image_tm(a):
            return a.reshape(T, W, n_img).permute(0, 2, 1).clone()

        return (per_image_tm(work["words_tm"]), per_image_tm(work["srcs_tm"]),
                work["scores"].reshape(W, n_img).T.clone(),
                work["lens"].reshape(W, n_img).T.clone())

    return _run("capk_fused_beam_decode", fused_beam_decode, ftp, ints, B, T, W, dt, True,
                start_idx, padding_idx, outputs)


fused_beam_decode.launches = 0
fused_beam_decode.kernel_launches = 0  # kernels a decode of the last call's key runs
fused_beam_decode.capture_ms = None  # ms the last call spent capturing, None if it replayed


# ---- one weight-streaming product on its own ------------------------------------

A_MODES = {"rows": 0, "layernorm": 1, "gather": 2}
E_MODES = {"store": 0, "store_f32": 1, "residual": 2, "qkv": 3, "gelu": 4, "embed": 5}


def stream_splits(rows: int, N: int, K: int) -> int:
    """K splits of the bf16 product of ``rows`` rows and a [K, N] weight:
    split s takes the 32-row chunks [s c / S, (s + 1) c / S), c = K / 32."""
    return _build.load_library().capk_stream_product_splits(rows, N, K)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bfloat16 (nearest even), as float32."""
    return t.to(torch.bfloat16).float()


def stream_product_reference(a, w, bias, mode="store", a_mode="rows", w_scale=None, ln_g=None,
                             ln_b=None, word=None, pad=0, out=None, kc=None, vc=None, t=0,
                             pos=None):
    """Plain version of the decode's bf16 product (``stream_product``): the
    rounded operands multiplied by one float32 ``torch.mm``, then the
    epilogue's roundings (the product, the int8 scale, the bias) and its
    mode. Writes and returns ``out`` as ``stream_product`` does."""
    if a_mode == "layernorm":
        A = TM._layer_norm({"g": ln_g, "b": ln_b}, a.float())
    elif a_mode == "gather":
        A = torch.where((word == pad)[:, None], 0.0, a[word.long()].float())
    else:
        A = a.float()
    y = _bf(torch.mm(_bf(A), w.float()))
    if w_scale is not None:
        y = _bf(y * _bf(w_scale))
    y = _bf(y + _bf(bias))
    M, N = y.shape
    out = _product_out(mode, M, N, out, a.device)
    if mode == "residual":
        out += y
    elif mode == "embed":
        out.copy_(y + pos)
    elif mode == "gelu":
        out.copy_(torch.nn.functional.gelu(y, approximate="tanh"))
    elif mode == "qkv":
        D = N // 3
        out.copy_(y[:, :D])
        kc[:, t] = y[:, D:2 * D].to(kc.dtype)
        vc[:, t] = y[:, 2 * D:].to(vc.dtype)
    else:
        out.copy_(y)
    return out


def _product_out(mode, M, N, out, dev):
    if out is not None:
        return out
    if mode in ("residual", "qkv"):
        raise ValueError(f"mode {mode!r} writes into a given out")
    dtype = torch.float32 if mode in ("store_f32", "embed") else torch.bfloat16
    return torch.empty((M, N), dtype=dtype, device=dev)


def stream_product(a, w, bias, mode="store", a_mode="rows", w_scale=None, ln_g=None, ln_b=None,
                   word=None, pad=0, out=None, kc=None, vc=None, t=0, pos=None, *,
                   pdl: bool = False):
    """One product of kernels D and E as a bf16 decode runs it, on its own:
    ``a`` [M, K] bf16 rows, float32 x under a LayerNorm (``ln_g``, ``ln_b``),
    or a bf16 table [V, K] gathered by ``word`` [M] (``pad`` gathers zeros);
    ``w`` [K, N] bf16, or int8 with ``w_scale`` [N]; ``bias`` [N] float32;
    ``mode`` one of ``E_MODES``: "store" / "gelu" (bf16 out), "store_f32",
    "residual" (out, float32 x, += y), "embed" (out = y + pos), "qkv" (q into
    out [M, N / 3], k and v into kc / vc [M, steps, N / 3] at position t).
    ``pdl``: launched with programmatic dependent launch, as a decode of
    up to 16 rows launches it, so that calls in a row overlap (the next
    one's weights stream in under this one). -> out. CPU tensors take
    ``stream_product_reference``."""
    if a.device.type == "cpu":
        return stream_product_reference(a, w, bias, mode, a_mode, w_scale, ln_g, ln_b, word,
                                        pad, out, kc, vc, t, pos)
    dev = a.device
    K, N = w.shape
    M = word.shape[0] if a_mode == "gather" else a.shape[0]
    if mode not in E_MODES or a_mode not in A_MODES:
        raise ValueError(f"unknown mode {mode!r} / a_mode {a_mode!r}")
    out = _product_out(mode, M, N, out, dev)
    lib = _build.load_library()
    stats = xn = None  # x's row statistics: read under a LayerNorm, written by residual and embed
    if a_mode == "layernorm" or mode in ("residual", "embed"):
        stats = torch.empty(max(K, N) // STREAM_TILE, M, 2, dtype=torch.float32, device=dev)
    if a_mode == "layernorm" and M > LN_ROWS:
        xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
    stream = _build.stream_ptr(dev)
    if a_mode == "layernorm" and M <= LN_ROWS:  # as the decode's x-writing products leave them
        _build.check(lib.capk_tile_stats(a.data_ptr(), M, K, stats.data_ptr(), stream),
                     "capk_tile_stats")
    ints = [M, N, K, A_MODES[a_mode], E_MODES[mode], int(w_scale is not None), pad, t,
            0 if kc is None else kc.shape[1], int(pdl)]
    ptrs = [_ptr(x) for x in (a, ln_g, ln_b, word, w, w_scale, bias, out, kc, vc, pos, stats,
                              xn)]
    _build.check(lib.capk_stream_product((ctypes.c_int * len(ints))(*ints),
                                         (ctypes.c_void_p * len(ptrs))(*ptrs), stream),
                 "capk_stream_product")
    stream_product.launches += 1
    return out


stream_product.launches = 0

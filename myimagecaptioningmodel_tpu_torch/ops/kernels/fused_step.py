"""Fused adaptive-attention decode step (kernel B), and the LSTM greedy
decode built from it.

Port of ``myimagecaptioningmodel_tpu/ops/pallas/fused_step.py``. One greedy
decode step (formula in that module's docstring):

    gates    = [word_emb ; h_prev] @ [W_word_cat ; W_hh_cat] + gxb
    c', h'   = LSTM cell;  sentinel = sigmoid(gates[4H:]) * tanh(c')
    p_hid    = tanh(h' @ Wp + bp);  hid_emb = p_hid @ Whe + bhe
    sent_key = sentinel @ Wse + bse
    ctx      = softmax-attention over [img_k ; sent_key] + hid_emb
    out      = tanh((ctx + p_hid) @ Wout + bout);  proj = out @ Wproj + bproj
    word'    = argmax(proj @ head_table^T + head_bias)      (with_head)

Two layouts of the weights. ``prepare`` gives the JAX package's
(``FusedStepParams``, with one batch's ``gxb``); ``pack_weights`` the
kernels' (``PackedStep``), once per loaded bundle: the gate matrix
``[W_word_cat ; W_hh_cat]`` as one ``[E + H, 5H]`` weight whose five gate
columns of each hidden unit are interleaved (``interleave_gates``: 16 units
a group, so that one product block holds whole units), ``hid_emb`` and
``sent_emb`` stacked, int8 params dequantized in float32 and then cast, as
``prepare`` does; ``with_batch`` adds a batch's ``gxb``.

On CUDA tensors ``fused_decode_step`` launches the hand-written kernels of
``csrc/fused_step.cu`` from one C call (the gate product with the LSTM cell
in its epilogue, the products with float32 epilogues, the attention; design
and bounds in that file's note) and, for the head, kernel A of
``vocab_head``; it takes either layout (``FusedStepParams`` is packed on
the call). ``lstm_greedy_decode`` runs a whole greedy decode, the step's
kernels, kernel A and the step tail for every step, as one CUDA graph per
``step_key`` (``decode_graphs.GRAPHS``, shared with kernels D and E): its
first call captures the decode's C call, every call copies the batch's
``gxb`` and image memory into the graph's tensors and replays it. Early
stop is a device flag: a decode never synchronizes with the host. On CPU
tensors both run the plain versions (``reference_step``,
``lstm_greedy_decode_reference``).

Numerics follow the TPU kernel: every product rounds its operands to the
compute dtype and accumulates and returns float32 with a float32 bias;
attention runs in float32.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
from myimagecaptioningmodel_tpu_torch.ops.kernels.decode_graphs import GRAPHS
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
    greedy_vocab_argmax,
    greedy_vocab_argmax_reference,
)
from myimagecaptioningmodel_tpu_torch.ops.quantization import (
    dense_in_dim,
    dense_weight,
    embedding_table,
)

GATE_UNITS = 16  # hidden units of a gate-product block (csrc's gate_col)
ATTN_SLICES = 8  # blocks of a row's attention cluster (csrc's kSlices)
DIM_MULTIPLE = 64  # the kernels take H and E in multiples of it


class FusedStepParams(NamedTuple):
    """Decode-invariant tensors in the JAX package's layout, prepared per
    decode call."""

    emb_table: torch.Tensor  # [V, E] gather table, padding row zeroed
    w_word_cat: torch.Tensor  # [E, 5H] = [W_lstm[:E] ; W_gate_x[:E]]
    w_hh_cat: torch.Tensor  # [H, 5H] = [W_lstm[E+H:] ; W_gate_h]
    gxb: torch.Tensor  # [B, 5H] f32: global-feat gate parts + all gate biases
    w_p: torch.Tensor  # [H, H]
    b_p: torch.Tensor  # [H]
    w_he: torch.Tensor  # [H, H]
    b_he: torch.Tensor  # [H]
    w_se: torch.Tensor  # [H, H]
    b_se: torch.Tensor  # [H]
    w_out: torch.Tensor  # [H, H]
    b_out: torch.Tensor  # [H]
    w_proj: torch.Tensor  # [H, E]
    b_proj: torch.Tensor  # [E]
    w_score: torch.Tensor  # [1, H] attention score row
    b_score: torch.Tensor  # [1] f32
    head_table: torch.Tensor  # [V, E] tied vocab table (compute dtype)
    head_bias: torch.Tensor  # [V] f32


class PackedStep(NamedTuple):
    """The kernels' layout (``pack_weights``): weights in the compute dtype,
    biases float32, and one batch's ``gxb`` (None until ``with_batch``)."""

    w_gate: torch.Tensor  # [E + H, 5H] [W_word_cat ; W_hh_cat], gates interleaved
    w_p: torch.Tensor  # [H, H]
    b_p: torch.Tensor  # [H]
    w_hs: torch.Tensor  # [2, H, H]: hid_emb, sent_emb
    b_hs: torch.Tensor  # [2, H]
    w_out: torch.Tensor  # [H, H]
    b_out: torch.Tensor  # [H]
    w_proj: torch.Tensor  # [H, E]
    b_proj: torch.Tensor  # [E]
    w_score: torch.Tensor  # [1, H]
    b_score: torch.Tensor  # [1]
    table: torch.Tensor  # [V, E] the word rows' table (padding row read as zeros) and the head's
    head_bias: torch.Tensor  # [V]
    gxb: Optional[torch.Tensor]  # [B, 5H] f32, the batch's

    @property
    def dims(self) -> Tuple[int, int, int]:
        """(H, E, V)"""
        return self.w_p.shape[0], self.w_proj.shape[1], self.table.shape[0]


def interleave_gates(w: torch.Tensor) -> torch.Tensor:
    """``[K, 5H]`` gate columns (gate q of unit j at ``q H + j``) -> the
    kernels' order: unit group ``j // 16``, then the gate, then ``j % 16``."""
    K, n5 = w.shape
    return w.reshape(K, 5, n5 // (5 * GATE_UNITS), GATE_UNITS).permute(0, 2, 1, 3).reshape(K, n5)


def deinterleave_gates(w: torch.Tensor) -> torch.Tensor:
    """The inverse of ``interleave_gates``."""
    K, n5 = w.shape
    return w.reshape(K, n5 // (5 * GATE_UNITS), 5, GATE_UNITS).permute(0, 2, 1, 3).reshape(K, n5)


def _gate_weights(params: Dict[str, Any], dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (W_word_cat [E, 5H], W_hh_cat [H, 5H]) in ``dt``, int8 dequantized
    in float32 first."""
    lw = dense_weight(params["lstm"])
    gw = dense_weight(params["gate_x"])
    E = dense_weight(params["out_proj"]).shape[1]
    H = dense_in_dim(params["p_hid"])
    w_word_cat = torch.cat([lw[:E], gw[:E]], dim=1).to(dt).contiguous()
    w_hh_cat = torch.cat(
        [lw[E + H:], dense_weight(params["gate_h"]).to(lw.dtype)], dim=1
    ).to(dt).contiguous()
    return w_word_cat, w_hh_cat


def gate_inputs(params: Dict[str, Any], pre) -> torch.Tensor:
    """gxb [B, 5H] float32: the global-feature parts of the gates and all
    three gate biases."""
    return torch.cat(
        [
            pre.lstm_gx + params["lstm"]["b"],
            pre.gate_gx + params["gate_x"]["b"] + params["gate_h"]["b"],
        ],
        dim=1,
    ).float().contiguous()


def _w(params, name, dt):
    return dense_weight(params[name]).to(dt).contiguous()


def _b(params, name):
    return params[name]["b"].float().contiguous()


def prepare(params: Dict[str, Any], pre, padding_idx: int, dt) -> FusedStepParams:
    """The decoder params and one batch's ``gxb`` in the JAX package's
    layout. int8 params (``ops/quantization.py``) are dequantized here once,
    in float32, then cast to ``dt``; the kernels themselves take only float
    tables."""
    table = embedding_table(params["embedding"])
    emb_table = table.clone()
    emb_table[padding_idx] = 0.0  # embed(padding_idx) == 0
    w_word_cat, w_hh_cat = _gate_weights(params, dt)
    return FusedStepParams(
        emb_table=emb_table, w_word_cat=w_word_cat, w_hh_cat=w_hh_cat,
        gxb=gate_inputs(params, pre),
        w_p=_w(params, "p_hid", dt), b_p=_b(params, "p_hid"),
        w_he=_w(params, "hid_emb", dt), b_he=_b(params, "hid_emb"),
        w_se=_w(params, "sent_emb", dt), b_se=_b(params, "sent_emb"),
        w_out=_w(params, "out", dt), b_out=_b(params, "out"),
        w_proj=_w(params, "out_proj", dt), b_proj=_b(params, "out_proj"),
        w_score=params["attention"]["score"]["w"].T.to(dt).contiguous(),
        b_score=params["attention"]["score"]["b"].float().contiguous(),
        head_table=table.to(dt).contiguous(),
        head_bias=params["out_bias"].float().contiguous(),
    )


def pack_weights(params: Dict[str, Any], compute_dtype=torch.bfloat16) -> PackedStep:
    """The decoder params in the kernels' layout, without a batch (``gxb``
    None): packed once per loaded bundle, with ``prepare``'s numerics."""
    dt = compute_dtype
    w_word_cat, w_hh_cat = _gate_weights(params, dt)
    return PackedStep(
        w_gate=interleave_gates(torch.cat([w_word_cat, w_hh_cat])).contiguous(),
        w_p=_w(params, "p_hid", dt), b_p=_b(params, "p_hid"),
        w_hs=torch.stack([_w(params, "hid_emb", dt), _w(params, "sent_emb", dt)]),
        b_hs=torch.stack([_b(params, "hid_emb"), _b(params, "sent_emb")]),
        w_out=_w(params, "out", dt), b_out=_b(params, "out"),
        w_proj=_w(params, "out_proj", dt), b_proj=_b(params, "out_proj"),
        w_score=params["attention"]["score"]["w"].T.to(dt).contiguous(),
        b_score=params["attention"]["score"]["b"].float().contiguous(),
        table=embedding_table(params["embedding"]).to(dt).contiguous(),
        head_bias=params["out_bias"].float().contiguous(),
        gxb=None,
    )


def packed_for(params: Dict[str, Any], compute_dtype, packed: Optional[PackedStep] = None
               ) -> PackedStep:
    """``packed`` if it was packed for ``compute_dtype``, else the params
    packed now (a bundle packs once, for its own compute dtype)."""
    if packed is not None and packed.w_p.dtype == compute_dtype:
        return packed
    return pack_weights(params, compute_dtype)


def with_batch(pk: PackedStep, params: Dict[str, Any], pre) -> PackedStep:
    """``pack_weights``' tensors with one batch's ``gxb``."""
    return pk._replace(gxb=gate_inputs(params, pre))


def pack_step(fp: FusedStepParams) -> PackedStep:
    """``prepare``'s tensors in the kernels' layout."""
    return PackedStep(
        w_gate=interleave_gates(torch.cat([fp.w_word_cat, fp.w_hh_cat])).contiguous(),
        w_p=fp.w_p, b_p=fp.b_p, w_hs=torch.stack([fp.w_he, fp.w_se]),
        b_hs=torch.stack([fp.b_he, fp.b_se]), w_out=fp.w_out, b_out=fp.b_out,
        w_proj=fp.w_proj, b_proj=fp.b_proj, w_score=fp.w_score, b_score=fp.b_score,
        table=fp.head_table, head_bias=fp.head_bias, gxb=fp.gxb,
    )


def unpack(pk: PackedStep, padding_idx: int = 0) -> FusedStepParams:
    """The packed tensors in the JAX package's layout (the gate columns
    de-interleaved; the gather table in float32 with its padding row
    zeroed), as the plain step reads them."""
    E = pk.w_proj.shape[1]
    w_gate = deinterleave_gates(pk.w_gate)
    emb_table = pk.table.float().clone()
    emb_table[padding_idx] = 0.0
    return FusedStepParams(
        emb_table=emb_table, w_word_cat=w_gate[:E], w_hh_cat=w_gate[E:], gxb=pk.gxb,
        w_p=pk.w_p, b_p=pk.b_p, w_he=pk.w_hs[0], b_he=pk.b_hs[0], w_se=pk.w_hs[1],
        b_se=pk.b_hs[1], w_out=pk.w_out, b_out=pk.b_out, w_proj=pk.w_proj, b_proj=pk.b_proj,
        w_score=pk.w_score, b_score=pk.b_score, head_table=pk.table, head_bias=pk.head_bias,
    )


Step = Union[FusedStepParams, PackedStep]


def gather_words(table: torch.Tensor, word: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """The word rows the gate product's prologue gathers: ``table[word]``,
    the padding id's row zeros."""
    rows = table[word.long()]
    return torch.where((word == padding_idx)[:, None], torch.zeros_like(rows), rows)


# ---- plain versions -----------------------------------------------------------


def _dot(a, b, dt):
    """a.astype(dt) @ b with float32 accumulation and a float32 result."""
    return torch.matmul(a.to(dt).float(), b.float())


def _per_row(img: torch.Tensor, rows: int) -> torch.Tensor:
    """The image memory of ``n_img`` images for ``rows`` rows, row r reading
    image ``r // (rows // n_img)`` (beam rows share their image's)."""
    return img if img.shape[0] == rows else img.repeat_interleave(rows // img.shape[0], dim=0)


def attention_slices(hid_emb, sent_key, sentinel, p_hid, img_k, img_v, w_score, b_score,
                     slices: int = ATTN_SLICES):
    """Plain version of the kernels' attention: each of ``slices`` column
    slices of H takes its partial scores of the image slots and the
    sentinel, the partials are summed in slice order, then the float32
    softmax -> ctx + p_hid [B, H]."""
    H = hid_emb.shape[-1]
    ws32 = w_score.float().reshape(H)
    z_img = torch.tanh(img_k.float() + hid_emb[:, None, :]) * ws32  # [B, k, H]
    z_sent = torch.tanh(sent_key + hid_emb) * ws32  # [B, H]
    z = torch.cat([z_img, z_sent[:, None, :]], dim=1)  # [B, k + 1, H]
    parts = z.reshape(*z.shape[:2], slices, H // slices).sum(-1)  # [B, k + 1, slices]
    e = parts[..., 0]
    for q in range(1, slices):
        e = e + parts[..., q]
    e = e + b_score
    a = torch.exp(e - e.max(dim=-1, keepdim=True).values)
    ctx = ((a[:, :-1, None] * img_v.float()).sum(1) + a[:, -1:] * sentinel) / a.sum(-1, keepdim=True)
    return ctx + p_hid


def _attention(w_score, b_score, hid_emb, sent_key, sentinel, imgk, imgv):
    """The adaptive attention over the image slots and the sentinel, in
    float32 -> ctx [B, H]."""
    ws32 = w_score.float()  # [1, H]
    z_img = torch.tanh(imgk.float() + hid_emb[:, None, :])  # [B, k, H]
    e_img = (z_img * ws32[None]).sum(-1) + b_score  # [B, k]
    z_sent = torch.tanh(sent_key + hid_emb)
    e_sent = (z_sent * ws32).sum(-1, keepdim=True) + b_score  # [B, 1]
    m = torch.maximum(e_img.max(dim=-1, keepdim=True).values, e_sent)
    a_img = torch.exp(e_img - m)
    a_sent = torch.exp(e_sent - m)
    denom = a_img.sum(-1, keepdim=True) + a_sent
    return ((a_img[:, :, None] * imgv.float()).sum(1) + a_sent * sentinel) / denom


def _step_math(fp: FusedStepParams, word_emb, h, c, imgk, imgv, dt):
    H = h.shape[-1]
    pre_act = _dot(word_emb, fp.w_word_cat, dt) + _dot(h, fp.w_hh_cat, dt) + fp.gxb
    i = torch.sigmoid(pre_act[:, :H])
    f = torch.sigmoid(pre_act[:, H:2 * H])
    g = torch.tanh(pre_act[:, 2 * H:3 * H])
    o = torch.sigmoid(pre_act[:, 3 * H:4 * H])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    sentinel = torch.sigmoid(pre_act[:, 4 * H:]) * torch.tanh(c_new)

    p_hid = torch.tanh(_dot(h_new, fp.w_p, dt) + fp.b_p)
    hid_emb = _dot(p_hid, fp.w_he, dt) + fp.b_he
    sent_key = _dot(sentinel, fp.w_se, dt) + fp.b_se

    ctx = _attention(fp.w_score, fp.b_score, hid_emb, sent_key, sentinel, imgk, imgv)
    out = torch.tanh(_dot(ctx + p_hid, fp.w_out, dt) + fp.b_out)
    proj = _dot(out, fp.w_proj, dt) + fp.b_proj  # [B, E]
    return h_new, c_new, proj


def reference_step(fp: Step, word_emb, h, c, img_k, img_v,
                   with_head: bool = True, compute_dtype=torch.bfloat16):
    """Plain version of the fused step -> (h', c', proj, word'). ``fp`` in
    either layout; the image memory of ``h``'s rows or of the images they
    share."""
    if isinstance(fp, PackedStep):
        fp = unpack(fp)
    B = h.shape[0]
    h_new, c_new, proj = _step_math(fp, word_emb, h, c, _per_row(img_k, B), _per_row(img_v, B),
                                    compute_dtype)
    if with_head:
        word = greedy_vocab_argmax_reference(proj, fp.head_table, fp.head_bias)
    else:
        word = torch.zeros((B,), dtype=torch.int32, device=h.device)
    return h_new, c_new, proj, word


# ---- kernels --------------------------------------------------------------------

# pointer order of csrc/fused_step.cu's LstmPtrs: the packed weights, the
# batch's inputs (copied into a graph's own tensors before each replay),
# then the state and scratch
_PTR_FIELDS = ("w_gate", "w_p", "b_p", "w_hs", "b_hs", "w_out", "b_out", "w_proj", "b_proj",
               "w_score", "b_score", "table", "head_bias")
_INPUT_FIELDS = ("gxb", "img_k", "img_v")
_WORK_FIELDS = ("word_emb", "word", "h0", "c0", "h1", "c1", "ws", "part_v", "part_i", "done",
                "flag", "ids_tm")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _ints(dt, rows, pk: PackedStep, S, n_img, steps=1, start=0, pad=0, stop=0, early=False):
    """csrc/fused_step.cu's LstmArg fields, in order."""
    H, E, V = pk.dims
    return [_build.dtype_code(dt), rows, E, H, S, n_img, V, steps, start, pad, stop, int(early)]


def _check(pk: PackedStep, img_k, img_v, rows: int, dt) -> Tuple[int, int]:
    """Validate the kernels' operands on CUDA -> (S, n_img)."""
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel B computes in float32 or bfloat16, got {dt}")
    H, E, V = pk.dims
    n_img, S = img_k.shape[:2]
    dev, f32 = pk.w_p.device, torch.float32
    for name, t, dtype, shape in (
        ("w_gate", pk.w_gate, dt, (E + H, 5 * H)),
        ("w_p", pk.w_p, dt, (H, H)), ("b_p", pk.b_p, f32, (H,)),
        ("w_hs", pk.w_hs, dt, (2, H, H)), ("b_hs", pk.b_hs, f32, (2, H)),
        ("w_out", pk.w_out, dt, (H, H)), ("b_out", pk.b_out, f32, (H,)),
        ("w_proj", pk.w_proj, dt, (H, E)), ("b_proj", pk.b_proj, f32, (E,)),
        ("w_score", pk.w_score, dt, (1, H)), ("b_score", pk.b_score, f32, (1,)),
        ("table", pk.table, dt, (V, E)), ("head_bias", pk.head_bias, f32, (V,)),
        ("gxb", pk.gxb, f32, (rows, 5 * H)),
        ("img_k", img_k, dt, (n_img, S, H)), ("img_v", img_v, dt, (n_img, S, H)),
    ):
        if t is None:
            raise ValueError(f"{name}: missing (gxb: with_batch)")
        _build.require(t, name, dev, dtype, shape)
    if H % DIM_MULTIPLE or E % DIM_MULTIPLE:
        raise ValueError(f"the kernels take H and E in multiples of {DIM_MULTIPLE}, "
                         f"got {H}, {E}")
    if rows < 1 or rows % n_img:
        raise ValueError(f"{rows} rows do not share {n_img} images evenly")
    return S, n_img


def fused_decode_step(
    fp: Step,
    word_emb: Optional[torch.Tensor],  # [B, E]
    h: torch.Tensor,  # [B, H] f32
    c: torch.Tensor,  # [B, H] f32
    img_k: torch.Tensor,  # [B or n_img, k, H] compute dtype
    img_v: torch.Tensor,  # [B or n_img, k, H] compute dtype
    with_head: bool = True,
    compute_dtype=torch.bfloat16,
    *,
    word: Optional[torch.Tensor] = None,
    padding_idx: int = 0,
    skip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (h', c', proj [B,E] f32, word' [B] int32 — zeros if not with_head).

    ``word`` [B] int32, if given, replaces ``word_emb``: the gate product
    gathers the rows of ``fp``'s table (``padding_idx``: zeros) in its
    prologue. ``img_k`` / ``img_v`` may hold n_img images that the rows
    share (row r reads image ``r // (B // n_img)``). ``skip`` [1] int32, on
    CUDA: a device flag on which every kernel of the step returns at once
    (its outputs are then left unwritten)."""
    pk = fp if isinstance(fp, PackedStep) else pack_step(fp)
    if word is not None:
        word_emb = None
    if h.device.type == "cpu":
        if word is not None:
            word_emb = gather_words(pk.table, word, padding_idx)
        return reference_step(pk, word_emb, h, c, img_k, img_v, with_head, compute_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    dt, dev = compute_dtype, h.device
    B = h.shape[0]
    H, E, _V = pk.dims
    S, n_img = _check(pk, img_k, img_v, B, dt)
    f32 = torch.float32
    _build.require(h, "h", dev, f32, (B, H))
    _build.require(c, "c", dev, f32, (B, H))
    if word is not None:
        _build.require(word, "word", dev, torch.int32, (B,))
    else:
        word_emb = word_emb.to(dt).contiguous()
        _build.require(word_emb, "word_emb", dev, dt, (B, E))
    if skip is not None:
        _build.require(skip, "skip", dev, torch.int32, (1,))
    # h', c', then the step's scratch: p_hid, sentinel, hid_emb, sent_key,
    # ctx + p_hid, out [B, H] each; proj [B, E]
    buf = torch.empty(8 * B * H + B * E, dtype=f32, device=dev)
    work = dict(word_emb=word_emb, word=word, h0=h, c0=c, h1=buf[:B * H], c1=buf[B * H:2 * B * H],
                ws=buf[2 * B * H:], flag=skip)
    ptrs = ([_ptr(getattr(pk, f)) for f in _PTR_FIELDS] + [_ptr(pk.gxb), _ptr(img_k), _ptr(img_v)]
            + [_ptr(work.get(f)) for f in _WORK_FIELDS])
    ints = _ints(dt, B, pk, S, n_img, pad=padding_idx)
    _build.check(_build.load_library().capk_fused_step(
        (ctypes.c_int * len(ints))(*ints), (ctypes.c_void_p * len(ptrs))(*ptrs),
        _build.stream_ptr(dev)), "capk_fused_step")
    fused_decode_step.launches += 1
    h_new = buf[:B * H].view(B, H)
    c_new = buf[B * H:2 * B * H].view(B, H)
    proj = buf[8 * B * H:].view(B, E)

    if with_head:
        nxt = greedy_vocab_argmax(proj, pk.table, pk.head_bias)
    else:
        nxt = torch.zeros((B,), dtype=torch.int32, device=dev)
    return h_new, c_new, proj, nxt


fused_decode_step.launches = 0


# ---- one of the bf16 step's products on its own -----------------------------------

PRODUCT_MODES = {"f32": 6, "tanh": 7, "lstm": 8}  # csrc/stream_product.cuh's EMode


def product_splits(rows: int, N: int, K: int, gate: bool = False) -> int:
    """K splits of the bf16 product of ``rows`` rows and a [K, N] weight (N:
    every problem's columns): split s takes the 32-row chunks [s c / S,
    (s + 1) c / S), c = K / 32."""
    return _build.load_library().capk_lstm_product_splits(rows, N, K, int(gate))


def _product_rows(a2, a, word, k_split, pad):
    """The product's A operand as float32: [a's rows or the table rows of
    ``word`` (``pad``: zeros) ; a2], the columns of a first."""
    if k_split == 0:
        return a2.float()
    rows = gather_words(a, word, pad) if word is not None else a
    return torch.cat([rows.float(), a2.float()], dim=1)


def step_product_reference(a2, w, bias, mode="f32", a=None, word=None, k_split=0, pad=0,
                           gxb=None, c=None):
    """Plain version of ``step_product``: the operands rounded to bfloat16,
    one float32 product, then the float32 epilogue."""
    A = _product_rows(a2, a, word, k_split, pad)
    if mode == "lstm":
        H = c.shape[1]
        z = torch.mm(A.to(torch.bfloat16).float(), deinterleave_gates(w).float()) + gxb
        c_new = torch.sigmoid(z[:, H:2 * H]) * c + torch.sigmoid(z[:, :H]) * torch.tanh(
            z[:, 2 * H:3 * H])
        tc = torch.tanh(c_new)
        return torch.sigmoid(z[:, 3 * H:4 * H]) * tc, c_new, torch.sigmoid(z[:, 4 * H:]) * tc
    ws = w if w.dim() == 3 else w[None]
    As = A.reshape(ws.shape[0], -1, A.shape[-1])
    y = torch.bmm(As.to(torch.bfloat16).float(), ws.float()) + bias.reshape(ws.shape[0], 1, -1)
    y = torch.tanh(y) if mode == "tanh" else y
    return y if w.dim() == 3 else y[0]


def step_product(a2, w, bias, mode="f32", a=None, word=None, k_split=0, pad=0, gxb=None,
                 c=None, *, pdl: bool = False):
    """One of the bf16 step's products on its own, as a step runs it: A =
    [``a``'s bf16 rows, or the table ``a``'s rows of ``word`` (int32;
    ``pad``: zeros), columns [0, k_split) ; the float32 rows ``a2``], rounded
    to bf16 as the fragments are formed; ``w`` [K, N] bf16, or [P, K, N]
    for P problems side by side (``a2`` [P, M, K], ``bias`` [P, N]); mode
    "f32" (A @ w + bias, float32), "tanh", or "lstm" (``w`` the gate weight
    as ``pack_weights`` interleaves it, ``gxb`` [M, 5H], ``c`` [M, H] ->
    (h', c', sentinel)). ``pdl``: launched with programmatic dependent
    launch, as a decode of up to 16 rows launches it. CPU tensors take
    ``step_product_reference``."""
    if a2.device.type == "cpu":
        return step_product_reference(a2, w, bias, mode, a, word, k_split, pad, gxb, c)
    dev, f32 = a2.device, torch.float32
    P = w.shape[0] if w.dim() == 3 else 1
    K, N = w.shape[-2:]
    M = a2.shape[-2]
    if mode == "lstm":
        H = N // 5
        out = [torch.empty(M, H, dtype=f32, device=dev) for _ in range(3)]
    else:
        out = torch.empty(*((P,) if w.dim() == 3 else ()), M, N, dtype=f32, device=dev)
    h_out, c_out, s_out = out if mode == "lstm" else (out, None, None)
    ints = [M, N, K, PRODUCT_MODES[mode], k_split, P, int(word is not None), pad, int(pdl)]
    ptrs = [_ptr(t) for t in (a, word, a2, w, bias, h_out, gxb, c, c_out, s_out)]
    _build.check(_build.load_library().capk_lstm_product(
        (ctypes.c_int * len(ints))(*ints), (ctypes.c_void_p * len(ptrs))(*ptrs),
        _build.stream_ptr(dev)), "capk_lstm_product")
    step_product.launches += 1
    return tuple(out) if mode == "lstm" else out


step_product.launches = 0


# ---- the whole greedy decode -------------------------------------------------------


def lstm_greedy_decode_reference(pk: PackedStep, img_k, img_v, max_length: int,
                                 start_idx: int = 2, padding_idx: int = 0,
                                 compute_dtype=torch.bfloat16, early_stop: bool = False,
                                 stop_idx: int = 3) -> torch.Tensor:
    """Plain version of the greedy decode on the packed tensors, every step
    run as the kernels run it (no host check; with ``early_stop``, rows that
    have emitted <stop> emit the padding id) -> int32 ids [B, max_length]."""
    B, dev = pk.gxb.shape[0], pk.gxb.device
    fp = unpack(pk, padding_idx)
    H = pk.w_p.shape[0]
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    word = torch.full((B,), start_idx, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ids = []
    for _t in range(max_length):
        h, c, _proj, word = reference_step(fp, gather_words(pk.table, word, padding_idx), h, c,
                                           img_k, img_v, True, compute_dtype)
        if early_stop:
            word = torch.where(done, torch.full_like(word, padding_idx), word)
            done = done | (word == stop_idx)
        ids.append(word)
    return torch.stack(ids, dim=1)


def step_key(entry: str, pk: PackedStep, ints, extra=()) -> tuple:
    """What fixes a captured LSTM decode: the entry, every int of the C call
    (dtype, rows, dims, images, vocab, steps, the start / pad / stop ids,
    early stop), the device and the packed weights' addresses (a bundle
    packs once; the graph reads them where they lie), and ``extra`` (the
    beam head's tensors). The batch's ``gxb`` and image memory are not in
    it: each replay copies them in."""
    weights = tuple((f, _ptr(getattr(pk, f))) for f in _PTR_FIELDS)
    return (entry, str(pk.w_p.device), tuple(int(i) for i in ints), weights,
            tuple(_ptr(t) for t in extra))


def _argmax_nblocks(V: int) -> int:
    """Columns of kernel A's partial buffers for a vocabulary of V rows."""
    return _build.load_library().capk_vocab_argmax_nblocks(V)


def _greedy_work(pk: PackedStep, rows, T, n_img, S, dt) -> dict:
    """The decode's own tensors (the graph's static ones), allocated before
    the capture: the copies of the batch's inputs, state, scratch, ids."""
    H, E, V = pk.dims
    dev, f32, i32 = pk.w_p.device, torch.float32, torch.int32
    nblk = _argmax_nblocks(V)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    return dict(gxb=empty(rows, 5 * H), img_k=empty(n_img, S, H, dtype=dt),
                img_v=empty(n_img, S, H, dtype=dt), word=empty(rows, dtype=i32),
                h0=empty(rows, H), c0=empty(rows, H), h1=empty(rows, H), c1=empty(rows, H),
                ws=empty(6 * rows * H + rows * E), part_v=empty(rows, nblk),
                part_i=empty(rows, nblk, dtype=i32), done=empty(rows, dtype=i32),
                flag=empty(1, dtype=i32), ids_tm=empty(T, rows, dtype=i32))


def _reset(work: dict, start_idx: int, padding_idx: int) -> None:
    """A decode's start state (captured in the graph, before the kernels)."""
    work["word"].fill_(start_idx)
    work["ids_tm"].fill_(padding_idx)
    for name in ("h0", "c0", "done", "flag"):
        work[name].zero_()


def _enqueue(pk: PackedStep, work: dict, ints, dev) -> int:
    """The C call that enqueues every step of a decode on the current
    stream, reading the batch's inputs from ``work``'s copies -> the number
    of kernels it enqueued."""
    ptrs = ([_ptr(getattr(pk, f)) for f in _PTR_FIELDS] + [_ptr(work[f]) for f in _INPUT_FIELDS]
            + [_ptr(work.get(f)) for f in _WORK_FIELDS])
    n = ctypes.c_int(0)
    _build.check(_build.load_library().capk_lstm_greedy_decode(
        (ctypes.c_int * len(ints))(*ints), (ctypes.c_void_p * len(ptrs))(*ptrs),
        _build.stream_ptr(dev), ctypes.byref(n)), "capk_lstm_greedy_decode")
    return n.value


def _greedy_graph(pk: PackedStep, img_k, img_v, ints, start_idx: int, padding_idx: int,
                  dt, graphs) -> torch.Tensor:
    """One greedy decode through ``graphs``: captured at a new ``step_key``,
    replayed after the batch's inputs are copied in; sets the counters."""
    dev = pk.gxb.device
    rows, (n_img, S) = pk.gxb.shape[0], img_k.shape[:2]
    T = ints[7]  # steps
    ids, cap, captured = graphs.run(
        step_key("capk_lstm_greedy_decode", pk, ints),
        lambda: _greedy_work(pk, rows, T, n_img, S, dt),
        lambda work: (_reset(work, start_idx, padding_idx), _enqueue(pk, work, ints, dev))[1],
        {"gxb": pk.gxb, "img_k": img_k, "img_v": img_v},
        lambda work: work["ids_tm"].T.contiguous(), dev)
    lstm_greedy_decode.kernel_launches = cap.kernel_launches
    lstm_greedy_decode.capture_ms = cap.capture_ms if captured else None
    fused_decode_step.launches += T
    greedy_vocab_argmax.launches += T
    return ids


def lstm_greedy_decode(pk: PackedStep, img_k: torch.Tensor, img_v: torch.Tensor,
                       max_length: int, start_idx: int = 2, padding_idx: int = 0,
                       compute_dtype=torch.bfloat16, early_stop: bool = False,
                       stop_idx: int = 3) -> torch.Tensor:
    """Whole greedy decode -> int32 ids [B, max_length] (B = ``pk.gxb``'s
    rows; ``img_k`` / ``img_v`` [B, k, H] in the compute dtype). For CUDA
    tensors, kernel B's steps with kernel A's head through one CUDA graph
    per ``step_key``; each call counts ``max_length`` launches of
    ``fused_decode_step`` and of ``greedy_vocab_argmax``."""
    if pk.gxb is None:
        raise ValueError("gxb: missing (with_batch)")
    dev = pk.gxb.device
    if dev.type == "cpu":
        return lstm_greedy_decode_reference(pk, img_k, img_v, max_length, start_idx,
                                            padding_idx, compute_dtype, early_stop, stop_idx)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    dt, T, B = compute_dtype, max_length, pk.gxb.shape[0]
    S, n_img = _check(pk, img_k, img_v, B, dt)
    if n_img != B or T < 1:
        raise ValueError(f"a greedy decode takes one image a row and >= 1 step, got "
                         f"{n_img} images for {B} rows, {T} steps")
    ints = _ints(dt, B, pk, S, n_img, T, start_idx, padding_idx, stop_idx, early_stop)
    return _greedy_graph(pk, img_k, img_v, ints, start_idx, padding_idx, dt, GRAPHS)


lstm_greedy_decode.kernel_launches = 0  # kernels a decode of the last call's key runs
lstm_greedy_decode.capture_ms = None  # ms the last call spent capturing, None if it replayed

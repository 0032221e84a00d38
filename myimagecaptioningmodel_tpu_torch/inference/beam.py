"""Batched beam-search decoding for the adaptive-attention LSTM decoder; port
of ``myimagecaptioningmodel_tpu/inference/beam.py``.

Beams are folded into the batch axis (``[B*W]`` rows through the decode
step). Semantics, as the reference:

- log-softmax scores accumulate per beam; at the start only beam 0 of each
  row is live (the others score ``NEG_INF``);
- a beam that has emitted ``<stop>`` is finished: it extends only with
  ``<pad>`` at zero cost, so its score freezes and it keeps competing;
- ``length_norm`` (0 = off) divides the final scores by
  ``max(len, 1) ** length_norm`` before the final pick, whose ties go to the
  lowest beam;
- ``beam_size=1`` reproduces greedy decode.

Every top-k goes through ``vocab_head.topk_stable`` (ties lowest index
first, as ``jax.lax.top_k``): ``early_stop`` relies on it, because once
every beam is finished the all-pad step must re-select the beams in order,
which is what the pre-filled history (``<pad>`` words, identity
back-pointers) assumes.

Two step bodies, chosen as the reference chooses them:

- **fused head** (``use_kernels and W > 1 and not parity_mode``): the fused
  decode step (kernel B) without its head on the ``[B*W]`` rows, on the
  weights packed once at load, then the top-k head (kernel C) gives each
  beam's best W words and the row's logsumexp, and the cross-beam selection
  runs on ``[B, W*W]`` candidates. Exact: for a fixed beam only its best W
  words can win a slot. Every one of the ``max_length`` steps runs (the
  all-pad steps after every beam has finished change nothing), so that on
  CUDA the whole search is one CUDA graph per shape, replayed per batch.
  Unlike the reference, no ``(B*W) % 8`` gate: the kernels take any batch.
- **plain**: ``decoder.step``, ``log_softmax`` over the vocab, the pad-only
  row for finished beams, and top-W over ``[B, W*V]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from myimagecaptioningmodel_tpu_torch.models import decoder as decoder_mod
from myimagecaptioningmodel_tpu_torch.models import transformer as transformer_mod
from myimagecaptioningmodel_tpu_torch.models.decoder import Precomputed
from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
from myimagecaptioningmodel_tpu_torch.ops.kernels.decode_graphs import GRAPHS
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
    topk_stable,
    topk_vocab_head,
)
from myimagecaptioningmodel_tpu_torch.ops.quantization import dense_in_dim, head_table
from myimagecaptioningmodel_tpu_torch.utils import tracing

NEG_INF = -1e9


def _fused_steps(pk, table, scale, bias, img_k, img_v, B: int, W: int, T: int, start_idx: int,
                 stop_idx: int, padding_idx: int, dt, early_stop: bool):
    """The fused-head search's ``T`` steps on ``[B*W]`` rows, every step run
    (no host check, so that a CUDA graph can hold them): kernel B without
    its head (the word rows gathered in its gate product), kernel C, the
    cross-beam selection. Once every beam is finished a step extends each by
    <pad> at zero cost and the stable top-W keeps its back-pointers the
    identity, so the result equals the early-stopped search's; with
    ``early_stop`` B and C then return at once on a device flag. -> (words,
    srcs [T, B, W], scores [B, W], lengths [B, W])."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    dev = img_k.device
    H = pk.w_p.shape[0]
    # (device fills only: a CUDA graph captures them; assigning a Python
    # number would copy it from the host)
    # finished beams: a single <pad> candidate at zero cost
    pad_row = torch.full((W,), NEG_INF, device=dev)
    pad_row[:1].fill_(0.0)
    h = torch.zeros((B * W, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    word = torch.full((B * W,), start_idx, dtype=torch.int32, device=dev)
    scores = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0].fill_(0.0)  # only beam 0 is live at first: all beams are equal
    finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.long, device=dev)
    batch_offsets = (torch.arange(B, device=dev) * W)[:, None]  # row base into [B*W]
    words, srcs = [], []  # per step [B, W]: chosen word, its source beam
    for _t in range(T):
        skip = finished.all().to(torch.int32).reshape(1) if early_stop else None
        h, c, proj, _w = FS.fused_decode_step(pk, None, h, c, img_k, img_v, with_head=False,
                                              compute_dtype=dt, word=word,
                                              padding_idx=padding_idx, skip=skip)
        vals, cand_ids, lse = topk_vocab_head(proj, table, bias, W, scale=scale,
                                              skip=skip)  # [B*W, W] x2, [B*W]
        logp = torch.where(finished[..., None], pad_row, (vals - lse[:, None]).reshape(B, W, W))
        cand_ids = torch.where(finished[..., None], padding_idx, cand_ids.reshape(B, W, W))
        scores, top_flat = topk_stable((scores[..., None] + logp).reshape(B, W * W), W)
        src_beam = top_flat // W  # [B, W] the beam each winner extends
        new_word = cand_ids.reshape(B, W * W).gather(1, top_flat)
        rows = (batch_offsets + src_beam).reshape(-1)
        h, c = h[rows], c[rows]
        prev_finished = finished.gather(1, src_beam)
        finished = prev_finished | (new_word == stop_idx)
        lengths = lengths.gather(1, src_beam) + (~prev_finished).long()
        word = new_word.reshape(-1)
        words.append(new_word)
        srcs.append(src_beam)
    return torch.stack(words).long(), torch.stack(srcs), scores, lengths


def _fused_search(params, pre: Precomputed, packed, B, W, T, start_idx, stop_idx, padding_idx,
                  dt, early_stop, graphs=None):
    """The fused-head search's steps (``_fused_steps``) on the packed
    weights; with ``graphs`` (``decode_graphs.GRAPHS`` for CUDA tensors)
    through one CUDA graph per shape and bundle (``fused_step.step_key``),
    each call copying its batch's gate inputs and image memory in, and
    counting ``T`` launches of kernels B and C."""
    from myimagecaptioningmodel_tpu_torch.ops.kernels import _build
    from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

    pk = FS.packed_for(params, dt, packed)
    pk = pk._replace(gxb=FS.gate_inputs(params, pre).repeat_interleave(W, dim=0))
    img_k = pre.img_k.to(dt).contiguous()  # one copy an image: its W rows share it
    img_v = pre.img_v.to(dt).contiguous()
    # an int8 table streams 1 byte per element through the head; a float
    # one is the packed table (the graph's key holds its address)
    table, scale = head_table(params["embedding"])
    if scale is None:
        table = pk.table
    bias = params["out_bias"]
    args = (B, W, T, start_idx, stop_idx, padding_idx, dt, early_stop)
    dev = img_k.device
    if graphs is None:
        return _fused_steps(pk, table, scale, bias, img_k, img_v, *args)

    def record(work):  # the steps on the graph's own inputs; the counters as a replay sets them
        counters = (FS.fused_decode_step.launches, topk_vocab_head.launches)
        out = _fused_steps(pk._replace(gxb=work["gxb"]), table, scale, bias, work["img_k"],
                           work["img_v"], *args)
        FS.fused_decode_step.launches, topk_vocab_head.launches = counters
        work.update(zip(("words", "srcs", "scores", "lengths"), out))
        return None  # kernels a replay runs: not counted (PyTorch's among them)

    def make_work():
        if dev.type == "cuda":
            _build.load_library()  # built before the capture
        return {"gxb": torch.empty_like(pk.gxb), "img_k": torch.empty_like(img_k),
                "img_v": torch.empty_like(img_v)}

    ints = [_build.dtype_code(dt), B, W, T, *img_k.shape[1:], *pk.dims, start_idx, stop_idx,
            padding_idx, int(early_stop)]
    out, cap, captured = graphs.run(
        FS.step_key("lstm_beam", pk, ints, (table, scale, bias)), make_work, record,
        {"gxb": pk.gxb, "img_k": img_k, "img_v": img_v},
        lambda w: tuple(w[k].clone() for k in ("words", "srcs", "scores", "lengths")), dev)
    beam_search_ids.capture_ms = cap.capture_ms if captured else None
    FS.fused_decode_step.launches += T
    topk_vocab_head.launches += T
    return out


def beam_search_ids(
    params,
    pre: Precomputed,
    max_length: int,
    beam_size: int = 4,
    start_idx: int = 2,
    stop_idx: int = 3,
    padding_idx: int = 0,
    length_norm: float = 0.0,
    parity_mode: bool = False,
    compute_dtype=torch.bfloat16,
    use_kernels: bool = False,
    early_stop: bool = False,
    packed=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ids int32 [B, max_length] of the best beam, scores float32 [B]).
    ``packed``: ``fused_step.pack_weights(params, compute_dtype)``, packed
    once at load (the fused-head branch packs here when None or of another
    dtype)."""
    B = pre.global_feat.shape[0]
    W = beam_size
    dev = pre.global_feat.device
    dt = compute_dtype
    if use_kernels and W > 1 and not parity_mode:
        quad = _fused_search(params, pre, packed, B, W, max_length, start_idx, stop_idx,
                             padding_idx, dt, early_stop, GRAPHS if dev.type == "cuda" else None)
        return beam_backtrack(*quad, length_norm)

    H = dense_in_dim(params["p_hid"])
    V = head_table(params["embedding"])[0].shape[0]
    pre_t = Precomputed(*(t.repeat_interleave(W, dim=0) for t in pre))
    # finished beams may only emit <pad>, at zero cost
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[padding_idx] = 0.0
    h = torch.zeros((B * W, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    word = torch.full((B * W,), start_idx, dtype=torch.long, device=dev)
    scores = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0  # only beam 0 is live at first: all beams are equal
    finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.long, device=dev)
    batch_offsets = (torch.arange(B, device=dev) * W)[:, None]  # row base into [B*W]
    words, srcs = [], []  # per step [B, W]: chosen word, its source beam

    for _t in range(max_length):
        if early_stop and tracing.all_done(finished):
            break
        h, c, logits = decoder_mod.step(params, pre_t, word, h, c, parity_mode, padding_idx, dt)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
        logp = torch.where(finished[..., None], pad_only, logp)
        cand = scores[..., None] + logp  # [B, W, V]
        scores, top_flat = topk_stable(cand.reshape(B, W * V), W)
        src_beam = top_flat // V  # [B, W] the beam each winner extends
        new_word = top_flat % V
        rows = (batch_offsets + src_beam).reshape(-1)
        h, c = h[rows], c[rows]
        prev_finished = finished.gather(1, src_beam)
        finished = prev_finished | (new_word == stop_idx)
        lengths = lengths.gather(1, src_beam) + (~prev_finished).long()
        word = new_word.reshape(-1)
        words.append(new_word)
        srcs.append(src_beam)

    # the steps an early stop skipped: <pad> words, identity back-pointers
    identity = torch.arange(W, device=dev).expand(B, W)
    for _t in range(max_length - len(words)):
        words.append(torch.full((B, W), padding_idx, dtype=torch.long, device=dev))
        srcs.append(identity)
    return beam_backtrack(torch.stack(words), torch.stack(srcs), scores, lengths, length_norm)


beam_search_ids.capture_ms = None  # ms the last fused-head search spent capturing, None if it replayed


@torch.no_grad()
def beam_decode(model, images, opts, beam_size: int = 4, length_norm: float = 0.0,
                stop_idx: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-model beam decode (encoder + search) -> (ids [B, T], scores [B])."""
    from myimagecaptioningmodel_tpu_torch.models import captioner

    img_embed, _feat, global_feat = captioner.img2feature(model, images, opts)
    dec = model.params["decoder"]
    if opts.arch == "transformer":  # kernel E exactly when use_kernels is set
        tpre = transformer_mod.precompute(dec, img_embed, global_feat,
                                          opts.tdims.num_heads, opts.dtype)
        return transformer_mod.beam_search_ids(
            dec, tpre, opts.tdims, opts.infer_max_length, beam_size, opts.start_idx,
            stop_idx, opts.padding_idx, length_norm, opts.dtype,
            use_kernels=opts.use_kernels, early_stop=opts.early_stop_decode,
            packed=model.decoder_packed,
        )
    pre = decoder_mod.precompute(dec, img_embed, global_feat, opts.dtype)
    return beam_search_ids(
        dec, pre, opts.infer_max_length, beam_size, opts.start_idx, stop_idx,
        opts.padding_idx, length_norm, opts.parity_mode, opts.dtype,
        use_kernels=opts.use_kernels, early_stop=opts.early_stop_decode,
        packed=model.decoder_packed,
    )

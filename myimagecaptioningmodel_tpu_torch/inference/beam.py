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
  decode step without its head on the ``[B*W]`` rows, then the top-k head
  (kernel C) gives each beam's best W words and the row's logsumexp, and the
  cross-beam selection runs on ``[B, W*W]`` candidates. Exact: for a fixed
  beam only its best W words can win a slot. Unlike the reference, no
  ``(B*W) % 8`` or model-dims gate: the kernels take any batch.
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
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
    topk_stable,
    topk_vocab_head,
)
from myimagecaptioningmodel_tpu_torch.ops.quantization import dense_in_dim, head_table

NEG_INF = -1e9


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ids int32 [B, max_length] of the best beam, scores float32 [B])."""
    B = pre.global_feat.shape[0]
    W = beam_size
    dev = pre.global_feat.device
    dt = compute_dtype
    H = dense_in_dim(params["p_hid"])
    V = head_table(params["embedding"])[0].shape[0]
    pre_t = Precomputed(*(t.repeat_interleave(W, dim=0) for t in pre))

    if use_kernels and W > 1 and not parity_mode:
        from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

        fp = FS.prepare(params, pre_t, padding_idx, dt)
        img_k = pre_t.img_k.to(dt).contiguous()
        img_v = pre_t.img_v.to(dt).contiguous()
        # an int8 table streams 1 byte per element through the head
        table, scale = head_table(params["embedding"], dt)
        table = table.contiguous()
        # finished beams: a single <pad> candidate at zero cost
        pad_row = torch.full((W,), NEG_INF, device=dev)
        pad_row[0] = 0.0

        def candidates(h, c, word, finished):
            h, c, proj, _w = FS.fused_decode_step(
                fp, fp.emb_table[word], h, c, img_k, img_v, with_head=False,
                compute_dtype=dt,
            )
            vals, cand_ids, lse = topk_vocab_head(
                proj, table, params["out_bias"], W, scale=scale
            )  # [B*W, W] x2, [B*W]
            logp = (vals - lse[:, None]).reshape(B, W, W)
            cand_ids = cand_ids.long().reshape(B, W, W)
            logp = torch.where(finished[..., None], pad_row, logp)
            cand_ids = torch.where(finished[..., None], padding_idx, cand_ids)
            return h, c, logp, cand_ids
    else:
        # finished beams may only emit <pad>, at zero cost
        pad_only = torch.full((V,), NEG_INF, device=dev)
        pad_only[padding_idx] = 0.0

        def candidates(h, c, word, finished):
            h, c, logits = decoder_mod.step(
                params, pre_t, word, h, c, parity_mode, padding_idx, dt
            )
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
            logp = torch.where(finished[..., None], pad_only, logp)
            return h, c, logp, None

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
        if early_stop and bool(finished.all()):
            break
        h, c, logp, cand_ids = candidates(h, c, word, finished)
        cand = scores[..., None] + logp  # [B, W, W or V]
        n = cand.shape[-1]
        scores, top_flat = topk_stable(cand.reshape(B, W * n), W)
        src_beam = top_flat // n  # [B, W] the beam each winner extends
        if cand_ids is None:
            new_word = top_flat % n
        else:
            new_word = cand_ids.reshape(B, W * n).gather(1, top_flat)
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
    )

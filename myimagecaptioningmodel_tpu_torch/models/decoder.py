"""Adaptive-attention ("visual sentinel") LSTM decoder with tied embeddings,
decode side; port of ``myimagecaptioningmodel_tpu/models/decoder.py``.

Params are the reference's dict layout (dense weights ``[in, out]``) holding
torch tensors. One decode step, as the reference (the sentinel gate reads the
previous hidden state, ``p_hid`` the new one):

    xt = [word_emb ; global_feat];  h, c = lstm(xt, h_prev, c_prev)
    sentinel = sigmoid(fc(xt) + fc(h_prev)) * tanh(c)
    p_hid = tanh(fc(h));  ctx = adaptive attention;  out = tanh(fc(ctx + p_hid))
    logits = fc(out, E) @ embedding_table^T + out_bias

Params may hold int8 weights (``ops/quantization.py``): every product of
such a weight applies its per-output-channel scale, and the tied head its
per-row scale, where the reference does.

``greedy_decode_ids`` runs kernel B's whole-decode graph when ``use_kernels``
is on (CUDA), and the plain step otherwise. Unlike the reference it needs no
batch padding: the kernels take any B >= 1 and mask their own ragged edges,
and decoding is per row either way (they take H in multiples of 64 and E
in multiples of 32).

``teacher_forcing_logits`` is the training forward, with the reference's
structure: everything that does not feed the recurrence is batched over
time, a Python loop over T keeps only the h-recurrent product (each step
under ``torch.utils.checkpoint`` with ``remat``, the reference's switch),
and the all-steps attention scores are checkpointed too, so the backward
recomputes the ``[T, B, k, H]`` tanh tensor instead of storing it. With
``fused_attn_bwd`` the scores are ``ops/attention.attn_scores_fused_bwd``
instead (kernel H on a card), whose backward writes no ``[T, B, k, H]``
tensor.

Under vocab tensor parallelism (``parallel/vocab_parallel.py``) the params
hold this rank's rows of the table and of ``out_bias``:
``teacher_forcing_logits(vocab_parallel=True)`` looks the words up across
the model group and returns this rank's logit columns, and
``greedy_decode_ids(vocab_slice=(lo, hi))`` decodes on the full table (for
the word rows) with the head on rows ``[lo, hi)``, merged over the group.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from myimagecaptioningmodel_tpu_torch.ops import attention as A
from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH
from myimagecaptioningmodel_tpu_torch.ops.lstm import lstm_from_gates
from myimagecaptioningmodel_tpu_torch.ops.quantization import (
    dense_in_dim,
    head_table,
    is_quantized,
)
from myimagecaptioningmodel_tpu_torch.parallel import vocab_parallel as VP
from myimagecaptioningmodel_tpu_torch.utils import tracing

Params = Dict[str, Any]


class DecoderDims(NamedTuple):
    vocab_size: int = 12295
    embedding_size: int = 256
    hidden_dim: int = 1024
    feat_channels: int = 1280  # encoder output channels
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        """Table/logits rows: vocab rounded up; padded entries carry a -1e9
        output bias and never win the argmax."""
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @classmethod
    def from_config(cls, md) -> "DecoderDims":
        return cls(
            vocab_size=md.decoder.vocab_size,
            embedding_size=md.decoder.embedding_size,
            hidden_dim=md.decoder.hidden_dim,
            feat_channels=md.encoder.encoder_channel,
            vocab_pad_multiple=getattr(md.decoder, "vocab_pad_multiple", 1),
        )


def _xavier(gen: torch.Generator, fan_in: int, fan_out: int) -> torch.Tensor:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty((fan_in, fan_out)).uniform_(-lim, lim, generator=gen)


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {"w": _xavier(gen, in_dim, out_dim), "b": torch.zeros(out_dim)}


def init(gen: torch.Generator, dims: DecoderDims, parity_init: bool = False) -> Params:
    """The reference's decoder param dict, drawn from ``gen``."""
    E, H, V = dims.embedding_size, dims.hidden_dim, dims.padded_vocab
    lim = 1.0 if parity_init else 1.0 / (E ** 0.5)
    out_bias = torch.zeros(V)
    out_bias[dims.vocab_size:] = -1e9  # padded vocab rows never win
    return {
        "embedding": {"table": torch.empty((V, E)).uniform_(-lim, lim, generator=gen)},
        "lstm": {"w": _xavier(gen, E + H + H, 4 * H), "b": torch.zeros(4 * H)},
        "img_v": init_dense(gen, H, H),
        "img_k": init_dense(gen, H, H),
        "gate_x": init_dense(gen, E + H, H),
        "gate_h": init_dense(gen, H, H),
        "p_hid": init_dense(gen, H, H),
        "hid_emb": init_dense(gen, H, H),
        "sent_emb": init_dense(gen, H, H),
        "attention": {"score": init_dense(gen, H, 1)},
        "out": init_dense(gen, H, H),
        "out_proj": init_dense(gen, H, E),
        "out_bias": out_bias,
    }


class Precomputed(NamedTuple):
    """Per-image tensors computed once, reused by all decode steps."""

    img_v: torch.Tensor  # [B, k, H] tanh value projection
    img_k: torch.Tensor  # [B, k, H] key projection
    global_feat: torch.Tensor  # [B, H]
    lstm_gx: torch.Tensor  # [B, 4H] global-feat part of the LSTM gates
    gate_gx: torch.Tensor  # [B, H] global-feat part of the sentinel gate


def _row_matmul(p: Params, x: torch.Tensor, lo: int, hi, dt, scaled: bool) -> torch.Tensor:
    """x @ W[lo:hi] in the compute dtype, for a possibly int8 ``[I, O]`` weight.

    ``scaled=True`` returns float32 in real units (an int8 weight's
    per-output-channel scale applied). ``scaled=False`` returns the raw
    product in dt without the scale: the caller sums row splits of one weight
    first (the scale commutes with row slicing) and then multiplies by
    ``_out_scale(p)``."""
    w = p["w_q"] if is_quantized(p) else p["w"]
    y = torch.matmul(x.to(dt), w[lo:hi].to(dt))
    if scaled and is_quantized(p):
        y = y.float() * p["scale"]
    return y.float() if scaled else y


def _out_scale(p: Params):
    return p["scale"] if is_quantized(p) else None


def precompute(params: Params, p_img_feat: torch.Tensor, global_feat: torch.Tensor,
               compute_dtype=torch.bfloat16) -> Precomputed:
    """Hoist every step-invariant piece out of the decode loop: attention
    keys/values and the global-feature parts of both gates (in real units:
    int8 scales applied here, once)."""
    dt = compute_dtype
    img_v = torch.tanh(L.dense(params["img_v"], p_img_feat, dt)).to(dt)
    img_k = L.dense(params["img_k"], p_img_feat, dt).to(dt)
    E = head_table(params["embedding"])[0].shape[1]
    H = dense_in_dim(params["gate_h"])
    # lstm["w"] rows: [0:E) word emb | [E:E+H) global feat | [E+H:) h_prev
    lstm_gx = _row_matmul(params["lstm"], global_feat, E, E + H, dt, scaled=True)
    gate_gx = _row_matmul(params["gate_x"], global_feat, E, E + H, dt, scaled=True)
    return Precomputed(img_v, img_k, global_feat, lstm_gx, gate_gx)


def step_core(params: Params, pre: Precomputed, word: torch.Tensor,
              h_prev: torch.Tensor, c_prev: torch.Tensor, parity_mode: bool = False,
              padding_idx: int = 0, compute_dtype=torch.bfloat16):
    """One decode step up to the tied-vocab head -> (h, c, proj [B, E])."""
    dt = compute_dtype
    word_emb = L.embed(params["embedding"], word, padding_idx)
    E = word_emb.shape[-1]
    H = h_prev.shape[-1]

    lp = params["lstm"]
    raw = (_row_matmul(lp, word_emb, 0, E, dt, scaled=False)
           + _row_matmul(lp, h_prev, E + H, None, dt, scaled=False)).float()
    s = _out_scale(lp)
    if s is not None:
        raw = raw * s
    gates = raw + pre.lstm_gx + lp["b"]
    h, c = lstm_from_gates(gates, c_prev)

    gp = params["gate_x"]
    raw_g = _row_matmul(gp, word_emb, 0, E, dt, scaled=False).float()
    sg = _out_scale(gp)
    if sg is not None:
        raw_g = raw_g * sg
    gate = torch.sigmoid(
        raw_g
        + pre.gate_gx
        + gp["b"]
        + L.dense(params["gate_h"], h_prev, dt).float()
    )
    sentinel = gate * torch.tanh(c)

    p_hid = torch.tanh(L.dense(params["p_hid"], h, dt))
    hid_emb = L.dense(params["hid_emb"], p_hid, dt)
    sent_key = L.dense(params["sent_emb"], sentinel, dt)
    context, _alpha = A.adaptive_attention(
        params["attention"], pre.img_k, pre.img_v, sent_key, sentinel, hid_emb,
        parity_mode, dt,
    )
    out = torch.tanh(L.dense(params["out"], context + p_hid, dt))
    proj = L.dense(params["out_proj"], out, dt)  # [B, E]
    return h, c, proj


def head_logits(params: Params, proj: torch.Tensor, compute_dtype=torch.bfloat16):
    """Tied-embedding vocab head: proj @ table^T (* scale) + bias -> [B, V]
    float32. An int8 table's per-row scale multiplies the logit columns."""
    dt = compute_dtype
    table, scale = head_table(params["embedding"])
    logits = torch.matmul(proj.to(dt), table.to(dt).T).float()
    if scale is not None:
        logits = logits * scale
    return logits + params["out_bias"]


def step(params: Params, pre: Precomputed, word: torch.Tensor, h_prev: torch.Tensor,
         c_prev: torch.Tensor, parity_mode: bool = False, padding_idx: int = 0,
         compute_dtype=torch.bfloat16):
    """One decode step -> (h, c, logits [B, V] float32)."""
    h, c, proj = step_core(params, pre, word, h_prev, c_prev, parity_mode, padding_idx,
                           compute_dtype)
    return h, c, head_logits(params, proj, compute_dtype)


def _recurrent_step(h, c, gx_t, w_hh, dt):
    gates = gx_t + torch.matmul(h.to(dt), w_hh).float()
    return lstm_from_gates(gates, c)


def teacher_forcing_logits(
    params: Params,
    pre: Precomputed,
    source: torch.Tensor,  # [B, T] input words (caption[:, :-1])
    parity_mode: bool = False,
    padding_idx: int = 0,
    compute_dtype=torch.bfloat16,
    remat: bool = True,
    fused_attn_bwd: bool = False,
    vocab_parallel: bool = False,
) -> torch.Tensor:
    """Training forward over the whole caption -> logits [B, T, V] float32
    (``vocab_parallel``: this rank's columns [B, T, V_local] of a table
    sharded by rows).

    ``remat`` checkpoints each recurrent step (its backward recomputes the
    cell instead of storing its intermediates); off, the same forward bits
    and gradients. ``fused_attn_bwd`` takes the image scores from
    ``attn_scores_fused_bwd`` (the same forward bits on the CPU; its
    backward one pass, kernel H on a card) instead of autograd of the
    checkpointed expression. Both as the JAX package, which defaults the
    fused backward off: it measured the two at parity on a TPU, where XLA
    fuses the recompute into each reduction."""
    B, T = source.shape
    H = dense_in_dim(params["p_hid"])
    dt = compute_dtype
    dev = pre.global_feat.device
    h0 = torch.zeros((B, H), dtype=torch.float32, device=dev)

    # the word, global and bias gate terms of every step, batched over time
    embed = VP.embed if vocab_parallel else L.embed
    word_emb = embed(params["embedding"], source, padding_idx)  # [B, T, E]
    E = word_emb.shape[-1]
    lw = params["lstm"]["w"]
    gx = (torch.matmul(word_emb.to(dt), lw[:E].to(dt)).float()
          + pre.lstm_gx[:, None, :] + params["lstm"]["b"])  # [B, T, 4H]
    gx_tm = gx.transpose(0, 1)  # time-major
    w_hh = lw[E + H:].to(dt)

    h, c = h0, torch.zeros_like(h0)
    hs, cs = [], []
    for t in range(T):  # only the h-recurrent product is inside the loop
        if remat:
            h, c = checkpoint(_recurrent_step, h, c, gx_tm[t], w_hh, dt, use_reentrant=False)
        else:
            h, c = _recurrent_step(h, c, gx_tm[t], w_hh, dt)
        hs.append(h)
        cs.append(c)
    hs, cs = torch.stack(hs), torch.stack(cs)  # [T, B, H]
    h_prev_seq = torch.cat([h0[None], hs[:-1]], dim=0)  # h_{t-1}

    # the post-recurrence step math (as step_core), batched over [T, B, .]
    gw = params["gate_x"]["w"]
    gate = torch.sigmoid(
        torch.matmul(word_emb.to(dt), gw[:E].to(dt)).transpose(0, 1).float()
        + pre.gate_gx
        + params["gate_x"]["b"]
        + L.dense(params["gate_h"], h_prev_seq, dt).float()
    )
    sentinel = gate * torch.tanh(cs)  # [T, B, H]
    p_hid = torch.tanh(L.dense(params["p_hid"], hs, dt))
    hid_emb = L.dense(params["hid_emb"], p_hid, dt)
    sent_key = L.dense(params["sent_emb"], sentinel, dt)

    if parity_mode:
        k1 = pre.img_v.shape[1] + 1
        context = (pre.img_v.sum(dim=1).float()[None] + sentinel) / k1
    else:
        score = params["attention"]["score"]
        if fused_attn_bwd:
            e_img = A.attn_scores_fused_bwd(dt, score, pre.img_k, hid_emb)
        else:
            e_img = checkpoint(KH.attn_scores_reference, pre.img_k, hid_emb, score["w"],
                               score["b"], dt, use_reentrant=False)
        z_sent = torch.tanh(sent_key + hid_emb)
        e_sent = L.dense(score, z_sent, dt)
        e = torch.cat([e_img, e_sent], dim=-1).float()
        alpha = torch.softmax(e, dim=-1)  # [T, B, k+1]
        context = (
            torch.einsum("tbk,bkh->tbh", alpha[..., :-1].to(dt), pre.img_v.to(dt)).float()
            + alpha[..., -1:] * sentinel
        )

    out = torch.tanh(L.dense(params["out"], context + p_hid, dt))
    proj = L.dense(params["out_proj"], out, dt)  # [T, B, E]
    if vocab_parallel:
        proj = VP.head_input(proj)
    return head_logits(params, proj, dt).transpose(0, 1)  # [B, T, V]


def greedy_decode_ids(
    params: Params,
    pre: Precomputed,
    max_length: int,
    start_idx: int = 2,
    parity_mode: bool = False,
    padding_idx: int = 0,
    compute_dtype=torch.bfloat16,
    use_kernels: bool = False,
    early_stop: bool = False,
    stop_idx: int = 3,
    packed=None,
    vocab_slice=None,
) -> torch.Tensor:
    """Greedy decode, argmax feedback for ``max_length`` steps -> int32 [B, T].

    ``vocab_slice`` (lo, hi): vocab tensor parallelism, ``params`` with the
    full table (``vocab_parallel.full_decoder``); the head runs on rows
    ``[lo, hi)`` and is merged over the model group
    (``vocab_parallel.greedy_head``: kernel A on the slice on a card), step
    by step, with no host check (``_greedy_vocab_parallel``).

    ``use_kernels``: the whole decode is kernel B's (``ops/kernels/
    fused_step.lstm_greedy_decode``: each step the fused step ending in the
    vocab-argmax kernel, one CUDA graph replay per decode), on ``packed``
    (``fused_step.pack_weights(params, compute_dtype)``, packed once at
    load; packed here when None or of another dtype, int8 params
    dequantized there); under ``parity_mode`` the plain step runs with the
    vocab-argmax kernel as its head (on an int8 table with its scale).
    ``early_stop`` fills the positions after a row's ``<stop>`` with the
    padding id (captions equal the fixed-length decode's); the plain loop
    also ends once every row has emitted ``<stop>``.
    """
    B = pre.global_feat.shape[0]
    H = dense_in_dim(params["p_hid"])
    dev = pre.global_feat.device
    dt = compute_dtype

    if vocab_slice is not None:
        return _greedy_vocab_parallel(params, pre, max_length, start_idx, parity_mode,
                                      padding_idx, dt, use_kernels, early_stop, stop_idx,
                                      packed, vocab_slice)
    if use_kernels and not parity_mode:
        from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

        pk = FS.with_batch(FS.packed_for(params, dt, packed), params, pre)
        return FS.lstm_greedy_decode(pk, pre.img_k.to(dt).contiguous(),
                                     pre.img_v.to(dt).contiguous(), max_length, start_idx,
                                     padding_idx, dt, early_stop, stop_idx)
    if use_kernels:
        from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import (
            greedy_vocab_argmax,
        )

        # an int8 table streams 1 byte per element, its scale fused
        table, scale = head_table(params["embedding"])

        def argmax_head(proj):
            return greedy_vocab_argmax(proj, table, params["out_bias"], scale)
    else:

        def argmax_head(proj):
            return torch.argmax(head_logits(params, proj, dt), dim=-1).to(torch.int32)

    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    word = torch.full((B,), start_idx, dtype=torch.int64, device=dev)
    ids = torch.full((B, max_length), padding_idx, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_length):
        if early_stop and tracing.all_done(done):
            break
        h, c, proj = step_core(params, pre, word, h, c, parity_mode, padding_idx, dt)
        nxt = argmax_head(proj)
        if early_stop:
            nxt = torch.where(done, torch.full_like(nxt, padding_idx), nxt)
            done = done | (nxt == stop_idx)
        ids[:, t] = nxt
        word = nxt.long()
    return ids


def _greedy_vocab_parallel(params: Params, pre: Precomputed, max_length: int, start_idx: int,
                           parity_mode: bool, padding_idx: int, dt, use_kernels: bool,
                           early_stop: bool, stop_idx: int, packed, vocab_slice) -> torch.Tensor:
    """``greedy_decode_ids``' vocab-parallel decode: each step kernel B
    without its head (``use_kernels``, not parity mode; its word rows
    gathered from the full table in its pack) or the plain step, then the
    head on this rank's rows merged over the model group. A collective
    cannot sit inside a CUDA graph, so the steps run one by one; the loop
    runs every step (the early-stop fill gives the same ids)."""
    lo, hi = vocab_slice
    B = pre.global_feat.shape[0]
    H = dense_in_dim(params["p_hid"])
    dev = pre.global_feat.device
    fused = use_kernels and not parity_mode and dev.type == "cuda"
    if fused:
        from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as FS

        pk = FS.with_batch(FS.packed_for(params, dt, packed), params, pre)
        table, bias = pk.table[lo:hi], pk.head_bias[lo:hi]
        img_k, img_v = pre.img_k.to(dt).contiguous(), pre.img_v.to(dt).contiguous()
        logits_fn = None
    else:
        if is_quantized(params["embedding"]):
            raise ValueError("the vocab-parallel decode takes a float table")
        table, bias = params["embedding"]["table"][lo:hi], params["out_bias"][lo:hi]
        local = {"embedding": {"table": table}, "out_bias": bias}
        logits_fn = None if use_kernels else (lambda proj: head_logits(local, proj, dt))
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    word = torch.full((B,), start_idx, dtype=torch.int32, device=dev)
    ids = torch.full((B, max_length), padding_idx, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_length):
        if fused:
            h, c, proj, _ = FS.fused_decode_step(pk, None, h, c, img_k, img_v, False, dt,
                                                 word=word, padding_idx=padding_idx)
        else:
            h, c, proj = step_core(params, pre, word.long(), h, c, parity_mode, padding_idx, dt)
        nxt = VP.greedy_head(proj, table, bias, logits_fn)
        if early_stop:
            nxt = torch.where(done, torch.full_like(nxt, padding_idx), nxt)
            done = done | (nxt == stop_idx)
        ids[:, t] = nxt
        word = nxt
    return ids

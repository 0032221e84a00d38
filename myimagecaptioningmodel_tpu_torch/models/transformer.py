"""Transformer captioning decoder; port of
``myimagecaptioningmodel_tpu/models/transformer.py``.

A pre-LN transformer decoder with cross-attention over the same 49 + 1
image slots the LSTM family attends to (``model.decoder.arch =
"transformer"``). Params are the reference's dict layout (dense weights
``[in, out]``, ``embedding``/``out_bias`` tied as in the LSTM family), with
``layers`` a list in layer order (the reference's tuple).

Rounding points, as the reference: LayerNorm, softmax and the residual
stream are float32; every dense layer rounds its operands to the compute
dtype, accumulates in float32, rounds the product to the compute dtype and
adds the bias there (``layers.dense``). Two places differ from the
reference's XLA path in bfloat16 and agree in float32 (which is what the CPU
tests hold): attention scores ``q . k`` and the vocab logits are accumulated
and kept in float32 here, as the whole-decode kernels D and E compute them
(``ops/kernels/fused_transformer.py``); the reference rounds both to the
compute dtype. Training keeps them in float32 too, so that one forward,
``teacher_forcing_logits``, trains the weights and is the plain version D
and E are held against; in bfloat16 the training loss then lies within
the two packages' own bfloat16 noise of the reference's
(``tests/test_torch_bf16_parity.py::test_transformer_loss_bf16``).

Decoding carries a KV cache per layer, ``[B, T, heads, dh]``, updated in
place (the reference's ``dynamic_update_slice``). ``greedy_decode_ids`` and
``beam_search_ids`` run kernel D or E when ``use_kernels`` is set, and the
plain KV-cached loop otherwise.

int8 serving (``quantize_transformer_decoder``): every dense weight gets a
per-output-channel scale and the tied table a per-row scale
(``ops/quantization.py``'s scheme); ``layers.dense``/``embed`` and
``head_logits`` take the int8 leaves, each product scaled after it, in the
compute dtype, before the bias. ``quantize_kv`` (greedy only) streams the
cross-attention memory as int8 with a scale per (layer, K|V, channel) in
kernel D; the plain loop applies the same grid as a quantize-dequantize
(``quantize_kv_pre``), as the reference's XLA path does. A
``TransformerPre`` whose memory is already int8 carries its scales
(``kv_scale``): K's scale then multiplies the query and V's the context,
where kernel D folds them.

Not ported, and why: the reference's XLA fused-head beam branch (kernel E's
plain version computes the same per-row top-W and logsumexp), and
``TransformerPreMBD``/``precompute_mbd``/``_mbd_to_pre`` (the TPU kernel's
``[M, B, D]`` DMA layout; the CUDA kernels take ``precompute``'s own).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from myimagecaptioningmodel_tpu_torch.models.decoder import _xavier, init_dense
from myimagecaptioningmodel_tpu_torch.ops import layers as L
from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import topk_stable
from myimagecaptioningmodel_tpu_torch.ops.quantization import (
    dense_in_dim,
    is_quantized,
    quantize_weight,
)

Params = Dict[str, Any]

NEG_INF = -1e9  # beam score floor and attention mask value
LN_EPS = 1e-6


class TransformerDims(NamedTuple):
    vocab_size: int = 12295
    embedding_size: int = 256  # tied-table width
    model_dim: int = 1024  # == hidden_dim: the img2feature output width
    num_layers: int = 4
    num_heads: int = 8
    mlp_ratio: int = 4
    max_positions: int = 35  # >= max(sentence_length, infer_max_length)
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    @classmethod
    def from_config(cls, md) -> "TransformerDims":
        d = md.decoder
        return cls(
            vocab_size=d.vocab_size,
            embedding_size=d.embedding_size,
            model_dim=d.hidden_dim,
            num_layers=d.num_layers,
            num_heads=d.num_heads,
            mlp_ratio=d.mlp_ratio,
            max_positions=max(d.sentence_length, d.infer_max_length),
            vocab_pad_multiple=getattr(d, "vocab_pad_multiple", 1),
        )


def _init_ln(dim: int) -> Params:
    return {"g": torch.ones(dim), "b": torch.zeros(dim)}


def _init_attn(gen: torch.Generator, dim: int) -> Params:
    return {
        "wq": init_dense(gen, dim, dim),
        "wk": {"w": _xavier(gen, dim, dim)},  # no bias, as the reference
        "wv": init_dense(gen, dim, dim),
        "wo": init_dense(gen, dim, dim),
    }


def init(gen: torch.Generator, dims: TransformerDims) -> Params:
    """The reference's decoder param dict, the same shapes and scales, as CPU
    float32 tensors drawn from ``gen``."""
    E, D, V = dims.embedding_size, dims.model_dim, dims.padded_vocab
    out_bias = torch.zeros(V)
    out_bias[dims.vocab_size:] = -1e9  # padded vocab rows never win
    layers = [
        {
            "ln1": _init_ln(D),
            "attn": _init_attn(gen, D),
            "ln2": _init_ln(D),
            "xattn": _init_attn(gen, D),
            "ln3": _init_ln(D),
            "mlp": {
                "fc1": init_dense(gen, D, D * dims.mlp_ratio),
                "fc2": init_dense(gen, D * dims.mlp_ratio, D),
            },
        }
        for _ in range(dims.num_layers)
    ]
    lim = 1.0 / (E ** 0.5)
    return {
        "embedding": {"table": torch.empty((V, E)).uniform_(-lim, lim, generator=gen)},
        "in_proj": init_dense(gen, E, D),
        "pos": 0.02 * torch.randn((dims.max_positions, D), generator=gen),
        "layers": layers,
        "ln_f": _init_ln(D),
        "out_proj": init_dense(gen, D, E),
        "out_bias": out_bias,
    }


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """float32 LayerNorm, biased variance, eps 1e-6."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["g"] + p["b"]


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., T, D] -> [..., T, heads, d_head]"""
    return x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., T, heads, d_head] -> [..., T, D]"""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Attention logits ``q . k`` -> [B, h, Tq, Tk], accumulated and kept in
    float32, as kernels D and E keep them (the reference rounds them to the
    compute dtype; ``tests/test_torch_bf16_parity.py`` pins the difference)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def _attend(q, k, v, mask=None, v_scale=None):
    """Scaled dot-product attention: float32 scores and softmax, the weights
    rounded to the compute dtype, float32 accumulation (times ``v_scale``
    [h, d], int8 memory's V scale, if given), the result in it.

    q: [B, Tq, h, d]   k/v: [B, Tk, h, d]   mask: broadcastable [B?, Tq, Tk]
    """
    d = q.shape[-1]
    scores = _scores(q, k) / (d ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).float(), v.float())
    if v_scale is not None:
        out = out * v_scale
    return out.to(q.dtype)


class TransformerPre(NamedTuple):
    """Step-invariant per-image tensors: each layer's cross-attention K/V;
    int8 K/V carry their float32 scales, per layer ``[2, D]`` (K, V)."""

    mem_k: List[torch.Tensor]  # per layer: [B, M, heads, d_head]
    mem_v: List[torch.Tensor]  # per layer: [B, M, heads, d_head]
    kv_scale: Optional[List[torch.Tensor]] = None

    @property
    def batch(self) -> int:
        return self.mem_k[0].shape[0]


def precompute(params: Params, img_embed: torch.Tensor, global_feat: torch.Tensor,
               n_heads: int, compute_dtype=torch.bfloat16) -> TransformerPre:
    """img_embed [B, k, D] and global_feat [B, D] -> the memory [B, k+1, D]
    and its per-layer K/V projections."""
    dt = compute_dtype
    mem = torch.cat([img_embed.to(dt), global_feat.to(dt)[:, None, :]], dim=1)
    ks, vs = [], []
    for layer in params["layers"]:
        xa = layer["xattn"]
        ks.append(_split_heads(L.dense(xa["wk"], mem, dt), n_heads))
        vs.append(_split_heads(L.dense(xa["wv"], mem, dt), n_heads))
    return TransformerPre(ks, vs)


def quantize_kv_pre(pre: TransformerPre) -> TransformerPre:
    """int8 quantize-dequantize of the cross-attention memory on kernel D's
    ``quantize_kv`` grid: a symmetric absmax / 127 scale per (layer, K|V,
    channel) over every (image, slot) position."""

    def qdq(x):  # [B, M, heads, dh]: the channels are heads * dh
        flat = x.reshape(*x.shape[:2], -1).float()
        s = torch.clamp(flat.abs().amax(dim=(0, 1), keepdim=True) / 127.0, min=1e-12)
        return (torch.clamp(torch.round(flat / s), -127, 127) * s).to(x.dtype).reshape(x.shape)

    return TransformerPre([qdq(k) for k in pre.mem_k], [qdq(v) for v in pre.mem_v])


def prepare_decode_layers(params: Params) -> List[Params]:
    """Decode-time layer views with the self-attention q/k/v projections
    concatenated into one ``[D, 3D]`` weight (``wqkv``), with a zero bias
    for the bias-free ``wk``: the same three products. int8 weights
    concatenate with their per-output-channel scales."""
    out = []
    for layer in params["layers"]:
        a = layer["attn"]
        parts, q = [a["wq"], a["wk"], a["wv"]], is_quantized(a["wq"])
        w = torch.cat([p["w_q" if q else "w"] for p in parts], dim=1)
        wqkv = {"w_q": w, "scale": torch.cat([p["scale"] for p in parts])} if q else {"w": w}
        zeros = torch.zeros(dense_in_dim(a["wq"]), device=w.device)
        wqkv["b"] = torch.cat([a["wq"].get("b", zeros), zeros, a["wv"].get("b", zeros)])
        out.append({**layer, "attn": {**a, "wqkv": wqkv}})
    return out


def _block(layer: Params, x: torch.Tensor, mem_k, mem_v, n_heads: int, dt,
           self_mask=None, cache=None, cache_index=None, kv_scale=None):
    """One pre-LN block on the float32 residual stream x [B, T, D]. With
    ``cache`` (decode, x [B, 1, D]) the new K/V are written into the caches
    in place at ``cache_index`` and attention runs over slots <= it. With
    ``kv_scale`` ([2, D]: int8 memory's K and V scales) K's scale multiplies
    the query in float32 (then rounded to ``dt``) and V's the float32
    context, as kernel D folds them."""
    a = layer["attn"]
    h = _layer_norm(layer["ln1"], x)
    if "wqkv" in a:  # decode-prepared fused projection
        qkv = L.dense(a["wqkv"], h, dt)
        D = qkv.shape[-1] // 3
        q, k_new, v_new = (_split_heads(qkv[..., i * D:(i + 1) * D], n_heads)
                           for i in range(3))
    else:
        q = _split_heads(L.dense(a["wq"], h, dt), n_heads)
        k_new = _split_heads(L.dense(a["wk"], h, dt), n_heads)
        v_new = _split_heads(L.dense(a["wv"], h, dt), n_heads)
    if cache is None:
        sa = _attend(q, k_new, v_new, self_mask)
    else:
        ck, cv = cache  # [B, T_max, heads, d]
        ck[:, cache_index] = k_new[:, 0]
        cv[:, cache_index] = v_new[:, 0]
        valid = (torch.arange(ck.shape[1], device=ck.device) <= cache_index)[None, None, :]
        sa = _attend(q, ck, cv, valid)
    x = x + L.dense(a["wo"], _merge_heads(sa), dt).float()

    xa = layer["xattn"]
    h = _layer_norm(layer["ln2"], x)
    qx = _split_heads(L.dense(xa["wq"], h, dt), n_heads)
    v_scale = None
    if kv_scale is not None:
        qx = (qx.float() * _split_heads(kv_scale[0], n_heads)).to(dt)
        v_scale = _split_heads(kv_scale[1], n_heads)
    x = x + L.dense(xa["wo"], _merge_heads(_attend(qx, mem_k, mem_v, v_scale=v_scale)), dt).float()

    h = _layer_norm(layer["ln3"], x)
    h = F.gelu(L.dense(layer["mlp"]["fc1"], h, dt).float(), approximate="tanh").to(dt)
    return x + L.dense(layer["mlp"]["fc2"], h, dt).float()


def _embed_in(params: Params, ids: torch.Tensor, positions, padding_idx: int, dt):
    """ids [..., T] -> residual stream [..., T, D] (float32); the padding id
    embeds to zero."""
    emb = L.embed(params["embedding"], ids, padding_idx)
    x = L.dense(params["in_proj"], emb, dt).float()
    return x + params["pos"][positions]


def head_proj(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Final LN -> out_proj D->E, in the compute dtype."""
    return L.dense(params["out_proj"], _layer_norm(params["ln_f"], x), compute_dtype)


def head_logits(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Final LN -> out_proj -> tied table head -> [..., V] float32 (the
    product accumulated and kept in float32; an int8 table's product rounded
    to the compute dtype, then times the row scale in float32, as the
    reference)."""
    dt = compute_dtype
    proj = head_proj(params, x, dt)
    emb = params["embedding"]
    if is_quantized(emb):
        logits = torch.matmul(proj.float(), emb["table_q"].to(dt).float().T).to(dt).float()
        return logits * emb["scale"] + params["out_bias"]
    return torch.matmul(proj.float(), emb["table"].to(dt).float().T) + params["out_bias"]


def teacher_forcing_logits(params: Params, pre: TransformerPre, source: torch.Tensor,
                           dims: TransformerDims, padding_idx: int = 0,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """All T steps at once with causal self-attention -> logits [B, T, V]
    float32: the training forward (``captioner.loss_terms`` differentiates
    it) and the plain version kernels D and E are held against."""
    B, T = source.shape
    dt = compute_dtype
    dev = source.device
    x = _embed_in(params, source, torch.arange(T, device=dev), padding_idx, dt)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
    for l, (layer, mk, mv) in enumerate(zip(params["layers"], pre.mem_k, pre.mem_v)):
        x = _block(layer, x, mk, mv, dims.num_heads, dt, causal,
                   kv_scale=None if pre.kv_scale is None else pre.kv_scale[l])
    return head_logits(params, x, dt)


def _init_cache(dims: TransformerDims, batch: int, max_length: int, dt, device):
    shape = (batch, max_length, dims.num_heads, dims.head_dim)
    return [(torch.zeros(shape, dtype=dt, device=device),
             torch.zeros(shape, dtype=dt, device=device))
            for _ in range(dims.num_layers)]


def _decode_step(params: Params, pre: TransformerPre, dims: TransformerDims,
                 word: torch.Tensor, caches, t: int, padding_idx: int, dt, layers=None):
    """One KV-cached decode step -> x_last [B, D] float32 (caches updated in
    place)."""
    pos = torch.tensor([t], device=word.device)
    x = _embed_in(params, word[:, None], pos, padding_idx, dt)  # [B, 1, D]
    for l, (layer, mk, mv, cache) in enumerate(zip(
            params["layers"] if layers is None else layers, pre.mem_k, pre.mem_v, caches)):
        x = _block(layer, x, mk, mv, dims.num_heads, dt, None, cache=cache, cache_index=t,
                   kv_scale=None if pre.kv_scale is None else pre.kv_scale[l])
    return x[:, 0, :]


def greedy_decode_ids(params: Params, pre: TransformerPre, dims: TransformerDims,
                      max_length: int, start_idx: int = 2, padding_idx: int = 0,
                      compute_dtype=torch.bfloat16, use_kernels: bool = False,
                      early_stop: bool = False, stop_idx: int = 3,
                      packed=None, quantize_kv: bool = False) -> torch.Tensor:
    """Greedy decode -> int32 ids [B, max_length]. ``early_stop``: done rows
    emit ``<pad>``, a row is done once it has emitted ``<stop>``, and the
    loop ends when every row is done (later positions stay ``<pad>``).
    ``use_kernels``: the whole decode is kernel D, on the weights
    ``packed`` once by ``fused_transformer.pack_weights`` if given.
    ``quantize_kv``: the cross-attention memory on an int8 grid (kernel D
    streams it as int8; the plain loop quantizes and dequantizes it)."""
    dt = compute_dtype
    if use_kernels:
        from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

        ftp = FT.prepare(params, pre, dims.num_heads, dt, packed, quantize_kv=quantize_kv)
        return FT.fused_greedy_decode(ftp, max_length, dims.num_heads, start_idx,
                                      padding_idx, dt, early_stop=early_stop,
                                      stop_idx=stop_idx)
    if quantize_kv:
        pre = quantize_kv_pre(pre)
    B = pre.batch
    dev = pre.mem_k[0].device
    word = torch.full((B,), start_idx, dtype=torch.long, device=dev)
    caches = _init_cache(dims, B, max_length, dt, dev)
    layers = prepare_decode_layers(params)
    ids = torch.full((B, max_length), padding_idx, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_length):
        if early_stop and bool(done.all()):
            break
        x_last = _decode_step(params, pre, dims, word, caches, t, padding_idx, dt, layers)
        nxt = torch.argmax(head_logits(params, x_last, dt), dim=-1)
        if early_stop:
            nxt = torch.where(done, torch.full_like(nxt, padding_idx), nxt)
            done = done | (nxt == stop_idx)
        ids[:, t] = nxt.to(torch.int32)
        word = nxt
    return ids


def beam_search_ids(params: Params, pre: TransformerPre, dims: TransformerDims,
                    max_length: int, beam_size: int = 4, start_idx: int = 2,
                    stop_idx: int = 3, padding_idx: int = 0, length_norm: float = 0.0,
                    compute_dtype=torch.bfloat16, use_kernels: bool = False,
                    early_stop: bool = False,
                    packed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with the beams folded into the batch, the semantics of
    ``inference/beam.py`` (finished beams extend only with ``<pad>`` at zero
    cost; GNMT ``length_norm``; ``early_stop`` ends once every beam is
    finished) -> (ids int32 [B, T] of the best beam, scores float32 [B]).
    The plain path gathers the KV caches with the beams on reorder;
    ``use_kernels`` runs the whole search as kernel E (``packed`` as in
    ``greedy_decode_ids``)."""
    B, W, dt = pre.batch, beam_size, compute_dtype
    if use_kernels:
        from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

        ftp = FT.prepare(params, pre, dims.num_heads, dt, packed)
        words_tm, srcs_tm, scores, lengths = FT.fused_beam_decode(
            ftp, max_length, dims.num_heads, W, start_idx, padding_idx, stop_idx, dt,
            early_stop=early_stop)
        return beam_backtrack(words_tm, srcs_tm, scores, lengths, length_norm)

    dev = pre.mem_k[0].device
    emb = params["embedding"]
    V = (emb["table_q"] if is_quantized(emb) else emb["table"]).shape[0]
    pre_t = TransformerPre([k.repeat_interleave(W, dim=0) for k in pre.mem_k],
                           [v.repeat_interleave(W, dim=0) for v in pre.mem_v])
    word = torch.full((B * W,), start_idx, dtype=torch.long, device=dev)
    caches = _init_cache(dims, B * W, max_length, dt, dev)
    layers = prepare_decode_layers(params)
    scores = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0  # only beam 0 is live at first
    finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.long, device=dev)
    batch_offsets = (torch.arange(B, device=dev) * W)[:, None]
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[padding_idx] = 0.0
    words = torch.full((max_length, B, W), padding_idx, dtype=torch.long, device=dev)
    srcs = torch.arange(W, device=dev).expand(max_length, B, W).clone()
    for t in range(max_length):
        if early_stop and bool(finished.all()):
            break  # the rest keeps <pad> words and identity back-pointers
        x_last = _decode_step(params, pre_t, dims, word, caches, t, padding_idx, dt, layers)
        logp = torch.log_softmax(head_logits(params, x_last, dt), dim=-1).reshape(B, W, V)
        logp = torch.where(finished[..., None], pad_only, logp)
        cand = scores[..., None] + logp  # [B, W, V]
        scores, top_flat = topk_stable(cand.reshape(B, W * V), W)
        src_beam = top_flat // V
        new_word = top_flat % V
        gather = (batch_offsets + src_beam).reshape(-1)
        caches = [(ck[gather], cv[gather]) for ck, cv in caches]
        prev_finished = finished.gather(1, src_beam)
        finished = prev_finished | (new_word == stop_idx)
        lengths = lengths.gather(1, src_beam) + (~prev_finished).long()
        word = new_word.reshape(-1)
        words[t], srcs[t] = new_word, src_beam
    return beam_backtrack(words, srcs, scores, lengths, length_norm)



# ---- int8 serving ----------------------------------------------------------------


def quantize_transformer_decoder(decoder_params: Params) -> Params:
    """int8 weight storage for serving, the reference's scheme: every dense
    ``[I, O]`` weight (``in_proj``, ``out_proj``, each layer's attention,
    cross-attention and MLP) gets a per-output-channel scale, the tied table
    a per-row scale; biases, LayerNorms, positions and ``out_bias`` stay."""

    def q_dense(p):
        p = dict(p)
        p["w_q"], p["scale"] = quantize_weight(p.pop("w"), axis=0)
        return p

    q = dict(decoder_params)
    q["in_proj"] = q_dense(q["in_proj"])
    q["out_proj"] = q_dense(q["out_proj"])
    q["layers"] = [{name: (sub if name.startswith("ln") else
                           {k: (q_dense(v) if "w" in v else v) for k, v in sub.items()})
                    for name, sub in layer.items()} for layer in q["layers"]]
    emb = dict(q["embedding"])
    emb["table_q"], emb["scale"] = quantize_weight(emb.pop("table"), axis=1)  # per row
    q["embedding"] = emb
    return q

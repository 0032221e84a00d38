"""Vocab tensor parallelism: the layers that touch the vocab-sized tensors,
each rank holding rows ``[lo, hi)`` of the tied table and of ``out_bias``
(``parallel/mesh.py``), as ``torch.autograd.Function``s over the model
group (``distributed.model_group``).

The JAX package gets these from GSPMD when it shards the table and the bias
over its ``model`` axis (``mesh.param_shardings``); here they are written
out, and both decoder families route through them when
``opts.vocab_parallel`` is set (``captioner.loss_terms``, the families'
``teacher_forcing_logits``):

- ``embed``: a masked local gather (ids outside the rank's rows, and
  ``padding_idx``, read zeros), summed over the model group in the forward;
  the backward is the identity, so each rank's table gradient lands on its
  own rows;
- ``head_input``: the identity forward, and a sum over the model group in
  the backward: every rank's logits depend on the head's input, so its
  gradient (and every replicated param's) sums the ranks' vocab slices;
- ``cross_entropy``: the token CE over logits sharded by columns: the max
  of the local maxima, the sum of ``exp(l - max)``, the gold logit from its
  owning rank, each reduced over the model group; label smoothing's mean
  logit over the real vocab rows only (a rank sums its columns below
  ``vocab_size``). Its backward is the softmax less the targets, on the
  local columns;
- ``greedy_head`` / ``merge_argmax``: the greedy decode's head on the slice
  (kernel A with its winning logit on a card) and the merge of the ranks'
  (value, index) pairs: the largest value, ties to the lowest global index,
  ``jnp.argmax``'s rule over the full vocab.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from myimagecaptioningmodel_tpu_torch.parallel import distributed


def _group():
    return distributed.model_group()


def vocab_offset(local_rows: int) -> int:
    """The first global row of this rank's slice of ``local_rows`` rows."""
    return distributed.model_index() * local_rows


class _ReduceForward(torch.autograd.Function):
    """Sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_sum_(x.clone(), _group())

    @staticmethod
    def backward(ctx, g):
        return g


class _ReduceBackward(torch.autograd.Function):
    """Identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_sum_(g.clone(), _group())


def embed(p, ids: torch.Tensor, padding_idx: Optional[int] = 0) -> torch.Tensor:
    """``layers.embed`` over a table sharded by rows: the rows of ``ids``
    from whichever rank holds them (zeros for ``padding_idx``)."""
    table = p["table"]
    vl = table.shape[0]
    local = ids - vocab_offset(vl)
    mask = (local >= 0) & (local < vl)
    if padding_idx is not None:
        mask = mask & (ids != padding_idx)
    rows = table[local.clamp(0, vl - 1)] * mask.unsqueeze(-1).to(table.dtype)
    return _ReduceForward.apply(rows)


def head_input(x: torch.Tensor) -> torch.Tensor:
    """The input of the vocab head (see the module docstring)."""
    return _ReduceBackward.apply(x)


class _CrossEntropy(torch.autograd.Function):
    """(local logits [..., V_local], targets [...], real vocab, smoothing) ->
    the per-token CE [...] of the full logits, on every rank."""

    @staticmethod
    def forward(ctx, logits, target, real_v: int, eps: float):
        group = _group()
        vl = logits.shape[-1]
        lo = vocab_offset(vl)
        m = distributed.all_reduce_max_(logits.detach().amax(-1).clone(), group)
        e = torch.exp(logits - m.unsqueeze(-1))
        local_t = target - lo
        owns = (local_t >= 0) & (local_t < vl)
        gold = logits.gather(-1, local_t.clamp(0, vl - 1).unsqueeze(-1))[..., 0]
        sums = [e.sum(-1), torch.where(owns, gold, torch.zeros_like(gold))]
        n_real = min(max(real_v - lo, 0), vl)
        if eps > 0.0:
            sums.append(logits[..., :n_real].sum(-1))
        sums = distributed.all_reduce_sum_(torch.stack(sums), group)
        logz = m + torch.log(sums[0])
        ce = logz - sums[1]
        if eps > 0.0:
            ce = (1.0 - eps) * ce + eps * (logz - sums[2] / real_v)
        ctx.save_for_backward(e / sums[0].unsqueeze(-1), local_t, owns)
        ctx.eps, ctx.n_real, ctx.real_v = eps, n_real, real_v
        return ce

    @staticmethod
    def backward(ctx, g):
        soft, local_t, owns = ctx.saved_tensors
        vl = soft.shape[-1]
        eps = ctx.eps
        d = soft.clone()
        hit = torch.where(owns, torch.full_like(g, 1.0 - eps), torch.zeros_like(g))
        d.scatter_add_(-1, local_t.clamp(0, vl - 1).unsqueeze(-1), -hit.unsqueeze(-1))
        if eps > 0.0:
            d[..., :ctx.n_real] -= eps / ctx.real_v
        return d * g.unsqueeze(-1), None, None, None


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, real_v: int,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token CE ``logz - gold`` (label smoothing ``eps``: ``(1 - eps) *
    ce + eps * (logz - mean over the real vocab)``) of logits sharded by
    columns -> [...] float, the same on every rank of the model group."""
    return _CrossEntropy.apply(logits, target, real_v, float(label_smoothing))


# ---- the greedy decode's head ------------------------------------------------------


def merge_argmax(value: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Each rank's winning (logit [B], global index [B]) -> the global argmax
    int32 [B]: the largest value, and on ties the lowest index. One
    all-gather of both over the model group."""
    B = value.shape[0]
    both = torch.stack([value.double(), index.double()], dim=0)
    got = distributed.all_gather_rows(both, _group())
    vals, idx = got[0::2], got[1::2]  # [ranks, B]
    best = vals.max(dim=0).values
    cand = torch.where(vals == best, idx, torch.full_like(idx, float("inf")))
    out = cand.min(dim=0).values
    return out.to(torch.int32).reshape(B)


def greedy_head(proj: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                logits_fn=None) -> torch.Tensor:
    """The greedy head over this rank's slice (``table`` [V_local, E],
    ``bias`` [V_local]) merged over the model group -> int32 [B] global ids.
    On a CUDA tensor, kernel A with its winning logit; on the CPU,
    ``logits_fn(proj)`` (the decoder family's own head on the slice), or
    kernel A's plain version."""
    lo = vocab_offset(table.shape[0])
    if proj.device.type == "cuda" or logits_fn is None:
        from myimagecaptioningmodel_tpu_torch.ops.kernels.vocab_head import greedy_vocab_argmax

        ids, val = greedy_vocab_argmax(proj, table, bias, with_value=True)
    else:
        logits = logits_fn(proj)
        ids = torch.argmax(logits, dim=-1)
        val = logits.gather(-1, ids.unsqueeze(-1))[..., 0]
    return merge_argmax(val, ids.long() + lo)


class DecodePack(NamedTuple):
    """What a vocab-parallel greedy decode reads, gathered once per
    evaluation (``captioner.pack_decoder``)."""

    decoder: dict  # the decoder params with the full table and out_bias
    rows: Tuple[int, int]  # this rank's vocab rows [lo, hi)
    packed: Any = None  # kernel B's pack of ``decoder`` (LSTM on a card), else None


@torch.no_grad()
def full_decoder(dec: dict) -> dict:
    """A decoder params dict holding this rank's rows of the table and of
    ``out_bias`` -> the same dict with the full ones (one all-gather of each
    over the model group), and this rank's rows."""
    table, bias = dec["embedding"]["table"], dec["out_bias"]
    lo = vocab_offset(table.shape[0])
    full_t = distributed.all_gather_rows(table.detach(), _group())
    full_b = distributed.all_gather_rows(bias.detach(), _group())
    return ({**dec, "embedding": {**dec["embedding"], "table": full_t}, "out_bias": full_b},
            (lo, lo + table.shape[0]))

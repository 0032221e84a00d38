"""The training and decode steps on one device; port of
``myimagecaptioningmodel_tpu/parallel/train_step.py``: Adam with the
optional clip and params-EMA, gradient accumulation, the tree walkers, and
``build_steps``' train step and greedy dev decode (through the decoder
family's kernels when ``opts.use_kernels``).

Data parallelism (inside a process group, ``parallel/distributed.py``): each
process steps on its rows of the global batch, and the step reproduces the
JAX package's step on the whole global batch. Its loss is the global token
mean, so each rank differentiates its masked CE sum over the GLOBAL token
count (all-reduced up front; under accumulation the sum is divided once, at
the end), and the gradients (with the rank's loss share) are summed over
the ranks as one flat bucket once a step (``distributed.reduce_flat_``),
never as a mean of per-rank means: ranks hold different numbers of tokens.
Clip, Adam and the EMA then run on every rank alike. The train-mode BN
reduces its own statistics (``ops/layers.py``).

Vocab tensor parallelism (``opts.vocab_parallel``, a (data, model) grid of
``parallel/mesh.py``): the ranks of a model group hold the same rows and
each its own rows of the table and the output bias (and of their moments
and EMA). Every reduction above runs over the data group only (a reduction
over every process would count each row ``model_parallel`` times): the
replicated leaves' gradients are already equal across the model group (the
vocab-parallel head input sums them there), and each sharded leaf's rows
are summed over the data group like any other leaf. Clip, Adam and the EMA
are elementwise, so they run on each rank's shard unchanged.

The optimizer is optax's ``adam`` written out (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0), with the learning rate ``schedule(count)`` read at the count
*before* the update; an optional clip by value ahead of it and an optional
params-EMA after it, as ``make_optimizer`` chains them in the reference. Its
arithmetic runs as ``torch._foreach_*`` ops over all leaves at once.

Unlike the reference's pure functions, ``train_step`` updates the params
tree and the optimizer state in place (no second copy of the weights and
moments) and returns them; it returns a new BN state tree, as the
reference does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from myimagecaptioningmodel_tpu_torch.models import captioner
from myimagecaptioningmodel_tpu_torch.models.captioner import ModelOptions
from myimagecaptioningmodel_tpu_torch.parallel import distributed

Params = Dict[str, Any]

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts (in sorted-key order) and lists or tuples (in
    index order, as the transformer's ``decoder/layers``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Leaves in ``tree_leaves`` order -> the nested dicts and lists of
    ``like`` (dict keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts and lists (tuples come back as
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class EmaState(NamedTuple):
    """State of the params-EMA tracker: the averaged params tree."""

    ema: dict


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: List[torch.Tensor]  # first moments, in tree_leaves order
    nu: List[torch.Tensor]  # second moments


class OptState(NamedTuple):
    adam: AdamState
    ema: Optional[EmaState]


def ema_params_from_opt_state(opt_state):
    """The EMA params tree of an optimizer state (nested tuples searched);
    None when absent."""
    if isinstance(opt_state, EmaState):
        return opt_state.ema
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = ema_params_from_opt_state(s)
            if found is not None:
                return found
    return None


class Optimizer:
    """optax's ``chain(clip(c), adam(schedule), params_ema_tracker(d))``, the
    clip and the EMA each optional."""

    def __init__(self, schedule: Callable[[int], float], clip: Optional[float] = None,
                 ema_decay: float = 0.0) -> None:
        self.schedule, self.clip, self.ema_decay = schedule, clip, ema_decay

    def init(self, params: Params) -> OptState:
        leaves = tree_leaves(params)
        zeros = [torch.zeros_like(p, requires_grad=False) for p in leaves]
        ema = None
        if self.ema_decay > 0.0:
            ema = EmaState(tree_map(lambda p: p.detach().clone(), params))
        return OptState(AdamState(0, zeros, [z.clone() for z in zeros]), ema)

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], state: OptState, params: Params) -> OptState:
        """One update: the params (``tree_leaves`` order matches ``grads``)
        and the moments change in place -> the new state."""
        leaves = tree_leaves(params)
        g = list(grads)
        if self.clip:
            g = [torch.clamp(x, -self.clip, self.clip) for x in g]
        count, mu, nu = state.adam
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        t = count + 1
        # u = -lr(count) * mu_hat / (sqrt(nu_hat) + eps)
        denom = torch._foreach_div(nu, 1.0 - B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, 1.0 - B1 ** t)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -self.schedule(count))
        ema = state.ema
        if ema is not None:  # ema = d * ema + (1 - d) * (params + updates)
            d = self.ema_decay
            e_leaves = tree_leaves(ema.ema)
            torch._foreach_mul_(e_leaves, d)
            torch._foreach_add_(e_leaves, torch._foreach_add(leaves, upd), alpha=1.0 - d)
        torch._foreach_add_(leaves, upd)
        return OptState(AdamState(t, mu, nu), ema)


def make_optimizer(cfg, schedule) -> Optimizer:
    """Adam + optional by-value clip (reference train.py:26-31,42-43) +
    optional params-EMA (cfg.train.ema_decay)."""
    clip = cfg.train.gradient_clip
    return Optimizer(schedule, clip=float(clip) if clip else None,
                     ema_decay=float(cfg.train.ema_decay))


class TrainStepFns(NamedTuple):
    train_step: Callable  # (params, opt_state, model_state, step, imgs, caps) -> (params, opt_state, model_state, step, loss, lr)
    decode_step: Callable  # (params, model_state, imgs, packed=None) -> ids


def build_steps(opts: ModelOptions, optimizer: Optimizer, schedule,
                grad_accum_steps: int = 1) -> TrainStepFns:
    """The train and decode steps on this process's device.

    ``grad_accum_steps > 1`` runs forward and backward over N sequential
    microbatches and applies one Adam update to the gradient of the summed
    CE over the GLOBAL token count, the whole-batch token-mean objective; the
    BN state threads through the microbatches. Inside a process group the
    step is data-parallel (module docstring); in a group of one its bits are
    those of one process without a group."""

    def grads_and_loss(params, model_state, images, captions):
        leaves = tree_leaves(params)
        images = torch.as_tensor(images)
        captions = torch.as_tensor(captions)
        a = grad_accum_steps
        dp = distributed.active()
        n_global = None
        if dp:  # the global token count, as loss_terms counts tokens
            n_global = distributed.all_reduce_sum_(
                (captions[:, 1:] != opts.padding_idx).float().sum().to(
                    params["img_embed"]["w"].device), distributed.data_group())
        g_sum = [torch.zeros_like(p) for p in leaves]
        got = [False] * len(leaves)
        ce_total, tok_total, mstate = 0.0, 0.0, model_state
        for im, cp in zip(images.chunk(a), captions.chunk(a)):
            ce_sum, n_tok, mstate = captioner.loss_terms(params, mstate, im, cp, opts)
            if a == 1:  # the token mean itself, as the reference differentiates it
                ce_sum = ce_sum / torch.clamp(n_tok if n_global is None else n_global,
                                              min=1.0)
            g = torch.autograd.grad(ce_sum, leaves, allow_unused=True)
            for i, gi in enumerate(g):
                if gi is not None:  # None: a frozen encoder's params
                    g_sum[i] += gi
                    got[i] = True
            ce_total = ce_total + ce_sum.detach()
            tok_total = tok_total + n_tok
        if dp:  # one bucket: every gradient that exists, and the loss share
            live = [i for i in range(len(leaves)) if got[i]]
            summed = distributed.reduce_flat_(
                [g_sum[i] for i in live] + [ce_total.to(leaves[0].dtype).reshape(1)],
                distributed.data_group())
            for i, t in zip(live, summed):
                g_sum[i] = t
            ce_total = summed[-1].reshape(()).to(ce_total.dtype)
            tok_total = n_global
        if a == 1:
            return g_sum, ce_total, mstate
        denom = torch.clamp(tok_total, min=1.0)
        return [g / denom for g in g_sum], ce_total / denom, mstate

    def train_step(params, opt_state, model_state, step, images, captions):
        grads, loss, new_model_state = grads_and_loss(params, model_state, images, captions)
        new_opt_state = optimizer.apply(grads, opt_state, params)
        return params, new_opt_state, new_model_state, step + 1, loss, schedule(step)

    def decode_step(params, model_state, images, packed=None):
        return captioner.greedy_decode_tree(params, model_state, images, opts, packed)

    return TrainStepFns(train_step, decode_step)

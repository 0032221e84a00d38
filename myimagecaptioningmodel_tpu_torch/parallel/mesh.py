"""The (data, model) grid of processes, described as the JAX package's mesh
describes its devices; the counterpart of
``myimagecaptioningmodel_tpu/parallel/mesh.py``.

In the JAX package a ``Mesh`` of (data, model) axes carries the sharding,
and GSPMD inserts the collectives. In the port each process owns one device:
``make_mesh`` lays the processes out as a (data, model) grid, ``rank = d *
model_parallel + m`` in the order of JAX's ``reshape(n // mp, mp)``, and
makes its groups (``distributed.set_grid``). Along ``data`` the processes
hold different rows of every global batch (``shard_batch``); along
``model`` (vocab tensor parallelism, ``train.model_parallel`` > 1) they hold
the same rows and each keeps one slice of the vocab-sized tensors, the tied
embedding table ``[V_pad, E]`` and ``out_bias [V_pad]``, with their Adam
moments and EMA (``param_shardings``, ``opt_state_shardings``); everything
else is replicated. ``shard_state`` keeps this rank's rows of full trees and
``gather_state`` puts the full trees back together, so checkpoints and
bundles have one format at every ``model_parallel``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import torch

from myimagecaptioningmodel_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the vocab-sized leaves, by tree path (never by shape: mesh.py:76-105)
VOCAB_SHARDED = ("decoder/embedding/table", "decoder/out_bias")


class Mesh(NamedTuple):
    """The (data, model) grid as this process sees it."""

    size: int  # processes along the data axis (that hold different rows)
    rank: int  # this process's data index
    device: torch.device  # this process's device
    model_size: int = 1  # processes along the model axis (vocab slices)
    model_rank: int = 0  # this process's vocab slice

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

    @property
    def data_group(self):
        """The processes of this one's model index (None: every process)."""
        return distributed.data_group()

    @property
    def model_group(self):
        """The processes that share this one's rows (None outside a grid)."""
        return distributed.model_group()


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """Rows ``[lo, hi)`` of a vocab-sharded leaf on this rank (a leaf of the
    shardings trees, not a tuple that the tree walkers would descend)."""

    lo: int
    hi: int


def make_mesh(device: Optional[torch.device] = None, model_parallel: int = 1) -> Mesh:
    """The grid of the current process group (one process outside one);
    ``device`` defaults to this process's GPU. A ``model_parallel`` that
    does not divide the process count is a ``ValueError``, as in the JAX
    package; vocab tensor parallelism across hosts is refused, as there."""
    n = distributed.process_count()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the {n} processes")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if model_parallel > 1 and local < n:
        raise NotImplementedError(
            "vocab-TP + multi-host in one run is not supported: checkpoint writes gather "
            "the TP-sharded params over the model group (use TP within a host, DP across)")
    if device is None:
        device = distributed.local_device()
    if distributed.active():
        distributed.set_grid(model_parallel)
    return Mesh(distributed.data_size(), distributed.data_index(), torch.device(device),
                model_parallel, distributed.model_index())


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global host batch, on the mesh's device."""
    out = tuple(torch.as_tensor(distributed.local_rows(a)).to(mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]


# ---- vocab tensor parallelism --------------------------------------------------------


def vocab_rows(mesh: Mesh, padded_vocab: int) -> VocabShard:
    """This rank's rows of a ``padded_vocab``-row table. A padded vocab that
    ``model_parallel`` does not divide is a ``ValueError`` (``loop.py:312-317``)."""
    mp = mesh.model_size
    if padded_vocab % mp:
        raise ValueError(f"padded vocab {padded_vocab} not divisible by model_parallel={mp}; "
                         "set model.decoder.vocab_pad_multiple to a multiple")
    per = padded_vocab // mp
    return VocabShard(mesh.model_rank * per, (mesh.model_rank + 1) * per)


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """``/``-joined paths of the leaves, in ``train_step.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _path_map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _path_map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_path_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_shardings(mesh: Mesh, params):
    """A tree like ``params``: ``VocabShard`` (this rank's rows) for the tied
    table and the output bias when the model axis is above 1, None
    (replicated) for every other leaf."""
    if mesh.model_size == 1 or "decoder" not in params:
        return _path_map(lambda p, leaf: None, params)
    rows = vocab_rows(mesh, params["decoder"]["embedding"]["table"].shape[0])
    return _path_map(lambda p, leaf: rows if p in VOCAB_SHARDED else None, params)


def opt_state_shardings(mesh: Mesh, opt_state, params, p_shardings):
    """The optimizer state's shardings, matched to the params' by tree path:
    Adam's moments are lists in ``tree_leaves`` order of the params, so
    moment i takes the sharding of param path i; the EMA tree mirrors the
    params. The count is replicated -> ``OptState`` of the same shape."""
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        AdamState, EmaState, OptState, tree_leaves,
    )

    by_leaf = tree_leaves(p_shardings) if isinstance(p_shardings, dict) else None
    if by_leaf is None or len(by_leaf) != len(leaf_paths(params)):
        raise ValueError("p_shardings does not mirror params")
    ema = None
    if opt_state.ema is not None:
        ema = EmaState(p_shardings)
    return OptState(AdamState(None, list(by_leaf), list(by_leaf)), ema)


@torch.no_grad()
def _rows_of(t: torch.Tensor, sh: Optional[VocabShard]) -> torch.Tensor:
    return t if sh is None else t[sh.lo:sh.hi].clone()


def shard_state(mesh: Mesh, params, opt_state):
    """Full (params, opt_state) -> this rank's: the vocab-sharded leaves keep
    their rows (fresh leaves; params keep ``requires_grad`` as they had it).
    Identity at ``model_size`` 1."""
    if mesh.model_size == 1:
        return params, opt_state
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        AdamState, EmaState, OptState, tree_leaves, tree_unflatten,
    )

    p_sh = param_shardings(mesh, params)
    o_sh = opt_state_shardings(mesh, opt_state, params, p_sh)
    count, mu, nu = opt_state.adam
    adam = AdamState(count, [_rows_of(t, s) for t, s in zip(mu, o_sh.adam.mu)],
                     [_rows_of(t, s) for t, s in zip(nu, o_sh.adam.nu)])
    ema = None
    if opt_state.ema is not None:
        ema = EmaState(tree_unflatten(opt_state.ema.ema, [
            _rows_of(t, s) for t, s in zip(tree_leaves(opt_state.ema.ema), tree_leaves(p_sh))]))
    return shard_params(mesh, params), OptState(adam, ema)


def shard_params(mesh: Mesh, params):
    """Full params -> this rank's (``shard_state`` without an optimizer
    state; every leaf keeps ``requires_grad`` as it had it)."""
    if mesh.model_size == 1:
        return params
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves, tree_unflatten

    leaves = []
    for p, s in zip(tree_leaves(params), tree_leaves(param_shardings(mesh, params))):
        leaves.append(_rows_of(p, s).requires_grad_(p.requires_grad))
    return tree_unflatten(params, leaves)


@torch.no_grad()
def _gather(t: torch.Tensor, sharded: bool) -> torch.Tensor:
    if not sharded:
        return t
    return distributed.all_gather_rows(t.detach(), distributed.model_group())


def gather_state(mesh: Mesh, params, opt_state):
    """This rank's (params, opt_state) -> the full trees (an all-gather over
    the model group per vocab-sharded leaf; every rank of the group takes
    part), detached, in ``checkpoint_arrays``' and ``reference_tree``'s
    format. Identity at ``model_size`` 1."""
    if mesh.model_size == 1:
        return params, opt_state
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        AdamState, EmaState, OptState, tree_leaves, tree_unflatten,
    )

    sh = [p in VOCAB_SHARDED for p in leaf_paths(params)]
    full = tree_unflatten(params, [_gather(t, s) for t, s in zip(tree_leaves(params), sh)])
    count, mu, nu = opt_state.adam
    adam = AdamState(count, [_gather(t, s) for t, s in zip(mu, sh)],
                     [_gather(t, s) for t, s in zip(nu, sh)])
    ema = None
    if opt_state.ema is not None:
        ema = EmaState(tree_unflatten(opt_state.ema.ema, [
            _gather(t, s) for t, s in zip(tree_leaves(opt_state.ema.ema), sh)]))
    return full, OptState(adam, ema)

"""Checkpoints and inference bundles; port of
``myimagecaptioningmodel_tpu/training/checkpoint.py``.

A **checkpoint** (the training half) is a directory holding:

- ``state.npz``: ``{"params", "opt_state", "model_state"}`` flattened to
  ``/``-joined keys, as a bundle's params are, in the reference layout
  (dense ``[in, out]``, conv HWIO). ``opt_state`` holds Adam's ``count``
  and its moments ``mu`` and ``nu`` as params-shaped trees, and the
  params-EMA as ``ema`` when the optimizer keeps one;
- ``meta.json``: the run metadata (next epoch, step, mid-epoch batches,
  best BLEU, encoder trainability), so resume state travels with it;
- ``COMMITTED``, written last.

``AsyncCheckpointWriter`` takes the host copy in ``save()`` and writes in a
thread; ``convert_jax_checkpoint`` turns a JAX checkpoint (``state.msgpack``,
optax's state) into a port checkpoint. ``save_params``/``load_params`` and
``graft_subtree`` are the bare-params file and the partial load (a
pretrained encoder onto fresh params).

An **inference bundle** is a directory holding:

- ``params.npz``: the reference's ``{"params": .., "model_state": ..}``
  pytree, flattened to ``/``-joined keys (``params/decoder/lstm/w``), in the
  reference's layouts (dense ``[in, out]``, conv HWIO). numpy reads it, so a
  bundle loads with no JAX, flax or msgpack installed;
- ``config.json``: the serialized ``Config``;
- the vocab files (``word2idx.json``, ``idx2word.json``, ``word_dict.npy``);
- ``COMMITTED``, written last.

Publishing keeps the reference's crash-atomic contract for both: the
directory is written into ``<dir>.tmp``, the previous version is renamed
aside to ``<dir>.old`` before the new one is renamed in, and ``_recover``
promotes whichever complete copy survives a crash. ``convert_jax_bundle``
turns a JAX bundle (``params.msgpack``) into a port bundle in one call.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

PARAMS_FILE = "params.npz"
CKPT_FILE = "state.npz"
META_FILE = "meta.json"
CONFIG_FILE = "config.json"
COMMIT_FILE = "COMMITTED"  # written last into .tmp: marks the dir complete
VOCAB_FILES = ("word2idx.json", "idx2word.json", "word_dict.npy")


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": numpy array}; a list or tuple is keyed by its
    indices, as flax stores one (``compat/from_jax.tree_to_torch`` reads it
    back as a list)."""
    flat: Dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else ((str(i), v) for i, v in enumerate(tree))
    for k, v in items:
        if "/" in k:
            raise ValueError(f"pytree key {k!r} contains '/'")
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _commit_swap(tmp: str, directory: str) -> None:
    """Publish a fully written ``tmp`` as ``directory`` without a moment in
    which no loadable bundle exists."""
    old = directory + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.rename(directory, old)
    os.rename(tmp, directory)
    shutil.rmtree(old, ignore_errors=True)


def _is_complete(directory: str) -> bool:
    """A directory is a finished artifact iff its COMMITTED marker is there."""
    return os.path.exists(os.path.join(directory, COMMIT_FILE))


def _recover(directory: str) -> None:
    """Promote a surviving complete ``.tmp`` / ``.old`` after a crashed swap."""
    tmp, old = directory + ".tmp", directory + ".old"
    if _is_complete(directory):
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.rmtree(old, ignore_errors=True)
        return
    if os.path.exists(directory):  # incomplete: discard
        shutil.rmtree(directory)
    if _is_complete(tmp) and any(os.path.exists(os.path.join(tmp, f))
                                 for f in (PARAMS_FILE, CKPT_FILE)):
        os.rename(tmp, directory)
        shutil.rmtree(old, ignore_errors=True)
        return
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if _is_complete(old):
        os.rename(old, directory)


# ---- checkpoints -------------------------------------------------------------


def checkpoint_arrays(params, opt_state, model_state) -> Dict[str, np.ndarray]:
    """The host copy a checkpoint holds: port training trees (tensors, convs
    OIHW; ``opt_state`` a ``train_step.OptState``) -> flat numpy arrays in
    the reference layout. Copies: later in-place updates of the tensors do
    not reach them."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_layout, to_numpy
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_unflatten

    count, mu, nu = opt_state.adam
    opt = {"count": np.asarray(count, np.int32),
           "mu": reference_layout(tree_unflatten(params, mu)),
           "nu": reference_layout(tree_unflatten(params, nu))}
    if opt_state.ema is not None:
        opt["ema"] = reference_layout(opt_state.ema.ema)
    return flatten_tree({"params": reference_layout(params), "opt_state": opt,
                         "model_state": to_numpy(model_state)})


def write_checkpoint(directory: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    """Crash-atomic write of ``checkpoint_arrays``' output and ``meta``."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, CKPT_FILE), **arrays)
    with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
        f.write("ok")
    _commit_swap(tmp, directory)


def save_checkpoint(directory: str, params, opt_state, model_state, meta: Dict[str, Any]) -> None:
    """Crash-atomic full-checkpoint write (tmp + marker + rename dance)."""
    write_checkpoint(directory, checkpoint_arrays(params, opt_state, model_state), meta)


class AsyncCheckpointWriter:
    """Checkpoint writes off the training loop's thread.

    ``save(...)`` copies the trees to host memory synchronously (the train
    step updates the params and moments in place, so the copy must be taken
    before the next step) and hands the npz write and the crash-atomic
    directory swap to one background thread. At most one save is in flight;
    a new ``save`` waits for the previous one. ``wait()`` blocks until the
    pending save has landed and re-raises its error; a write error also
    surfaces at the next ``save``. ``snapshot_seconds`` and
    ``write_seconds`` hold the last save's time in ``save()`` and in the
    thread."""

    def __init__(self) -> None:
        self._thread = None
        self._error = None
        self.snapshot_seconds = self.write_seconds = 0.0

    def save(self, directory: str, params, opt_state, model_state, meta) -> None:
        self.wait()
        t0 = time.perf_counter()
        arrays = checkpoint_arrays(params, opt_state, model_state)
        meta = dict(meta)
        self.snapshot_seconds = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                write_checkpoint(directory, arrays, meta)
            except BaseException as e:  # surfaced at the next save() or wait()
                self._error = e
            self.write_seconds = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _paths(tree) -> set:
    return set(flatten_tree(_shape_only(tree)))


def _shape_only(tree):
    if isinstance(tree, dict):
        return {k: _shape_only(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_only(v) for v in tree]
    return 0


def load_checkpoint(directory: str, like_params, like_opt_state, like_model_state):
    """Restore a checkpoint into the structure, device and dtype of the
    templates -> (params, opt_state, model_state, meta). A checkpoint whose
    trees differ from the templates' (a leaf more or less, an EMA present in
    one and not the other) is an error."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import port_layout, tree_to_torch
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        AdamState, EmaState, OptState, tree_leaves,
    )

    _recover(directory)
    with np.load(os.path.join(directory, CKPT_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(directory, META_FILE), "r", encoding="utf-8") as f:
        meta = json.load(f)
    want = {"params/" + p for p in _paths(like_params)}
    want |= {"model_state/" + p for p in _paths(like_model_state)}
    want |= {"opt_state/count"} | {f"opt_state/{m}/{p}" for m in ("mu", "nu")
                                   for p in _paths(like_params)}
    if like_opt_state.ema is not None:
        want |= {"opt_state/ema/" + p for p in _paths(like_params)}
    if set(flat) != want:
        raise ValueError(f"checkpoint {directory} does not match the training state: "
                         f"missing {sorted(want - set(flat))[:5]}, "
                         f"unexpected {sorted(set(flat) - want)[:5]}")
    tree = unflatten_tree(flat)
    leaf = tree_leaves(like_params)[0]
    dev, dt = leaf.device, leaf.dtype
    params = port_layout(tree["params"], dev, dt)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = tree["opt_state"]
    adam = AdamState(int(opt["count"]), tree_leaves(port_layout(opt["mu"], dev, dt)),
                     tree_leaves(port_layout(opt["nu"], dev, dt)))
    ema = EmaState(port_layout(opt["ema"], dev, dt)) if "ema" in opt else None
    state_dt = tree_leaves(like_model_state)[0].dtype if tree_leaves(like_model_state) else dt
    model_state = tree_to_torch(tree["model_state"], dev, state_dt)
    return params, OptState(adam, ema), model_state, meta


def checkpoint_exists(directory: str) -> bool:
    _recover(directory)
    return os.path.exists(os.path.join(directory, CKPT_FILE))


def save_params(path: str, params) -> None:
    """The bare params of a training tree -> one npz file in the reference
    layout."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_layout

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flatten_tree(reference_layout(params)))


def load_params(path: str) -> Dict[str, Any]:
    """``save_params``' file -> nested numpy (reference layout)."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def graft_subtree(params, path: str, subtree_key: str):
    """Load saved params and graft ``saved[subtree_key]`` (or the whole file
    if it IS the subtree) onto ``params[subtree_key]`` — the pretrained-
    MobileNet partial load (reference util.get_predicate + load_vars,
    train.py:96-99, util.py:122-138). The grafted leaves take the device and
    dtype of the ones they replace and ``requires_grad``."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import port_layout
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

    loaded = load_params(path)
    want = _paths(params[subtree_key])
    if _paths(loaded) != want:
        if subtree_key not in loaded or _paths(loaded[subtree_key]) != want:
            raise ValueError(f"{path} holds neither the {subtree_key!r} subtree nor a "
                             f"params tree with it")
        loaded = loaded[subtree_key]
    leaf = tree_leaves(params[subtree_key])[0]
    sub = port_layout({subtree_key: loaded}, leaf.device, leaf.dtype)[subtree_key]
    for p in tree_leaves(sub):
        p.requires_grad_(leaf.requires_grad)
    return {**params, subtree_key: sub}


def _find(tree, keys: set):
    """The first dict (depth first, keys in index/sorted order) whose key
    set is ``keys``, else None."""
    if not isinstance(tree, dict):
        return None
    if set(tree) == keys:
        return tree
    for k in sorted(tree, key=lambda k: (not k.isdigit(), int(k) if k.isdigit() else 0, k)):
        found = _find(tree[k], keys)
        if found is not None:
            return found
    return None


def convert_jax_checkpoint(src: str, dst: str) -> None:
    """JAX checkpoint directory (``state.msgpack`` + ``meta.json``) -> port
    checkpoint at ``dst``. optax's state maps onto the port's: the
    ``ScaleByAdamState(count, mu, nu)`` of ``chain(clip?, adam, ema?)`` (the
    clip's and the schedule's own states carry nothing else), and the EMA
    tracker's tree; the meta passes through. Reads msgpack: it runs where
    the JAX package's files are made."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import read_msgpack

    payload = read_msgpack(os.path.join(src, "state.msgpack"))
    adam = _find(payload["opt_state"], {"count", "mu", "nu"})
    if adam is None:
        raise ValueError(f"no Adam state in {src}")
    opt = {"count": np.asarray(adam["count"], np.int32), "mu": adam["mu"], "nu": adam["nu"]}
    ema = _find(payload["opt_state"], {"ema"})
    if ema is not None:
        opt["ema"] = ema["ema"]
    with open(os.path.join(src, META_FILE), "r", encoding="utf-8") as f:
        meta = json.load(f)
    write_checkpoint(dst, flatten_tree({"params": payload["params"], "opt_state": opt,
                                        "model_state": payload["model_state"]}), meta)


# ---- inference bundles ----------------------------------------------------------


def export_inference_bundle(
    directory: str,
    params: Any,
    model_state: Any,
    cfg,
    vocab_src_dir: Optional[str] = None,
) -> None:
    """Self-contained decode artifact: params + BN state + config + vocab."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = flatten_tree({"params": params, "model_state": model_state})
    np.savez(os.path.join(tmp, PARAMS_FILE), **flat)
    with open(os.path.join(tmp, CONFIG_FILE), "w", encoding="utf-8") as f:
        f.write(cfg.to_json(indent=2))
    if vocab_src_dir:
        for name in VOCAB_FILES:
            src = os.path.join(vocab_src_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(tmp, name))
    with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
        f.write("ok")
    _commit_swap(tmp, directory)


def load_inference_bundle(directory: str) -> Tuple[Dict[str, Any], Dict[str, Any], Any]:
    """-> (params, model_state, cfg) with numpy leaves."""
    from myimagecaptioningmodel_tpu_torch.config import Config

    _recover(directory)
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path):
        hint = ""
        if os.path.exists(os.path.join(directory, "params.msgpack")):
            hint = (" (it holds a JAX bundle: convert it with "
                    "training.checkpoint.convert_jax_bundle)")
        raise FileNotFoundError(f"no {PARAMS_FILE} in {directory}{hint}")
    with np.load(path) as z:
        tree = unflatten_tree({k: z[k] for k in z.files})
    cfg = Config.from_json_file(os.path.join(directory, CONFIG_FILE))
    return tree.get("params", {}), tree.get("model_state", {}), cfg


def convert_jax_bundle(src: str, dst: str) -> None:
    """JAX bundle directory (``params.msgpack``) -> port bundle at ``dst``,
    with the same config and vocab files."""
    from myimagecaptioningmodel_tpu_torch.config import Config
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import read_jax_bundle

    params, model_state = read_jax_bundle(src)
    cfg = Config.from_json_file(os.path.join(src, CONFIG_FILE))
    export_inference_bundle(dst, params, model_state, cfg, vocab_src_dir=src)

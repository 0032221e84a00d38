"""Inference bundles; port of the bundle part of
``myimagecaptioningmodel_tpu/training/checkpoint.py``.

A port bundle is a directory holding:

- ``params.npz``: the reference's ``{"params": .., "model_state": ..}``
  pytree, flattened to ``/``-joined keys (``params/decoder/lstm/w``), in the
  reference's layouts (dense ``[in, out]``, conv HWIO). numpy reads it, so a
  bundle loads with no JAX, flax or msgpack installed;
- ``config.json``: the serialized ``Config``;
- the vocab files (``word2idx.json``, ``idx2word.json``, ``word_dict.npy``);
- ``COMMITTED``, written last.

Publishing keeps the reference's crash-atomic contract: the bundle is written
into ``<dir>.tmp``, the previous version is renamed aside to ``<dir>.old``
before the new one is renamed in, and ``_recover`` promotes whichever
complete copy survives a crash. ``convert_jax_bundle`` turns a JAX bundle
(``params.msgpack``) into a port bundle in one call.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

PARAMS_FILE = "params.npz"
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
    if _is_complete(tmp) and os.path.exists(os.path.join(tmp, PARAMS_FILE)):
        os.rename(tmp, directory)
        shutil.rmtree(old, ignore_errors=True)
        return
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if _is_complete(old):
        os.rename(old, directory)


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

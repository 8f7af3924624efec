"""Tree checkpointing in the reference's format (counterpart of
``repro.checkpointing.checkpoint``): a flat ``.npz`` payload plus ``.json``
metadata, keys the ``/``-joined dict keys and sequence indices of each
leaf's path, written under an atomic rename.  A file that
``repro.checkpointing.checkpoint.save`` wrote loads here.

A tree here is nested dicts, lists and tuples of tensors or numpy
arrays.  numpy has no bfloat16: the reference's bfloat16 leaves arrive
as raw 2-byte records, and the json's dtype names them, so ``load_flat``
gives them back as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, object]:
    if isinstance(tree, dict):
        items = sorted(tree.items())         # the reference's key order
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, object] = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                        else str(k)))
    return flat


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:        # as numpy holds it: raw bits
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, name: str = "state") -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    dtypes = {k: ("bfloat16" if isinstance(flat[k], torch.Tensor)
                  and flat[k].dtype == torch.bfloat16 else str(a.dtype))
              for k, a in arrays.items()}
    meta = {"step": step,
            "keys": {k: {"dtype": dtypes[k], "shape": list(a.shape)}
                     for k, a in arrays.items()}}
    path = os.path.join(directory, f"{name}_{step:08d}")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str, name: str = "state") -> int:
    if not os.path.isdir(directory):
        return -1
    steps = [int(f[len(name) + 1:-5]) for f in os.listdir(directory)
             if f.startswith(name + "_") and f.endswith(".json")]
    return max(steps) if steps else -1


def load_flat(directory: str, step: int,
              name: str = "state") -> Dict[str, torch.Tensor]:
    """``{key: CPU tensor}`` of one checkpoint, in its saved dtypes."""
    path = os.path.join(directory, f"{name}_{step:08d}")
    with open(path + ".json") as f:
        meta = json.load(f)["keys"]
    out = {}
    with np.load(path + ".npz") as data:
        for k, info in meta.items():
            arr = data[k]
            if info["dtype"] == "bfloat16":
                out[k] = torch.from_numpy(
                    arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(arr.copy())
            if list(out[k].shape) != info["shape"]:
                raise ValueError(f"checkpoint {path}: {k} has shape "
                                 f"{tuple(out[k].shape)}, metadata says "
                                 f"{info['shape']}")
    return out


def unflatten(flat: Dict[str, object]):
    """Nested dicts from ``/``-joined keys; a dict whose keys are exactly
    0..n-1 becomes a list."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def restore(directory: str, step: int, like_tree, name: str = "state"):
    """Restore into the structure of ``like_tree``: each leaf as a tensor
    of the like leaf's dtype, on its device (tensors) or the CPU."""
    flat = load_flat(directory, step, name)
    flat_like = _flatten_with_paths(like_tree)
    restored = {}
    for k, like in flat_like.items():
        t = flat[k]
        if tuple(t.shape) != tuple(np.shape(like)):
            raise ValueError(f"checkpoint leaf {k}: shape "
                             f"{tuple(t.shape)} != {tuple(np.shape(like))}")
        if isinstance(like, torch.Tensor):
            t = t.to(device=like.device, dtype=like.dtype)
        restored[k] = t
    return _rebuild(like_tree, restored, "")


def _rebuild(like, flat, prefix):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, key(i))
                          for i, v in enumerate(like))
    return flat[prefix]

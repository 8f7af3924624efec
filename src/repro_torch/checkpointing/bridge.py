"""Carry ``repro``'s DiT parameters into the port.

``repro`` keeps a pytree with layer-stacked blocks (``single`` /
``double`` leaves ``[n_layers, ...]``) and attention projections shaped
``wq/wk/wv [d, H, hd]``, ``wo [H, hd, d]``.  The port keeps per-layer
lists and ``[d, d]`` projections.  The tree arrives as numpy
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import DiTConfig

_ATTN_MATS = ("wq", "wk", "wv", "wo")


def _take(tree, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _block(tree, d: int):
    """One unstacked block: flatten the attention projections."""
    out = {k: (_block(v, d) if isinstance(v, dict) else v)
           for k, v in tree.items()}
    if "wq" in out:
        for name in _ATTN_MATS:
            out[name] = out[name].reshape(d, d)
    return out


def params_from_jax_numpy(tree, cfg: DiTConfig, device=None, dtype=None):
    """``repro`` DiT params (numpy pytree) -> the port's parameters on
    ``device`` (default ``cuda``), in ``dtype`` (default: as given)."""
    dev = device_lib.resolve(device)
    d = cfg.d_model

    def to_t(tree_):
        if isinstance(tree_, dict):
            return {k: to_t(v) for k, v in tree_.items()}
        if isinstance(tree_, list):
            return [to_t(v) for v in tree_]
        t = torch.tensor(np.asarray(tree_))   # copies: jax's are read-only
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = {k: v for k, v in tree.items() if k not in ("single", "double")}
    out["single"] = [_block(_take(tree["single"], i), d)
                     for i in range(cfg.n_layers)]
    if "double" in tree:
        out["double"] = [
            {s: _block(_take(tree["double"][s], i), d)
             for s in ("img", "txt")}
            for i in range(cfg.n_double)]
    return to_t(out)

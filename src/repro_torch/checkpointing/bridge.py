"""Carry ``repro``'s parameters into the port.

``repro`` keeps a pytree with layer-stacked blocks (the DiT's ``single``
/ ``double`` leaves ``[n_layers, ...]``; an LM's or backbone's
``stack`` leaves ``[n_groups, ...]`` under ``l{i}``; an enc-dec
model's ``encoder`` / ``decoder`` leaves ``[n_layers, ...]``) and
attention projections shaped ``wq/wk/wv [d, H, hd]``, ``wo [H, hd, d]``.  The
port keeps per-layer (per-group) lists and matrix projections.  The tree
arrives as numpy (``jax.tree.map(np.asarray, params)``) or as a
checkpoint file of the reference's format (``params_from_checkpoint``),
so this module needs no JAX.  ``params_to_jax_numpy`` and
``lm_params_to_jax_numpy`` go the other way, so that a checkpoint the
port saves restores in ``repro``.  ``lm_cache_from_jax_numpy`` and
``lm_cache_to_jax_numpy`` carry an LM decode cache across both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.checkpointing import checkpoint
from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.models import attention, blocks, ssm

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


def _to_torch(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dev, dtype) for v in tree]
    t = (tree.clone() if isinstance(tree, torch.Tensor)
         else torch.tensor(np.asarray(tree)))   # copies: jax's are read-only
    return t.to(device=dev, dtype=dtype or t.dtype)


def params_from_jax_numpy(tree, cfg: DiTConfig, device=None, dtype=None):
    """``repro`` DiT params (numpy pytree) -> the port's parameters on
    ``device`` (default ``cuda``), in ``dtype`` (default: as given)."""
    dev = device_lib.resolve(device)
    d = cfg.d_model
    out = {k: v for k, v in tree.items() if k not in ("single", "double")}
    out["single"] = [_block(_take(tree["single"], i), d)
                     for i in range(cfg.n_layers)]
    if "double" in tree:
        out["double"] = [
            {s: _block(_take(tree["double"][s], i), d)
             for s in ("img", "txt")}
            for i in range(cfg.n_double)]
    return _to_torch(out, dev, dtype)


def _unblock(tree, n_heads: int):
    """One port block back to the reference's leaf shapes: ``wq/wk/wv
    [d, d] -> [d, H, hd]``, ``wo [d, d] -> [H, hd, d]``."""
    out = {k: (_unblock(v, n_heads) if isinstance(v, dict) else v)
           for k, v in tree.items()}
    if "wq" in out:
        d = out["wq"].shape[0]
        for name in ("wq", "wk", "wv"):
            out[name] = out[name].reshape(d, n_heads, d // n_heads)
        out["wo"] = out["wo"].reshape(n_heads, d // n_heads, d)
    return out


def _stack(layers):
    """Per-layer trees -> one tree of ``[n_layers, ...]`` leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def params_to_jax_numpy(params, cfg: DiTConfig):
    """The port's DiT parameters (or a tree of their gradients) ->
    ``repro``'s tree: the per-layer lists re-stacked into ``[n_layers,
    ...]`` leaves, the attention projections in the reference's shapes;
    the exact inverse of ``params_from_jax_numpy``.  Leaves are CPU
    tensors in their own types (``.numpy()`` gives the reference's
    arrays, except bf16, which numpy lacks and which ``checkpoint.save``
    writes as the reference's files hold it), so ``checkpoint.save(dir,
    step, tree, name="dit")`` writes what
    ``repro.checkpointing.checkpoint.restore`` loads."""
    params = _to_cpu(params)     # stacked on the host, not on the card
    out = {k: v for k, v in params.items() if k not in ("single", "double")}
    out["single"] = _stack([_unblock(layer, cfg.n_heads)
                            for layer in params["single"]])
    if "double" in params:
        out["double"] = {s: _stack([_unblock(layer[s], cfg.n_heads)
                                    for layer in params["double"]])
                         for s in ("img", "txt")}
    return out


def params_to_wire(params, cfg: DiTConfig):
    """The port's DiT parameters -> the numpy tree a fleet worker is sent
    (``launch/serve.fleet_engine_factory``): ``repro``'s layout
    (``params_to_jax_numpy``), so a float32 tree is exactly the
    reference's ``tree_map(np.asarray, params)``.  numpy has no bf16, so
    a bf16 leaf travels as its raw bits in a ``uint16`` array (no float32
    detour: half the bytes, no rounding); ``params_from_wire`` reads
    them back as bf16 under a bf16 config."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return _map(leaf, params_to_jax_numpy(params, cfg))


def params_from_wire(tree, cfg: DiTConfig, device=None):
    """Inverse of ``params_to_wire`` (and the reference's numpy pytree
    as it is): ``uint16`` leaves are bf16 bits, allowed only when
    ``cfg.dtype`` is bf16; the parameters land on ``device`` (default
    ``cuda``)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype != np.uint16:
            return a
        if cfg.dtype != "bfloat16":
            raise TypeError(f"uint16 (bf16 bits) leaf in a {cfg.dtype} "
                            f"{cfg.arch_id} tree")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return params_from_jax_numpy(_map(leaf, tree), cfg, device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_checkpoint(directory: str, step: int, cfg: DiTConfig,
                           device=None, dtype=None, name: str = "dit"):
    """The port's DiT parameters from a checkpoint of ``repro``'s DiT
    params (``repro.checkpointing.checkpoint.save(directory, step,
    params, name)``; ``launch/train.py`` names its files ``dit``), on
    ``device`` (default ``cuda``), in ``dtype`` (default: as saved)."""
    tree = checkpoint.unflatten(checkpoint.load_flat(directory, step, name))
    return params_from_jax_numpy(tree, cfg, device=device, dtype=dtype)


# the attention subtrees of an LM block (``attn``) and of an enc-dec
# decoder block (``self_attn``, ``cross_attn``)
_ATTN_KEYS = ("attn", "self_attn", "cross_attn")


def _lm_block(tree):
    """One LM group position or enc-dec layer: the attention leaves ``[d,
    H, hd]`` / ``[H, hd, d]`` become ``[d, H·hd]`` / ``[H·hd, d]``;
    everything else (norms, FFN, the SSM leaves) is kept as it is."""
    out = dict(tree)
    for key in _ATTN_KEYS:
        if key not in tree:
            continue
        attn = dict(tree[key])
        for name in ("wq", "wk", "wv"):
            w = attn[name]      # numpy, or a CPU tensor (bf16 from a file)
            attn[name] = w.reshape(w.shape[0], -1)
        wo = attn["wo"]
        attn["wo"] = wo.reshape(-1, wo.shape[-1])
        out[key] = attn
    return out


def lm_params_from_jax_numpy(tree, cfg: ModelConfig, device=None,
                             dtype=None):
    """``repro`` LM or backbone-denoiser params (numpy pytree: ``stack``
    leaves ``[n_groups, ...]`` under ``l{i}``, beside the embedding,
    head, norms, prefix or patch / time projections) -> the port's
    parameters, ``params["stack"]`` a list of ``n_groups`` dicts
    ``{"l{i}": block}``, on ``device`` (default ``cuda``), in ``dtype``
    (default: as given).  An enc-dec tree's ``encoder`` and ``decoder``
    stacks (leaves ``[n_enc_layers, ...]`` / ``[n_layers, ...]``) become
    per-layer lists."""
    dev = device_lib.resolve(device)
    if cfg.is_encdec:
        out = {k: v for k, v in tree.items()
               if k not in ("encoder", "decoder")}
        for key, n in (("encoder", cfg.n_enc_layers),
                       ("decoder", cfg.n_layers)):
            out[key] = [_lm_block(_take(tree[key], i)) for i in range(n)]
        return _to_torch(out, dev, dtype)
    _, n_groups, plan = blocks._layer_plan(cfg)
    out = {k: v for k, v in tree.items() if k != "stack"}
    out["stack"] = [{f"l{i}": _lm_block(_take(tree["stack"][f"l{i}"], g))
                     for i in range(len(plan))} for g in range(n_groups)]
    return _to_torch(out, dev, dtype)


def _lm_unblock(tree, cfg: ModelConfig):
    """One port group position or enc-dec layer back to the reference's
    leaf shapes: ``wq [d, H·hd] -> [d, H, hd]``, ``wk, wv [d, Hkv·hd] ->
    [d, Hkv, hd]``, ``wo [H·hd, d] -> [H, hd, d]``; the rest as it is."""
    out = dict(tree)
    hd = cfg.head_dim
    for key in _ATTN_KEYS:
        if key not in tree:
            continue
        attn = dict(tree[key])
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            attn[name] = attn[name].reshape(attn[name].shape[0], heads, hd)
        attn["wo"] = attn["wo"].reshape(cfg.n_heads, hd, -1)
        out[key] = attn
    return out


def lm_params_to_jax_numpy(params, cfg: ModelConfig):
    """The port's LM parameters (or a tree of their gradients) ->
    ``repro``'s tree: the per-group list re-stacked into ``stack`` leaves
    ``[n_groups, ...]`` under ``l{i}`` (an enc-dec config's ``encoder``
    and ``decoder`` lists into their stacks), the attention projections
    in the reference's shapes; the exact inverse of
    ``lm_params_from_jax_numpy``.  Leaves are CPU tensors in their own
    types, so ``checkpoint.save(dir, step, tree, name=cfg.arch_id)``
    writes what ``repro.checkpointing.checkpoint.restore`` loads."""
    params = _to_cpu(params)     # stacked on the host, not on the card
    if cfg.is_encdec:
        out = {k: v for k, v in params.items()
               if k not in ("encoder", "decoder")}
        for key in ("encoder", "decoder"):
            out[key] = _stack([_lm_unblock(layer, cfg)
                               for layer in params[key]])
        return out
    _, _, plan = blocks._layer_plan(cfg)
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = {f"l{i}": _stack([_lm_unblock(group[f"l{i}"], cfg)
                                     for group in params["stack"]])
                    for i in range(len(plan))}
    return out


def _fields(node):
    """A cache node's fields: the reference's NamedTuple (``k, v,
    index`` or ``conv, state``) or a dict of the same keys."""
    return node._asdict() if hasattr(node, "_asdict") else dict(node)


def lm_cache_from_jax_numpy(tree, cfg: ModelConfig, device=None):
    """``repro``'s stacked decode cache (``{"l{i}": KVCache(k, v [n_groups,
    B, L, Hkv, hd], index [n_groups])}`` or ``SSMCache(conv, state)``,
    leaves numpy) -> the port's: a list of ``n_groups`` dicts ``{"l{i}":
    cache}`` on ``device`` (default ``cuda``), each KV cache's position
    an ``int``; every layer's index must be the same."""
    dev = device_lib.resolve(device)
    _, n_groups, plan = blocks._layer_plan(cfg)
    out = [{} for _ in range(n_groups)]
    for i, (kind, _) in enumerate(plan):
        f = _to_torch(_fields(tree[f"l{i}"]), dev, None)
        if kind == "attn":
            index = set(f["index"].reshape(-1).tolist())
            if len(index) != 1:
                raise ValueError(f"l{i}: layers at positions {index}")
            pos = int(index.pop())
        for g in range(n_groups):
            out[g][f"l{i}"] = (
                attention.KVCache(f["k"][g].clone(), f["v"][g].clone(), pos)
                if kind == "attn" else
                ssm.SSMCache(f["conv"][g].clone(), f["state"][g].clone()))
    return out


def lm_cache_to_jax_numpy(cache, cfg: ModelConfig):
    """The port's decode cache -> ``repro``'s stacked layout as dicts
    (``{"l{i}": {"k", "v", "index"}}`` or ``{"conv", "state"}``, leaves
    ``[n_groups, ...]``; ``index`` int32); the inverse of
    ``lm_cache_from_jax_numpy``.  Leaves are CPU tensors in their own
    types (``.numpy()`` gives the reference's arrays, except bf16)."""
    _, _, plan = blocks._layer_plan(cfg)
    out = {}
    for i, (kind, _) in enumerate(plan):
        layers = [group[f"l{i}"] for group in cache]
        if kind == "attn":
            out[f"l{i}"] = {
                "k": _stack([c.k.detach().cpu() for c in layers]),
                "v": _stack([c.v.detach().cpu() for c in layers]),
                "index": torch.tensor([c.index for c in layers],
                                      dtype=torch.int32)}
        else:
            out[f"l{i}"] = {
                "conv": _stack([c.conv.detach().cpu() for c in layers]),
                "state": _stack([c.state.detach().cpu() for c in layers])}
    return out

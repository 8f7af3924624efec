"""Logical-axis -> mesh-axis rules and per-device placements
(counterpart of ``repro.sharding.partitioning``).

Every parameter and cache dimension carries a logical axis name
(``models.common.ParamSpec.axes``).  Rules map those names to mesh
axes with the reference's divisibility-aware fallbacks, kept exactly:

* tensor parallelism (``"model"``): ffn / experts / heads; where a head
  count does not divide the model axis, the head width is sharded
  instead, at decode shapes only;
* FSDP (``"data"``, and ``"pod"`` where the mesh has it): the
  ``"embed"`` dimension of weights in training, and at serve time for
  weights above ``serve_tp_bytes`` a tensor-parallel shard;
* batch dimensions shard over ``("pod", "data")``; a single-request
  decode shards the KV cache's length instead (``launch.steps``).

A placement is a tuple with one entry per dimension of the port's leaf,
``None``, a mesh axis or a tuple of them: the counterpart of a
``PartitionSpec``.  Where the port merges two of the reference's
dimensions (``[d, H·hd]`` for ``[d, H, hd]``), each component keeps its
own rule and its own uneven-shard guard, and the merged dimension takes
the mesh axes of the components that keep one, so a leaf's per-device
size equals the reference's.  Meshes are abstract (``launch.mesh``):
nothing here allocates, and ``constraint`` is the identity on the
one-card mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common

Entry = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, Entry]
Placement = Tuple[Entry, ...]


def _axis_size(mesh: Mesh, name: Entry) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def model_rules(cfg: ModelConfig, mesh: Mesh, mode: str,
                serve_tp_bytes: float = 4e9,
                shape_kind: str = "train") -> Rules:
    """``mode``: ``"train"`` (FSDP + TP) or ``"serve"`` (2-D weights +
    TP).  ``serve_tp_bytes``: weights above this many bytes per TP shard
    are also sharded over the data axis at serve time.  ``shape_kind``:
    the head-width fallback (a head count that does not divide the model
    axis) applies only at decode, as in the reference."""
    msz = mesh.shape["model"]
    dp = dp_axes(mesh)
    dpsz = _axis_size(mesh, dp)
    rules: Rules = {
        "layer": None, "heads": None, "head_dim": None, "kv_heads": None,
        "kv_head_dim": None, "ffn": None, "expert": None, "vocab": None,
        "embed": None, "inner": None, "ssm_heads": None,
    }
    if _div(cfg.d_ff, msz):
        rules["ffn"] = "model"
    if cfg.moe is not None and cfg.moe.n_experts > 0:
        if _div(cfg.moe.e_total, msz):
            rules["expert"] = "model"
            rules["ffn"] = None          # experts already split the FFN
    if _div(cfg.n_heads, msz):
        rules["heads"] = "model"
    elif _div(cfg.head_dim, msz) and shape_kind == "decode":
        rules["head_dim"] = "model"
    if _div(cfg.n_kv_heads, msz):
        rules["kv_heads"] = "model"
    elif _div(cfg.head_dim, msz) and shape_kind == "decode":
        rules["kv_head_dim"] = "model"
    if _div(cfg.vocab_size, msz):
        rules["vocab"] = "model"
    if cfg.ssm is not None:
        d_inner = cfg.d_inner
        proj_out = 2 * d_inner + 2 * cfg.ssm.d_state + cfg.n_ssm_heads
        conv_dim = d_inner + 2 * cfg.ssm.d_state
        if all(_div(n, msz) for n in (d_inner, proj_out, conv_dim)):
            rules["inner"] = "model"
        if _div(cfg.n_ssm_heads, msz):
            rules["ssm_heads"] = "model"
    big = param_bytes(cfg) / msz > serve_tp_bytes
    if mode == "train" or big:
        if _div(cfg.d_model, dpsz):
            rules["embed"] = dp
    return rules


def dit_rules(cfg: DiTConfig, mesh: Mesh) -> Rules:
    msz = mesh.shape["model"]
    rules: Rules = {"layer": None, "embed": None, "vocab": None,
                    "heads": None, "head_dim": None, "ffn": None}
    if _div(cfg.d_ff, msz):
        rules["ffn"] = "model"
    if _div(cfg.n_heads, msz):
        rules["heads"] = "model"
    elif _div(cfg.head_dim, msz):
        rules["head_dim"] = "model"
    return rules


def param_bytes(cfg: ModelConfig, bytes_per: int = 2) -> int:
    """Total parameter bytes of an LM config from its specs, no
    allocation; the port's per-group leaves hold the same elements as
    the reference's stacked ones."""
    from repro_torch.models import encdec, transformer
    specs = (encdec.encdec_specs(cfg) if cfg.is_encdec
             else transformer.lm_specs(cfg))
    leaves = []
    common.map_specs(leaves.append, specs)
    return sum(math.prod(s.shape) * bytes_per for s in leaves)


def spec_for_axes(axes: Tuple[Optional[str], ...], rules: Rules
                  ) -> Placement:
    """Logical axes -> the rules' mesh axes (no divisibility guard)."""
    return tuple(None if name is None else rules.get(name) for name in axes)


def _flat(entries) -> Entry:
    names = tuple(n for e in entries
                  for n in (e if isinstance(e, tuple) else (e,)))
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def placement(spec: common.ParamSpec, rules: Rules, mesh: Mesh) -> Placement:
    """One leaf's placement: each component's rule, dropped where its
    mesh axes do not divide the component (the uneven-shard guard)."""
    out = []
    for comp in spec.components():
        kept = []
        for name, size in comp:
            entry = None if name is None else rules.get(name)
            if entry is not None and _div(size, _axis_size(mesh, entry)):
                kept.append(entry)
        out.append(_flat(kept))
    return tuple(out)


def shardings_for_specs(spec_tree, rules: Rules, mesh: Mesh):
    """ParamSpec tree -> placement tree (no allocation)."""
    return common.map_specs(lambda s: placement(s, rules, mesh), spec_tree)


def shard_shape(shape, place: Placement, mesh: Mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` placed by ``place``."""
    out = []
    for dim, entry in zip(shape, place, strict=True):
        n = _axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split {n} ways "
                             f"({entry})")
        out.append(dim // n)
    return tuple(out)


def batch_spec(mesh: Mesh, global_batch: int, ndim: int,
               extra: Tuple = ()) -> Placement:
    """Batch on the data-parallel axes where they divide it (else on
    ``"data"`` alone, else replicated); ``extra`` places the next
    dimensions."""
    dp: Entry = dp_axes(mesh)
    if not _div(global_batch, _axis_size(mesh, dp)):
        dp = ("data",) if _div(global_batch, mesh.shape["data"]) else None
    entries = [_flat([dp])] + [None] * (ndim - 1)
    for i, e in enumerate(extra):
        entries[1 + i] = e
    return tuple(entries)


def constraint(x: torch.Tensor, mesh: Mesh, *entries) -> torch.Tensor:
    """The identity on the one-card mesh (and for the dry run's meta
    tensors on any mesh); no step runs on a multi-device mesh."""
    if mesh.size == 1 or x.is_meta:
        return x
    raise NotImplementedError(
        f"a {mesh.name} mesh serves the dry run's arithmetic only; the "
        "port runs one card")

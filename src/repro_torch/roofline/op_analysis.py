"""The step cost counter: FLOPs, bytes and peak memory of one step run
on ``meta`` tensors.  It replaces ``repro.roofline.hlo_analysis``, which
walks XLA's optimized HLO; the port has no HLO, so it counts the aten
operations the step dispatches.

``analyze(fn, *args)`` calls ``fn`` under a ``TorchDispatchMode`` on the
abstract (meta) arguments that ``launch.steps.build`` makes: shapes and
types, no data, nothing allocated, so a full-width step of any config
runs on any host in seconds.  The op layer routes meta tensors as the
card's (``kernels.ops._on_cuda``), so each kernel the step would launch
records its own work (``kernels.meta``), never the plain twin's ops.

* FLOPs: the matmul family after decomposition (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``, ``dot``; no step has a convolution) at
  2·M·N·K, the reference's rule for its ``dot`` ops; each kernel by its
  own formula.
* Bytes: every op's operands and results, once each, with views and
  allocations free: eager traffic, the counterpart of the reference's
  bytes at fusion boundaries (eager PyTorch has no fusion, so this is
  the traffic the port's step really makes, not what a fused program
  would); a kernel's bytes are its inputs read and outputs written once.
* Peak: live storage bytes as ops run, each new storage added when an op
  returns it and dropped through a ``weakref.finalize`` on the storage,
  each rounded up to 512 bytes as the card's caching allocator rounds a
  block; the counterpart of ``memory_analysis().temp_size_in_bytes``
  plus the arguments (``torch.cuda.max_memory_allocated`` counts both).
* Collectives: the ``_c10d_functional`` ops the step dispatches (none: the
  port runs one card).

``decode_step_bytes`` / ``decode_step_flops`` are the least work of one
decode step (every weight once, the cache read), the decode rows'
bounds in ``chip_smoke.py``.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta

aten = torch.ops.aten
_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default, aten.mv.default, aten.addmv.default,
           aten.dot.default}
# allocate only: no byte of traffic
_ALLOC = {aten.empty.memory_format, aten.empty_strided.default,
          aten.empty_like.default, aten.new_empty.default,
          aten.new_empty_strided.default}
_BLOCK = 512     # the caching allocator's rounding of a block


def _matmul_flops(func, args) -> int:
    """2·M·N·K of a product (the added term of ``addmm`` and the like
    not counted)."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        args = args[1:]
    a, b = args[0], args[1]
    if func in (aten.mv.default, aten.addmv.default):
        return 2 * a.shape[0] * a.shape[1]
    if func == aten.dot.default:
        return 2 * a.shape[0]
    *batch, m, k = a.shape                     # mm, addmm, bmm, baddbmm
    return 2 * math.prod(batch) * m * b.shape[-1] * k


def _tensors(tree):
    """The tensors of a tree of lists, tuples, dicts and dataclasses (the
    caches)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif hasattr(tree, "__dataclass_fields__"):
        yield from _tensors(list(vars(tree).values()))


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's traffic: its elements, but no more than its storage (an
    expanded tensor reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.kinds: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[str, float] = {}
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0

    def add(self, kind: str, flops: float = 0.0, nbytes: float = 0.0,
            calls: int = 0, flops_by_type=None) -> None:
        k = self.kinds.setdefault(kind, {"flops": 0.0, "bytes": 0.0,
                                         "calls": 0})
        k["flops"] += flops
        k["bytes"] += nbytes
        k["calls"] += calls
        for t, f in (flops_by_type or {}).items():
            k.setdefault("flops_by_type", {}).setdefault(t, 0.0)
            k["flops_by_type"][t] += f

    def kernel(self, name: str, flops: Dict[str, float], nbytes: int):
        self.add(name, sum(flops.values()), nbytes, 1, flops)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        size = -(-st.nbytes() // _BLOCK) * _BLOCK
        self.live[key] = size
        self.live_bytes += size
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.track(t)
        self.peak = max(self.peak, self.live_bytes)
        if func.namespace == "_c10d_functional":
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collectives[func.__name__] = \
                self.collectives.get(func.__name__, 0.0) + b
        if func in _ALLOC or _is_view(func):
            return out
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))
        if func in _MATMUL:
            flops = _matmul_flops(func, args)
            self.add("dense", flops, nbytes, 1,
                     {str(out.dtype).removeprefix("torch."): flops})
        else:
            self.add("other", 0.0, nbytes, 1)
        return out


def analyze(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` on meta arguments and count it.  Returns
    ``flops`` and ``bytes_accessed`` (totals), ``by_kind`` (``dense``,
    ``other`` and each kernel by name: flops, bytes, calls, and flops by
    operand type, ``flops_by_type``: a dense product's output type, a
    kernel's own), ``flops_by_type`` (summed over the kinds),
    ``argument_bytes`` (the arguments' storages, each once),
    ``peak_bytes`` (arguments included), ``temp_bytes`` (peak less the
    arguments) and ``collectives``."""
    leaves = list(_tensors(list(args)))
    if any(not t.is_meta for t in leaves):
        raise ValueError("analyze takes meta arguments (launch.steps.build)")
    counter = _Counter()
    seen = {}
    for t in leaves:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
        counter.track(t)
    arg_bytes = sum(seen.values())
    start = counter.peak = counter.live_bytes
    with meta.listening(counter.kernel), counter:
        out = fn(*args)
    del out
    kinds = counter.kinds
    total = sum(k["flops"] for k in kinds.values())
    nbytes = sum(k["bytes"] for k in kinds.values())
    coll = dict(counter.collectives)
    coll["total_bytes"] = float(sum(counter.collectives.values()))
    by_type: Dict[str, float] = {}
    for k in kinds.values():
        for t, f in k.get("flops_by_type", {}).items():
            by_type[t] = by_type.get(t, 0.0) + f
    return {"flops": float(total), "bytes_accessed": float(nbytes),
            "by_kind": kinds, "flops_by_type": by_type,
            "argument_bytes": int(arg_bytes),
            "peak_bytes": int(counter.peak),
            "temp_bytes": int(counter.peak - start),
            "collectives": coll}


def decode_step_bytes(cfg, params, cache, batch: int) -> int:
    """Bytes one decode step must move: every weight once (of an untied
    embedding table only the batch's rows), every cache buffer read, the
    new K / V slot or the SSM state and conv history written, the logits
    written."""
    from repro_torch.optim import adamw
    n = sum(p.numel() * p.element_size() for p in adamw.leaves(params))
    emb = params["embed"]["embedding"]
    if not cfg.tie_embeddings:
        n -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    for group in cache:
        for c in group.values():
            if hasattr(c, "index"):
                n += c.k.nbytes + c.v.nbytes
                n += 2 * c.k[:, 0].nbytes
            else:
                n += 2 * (c.state.nbytes + c.conv.nbytes)
    return n + batch * cfg.vocab_size * emb.element_size()


def decode_step_flops(cfg, params, cache, batch: int) -> float:
    """Operations of one decode step: 2 per weight of a matmul per token
    (the embedding is a lookup; of an expert ``[e, ...]`` leaf only the
    top-k experts' weights a token), attention 4·hd per query head and
    valid slot (the whole ring or the filled prefix), the SSM recurrence
    ~6 per state element."""
    from repro_torch.optim import adamw
    leaves = adamw.leaves(params)
    n_mat = sum(p.numel() for p in leaves if p.dim() == 2)
    if not cfg.tie_embeddings:
        n_mat -= params["embed"]["embedding"].numel()
    if cfg.moe is not None:
        n_mat += sum(p.numel() for p in leaves if p.dim() == 3
                     ) * cfg.moe.top_k / cfg.moe.e_total
    flops = 2.0 * n_mat * batch
    for group in cache:
        for c in group.values():
            if hasattr(c, "index"):
                valid = min(c.index + 1, c.k.shape[1])
                flops += 4.0 * cfg.head_dim * cfg.n_heads * valid * batch
            else:
                flops += 6.0 * c.state.numel()
    return flops

"""Step builders and abstract inputs for every (arch x input shape)
(counterpart of ``repro.launch.steps``): the LM train step with AdamW
and gradient accumulation, the prefill step and the decode step, and
``build`` / ``build_dit``, which bundle a step with its abstract
arguments and their per-device placements for the dry run
(``launch.dryrun``) and the card rows of ``chip_smoke.py``.

``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` keep
the reference's arithmetic and return values; they run eagerly on the
tensors' device (on the card the scan and attention kernels and their
backwards; decode launches none).  The AdamW update is in place
(``optim.adamw.update``), so the parameters a train step returns are
the ones it was given; so is the decode cache.  An enc-dec config takes
``models.encdec``'s specs, loss, prefill (``batch["frames"]``) and
decode step (against an encoder memory); a modality-prefix config's
batches carry ``batch["prefix_embeds"]``.

Abstract arguments are tensors on the ``meta`` device, the counterpart
of ``jax.ShapeDtypeStruct``: shapes and types, nothing allocated.  A
``StepSpec``'s step runs on them as it runs on the card (each kernel
route records its work instead of launching, ``kernels.meta``), which is
how ``roofline.op_analysis`` counts a step.  Meshes are abstract
(``launch.mesh``); a step built for a mesh of more than one device runs
on meta tensors only and raises ``NotImplementedError`` on real ones.
The reference's ``constrain`` hooks have no counterpart inside the
models; ``activation_constrain`` is the identity on one card.  Tokens
and labels are int32, as the reference's; the optimizer's step count
and a KV cache's position are host ``int`` s, so neither is an argument
byte (the reference's are int32 arrays).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs as config_lib
from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, blocks, common, dit, encdec, \
    transformer
from repro_torch.optim import adamw
from repro_torch.sharding import partitioning as pt
from repro_torch.sharding.partitioning import param_bytes


def model_specs(cfg: ModelConfig):
    """The parameter specs of an LM config: ``encdec.encdec_specs`` for
    an enc-dec one, else ``transformer.lm_specs``."""
    if cfg.is_encdec:
        return encdec.encdec_specs(cfg)
    return transformer.lm_specs(cfg)


def loss_fn(cfg: ModelConfig):
    """The config's ``loss_fn(params, batch, cfg)``."""
    return encdec.loss_fn if cfg.is_encdec else transformer.loss_fn


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    microbatch: int = 1):
    """``(train_step, opt_cfg)``: ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)`` takes the gradient of the config's
    ``loss_fn`` with respect to every leaf (each is made to
    require grad) and applies one AdamW update in place.  The default
    optimizer keeps bf16 moments above 2e11 parameter bytes, else
    float32, as the reference's.  ``microbatch > 1`` is gradient
    accumulation: the batch splits into ``microbatch`` sub-batches along
    its first axis, run in order, each gradient added in float32 divided
    by the count, and each metric the mean over the sub-batches; an
    unused leaf's gradient is zero (``None`` without accumulation, which
    AdamW counts as zero).  The metrics are the loss's and AdamW's
    (``grad_norm``, ``lr``), as 0-d tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        moment_dtype="bfloat16" if param_bytes(cfg) > 2e11 else "float32")
    loss_of = loss_fn(cfg)

    def grads_of(params, flat, batch):
        loss, metrics = loss_of(params, batch, cfg)
        return metrics, torch.autograd.grad(loss, flat, allow_unused=True)

    def train_step(params, opt_state, batch):
        flat = [p.requires_grad_(True) for p in adamw.leaves(params)]
        if microbatch > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            runs = []
            for k in range(microbatch):
                one = {key: v.reshape((microbatch, v.shape[0] // microbatch)
                                      + tuple(v.shape[1:]))[k]
                       for key, v in batch.items()}
                metrics, grads = grads_of(params, flat, one)
                for a, g in zip(acc, grads, strict=True):
                    if g is not None:
                        a.add_(g.to(torch.float32) / microbatch)
                runs.append({k2: m.detach() for k2, m in metrics.items()})
                del grads
            grads = acc
            metrics = {key: torch.stack([r[key] for r in runs]).mean()
                       for key in runs[0]}
        else:
            metrics, grads = grads_of(params, flat, batch)
            metrics = {key: m.detach() for key, m in metrics.items()}
        it = iter(grads)
        tree = adamw.tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw.update(opt_cfg, tree, opt_state, params)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step, opt_cfg


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> [B, vocab]``: the full-sequence
    forward of ``batch["tokens"]`` without remat and under
    ``torch.no_grad``, then the last token's logits only (the ``[B, S,
    vocab]`` tensor never exists).  An enc-dec config encodes
    ``batch["frames"]`` first and runs the decoder against it; a prefix
    config prepends the projected ``batch["prefix_embeds"]``."""

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encdec:
            memory = encdec.encode(params, batch["frames"], cfg)
            h = encdec.decoder(params, batch["tokens"], memory, cfg)
            return encdec.head_logits(params, h[:, -1:], cfg)[:, 0]
        x = transformer.embed_inputs(
            params, batch["tokens"], cfg,
            batch["prefix_embeds"] if cfg.n_prefix_tokens > 0 else None)
        h, _ = blocks.stack_full(params["stack"], x, cfg, remat=False)
        hn = common.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        w = transformer._embedding_matrix(params, cfg)
        return (hn @ w.to(hn.dtype))[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    """``decode_step(params, tokens [B, 1], cache) -> (logits [B, 1, V],
    cache)`` under ``torch.no_grad``: ``transformer.decode_step``, the
    cache updated in place.  An enc-dec config's step is
    ``decode_step(params, tokens, cache, memory)``, the decoder against
    the encoder memory (``encdec.decode_step``; its cache from
    ``encdec.decode_cache_zeros``)."""
    if cfg.is_encdec:
        @torch.no_grad()
        def encdec_step(params, tokens, cache, memory):
            return encdec.decode_step(params, tokens, memory, cache, cfg,
                                      window=window)
        return encdec_step

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        return transformer.decode_step(params, tokens, cache, cfg,
                                       window=window)

    return decode_step


# ---------------------------------------------------------------------------
# abstract steps for the dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepSpec:
    """A step, its abstract (meta) arguments and their per-device
    placements (``sharding.partitioning``) on ``mesh``."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    mesh: Mesh


def activation_constrain(mesh: Optional[Mesh]):
    """The counterpart of the reference's hook that pins activations to
    a mesh: ``None`` without a mesh, else a function of a tensor that is
    the identity on one card (and on meta tensors on any mesh, whose
    work the dry run splits evenly) and raises for a real tensor on a
    larger mesh (``partitioning.constraint``).  The port's models take no
    such hook; ``build``'s steps apply it to their arguments."""
    if mesh is None:
        return None
    return functools.partial(pt.constraint, mesh=mesh)


def _guarded(mesh: Mesh, fn: Callable) -> Callable:
    """``fn`` itself on one card; on a larger mesh, ``fn`` for meta
    arguments only."""
    if mesh.size == 1:
        return fn
    constrain = activation_constrain(mesh)

    def on_mesh(*args):
        for t in adamw.leaves(list(args)):
            if isinstance(t, torch.Tensor):
                constrain(t)
        return fn(*args)
    return on_mesh


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """Abstract (meta) model inputs for a named input shape; ``batch``
    replaces the shape's global batch (the dry run's per-card batch on
    one card)."""
    info = config_lib.INPUT_SHAPES[shape_name]
    seq, kind = info["seq_len"], info["kind"]
    gb = batch or info["global_batch"]
    dtype = getattr(torch, cfg.dtype)
    i32 = torch.int32
    if kind in ("train", "prefill"):
        if cfg.is_encdec:
            ins = {"frames": _meta((gb, seq, cfg.d_model), dtype),
                   "tokens": _meta((gb, seq), i32)}
        elif cfg.n_prefix_tokens > 0:
            ins = {"prefix_embeds": _meta(
                (gb, cfg.n_prefix_tokens, cfg.d_model), dtype),
                "tokens": _meta((gb, seq - cfg.n_prefix_tokens), i32)}
        else:
            ins = {"tokens": _meta((gb, seq), i32)}
        if kind == "train":
            ins["labels"] = _meta(ins["tokens"].shape, i32)
        return ins
    if kind != "decode":
        raise ValueError(f"unknown shape kind {kind!r}")
    out = {"tokens": _meta((gb, 1), i32)}
    if cfg.is_encdec:
        out["cache"] = encdec.decode_cache_abstract(cfg, gb, seq, dtype)
        out["memory"] = _meta((gb, seq, cfg.d_model), dtype)
    else:
        out["cache"] = blocks.stack_cache_abstract(cfg, gb, seq, dtype)
    return out


def _cache_rules(rules, mesh: Mesh, global_batch: int):
    """The cache's rules: batch on the data-parallel axes where they
    divide it, else (a single long request) the KV length on data."""
    dp = pt.dp_axes(mesh)
    dpsz = pt._axis_size(mesh, dp)
    cache_rules = dict(rules)
    cache_rules["layer"] = None
    if global_batch % dpsz == 0 and global_batch >= dpsz:
        cache_rules.update(batch=dp, len=None)
    else:
        cache_rules.update(batch=None, len="data")
    return cache_rules


def _cache_shardings(axes_tree, cache_rules):
    """Placements of a cache from its axes (``KVCache`` / ``SSMCache``
    leaves in lists and dicts)."""
    if isinstance(axes_tree, list):
        return [_cache_shardings(a, cache_rules) for a in axes_tree]
    if isinstance(axes_tree, dict):
        return {k: _cache_shardings(a, cache_rules)
                for k, a in axes_tree.items()}
    return dataclasses.replace(axes_tree, **{
        f.name: pt.spec_for_axes(getattr(axes_tree, f.name), cache_rules)
        for f in dataclasses.fields(axes_tree) if f.name != "index"})


def _batch_shardings(batch, mesh: Mesh, gb: int):
    return {k: pt.batch_spec(mesh, gb, x.dim()) for k, x in batch.items()}


def build(arch_id: str, shape_name: str, mesh: Mesh,
          overrides: Optional[Dict[str, Any]] = None) -> StepSpec:
    """Assemble (step, abstract args, placements) for one dry-run combo.
    ``overrides``: ``moe_impl`` (``"einsum"`` | ``"gather"``) and
    ``moe_pad`` (experts padded to this count), as the reference's; and
    ``batch``, which replaces the shape's global batch (a per-card batch
    on one card)."""
    ov = overrides or {}
    base_cfg = config_lib.get_config(arch_id)
    if not isinstance(base_cfg, ModelConfig):
        raise ValueError(f"{arch_id} is a DiT config; use build_dit()")
    cfg = config_lib.for_shape(base_cfg, shape_name)
    if cfg.moe is not None and (ov.get("moe_impl") or ov.get("moe_pad")):
        moe_kw = {}
        if ov.get("moe_impl"):
            moe_kw["impl"] = ov["moe_impl"]
        if ov.get("moe_pad"):
            moe_kw["padded_experts"] = int(ov["moe_pad"])
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    info = config_lib.INPUT_SHAPES[shape_name]
    gb, kind = int(ov.get("batch") or info["global_batch"]), info["kind"]
    mode = "train" if kind == "train" else "serve"
    rules = pt.model_rules(cfg, mesh, mode, shape_kind=kind)
    specs = model_specs(cfg)
    params_abs = common.abstract_params(specs, getattr(torch, cfg.dtype))
    params_sh = pt.shardings_for_specs(specs, rules, mesh)
    ins = input_specs(cfg, shape_name, gb)

    if kind == "train":
        fn, opt_cfg = make_train_step(cfg)
        mdt = getattr(torch, opt_cfg.moment_dtype)
        opt_abs = adamw.OptState(
            mu=adamw.tree_map(lambda p: _meta(p.shape, mdt), params_abs),
            nu=adamw.tree_map(lambda p: _meta(p.shape, mdt), params_abs),
            step=0)
        opt_sh = adamw.OptState(mu=params_sh, nu=params_sh, step=())
        return StepSpec(
            name=f"{arch_id}:{shape_name}:train", fn=_guarded(mesh, fn),
            args=(params_abs, opt_abs, ins),
            in_shardings=(params_sh, opt_sh,
                          _batch_shardings(ins, mesh, gb)),
            mesh=mesh)
    if kind == "prefill":
        return StepSpec(
            name=f"{arch_id}:{shape_name}:prefill",
            fn=_guarded(mesh, make_prefill_step(cfg)),
            args=(params_abs, ins),
            in_shardings=(params_sh, _batch_shardings(ins, mesh, gb)),
            mesh=mesh)

    window = cfg.sliding_window
    seq = info["seq_len"]
    cache_len = min(seq, window) if window > 0 else seq
    dtype = getattr(torch, cfg.dtype)
    cache_rules = _cache_rules(rules, mesh, gb)
    if cfg.is_encdec:
        cache_abs = encdec.decode_cache_abstract(cfg, gb, cache_len, dtype)
        kv = ("batch", "len", "kv_heads", "kv_head_dim")
        axes = [attention.KVCache(k=kv, v=kv) for _ in range(cfg.n_layers)]
    else:
        cache_abs = blocks.stack_cache_abstract(cfg, gb, cache_len, dtype)
        axes = blocks.stack_cache_axes(cfg)
    cache_sh = _cache_shardings(axes, cache_rules)
    args = [params_abs, ins["tokens"], cache_abs]
    in_sh = [params_sh, pt.batch_spec(mesh, gb, 2), cache_sh]
    if cfg.is_encdec:
        args.append(ins["memory"])
        in_sh.append(pt.batch_spec(mesh, gb, 3))
    return StepSpec(
        name=f"{arch_id}:{shape_name}:decode",
        fn=_guarded(mesh, make_decode_step(cfg, window=window)),
        args=tuple(args), in_shardings=tuple(in_sh), mesh=mesh)


def build_dit(arch_id: str, mesh: Mesh, batch: int = 64, latent: int = 128,
              cached_step: bool = False) -> StepSpec:
    """Dry-run spec for the paper's MMDiT.  ``cached_step=False``: one
    full denoiser forward, ``(velocity, CRF)``, as the reference's.
    ``cached_step=True``: the FreqCa skip path as the port serves it:
    ``FreqCaPolicy.predict`` (interval 5, dct, rho 0.0625, Hermite order
    2) from float32 rings, the fused synthesis + Hermite kernel, then
    the final layer alone (``dit.dit_from_crf``); the reference's
    legacy-state skip path forecasts with plain ops instead."""
    cfg = config_lib.get_config(arch_id)
    if not isinstance(cfg, DiTConfig):
        raise ValueError(f"{arch_id} is not a DiT config")
    rules = pt.dit_rules(cfg, mesh)
    specs = dit.dit_specs(cfg)
    dtype = getattr(torch, cfg.dtype)
    params_abs = common.abstract_params(specs, dtype)
    params_sh = pt.shardings_for_specs(specs, rules, mesh)
    n_tok = (latent // cfg.patch_size) ** 2
    t = _meta((batch,), torch.float32)
    t_sh = pt.batch_spec(mesh, batch, 1)
    if cached_step:
        from repro_torch.core.policies import base as policy_base
        from repro_torch.core.policies.freqca import FreqCaPolicy
        pol = FreqCaPolicy(interval=5, method="dct", rho=0.0625,
                           high_order=2)
        feat = (n_tok, cfg.d_model)
        state = pol.init(batch, feat, torch.float32, device="meta")
        state_sh = policy_base.tree_map(
            lambda a: pt.batch_spec(mesh, batch, a.dim()), state)

        def cached(params, state, tt):
            ctx = policy_base.StepContext(
                step_idx=1, t_now=tt[0], x=None, batch=batch,
                feat_shape=feat, crf_dtype=torch.float32)
            crf_hat = pol.predict(state, ctx)
            return dit.dit_from_crf(params, crf_hat, tt, cfg, latent, latent)
        return StepSpec(name=f"{arch_id}:cached_step",
                        fn=_guarded(mesh, cached),
                        args=(params_abs, state, t),
                        in_shardings=(params_sh, state_sh, t_sh),
                        mesh=mesh)
    lat = _meta((batch, latent, latent, cfg.in_channels), dtype)
    args = [params_abs, lat, t]
    in_sh = [params_sh, pt.batch_spec(mesh, batch, 4), t_sh]
    if cfg.text_dim > 0:
        args.append(_meta((batch, cfg.n_text_tokens, cfg.text_dim), dtype))
        in_sh.append(pt.batch_spec(mesh, batch, 3))

    def full(params, latents, tt, text=None):
        out = dit.dit_forward(params, latents, tt, cfg, text)
        return out.velocity, out.crf
    return StepSpec(name=f"{arch_id}:denoise", fn=_guarded(mesh, full),
                    args=tuple(args), in_shardings=tuple(in_sh),
                    mesh=mesh)

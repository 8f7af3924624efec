"""AdamW with a warmup-cosine learning rate and global-norm clipping
(counterpart of ``repro.optim.adamw``; ``torch.optim.AdamW`` clips and
schedules otherwise).

A parameter tree is nested dicts and lists of tensors, as the models
keep them; the moments are trees of the same shape, in
``moment_dtype``.  The arithmetic is the reference's, in float32: clip
by the global norm, bias correction from the incremented step, the
decoupled decay folded into the step, results cast back to each
leaf's type.  ``update`` writes the parameters and moments in place
(the reference returns new trees), leaf by leaf and with in-place
float32 operations, so its temporaries are a few of one leaf's at a
time and each pass over a leaf reads and writes it once; fused
multiply-adds may round where the reference rounds twice (~1 ulp).  A missing gradient (``None``,
a leaf the forward did not use) counts as zero, as the reference's
zero gradient does: the moments decay and the weight decay still
moves the leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, NamedTuple, Optional

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: int


def leaves(tree) -> List[Optional[torch.Tensor]]:
    """The leaves of a dict / list tree in a fixed order (dict order;
    ``None`` leaves kept, so a gradient tree lines up with its
    parameters)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` of every leaf of a dict / list tree, in the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_ratio · lr`` at ``total_steps``; float32, 0-d, on the
    CPU."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=0)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf in float32 (``None`` leaves skipped)."""
    sq = [torch.sum(torch.square(x.to(_F32))) for x in leaves(tree)
          if x is not None]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params):
    """One AdamW step on ``params`` and ``state``'s moments, in place;
    returns ``(params, new_state, {"grad_norm", "lr"})``, the metrics as
    0-d float32 tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    c1 = 1.0 - _f32(cfg.b1) ** _f32(step)
    c2 = 1.0 - _f32(cfg.b2) ** _f32(step)
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state.mu),
                            leaves(state.nu), strict=True):
        # float32 moments are updated where they lie; bf16 ones in a copy
        mu_n, nu_n = mu.to(_F32), nu.to(_F32)
        mu_n.mul_(cfg.b1)
        nu_n.mul_(cfg.b2)
        if g is not None:
            g = g.to(_F32, copy=True).mul_(scale)
            mu_n.add_(g, alpha=1 - cfg.b1)
            nu_n.addcmul_(g, g, value=1 - cfg.b2)
        del g
        delta = torch.div(mu_n, c1).div_(torch.div(nu_n, c2).sqrt_()
                                          .add_(cfg.eps))
        p32 = p.to(_F32, copy=True)
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))
        if mu_n is not mu:
            mu.copy_(mu_n)
            nu.copy_(nu_n)
    return params, OptState(mu=state.mu, nu=state.nu, step=step), {
        "grad_norm": gnorm, "lr": lr}

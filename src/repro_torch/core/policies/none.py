"""No caching: every lane activates every step (ground truth / baseline
latency).  ``predict`` is never used but returns well-formed zeros."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.policies import base, registry


class NoCacheState(NamedTuple):
    n_valid: torch.Tensor          # [B] int32


@dataclasses.dataclass(frozen=True)
class NoCachePolicy(base.Policy):
    name = "none"

    @property
    def cache_units(self) -> int:
        return 0

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=torch.float32, device=None, **_):
        return NoCacheState(n_valid=torch.zeros((batch,), dtype=torch.int32,
                                                device=device))

    def decide(self, state, ctx):
        return state, torch.ones((ctx.batch,), dtype=torch.bool,
                                 device=state.n_valid.device)

    def update(self, state, crf, ctx):
        return NoCacheState(n_valid=state.n_valid + 1)

    def predict(self, state, ctx):
        return torch.zeros((ctx.batch,) + tuple(ctx.feat_shape),
                           dtype=ctx.crf_dtype, device=state.n_valid.device)


@registry.register("none")
def _from_spec(spec) -> NoCachePolicy:
    return NoCachePolicy(interval=1)

"""Parameter specs, initialisation and shared layers (counterpart of
``repro.models.common``).

Parameters are plain nested dicts (and per-layer lists) of tensors.  The
initialiser follows the reference's ``_initializer`` rules, drawn from a
``torch.Generator`` — the same distributions, not the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch import device as device_lib


# one dimension's logical axis: a name, None, or, for a dimension that
# merges several of the reference's (``[d, H·hd]`` for ``[d, H, hd]``),
# the tuple of their names in order
Axis = Union[None, str, Tuple[Optional[str], ...]]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One leaf: its shape in the port, how it is drawn, the shape of the
    same leaf in the reference's (layer-stacked) tree, which the fan-in
    rule reads, and the reference's logical axis of each dimension of
    the port's leaf (``axes``; the reference's ``"layer"`` axis has no
    dimension here, as the port keeps per-group leaves).  The sharding
    rules read the axes (``sharding.partitioning``)."""
    shape: Tuple[int, ...]
    init: str = "normal"                     # normal | zeros | ones | embed
    ref_shape: Optional[Tuple[int, ...]] = None
    scale: Optional[float] = None            # stddev override
    axes: Tuple[Axis, ...] = ()

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamSpec {self.shape}: axes {self.axes}")

    def components(self) -> Tuple[Tuple[Tuple[Optional[str], int], ...],
                                  ...]:
        """Per dimension, its ``(logical axis, size)`` components: one for
        a plain dimension; for a merged one, the reference's dimensions
        it holds, their sizes the trailing entries of ``ref_shape``."""
        flat = [a for ax in self.axes
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        sizes = (self.ref_shape[len(self.ref_shape) - len(flat):]
                 if len(flat) > len(self.shape) else self.shape)
        out, i = [], 0
        for dim, ax in zip(self.shape, self.axes, strict=True):
            names = ax if isinstance(ax, tuple) else (ax,)
            comp = tuple(zip(names, sizes[i:i + len(names)], strict=True))
            if math.prod(n for _, n in comp) != dim:
                raise ValueError(f"ParamSpec {self.shape}: axes "
                                 f"{self.axes} against {self.ref_shape}")
            out.append(comp)
            i += len(names)
        return tuple(out)

    def std(self) -> float:
        """The reference's rules: an explicit ``scale`` wins; ``embed``
        draws with 0.02; otherwise the fan-in rule on the reference's
        own leaf shape: dim 0 for 2-D and higher, dim 1 for 3-D (stacked
        2-D kernels), so stacked 4-D attention leaves ``[n_layers, d, H,
        hd]`` take the layer count as fan-in — copied as is, so both
        packages draw from one distribution."""
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 0.02
        shape = self.ref_shape or self.shape
        fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
        if len(shape) == 3:
            fan_in = shape[1]
        return 1.0 / math.sqrt(fan_in)


def dense_specs(d_in: int, d_out: int, in_ax: Optional[str] = None,
                out_ax: Optional[str] = None, use_bias: bool = False):
    s = {"kernel": ParamSpec((d_in, d_out), axes=(in_ax, out_ax))}
    if use_bias:
        s["bias"] = ParamSpec((d_out,), init="zeros", axes=(out_ax,))
    return s


def init_params(specs, seed: int = 0, dtype=torch.float32, device=None):
    """Spec tree -> tensor tree, drawn from ``torch.Generator(seed)`` on
    ``device`` (default ``cuda``; raises without one).  Each leaf is
    drawn in float32 and cast to ``dtype``."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(spec.std()).to(dtype)     # one float32 buffer a leaf

    return map_specs(draw, specs)


def abstract_params(specs, dtype=torch.bfloat16):
    """Spec tree -> tensors on the ``meta`` device: every leaf's shape
    in ``dtype``, nothing allocated (the dry run's counterpart of the
    reference's ``ShapeDtypeStruct`` parameters)."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                           device="meta"), specs)


def map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec of a dict / list tree."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"unsupported spec node {type(tree)!r}")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def layernorm(x: torch.Tensor, eps: float = 1e-6,
              scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm in float32 inside, cast back to x's type."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def rmsnorm_specs(d: int):
    return {"scale": ParamSpec((d,), init="ones", axes=(None,))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to x's type."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dtype)


@functools.lru_cache(maxsize=16)
def _host_frequencies(head_dim: int, theta: float,
                      device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):     # a plain tensor, whoever asks
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return (1.0 / (theta ** exps)).to(device)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)`` in float32, computed on the host
    (the reference's bits: XLA's CPU float32 pow) and copied to
    ``device`` once: a GPU's powf rounds a few of them one ulp away (4 of
    yi-9b's 64 on an H100), and at position ~5e5 one ulp moves a RoPE
    angle by ~0.03 rad.  The returned tensor is shared: do not write to
    it."""
    return _host_frequencies(head_dim, float(theta),
                             torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half (not interleaved) RoPE.  x: [..., seq, heads,
    head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [hd/2]
    angles = positions[..., :, None].to(torch.float32) * freqs  # [.., s, hd/2]
    angles = angles[..., None, :]                               # heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_specs(vocab: int, d: int):
    return {"embedding": ParamSpec((vocab, d), init="embed",
                                   axes=("vocab", "embed"))}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embedding"].T.to(x.dtype)

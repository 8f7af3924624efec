"""Mamba2 (SSD — state-space duality) block (counterpart of
``repro.models.ssm``).

The in-projection yields the gate ``z``, the conv input ``xbc`` and
``dt``; a depthwise causal conv, then the SSD scan over ``x``, ``B``
and ``C`` (column slices of the conv output), the D-skip, a gated
RMSNorm and the out-projection.  ``ssm_block`` runs the scan through
the op layer: the chunk-scan kernel on a CUDA tensor, under autograd
with the SSD-scan backward kernel (``ops.SSDChunkScanFn``), so the
block trains on the card; its plain version ``ref.ssd_chunk_scan_ref``
on the CPU (which also stands for the reference's ``ssd_chunked``:
asked, it returns the final state), differentiated by autograd.
Decode runs the O(1) recurrence (``ssd_recurrent_step``: plain PyTorch
on both devices, as the reference's einsums; not the chunk scan)
against an ``SSMCache`` that it updates in place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

_F32 = torch.float32


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm or SSMConfig()
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.d_state
    return ssm, d_inner, n_heads, conv_dim


def ssm_specs(cfg: ModelConfig, stack: int = 1):
    ssm, d_inner, n_heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    width = 2 * d_inner + 2 * ssm.d_state + n_heads
    return {
        # projects to [z (gate), x, B, C, dt]
        "in_proj": ParamSpec((d, width), ref_shape=(stack, d, width),
                             axes=("embed", "inner")),
        "conv_kernel": ParamSpec((ssm.conv_width, conv_dim), scale=0.1,
                                 axes=(None, "inner")),
        "conv_bias": ParamSpec((conv_dim,), init="zeros", axes=("inner",)),
        "A_log": ParamSpec((n_heads,), init="zeros", axes=("ssm_heads",)),
        "dt_bias": ParamSpec((n_heads,), init="zeros", axes=("ssm_heads",)),
        "D": ParamSpec((n_heads,), init="ones", axes=("ssm_heads",)),
        "norm_scale": ParamSpec((d_inner,), init="ones", axes=("inner",)),
        "out_proj": ParamSpec((d_inner, d), ref_shape=(stack, d_inner, d),
                              axes=("inner", "embed")),
    }


@dataclasses.dataclass
class SSMCache:
    """One mamba2 layer's decode cache: ``conv [B, W-1, conv_dim]``, the
    last conv inputs in the model dtype, and ``state [B, H, P, N]``, the
    recurrent state in float32.  Decode updates both in place."""
    conv: torch.Tensor
    state: torch.Tensor

    @classmethod
    def zeros(cls, batch: int, cfg: ModelConfig, dtype,
              device=None) -> "SSMCache":
        ssm, _, n_heads, conv_dim = _dims(cfg)
        return cls(
            conv=torch.zeros((batch, ssm.conv_width - 1, conv_dim),
                             dtype=dtype, device=device),
            state=torch.zeros((batch, n_heads, ssm.head_dim, ssm.d_state),
                              dtype=_F32, device=device))


def _split_proj(params, x: torch.Tensor, cfg: ModelConfig):
    ssm, d_inner, n_heads, _ = _dims(cfg)
    proj = x @ params["in_proj"].to(x.dtype)
    return torch.split(proj, [d_inner, d_inner + 2 * ssm.d_state, n_heads],
                       dim=-1)


def _causal_conv(params, xbc: torch.Tensor, cfg: ModelConfig, prefix=None):
    """Depthwise causal conv over [B, S, C]; prefix = [B, W-1, C] history.
    Returns (silu(conv), the last W-1 inputs)."""
    w = (cfg.ssm or SSMConfig()).conv_width
    if prefix is None:
        prefix = torch.zeros((xbc.shape[0], w - 1, xbc.shape[-1]),
                             dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prefix, xbc], dim=1)
    kernel = params["conv_kernel"].to(xbc.dtype)
    s = xbc.shape[1]
    out = xp[:, 0:s] * kernel[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * kernel[i]
    out = out + params["conv_bias"].to(xbc.dtype)
    return F.silu(out), xp[:, -(w - 1):]


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x: [B, S, d] -> [B, S, d]."""
    ssm, d_inner, n_heads, _ = _dims(cfg)
    b, s, _ = x.shape
    z, xbc, dt = _split_proj(params, x, cfg)
    xbc, _ = _causal_conv(params, xbc, cfg)
    # column slices of xbc: the kernel reads them through their strides
    xs, B, C = torch.split(xbc, [d_inner, ssm.d_state, ssm.d_state], dim=-1)
    xs = xs.reshape(b, s, n_heads, ssm.head_dim)
    A = -torch.exp(params["A_log"].to(_F32))
    dt = F.softplus(dt.to(_F32) + params["dt_bias"].to(_F32))
    y = ops.ssd(xs, dt, A, B, C, ssm.chunk)
    y = y + xs * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = common.rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z),
                       cfg.norm_eps)
    return y @ params["out_proj"].to(x.dtype)


def ssd_recurrent_step(x, dt, A, B, C, state: torch.Tensor):
    """Single-token recurrence, x [b, h, p], dt [b, h], B, C [b, n],
    state [b, h, p, n] float32: ``state = state·exp(dt·A) + dt·x⊗B`` in
    place, ``y = state·C``.  Returns ``(y [b, h, p] float32, state)``."""
    x, dt, B, C = (t.to(_F32) for t in (x, dt, B, C))
    dA = torch.exp(dt * A.to(_F32))                               # [b, h]
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt, B, x)
    state.mul_(dA[:, :, None, None]).add_(dbx)
    y = torch.einsum("bhpn,bn->bhp", state, C)
    return y, state


def ssm_decode_step(params, x: torch.Tensor, cfg: ModelConfig,
                    cache: SSMCache):
    """One-token decode, x [B, 1, d] -> (y [B, 1, d], cache); the conv
    history and the state are updated in place."""
    ssm, d_inner, n_heads, _ = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_proj(params, x, cfg)
    xbc, conv_state = _causal_conv(params, xbc, cfg, prefix=cache.conv)
    cache.conv.copy_(conv_state)
    xs, B, C = torch.split(xbc[:, 0], [d_inner, ssm.d_state, ssm.d_state],
                           dim=-1)
    xs = xs.reshape(b, n_heads, ssm.head_dim)
    A = -torch.exp(params["A_log"].to(_F32))
    dtv = F.softplus(dt[:, 0].to(_F32) + params["dt_bias"].to(_F32))
    y, _ = ssd_recurrent_step(xs, dtv, A, B, C, cache.state)
    y = y.to(x.dtype) + xs * params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, d_inner)
    y = common.rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z),
                       cfg.norm_eps)
    return y @ params["out_proj"].to(x.dtype), cache

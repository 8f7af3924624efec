"""Mamba2 (SSD — state-space duality) block, full-sequence path
(counterpart of ``repro.models.ssm``).

The in-projection yields the gate ``z``, the conv input ``xbc`` and
``dt``; a depthwise causal conv, then the SSD scan over ``x``, ``B``
and ``C`` (column slices of the conv output), the D-skip, a gated
RMSNorm and the out-projection.  ``ssm_block`` runs the scan through
the op layer: the chunk-scan kernel on a CUDA tensor, under autograd
with the SSD-scan backward kernel (``ops.SSDChunkScanFn``), so the
block trains on the card; its plain version ``ref.ssd_chunk_scan_ref``
on the CPU (which also stands for the reference's ``ssd_chunked``:
asked, it returns the final state), differentiated by autograd.  The
recurrent step and decode wait for the decode slice.
"""
from __future__ import annotations

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
        "in_proj": ParamSpec((d, width), ref_shape=(stack, d, width)),
        "conv_kernel": ParamSpec((ssm.conv_width, conv_dim), scale=0.1),
        "conv_bias": ParamSpec((conv_dim,), init="zeros"),
        "A_log": ParamSpec((n_heads,), init="zeros"),
        "dt_bias": ParamSpec((n_heads,), init="zeros"),
        "D": ParamSpec((n_heads,), init="ones"),
        "norm_scale": ParamSpec((d_inner,), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ref_shape=(stack, d_inner, d)),
    }


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

"""FLUX-like MMDiT denoiser (counterpart of ``repro.models.dit``).

Optional dual-stream (text+image) "double" blocks, then single-stream
joint blocks, AdaLN-zero modulation and a rectified-flow velocity head.
``dit_forward`` returns the image stream's Cumulative Residual Feature
(CRF) next to the velocity; ``dit_from_crf`` maps a predicted CRF to a
velocity through the final layer alone — the FreqCa skip path.

Layout differences from the reference, all exact reshapes: blocks are
per-layer lists instead of ``[n_layers, ...]`` stacks, and the attention
projections ``wq/wk/wv [d, H, hd]`` and ``wo [H, hd, d]`` are stored as
``[d, d]`` matrices.  ``double_block`` computes the joint attention once
and projects each stream's slice with its own ``wo`` (the reference
computes the same attention once per stream).

``backbone_denoiser_*`` wrap an assigned LM architecture (a
``ModelConfig``, e.g. mamba2-370m) as the denoiser: patch and time
embeddings around its non-causal layer stack, whose output is the CRF.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks, common
from repro_torch.models.common import ParamSpec


class DenoiserOutput(NamedTuple):
    velocity: torch.Tensor     # [B, H, W, C]
    crf: torch.Tensor          # [B, S_img, d] image-stream CRF


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """t: [B] in [0, 1] -> [B, dim] sinusoidal features (cos, then sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _pos_embedding(s: int, d: int, device) -> torch.Tensor:
    """[s, d] sinusoidal positions (sin, then cos)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    angles = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def patchify(latents: torch.Tensor, p: int) -> torch.Tensor:
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                              p * p * c)


def unpatchify(tokens: torch.Tensor, h: int, w: int, p: int,
               c: int) -> torch.Tensor:
    b = tokens.shape[0]
    x = tokens.reshape(b, h // p, w // p, p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _attn_specs(d: int, n_heads: int, stack: int):
    hd = d // n_heads
    return {
        "wq": ParamSpec((d, d), ref_shape=(stack, d, n_heads, hd),
                        axes=("embed", ("heads", "head_dim"))),
        "wk": ParamSpec((d, d), ref_shape=(stack, d, n_heads, hd),
                        axes=("embed", ("heads", "head_dim"))),
        "wv": ParamSpec((d, d), ref_shape=(stack, d, n_heads, hd),
                        axes=("embed", ("heads", "head_dim"))),
        "wo": ParamSpec((d, d), ref_shape=(stack, n_heads, hd, d),
                        axes=(("heads", "head_dim"), "embed")),
        "q_norm": ParamSpec((hd,), init="ones", axes=(None,)),
        "k_norm": ParamSpec((hd,), init="ones", axes=(None,)),
    }


def _mod_specs(d: int, n: int):
    """AdaLN-zero modulation: zero-initialised, as in the reference."""
    return {"kernel": ParamSpec((d, n * d), init="zeros",
                                axes=("embed", None)),
            "bias": ParamSpec((n * d,), init="zeros", axes=(None,))}


def single_block_specs(cfg: DiTConfig, stack: int):
    d = cfg.d_model
    return {"mod": _mod_specs(d, 6),
            "attn": _attn_specs(d, cfg.n_heads, stack),
            "mlp": {"wi": ParamSpec((d, cfg.d_ff),
                                    ref_shape=(stack, d, cfg.d_ff),
                                    axes=("embed", "ffn")),
                    "wo": ParamSpec((cfg.d_ff, d),
                                    ref_shape=(stack, cfg.d_ff, d),
                                    axes=("ffn", "embed"))}}


def dit_specs(cfg: DiTConfig):
    pdim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    d = cfg.d_model
    s = {
        "patch_proj": common.dense_specs(pdim, d, None, "embed",
                                         use_bias=True),
        "time_mlp1": common.dense_specs(cfg.time_embed_dim, d, None,
                                        "embed", use_bias=True),
        "time_mlp2": common.dense_specs(d, d, "embed", None, use_bias=True),
        "single": [single_block_specs(cfg, cfg.n_layers)
                   for _ in range(cfg.n_layers)],
        "final_mod": _mod_specs(d, 2),
        "final_proj": ParamSpec((d, pdim), init="zeros",
                                axes=("embed", None)),
    }
    if cfg.n_double > 0:
        s["double"] = [{"img": single_block_specs(cfg, cfg.n_double),
                        "txt": single_block_specs(cfg, cfg.n_double)}
                       for _ in range(cfg.n_double)]
    if cfg.text_dim > 0:
        s["text_proj"] = common.dense_specs(cfg.text_dim, d, None, "embed",
                                            use_bias=True)
    return s


def init_params(cfg: DiTConfig, seed: int = 0, device=None, dtype=None):
    """Random parameters of ``cfg`` (default type ``cfg.dtype``, default
    device ``cuda``)."""
    return common.init_params(dit_specs(cfg), seed,
                              dtype or torch_dtype(cfg.dtype), device)


# ---------------------------------------------------------------------------
# MMDiT blocks
# ---------------------------------------------------------------------------

def _modulation(params, cond: torch.Tensor, n: int):
    """cond: [B, d] -> n chunks of [B, 1, d]."""
    m = F.silu(cond) @ params["kernel"].to(cond.dtype) \
        + params["bias"].to(cond.dtype)
    return torch.chunk(m[:, None, :], n, dim=-1)


def _qkv_heads(p, x: torch.Tensor, n_heads: int):
    b, s, d = x.shape
    hd = d // n_heads

    def heads(w):
        return (x @ w.to(x.dtype)).reshape(b, s, n_heads, hd)

    q = common.layernorm(heads(p["wq"]), scale=p["q_norm"])
    k = common.layernorm(heads(p["wk"]), scale=p["k_norm"])
    return q, k, heads(p["wv"])


# flash-kernel threshold, the reference's TPU value; an H100
# measurement has yet to set the port's own
_FLASH_MIN_SEQ = 1024


def _flash_ok(s: int) -> bool:
    """The op layer's kernel edge-masks any S, so only the threshold
    decides; a head width the kernel lacks raises there."""
    return s >= _FLASH_MIN_SEQ


def _attention(q, k, v) -> torch.Tensor:
    """Non-causal MHA core ``[B, S, H, hd]``: the flash kernel above the
    threshold (through the op layer), else the full-logits path."""
    if _flash_ok(q.shape[1]):
        return ops.flash(q, k, v)
    return ref.attention_ref(q, k, v)


def _project(out: torch.Tensor, wo: torch.Tensor, x_dtype) -> torch.Tensor:
    b, s, h, hd = out.shape
    return out.reshape(b, s, h * hd) @ wo.to(x_dtype)


def single_block(params, x, cond, cfg: DiTConfig):
    """Single-stream joint block with AdaLN-zero."""
    sh1, sc1, g1, sh2, sc2, g2 = _modulation(params["mod"], cond, 6)
    h = common.layernorm(x, cfg.norm_eps) * (1 + sc1) + sh1
    q, k, v = _qkv_heads(params["attn"], h, cfg.n_heads)
    x = x + g1 * _project(_attention(q, k, v), params["attn"]["wo"],
                          x.dtype)
    h = common.layernorm(x, cfg.norm_eps) * (1 + sc2) + sh2
    y = F.gelu(h @ params["mlp"]["wi"].to(x.dtype), approximate="tanh")
    return x + g2 * (y @ params["mlp"]["wo"].to(x.dtype))


def double_block(params, img, txt, cond, cfg: DiTConfig):
    """Dual-stream MMDiT block: separate params, one joint attention."""
    streams = {"img": img, "txt": txt}
    qkvs, mods = {}, {}
    for name in ("img", "txt"):
        p = params[name]
        mods[name] = _modulation(p["mod"], cond, 6)
        sh1, sc1 = mods[name][0], mods[name][1]
        h = common.layernorm(streams[name], cfg.norm_eps) * (1 + sc1) + sh1
        qkvs[name] = _qkv_heads(p["attn"], h, cfg.n_heads)
    s_txt = txt.shape[1]
    # text tokens first, as in the reference
    q, k, v = (torch.cat([qkvs["txt"][i], qkvs["img"][i]], dim=1)
               for i in range(3))
    attn = _attention(q, k, v)
    outs = {}
    for name in ("img", "txt"):
        p = params[name]
        _, _, g1, sh2, sc2, g2 = mods[name]
        part = attn[:, s_txt:] if name == "img" else attn[:, :s_txt]
        x = streams[name] + g1 * _project(part, p["attn"]["wo"], img.dtype)
        h = common.layernorm(x, cfg.norm_eps) * (1 + sc2) + sh2
        y = F.gelu(h @ p["mlp"]["wi"].to(x.dtype), approximate="tanh")
        outs[name] = x + g2 * (y @ p["mlp"]["wo"].to(x.dtype))
    return outs["img"], outs["txt"]


def _time_cond(params, t, cfg: DiTConfig, dtype):
    emb = timestep_embedding(t, cfg.time_embed_dim).to(dtype)
    h = F.silu(common.dense(params["time_mlp1"], emb))
    return common.dense(params["time_mlp2"], h)


def dit_forward(params, latents: torch.Tensor, t: torch.Tensor,
                cfg: DiTConfig,
                text_embeds: Optional[torch.Tensor] = None
                ) -> DenoiserOutput:
    """latents: [B,H,W,C]; t: [B] in [0,1]; text_embeds: [B,T,text_dim]."""
    b, h, w, c = latents.shape
    dtype = torch_dtype(cfg.dtype)
    x = common.dense(params["patch_proj"],
                     patchify(latents.to(dtype), cfg.patch_size))
    s_img = x.shape[1]
    x = x + _pos_embedding(s_img, cfg.d_model, x.device).to(dtype)[None]
    cond = _time_cond(params, t, cfg, dtype)

    txt = None
    if cfg.text_dim > 0 and text_embeds is not None:
        txt = common.dense(params["text_proj"], text_embeds.to(dtype))
    if cfg.n_double > 0 and txt is not None:
        for layer in params["double"]:
            x, txt = double_block(layer, x, txt, cond, cfg)
    s_txt = 0
    if txt is not None:
        s_txt = txt.shape[1]
        x = torch.cat([txt, x], dim=1)
    for layer in params["single"]:
        x = single_block(layer, x, cond, cfg)
    crf = x[:, s_txt:]
    return DenoiserOutput(velocity=_final_layer(params, crf, cond, cfg, h, w),
                          crf=crf)


def _final_layer(params, crf, cond, cfg: DiTConfig, h: int, w: int):
    sh, sc = _modulation(params["final_mod"], cond, 2)
    y = common.layernorm(crf, cfg.norm_eps) * (1 + sc) + sh
    y = y @ params["final_proj"].to(crf.dtype)
    return unpatchify(y, h, w, cfg.patch_size, cfg.in_channels)


def dit_from_crf(params, crf: torch.Tensor, t: torch.Tensor,
                 cfg: DiTConfig, h: int, w: int) -> torch.Tensor:
    """FreqCa skip path: predicted CRF -> velocity (final layer only)."""
    cond = _time_cond(params, t, cfg, crf.dtype)
    return _final_layer(params, crf, cond, cfg, h, w)


# ---------------------------------------------------------------------------
# assigned-architecture backbones as denoisers
# ---------------------------------------------------------------------------

def backbone_denoiser_specs(cfg: ModelConfig, patch_size: int = 2,
                            in_channels: int = 4, time_dim: int = 256):
    pdim = patch_size * patch_size * in_channels
    return {
        "patch_proj": common.dense_specs(pdim, cfg.d_model, None, "embed",
                                         use_bias=True),
        "time_mlp1": common.dense_specs(time_dim, cfg.d_model, None,
                                        "embed", use_bias=True),
        "time_mlp2": common.dense_specs(cfg.d_model, cfg.d_model, "embed",
                                        None, use_bias=True),
        "stack": blocks.stack_specs(cfg),
        "final_norm": common.rmsnorm_specs(cfg.d_model),
        "final_proj": ParamSpec((cfg.d_model, pdim), init="zeros",
                                axes=("embed", None)),
    }


def backbone_denoiser_forward(params, latents: torch.Tensor, t: torch.Tensor,
                              cfg: ModelConfig, patch_size: int = 2,
                              time_dim: int = 256) -> DenoiserOutput:
    """latents [B, H, W, C]; t [B] -> (velocity, CRF [B, S, d])."""
    b, hh, ww, c = latents.shape
    dtype = torch_dtype(cfg.dtype)
    x = common.dense(params["patch_proj"],
                     patchify(latents.to(dtype), patch_size))
    x = x + _pos_embedding(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    emb = timestep_embedding(t, time_dim).to(dtype)
    temb = common.dense(params["time_mlp2"],
                        F.silu(common.dense(params["time_mlp1"], emb)))
    x = x + temb[:, None, :]
    h, _ = blocks.stack_full(params["stack"], x, cfg, causal=False)
    velocity = backbone_denoiser_from_crf(params, h, cfg, hh, ww, patch_size,
                                          c)
    return DenoiserOutput(velocity=velocity, crf=h)


def backbone_denoiser_from_crf(params, crf: torch.Tensor, cfg: ModelConfig,
                               h: int, w: int, patch_size: int = 2,
                               in_channels: int = 4) -> torch.Tensor:
    """FreqCa skip path of a backbone denoiser: final norm and
    projection only."""
    y = common.rmsnorm(params["final_norm"], crf, cfg.norm_eps)
    y = y @ params["final_proj"].to(y.dtype)
    return unpatchify(y, h, w, patch_size, in_channels)

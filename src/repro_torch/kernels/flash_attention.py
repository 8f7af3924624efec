"""Flash attention as a CUDA kernel: non-causal, causal, sliding-window
and grouped-query forms.

``flash_attention`` is the wrapper of ``csrc/flash_attention.cu`` (the
counterpart of ``repro.kernels.flash_attention``).  CUDA tensors only;
the op layer sends CPU tensors to ``ref.attention_ref``.  Any S and T
are taken: the kernel masks ragged tile edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (64, 128)   # the head widths the kernel is instantiated for


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_per_kv: int = 1, causal: bool = False,
                    window: int = 0) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, T, H / q_per_kv, hd] -> [B, S, H, hd].
    Causal keeps ``k_pos <= q_pos``, ``window > 0`` keeps ``k_pos >
    q_pos − window``."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    if q_per_kv < 1 or h % q_per_kv or window < 0:
        raise ValueError(f"flash_attention: {h} heads, q_per_kv {q_per_kv},"
                         f" window {window}")
    hkv = h // q_per_kv
    if k.shape != (b, t, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_per_kv "
                         f"{q_per_kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k, v must share one type")
    build.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, t, h, hkv, hd, int(causal), window,
                build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", status)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""Flash attention as CUDA kernels: non-causal, causal, sliding-window
and grouped-query forms, forward and backward.

``flash_attention`` is the wrapper of ``csrc/flash_attention.cu`` (the
counterpart of ``repro.kernels.flash_attention``); with ``return_lse``
it also returns each row's log-sum-exp, which ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``, bf16) recomputes the probabilities
from.  float32 forwards run on the TF32 tensor cores with each operand
split hi + lo (three products, float32 accuracy; the template
``csrc/flash_fwd_tf32.cuh``).  Both send float32 at head width 16,
non-causal with one kv head per query head (dit-small's joint
attention), to the library ``csrc/flash_attention_f32.cu``
(``flash_attention_f32``, that template at 16, and
``flash_attention_f32_bwd``, on the FMA units, each with its own launch
count); every other form at width 16 raises.  CUDA tensors only; the op layer sends
CPU tensors to ``ref.attention_ref``, which autograd differentiates.
Any S and T are taken: the kernels mask ragged tile edges.  On ``meta``
tensors the wrappers record their work (``fwd_work`` / ``bwd_work``,
``kernels.meta``) and return empty outputs; ``attention_pairs`` counts
the (query, key) pairs a mask keeps, which both formulas read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (64, 128)   # the head widths the kernels are instantiated for
F32_HEAD_DIM = 16       # flash_attention_f32's one width: float32, non-causal
                        # MHA only


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_per_kv: int, window: int, causal: bool = False) -> int:
    """Raise on what the kernels do not take; returns the kv heads."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    if q_per_kv < 1 or h % q_per_kv or window < 0:
        raise ValueError(f"{name}: {h} heads, q_per_kv {q_per_kv}, window "
                         f"{window}")
    hkv = h // q_per_kv
    if k.shape != (b, t, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, q_per_kv {q_per_kv}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k, v must share one type")
    if hd == F32_HEAD_DIM:
        if q.dtype != torch.float32 or causal or window or q_per_kv != 1:
            raise ValueError(
                f"{name}: head_dim {hd} takes float32, non-causal, no "
                f"window and q_per_kv 1 only (flash_attention_f32); got "
                f"{q.dtype}, causal {causal}, window {window}, q_per_kv "
                f"{q_per_kv}")
    elif hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS} "
                         f"(or {F32_HEAD_DIM} in float32)")
    return hkv


def _check_bwd(name: str, q: torch.Tensor, o: torch.Tensor,
               lse: torch.Tensor, do: torch.Tensor) -> None:
    """Raise unless ``o`` and ``do`` match ``q`` and ``lse`` is its
    float32 [B, H, S]."""
    b, s, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"{name}: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"expected {(b, h, s)} float32")


def attention_pairs(s: int, causal: bool = False, window: int = 0,
                    t: int = 0) -> int:
    """(query, key) pairs an attention of ``s`` queries on ``t`` keys
    (``t = s`` when 0) keeps: query i sees keys [max(0, i − window + 1),
    i + 1 if causal else t)."""
    t = t or s
    hi = s * (s + 1) // 2 if causal else s * t
    lo = (s - window) * (s - window + 1) // 2 if 0 < window < s else 0
    return hi - lo


_ELEM = {"bfloat16": 2, "float32": 4}


def fwd_work(b: int, s: int, t: int, hq: int, hkv: int, hd: int,
             dtype_name: str, causal: bool = False, window: int = 0,
             lse: bool = False):
    """The forward's work, ``({type: FLOP}, bytes)``: 4·hd FLOP a head
    and kept pair (Q·Kᵀ and P·V) on the tensor cores, under ``bfloat16``
    for bf16 inputs and ``tf32`` for float32 ones (the function once; the
    kernel's hi + lo split runs it three times); q, k, v read and the
    output written once, and with ``lse`` its float32 [B, H, S] too."""
    flops = 4 * hq * hd * b * attention_pairs(s, causal, window, t)
    nbytes = (2 * hq * s + 2 * hkv * t) * hd * _ELEM[dtype_name] * b
    op = "tf32" if dtype_name == "float32" else dtype_name
    return {op: flops}, nbytes + (b * hq * s * 4 if lse else 0)


def bwd_work(b: int, s: int, t: int, hq: int, hkv: int, hd: int,
             causal: bool = False, window: int = 0,
             dtype_name: str = "bfloat16"):
    """The backward's work: 10·hd FLOP a head and kept pair (S again, dV,
    dP, dQ, dK) in the inputs' type (bf16 on the tensor cores, float32 on
    the FMA units); q, o, dO read and dQ written, k, v read and dK, dV
    written, and the log-sum-exp read."""
    flops = 10 * hq * hd * b * attention_pairs(s, causal, window, t)
    nbytes = (4 * b * s * hq + 4 * b * t * hkv) * hd * _ELEM[dtype_name] \
        + b * hq * s * 4
    return {dtype_name: flops}, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_per_kv: int = 1, causal: bool = False,
                    window: int = 0, return_lse: bool = False):
    """q [B, S, H, hd]; k, v [B, T, H / q_per_kv, hd] -> [B, S, H, hd].
    Causal keeps ``k_pos <= q_pos``, ``window > 0`` keeps ``k_pos >
    q_pos − window``.  With ``return_lse``, ``(out, lse)`` with lse [B,
    H, S] float32, the row log-sum-exp of the scaled, masked logits."""
    b, s, h, hd = q.shape
    hkv = _check("flash_attention", q, k, v, q_per_kv, window, causal)
    if hd == F32_HEAD_DIM:
        return flash_attention_f32(q, k, v, return_lse)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:
        work = fwd_work(b, s, k.shape[1], h, hkv, hd, _dtype_name(q),
                        causal, window, return_lse)
        return meta.stand_in("flash_attention", work,
                             *((out, lse) if return_lse else (out,)))
    build.require_cuda("flash_attention", q, k, v)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, k.shape[1], h,
                hkv, hd, int(causal), window, build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention", status)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        q_per_kv: int = 1, causal: bool = False,
                        window: int = 0):
    """``(dq, dk, dv)`` of ``flash_attention`` from its output ``o``, its
    ``lse`` and the output's gradient ``do``: q, o, do [B, S, H, hd]; k,
    v [B, T, H / q_per_kv, hd]; lse [B, H, S] float32; bf16 at head width
    64 and 128 (a float32 backward at those widths is not written yet),
    float32 at 16 (``flash_attention_f32_bwd``).  Each gradient in its
    input's type, float32 accumulation on the tensor cores (wgmma).  Three
    launches: the row statistics, dK and dV (one block per key tile and
    kv head), dQ (one per query tile and head); a fourth sums, in a
    fixed order, the partial dK and dV of blocks that split a GQA group
    where the grid is small.  Each gradient row is written once and
    nothing is summed by atomics, so two calls are bitwise equal."""
    b, s, h, hd = q.shape
    hkv = _check("flash_attention_bwd", q, k, v, q_per_kv, window, causal)
    if hd == F32_HEAD_DIM:
        _check_bwd("flash_attention_bwd", q, o, lse, do)
        return flash_attention_f32_bwd(q, k, v, o, lse, do)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"flash_attention_bwd: {q.dtype} inputs at head_dim {hd}; the "
            "backward kernel takes bfloat16 only there (float32 at 64 and "
            "128 is queued in ROADMAP.md)")
    _check_bwd("flash_attention_bwd", q, o, lse, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.is_meta:
        return meta.stand_in("flash_attention_bwd", bwd_work(
            b, s, k.shape[1], h, hkv, hd, causal, window), dq, dk, dv)
    build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    lib = build.load("flash_attention_bwd")
    scratch = lib.flash_attention_bwd_scratch
    scratch.argtypes, scratch.restype = [_I] * 6, ctypes.c_long
    # the kernel's row statistics (lse·log2 e and D = rowsum(dO ∘ O)) and,
    # where it splits a GQA group over blocks, their partial dK and dV
    stats = torch.empty(scratch(b, s, k.shape[1], h, hkv, hd),
                        dtype=torch.float32, device=q.device)
    fn = lib.flash_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 9 + [_P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), stats.data_ptr(), b, s, k.shape[1], h, hkv, hd,
                int(causal), window, build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention_bwd", status)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        return_lse: bool = False):
    """The float32 forward at head width 16 (``csrc/
    flash_attention_f32.cu``, the 3xTF32 tensor-core template):
    non-causal MHA, q [B, S, H, 16], k, v [B, T, H, 16] float32 -> [B, S,
    H, 16] (and lse [B, H, S] with ``return_lse``).  Reached through
    ``flash_attention``, which checks the inputs."""
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:
        work = fwd_work(b, s, k.shape[1], h, h, hd, "float32",
                        lse=return_lse)
        return meta.stand_in("flash_attention_f32", work,
                             *((out, lse) if return_lse else (out,)))
    build.require_cuda("flash_attention_f32", q, k, v)
    lib = build.load("flash_attention_f32")
    fn = lib.flash_attention_f32_fwd
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, k.shape[1], h,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention_f32", status)
    flash_attention_f32.launches += 1
    return (out, lse) if return_lse else out


flash_attention_f32.launches = 0


def flash_attention_f32_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor):
    """``(dq, dk, dv)`` of ``flash_attention_f32`` from its output, its
    lse and the output's gradient, float32 on the FMA units.  Three
    launches: the row statistics (into a float32 scratch of the
    library's own size), dK and dV (one thread a key row), dQ (one a
    query row); each gradient row is written once and nothing is summed
    by atomics, so two calls are bitwise equal.  Reached through
    ``flash_attention_bwd``, which checks the inputs."""
    b, s, h, hd = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.is_meta:
        return meta.stand_in("flash_attention_f32_bwd", bwd_work(
            b, s, k.shape[1], h, h, hd, dtype_name="float32"), dq, dk, dv)
    build.require_cuda("flash_attention_f32_bwd", q, k, v, o, lse, do)
    lib = build.load("flash_attention_f32")
    scratch = lib.flash_attention_f32_bwd_scratch
    scratch.argtypes, scratch.restype = [_I] * 3, ctypes.c_long
    # the row statistics: lse·log2 e and D = rowsum(dO ∘ O), a float2 a row
    stats = torch.empty(scratch(b, s, h), dtype=torch.float32,
                        device=q.device)
    fn = lib.flash_attention_f32_bwd
    fn.argtypes = [_P] * 10 + [_I] * 4 + [_P]
    fn.restype = _I
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), stats.data_ptr(), b, s, k.shape[1], h,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, "flash_attention_f32_bwd", status)
    flash_attention_f32_bwd.launches += 1
    return dq, dk, dv


flash_attention_f32_bwd.launches = 0

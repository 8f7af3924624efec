"""Flash attention as CUDA kernels: non-causal, causal, sliding-window
and grouped-query forms, forward and backward.

``flash_attention`` is the wrapper of ``csrc/flash_attention.cu`` (the
counterpart of ``repro.kernels.flash_attention``); with ``return_lse``
it also returns each row's log-sum-exp, which ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``) recomputes the probabilities from.
float32 runs on the TF32 tensor cores with each operand split hi + lo
(three products, float32 accuracy): the forward's template
``csrc/flash_fwd_tf32.cuh``, the backward's ``csrc/flash_bwd_tf32.cuh``.

The forms each kernel takes (``_check``), every mask and GQA:

- any head width up to 128 (``MAX_HEAD_DIM``), run on the instance
  above it (``instance``: 16, 32, 64 or 128), the columns past it
  zero-filled in the kernels' own loads and the scale 1/√hd the true
  width's.  The kernels read rows of a multiple of 16 bytes (8 bf16, 4
  floats); another width runs on a zero-padded copy (``row_width``);
- up to 32 (``SMALL_HEAD_DIM``), float32 and bf16: the library
  ``csrc/flash_attention_f32.cu`` (``flash_attention_f32`` and
  ``flash_attention_f32_bwd``, each with its own launch count; float32
  on the TF32 template at 16 and 32 and its backward on the same split
  products, bf16 on the bf16 tensor cores, ``csrc/flash_bf16_small.cuh``;
  the library keeps the name of its first type);
- from 33 to 128: the forward and the backward in bf16 and float32;
- wider heads raise, naming ``ROADMAP.md``, where they are queued.

CUDA tensors only; the op layer sends CPU tensors to
``ref.attention_ref``, which autograd differentiates.
Any S and T are taken: the kernels mask ragged tile edges.  On ``meta``
tensors the wrappers record their work (``fwd_work`` / ``bwd_work``,
``kernels.meta``, at the true width) and return empty outputs;
``attention_pairs`` counts the (query, key) pairs a mask keeps, which
both formulas read.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (64, 128)      # flash_attention(_bwd).cu's instances
F32_HEAD_DIMS = (16, 32)   # flash_attention_f32.cu's: float32 and bf16
SMALL_HEAD_DIM = F32_HEAD_DIMS[-1]
MAX_HEAD_DIM = HEAD_DIMS[-1]


def instance(hd: int) -> int:
    """The kernel instance a head width runs on: the narrowest of 16,
    32, 64 and 128 that holds it."""
    return next(w for w in F32_HEAD_DIMS + HEAD_DIMS if hd <= w)


def row_width(hd: int, dtype: torch.dtype) -> int:
    """The row width the kernels read: ``hd`` rounded up to 16 bytes (8
    bf16, 4 floats), their copies' and TMA's unit."""
    vec = 16 * 8 // torch.finfo(dtype).bits
    return -(-hd // vec) * vec


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [..., hd] as a contiguous zero-padded copy of ``width`` columns."""
    return F.pad(x, (0, width - x.shape[-1])).contiguous()


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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16, got {q.dtype}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} above {MAX_HEAD_DIM}; "
                         "wider heads are queued in ROADMAP.md")
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
    dP, dQ, dK) on the tensor cores, under ``bfloat16`` for bf16 inputs
    and ``tf32`` for float32 ones (the function once; the kernel runs S
    and dP in both passes and each product three times); q, o, dO read
    and dQ written, k, v read and dK, dV written, and the log-sum-exp
    read."""
    flops = 10 * hq * hd * b * attention_pairs(s, causal, window, t)
    nbytes = (4 * b * s * hq + 4 * b * t * hkv) * hd * _ELEM[dtype_name] \
        + b * hq * s * 4
    op = "tf32" if dtype_name == "float32" else dtype_name
    return {op: flops}, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_per_kv: int = 1, causal: bool = False,
                    window: int = 0, return_lse: bool = False):
    """q [B, S, H, hd]; k, v [B, T, H / q_per_kv, hd] -> [B, S, H, hd].
    Causal keeps ``k_pos <= q_pos``, ``window > 0`` keeps ``k_pos >
    q_pos − window``.  With ``return_lse``, ``(out, lse)`` with lse [B,
    H, S] float32, the row log-sum-exp of the scaled, masked logits.
    Up to head width 32 the small library runs it
    (``flash_attention_f32``)."""
    b, s, h, hd = q.shape
    hkv = _check("flash_attention", q, k, v, q_per_kv, window, causal)
    width = row_width(hd, q.dtype)
    if width != hd and not q.is_meta:
        # rows of a 16-byte multiple: a zero-padded copy, the scale hd's
        out = _fwd(*(_pad(x, width) for x in (q, k, v)), q_per_kv, causal,
                   window, return_lse, hd)
        if return_lse:
            return out[0][..., :hd].contiguous(), out[1]
        return out[..., :hd].contiguous()
    return _fwd(q, k, v, q_per_kv, causal, window, return_lse, hd)


def _fwd(q, k, v, q_per_kv, causal, window, return_lse, scale_hd):
    """The forward on rows the kernels read (``row_width``), the logits
    scaled by 1/√scale_hd."""
    b, s, h, hd = q.shape
    hkv = h // q_per_kv
    if hd <= SMALL_HEAD_DIM:
        return flash_attention_f32(q, k, v, return_lse, q_per_kv, causal,
                                   window, scale_hd)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:
        work = fwd_work(b, s, k.shape[1], h, hkv, hd, _dtype_name(q),
                        causal, window, return_lse)
        return meta.stand_in("flash_attention", work,
                             *((out, lse) if return_lse else (out,)))
    build.require_cuda("flash_attention", q, k, v)
    fn = build.function("flash_attention", "flash_attention_fwd",
                        [_P] * 5 + [_I] * 10 + [_P])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, k.shape[1], h,
                hkv, hd, scale_hd, int(causal), window, build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.load("flash_attention"), "flash_attention", status)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        q_per_kv: int = 1, causal: bool = False,
                        window: int = 0):
    """``(dq, dk, dv)`` of ``flash_attention`` from its output ``o``, its
    ``lse`` and the output's gradient ``do``: q, o, do [B, S, H, hd]; k,
    v [B, T, H / q_per_kv, hd]; lse [B, H, S] float32; bf16 and float32
    at every head width up to 128 (up to 32 ``flash_attention_f32_bwd``).
    Each gradient in its input's type, float32 accumulation on the
    tensor cores.  bf16 (wgmma): three launches, the row statistics, dK
    and dV (one block per key tile and kv head), dQ (one per query tile
    and head); a fourth sums, in a fixed order, the partial dK and dV of
    blocks that split a GQA group where the grid is small.  float32
    (3xTF32 mma.sync, the logits computed as the forward's): three, dQ
    with the row statistics, then dV, then dK, a kv head's group of
    query heads summed in one warp in head order.  Each gradient row is
    written once and nothing is summed by atomics, so two calls are
    bitwise equal."""
    b, s, h, hd = q.shape
    _check("flash_attention_bwd", q, k, v, q_per_kv, window, causal)
    _check_bwd("flash_attention_bwd", q, o, lse, do)
    width = row_width(hd, q.dtype)
    if width != hd and not q.is_meta:
        grads = _bwd(*(_pad(x, width) for x in (q, k, v, o)), lse,
                     _pad(do, width), q_per_kv, causal, window, hd)
        return tuple(g[..., :hd].contiguous() for g in grads)
    return _bwd(q, k, v, o, lse, do, q_per_kv, causal, window, hd)


def _bwd(q, k, v, o, lse, do, q_per_kv, causal, window, scale_hd):
    """The backward on rows the kernels read, the logits scaled by
    1/√scale_hd."""
    b, s, h, hd = q.shape
    hkv = h // q_per_kv
    if hd <= SMALL_HEAD_DIM:
        return flash_attention_f32_bwd(q, k, v, o, lse, do, q_per_kv,
                                       causal, window, scale_hd)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.is_meta:
        return meta.stand_in("flash_attention_bwd", bwd_work(
            b, s, k.shape[1], h, hkv, hd, causal, window,
            dtype_name=_dtype_name(q)), dq, dk, dv)
    build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    scratch = build.function("flash_attention_bwd",
                             "flash_attention_bwd_scratch", [_I] * 7,
                             ctypes.c_long)
    # the kernel's row statistics (lse and D = rowsum(dO ∘ O)) and, where
    # the bf16 kernel splits a GQA group over blocks, their partial dK
    # and dV
    stats = torch.empty(scratch(b, s, k.shape[1], h, hkv, hd,
                                build.dtype_code(q)),
                        dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd",
                        [_P] * 10 + [_I] * 10 + [_P])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), stats.data_ptr(), b, s, k.shape[1], h, hkv, hd,
                scale_hd, int(causal), window, build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.load("flash_attention_bwd"), "flash_attention_bwd",
                status)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        return_lse: bool = False, q_per_kv: int = 1,
                        causal: bool = False, window: int = 0,
                        scale_hd: int = 0):
    """The forward at head width up to 32 (``csrc/flash_attention_f32.cu``:
    float32 on the TF32 template at 16 and 32, bf16 on the bf16 tensor
    cores), every form:
    q [B, S, H, hd], k, v [B, T, H / q_per_kv, hd] -> [B, S, H, hd] (and
    lse [B, H, S] with ``return_lse``), the logits scaled by
    1/√``scale_hd`` (default hd).  Reached through ``flash_attention``,
    which checks the inputs."""
    b, s, h, hd = q.shape
    hkv = h // q_per_kv
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.is_meta:
        work = fwd_work(b, s, k.shape[1], h, hkv, hd, _dtype_name(q), causal,
                        window, return_lse)
        return meta.stand_in("flash_attention_f32", work,
                             *((out, lse) if return_lse else (out,)))
    build.require_cuda("flash_attention_f32", q, k, v)
    fn = build.function("flash_attention_f32", "flash_attention_f32_fwd",
                        [_P] * 5 + [_I] * 10 + [_P])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, k.shape[1], h,
                hkv, hd, scale_hd or hd, int(causal), window,
                build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.load("flash_attention_f32"), "flash_attention_f32",
                status)
    flash_attention_f32.launches += 1
    return (out, lse) if return_lse else out


flash_attention_f32.launches = 0


def flash_attention_f32_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            q_per_kv: int = 1, causal: bool = False,
                            window: int = 0, scale_hd: int = 0):
    """``(dq, dk, dv)`` of ``flash_attention_f32`` from its output, its
    lse and the output's gradient, every form, each gradient in the
    inputs' type: float32 on the TF32 tensor cores (each operand split hi
    + lo, three products; S = Q·Kᵀ on the FMA units, rounded as float32
    rounds), bf16 on the bf16 tensor cores (one product each, P and dS
    rounded to bf16 once).  Two launches: dQ with the row statistics
    (into a float32 scratch of the library's own size), then dK and dV,
    a kv head's sum over its group of query heads taken in a fixed order
    (float32: in one warp, head by head; bf16: two head slices' partials
    joined in shared memory); each gradient row is written once by one
    warp and nothing is summed by atomics, so two calls are bitwise
    equal.  Reached through ``flash_attention_bwd``, which checks the
    inputs."""
    b, s, h, hd = q.shape
    hkv = h // q_per_kv
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.is_meta:
        return meta.stand_in("flash_attention_f32_bwd", bwd_work(
            b, s, k.shape[1], h, hkv, hd, causal, window,
            dtype_name=_dtype_name(q)), dq, dk, dv)
    build.require_cuda("flash_attention_f32_bwd", q, k, v, o, lse, do)
    scratch = build.function("flash_attention_f32",
                             "flash_attention_f32_bwd_scratch", [_I] * 3,
                             ctypes.c_long)
    # the row statistics: lse·log2 e and D = rowsum(dO ∘ O), a float2 a row
    stats = torch.empty(scratch(b, s, h), dtype=torch.float32,
                        device=q.device)
    fn = build.function("flash_attention_f32", "flash_attention_f32_bwd",
                        [_P] * 10 + [_I] * 10 + [_P])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), stats.data_ptr(), b, s, k.shape[1], h, hkv, hd,
                scale_hd or hd, int(causal), window, build.dtype_code(q),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(build.load("flash_attention_f32"),
                "flash_attention_f32_bwd", status)
    flash_attention_f32_bwd.launches += 1
    return dq, dk, dv


flash_attention_f32_bwd.launches = 0

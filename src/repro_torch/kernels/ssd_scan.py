"""Mamba2 SSD chunk scan as CUDA kernels, forward and backward.

``ssd_chunk_scan`` is the wrapper of ``csrc/ssd_scan.cu`` (the
counterpart of ``repro.kernels.ssd_scan``).  CUDA tensors only; the op
layer sends CPU tensors to ``ref.ssd_chunk_scan_ref``.  ``x``, ``B`` and
``C`` may be column slices of one ``[b, s, ·]`` tensor (as the mamba2
block's are): the kernel reads them through their batch and token
strides, so nothing is copied.

The kernels are instantiated for heads of 64 (``HEAD_DIM``).  A head
of 64·r (jamba's 128) runs as r heads of 64 (``split_heads``): the scan
is linear in x and the state ``[n, p]`` keeps its p columns apart, so
``y[..., j]`` depends on ``x[..., j]`` alone, through the head's dt and
A and the shared B and C.  The split is a view of x (batch and token
strides kept), dt and A are repeated r times per head, and the
backward sums each head's r copies of ddt and dA back
(``merge_head_grads``); dx is a view again, dB and dC are unchanged.

The kernel is chunk-parallel (``ref.ssd_chunk_scan_parallel_ref`` is
its algorithm in plain PyTorch): ``C Bᵀ`` once per (lane, chunk), each
chunk's own state contribution per (lane, chunk, head), the state
passed from chunk to chunk per (lane, head), then each chunk's output
per (lane, chunk, head); every product on the tensor cores (bf16
operands, a float32 one split into bf16 hi + lo).  The wrapper
allocates the float32 workspaces of those passes; one call counts as
one launch.

``ssd_chunk_scan_bwd`` is the wrapper of ``csrc/ssd_scan_bwd.cu``, the
gradients of the scan with respect to all five inputs
(``ref.ssd_chunk_scan_bwd_ref`` is its plain version, and
``ref.ssd_chunk_scan_bwd_split_ref`` writes out the kernel's
decomposition on the tensor cores); the op layer's ``SSDChunkScanFn``
calls it.  The reference has no such kernel: XLA
differentiates ``repro.models.ssm.ssd_chunked``.

On ``meta`` tensors both wrappers record their work (``fwd_work`` /
``bwd_work``, ``kernels.meta``) and return empty outputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
HEAD_DIM = 64          # the head width the kernels are instantiated for
MAX_STATE = 128        # largest d_state (a multiple of 8)
TILE = 64              # the chunk is a multiple of this, at most 256


def _strided_ok(t: torch.Tensor, inner: tuple) -> bool:
    """The innermost strides are ``inner`` (elements)."""
    return tuple(t.stride()[-len(inner):]) == inner


def _check(name: str, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Raise on what the kernels do not take; returns (b, s, h, p, n, q)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if p % HEAD_DIM or n > MAX_STATE or n % 8:
        raise ValueError(f"{name}: head_dim {p} (needs a multiple of "
                         f"{HEAD_DIM}), d_state {n} (needs a multiple of 8 "
                         f"up to {MAX_STATE})")
    if q % TILE or q > 4 * TILE or s % q:
        raise ValueError(f"{name}: chunk {q} must be a multiple of "
                         f"{TILE} up to {4 * TILE} dividing S={s}")
    if not x.dtype == B.dtype == C.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise TypeError(f"{name}: x, B, C share one type; dt and A "
                        "are float32")
    dev = x.device
    for t in (x, dt, A, B, C):
        if t.device.type not in ("cuda", "meta") or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one "
                             f"device, got {t.device}")
    if not (_strided_ok(x, (p, 1)) and _strided_ok(dt, (1,))
            and _strided_ok(B, (1,)) and _strided_ok(C, (1,))
            and A.is_contiguous()):
        raise ValueError(f"{name}: x needs contiguous heads, dt, B "
                         "and C a contiguous last axis")
    return b, s, h, p, n, q


def scan_flops(b: int, s: int, h: int, p: int, n: int, q: int,
               dtype_name: str) -> dict:
    """The operations the scan needs, by the type of their operands.
    With T = Q(Q+1)/2, the (i, j <= i) pairs of a chunk: C Bᵀ on the
    kept triangle, 2·T·N once per (batch, chunk) — B and C are one group
    shared by every head — with x's type as operands (bf16 products
    accumulate exactly in float32 on the tensor cores); per (batch,
    chunk, head) the masked scores · x, 2·T·P, and C · state plus the
    state update, 4·Q·N·P, both on float32 operands."""
    tri, chunks = q * (q + 1) // 2, b * (s // q)
    ops = {"float32": chunks * h * (2 * tri * p + 4 * q * n * p)}
    ops[dtype_name] = ops.get(dtype_name, 0) + chunks * 2 * tri * n
    return ops


def scan_bwd_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """The operations the scan's gradients need, counted on the kept
    triangles (T = Q(Q+1)/2 pairs a chunk): per (batch, chunk) C Bᵀ
    again, 2·T·N, and Z·B and Zᵀ·C, 2·T·N each, on Z summed over the
    heads (dB and dC sum over heads, and Σ_h (Z^h B) = (Σ_h Z^h) B; the
    sum's T·H additions are not counted); per (batch, chunk, head) dy·xᵀ
    and Mᵀ·dy, 2·T·P each, and five [Q, N, P] products of 2·Q·N·P (the
    forward's state again, its gradient's own share, B·D, S·dy and
    D·x)."""
    tri, chunks = q * (q + 1) // 2, b * (s // q)
    return chunks * 6 * tri * n + chunks * h * (4 * tri * p + 10 * q * n * p)


def fwd_work(b: int, s: int, h: int, p: int, n: int, q: int, elem: int):
    """The forward's work, ``({type: FLOP}, bytes)``: ``scan_flops``, all
    at the bf16 tensor-core peak, where the kernel runs every product;
    x read and y written, B and C read (``elem`` bytes an element), dt
    and A read in float32."""
    flops = sum(scan_flops(b, s, h, p, n, q, "bfloat16").values())
    nbytes = 2 * b * s * h * p * elem + 2 * b * s * n * elem \
        + b * s * h * 4 + h * 4
    return {"bfloat16": flops}, nbytes


def bwd_work(b: int, s: int, h: int, p: int, n: int, q: int, elem: int):
    """The backward's work: ``scan_bwd_flops`` at the bf16 peak; x, dy
    read and dx written, B, C read and dB, dC written, dt read and ddt
    written, A read and dA written."""
    nbytes = (3 * b * s * h * p + 4 * b * s * n) * elem + 2 * b * s * h * 4 \
        + 2 * h * 4
    return {"bfloat16": scan_bwd_flops(b, s, h, p, n, q)}, nbytes


def split_heads(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor):
    """``x [b, s, h, 64·r]``, ``dt [b, s, h]``, ``A [h]`` -> the same scan
    on ``h·r`` heads of 64: x as a view ``[b, s, h·r, 64]`` (its batch and
    token strides kept), dt and A repeated r times per head.  Any
    device; at r = 1 the inputs themselves."""
    b, s, h, p = x.shape
    r = p // HEAD_DIM
    if r == 1:
        return x, dt, A
    return (x.view(b, s, h * r, HEAD_DIM), dt.repeat_interleave(r, dim=-1),
            A.repeat_interleave(r))


def merge_head_grads(grads, p: int):
    """``(dx, ddt, dA, dB, dC)`` of the scan on ``split_heads``' inputs ->
    those of the scan on heads of ``p``: dx viewed back to ``[b, s, h,
    p]``, each head's r = p / 64 copies of ddt and dA summed (in float32,
    in a fixed order), dB and dC as they are."""
    dx, ddt, dA, dB, dC = grads
    r = p // HEAD_DIM
    if r == 1:
        return grads
    b, s, hr, _ = dx.shape
    h = hr // r
    return (dx.view(b, s, h, p), ddt.view(b, s, h, r).sum(-1),
            dA.view(h, r).sum(-1), dB, dC)


def _forward(x, dt, A, B, C, q: int, y):
    """The forward library's passes into new float32 workspaces: all
    four with ``y`` given (written), passes 1-3 with ``y`` None.  Returns
    the workspaces ``(gram, states, decay)``: C Bᵀ per chunk, the state
    entering each chunk (after pass 3) and exp(cum_Q) per chunk."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // q
    f32 = dict(dtype=torch.float32, device=x.device)
    gram = torch.empty((b, nc, q, q), **f32)          # C Bᵀ per chunk
    # each chunk's own contribution, overwritten by the state entering it
    states = torch.empty((b, nc, h, n, p), **f32)
    decay = torch.empty((b, nc, h), **f32)            # exp(cum_Q) per chunk
    lib = build.load("ssd_scan")
    fn = lib.ssd_chunk_scan_fwd
    fn.argtypes = [_P, _L, _L, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P,
                   _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(x.data_ptr(), x.stride(0), x.stride(1),
                dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
                B.data_ptr(), B.stride(0), B.stride(1),
                C.data_ptr(), C.stride(0), C.stride(1),
                None if y is None else y.data_ptr(),
                gram.data_ptr(), states.data_ptr(), decay.data_ptr(),
                b, s, h, n, q, build.dtype_code(x),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "ssd_chunk_scan", status)
    return gram, states, decay


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   chunk: int = 256) -> torch.Tensor:
    """x [b, s, h, 64·r]; dt [b, s, h] float32; A [h] float32; B, C [b,
    s, n] in x's type -> y [b, s, h, 64·r] in x's type (r > 1 through
    ``split_heads``)."""
    build.require_no_grad("ssd_chunk_scan", x, dt, A, B, C)
    b, s, h, p, n, q = _check("ssd_chunk_scan", x, dt, A, B, C, chunk)
    if x.is_meta:
        return meta.stand_in("ssd_chunk_scan", fwd_work(
            b, s, h, p, n, q, x.element_size()), torch.empty_like(x))
    xs, dts, As = split_heads(x, dt, A)
    y = torch.empty(xs.shape, dtype=x.dtype, device=x.device)
    _forward(xs, dts, As, B, C, q, y)
    ssd_chunk_scan.launches += 1
    return y.view(b, s, h, p)


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                       chunk: int = 256):
    """``(dx, ddt, dA, dB, dC)`` of ``ssd_chunk_scan`` for the output
    gradient ``dy [b, s, h, 64·r]`` (x's type; r > 1 through
    ``split_heads`` and ``merge_head_grads``), the wrapper of
    ``csrc/ssd_scan_bwd.cu``: x, B, C as the forward takes them (strided
    column slices allowed); dx, dB, dC in x's type, ddt ``[b, s, h]``
    and dA ``[h]`` float32.  It reruns the forward's passes 1-3 (C Bᵀ
    and the state entering each chunk, so nothing but the inputs is
    saved), then the backward's launches; dB and dC sum over heads
    through Z summed per chunk, and every sum over heads, tiles and
    chunks is taken in a fixed order (no atomics), so two calls are
    bitwise equal.  One call counts as one launch."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_chunk_scan_bwd: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device} must match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    b, s, h, p, n, q = _check("ssd_chunk_scan_bwd", x, dt, A, B, C, chunk)
    if x.is_meta:
        return meta.stand_in(
            "ssd_chunk_scan_bwd", bwd_work(b, s, h, p, n, q,
                                           x.element_size()),
            torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
            torch.empty_like(B), torch.empty_like(C))
    x, dt, A = split_heads(x, dt, A)
    h = x.shape[2]
    dy = dy.contiguous().view(x.shape)
    if dy.data_ptr() % 16:    # the kernel reads dy's rows 16 bytes at a time
        dy = dy.clone()
    gram, states, decay = _forward(x, dt, A, B, C, q, None)
    dev, nc = x.device, s // q
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    # the state's gradient per chunk; Z summed over the heads per chunk;
    # per (lane, chunk, head) and token cum, dt and the partials of ddt
    # (five, then two per 64-token tile); dA per chunk
    dstate = torch.empty((b, nc, h, n, HEAD_DIM), **f32)
    zsum = torch.empty((b, nc, q, q), **f32)
    tok = torch.empty((5 + 2 * (q // TILE), b, nc, h, q), **f32)
    daw = torch.empty((b, nc, h), **f32)
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_chunk_scan_bwd
    fn.argtypes = ([_P, _L, _L, _P, _L, _L, _P, _P, _L, _L, _P, _L, _L]
                   + [_P] * 13 + [_I] * 6 + [_P])
    fn.restype = _I
    status = fn(x.data_ptr(), x.stride(0), x.stride(1),
                dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
                B.data_ptr(), B.stride(0), B.stride(1),
                C.data_ptr(), C.stride(0), C.stride(1), dy.data_ptr(),
                gram.data_ptr(), states.data_ptr(), decay.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), dstate.data_ptr(), zsum.data_ptr(),
                tok.data_ptr(), daw.data_ptr(),
                b, s, h, n, q, build.dtype_code(x),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, "ssd_chunk_scan_bwd", status)
    ssd_chunk_scan_bwd.launches += 1
    return merge_head_grads((dx, ddt, dA, dB, dC), p)


ssd_chunk_scan_bwd.launches = 0

"""Port parity at the forms the TPU kernels take beyond the instances the
CUDA kernels are compiled for, on the CPU: attention in bf16 at head
widths 16 and 32 and at any head width up to 128 (kernels 3 and 7), and
the SSD scan at any chunk up to 256, any head width and any d_state up
to 128 (kernels 6 and 8).

- The plain versions (the op layer's CPU route, the CUDA kernels'
  oracles) against repro's Pallas kernels in interpret mode: float32
  1e-5 relative to the largest output (the two sum in different
  orders); bf16 2e-2 (the plain version rounds the probabilities and
  the output to bf16, the Pallas kernel the output only).
- Their backward twins against XLA's autodiff of the reference's
  ``blockwise_sdpa`` and ``ssd_chunked``: float32 1e-5 relative to the
  largest gradient, the SSD's dA 1e-3 (a sum over every token whose
  terms cancel, as ``test_torch_ssd_bwd.py``); bf16 2e-2.
- The algebra the kernels' forms rest on, on the plain versions: zero
  columns past the head width change neither attention (with the true
  width's scale) nor the scan; a head run in pieces equals the whole;
  zero columns of B and C change nothing; each chunk of Q followed by
  tokens with dt = 0 and x, B, C = 0 (``ssd_scan.kernel_form``) scans
  as the chunk of Q (the forward to 1e-6: it read 0.0 exactly; the
  gradients sum in another order, 1e-5 and dA 1e-3 as above); the
  chunk-parallel twin holds at the new chunks.
- On ``meta`` tensors the wrappers take every new form and record the
  work at the true widths; the forms still queued in ``ROADMAP.md``
  raise, naming it, before any device check.

XLA's CPU compile of each reference program is most of these tests'
time, so each form's references (the Pallas kernel and the ``jax.vjp``)
are one program, compiled once a module at XLA's optimisation level 0
(``_FAST``: the same HLO, only the machine code is less tuned) and shared
by the form's forward and backward tests, which draw the same inputs.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import flash_attention as jfa
from repro.kernels import ssd_scan as jssd
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, ops, ref, ssd_scan

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BF = torch.bfloat16
F32 = torch.float32
# (dtype, B, S, Hq, Hkv, hd, causal, window): the reference's dtype test
# (bf16 at hd 32, causal GQA 4/2), bf16 at hd 16 with a window, DiT-XL's
# head of 72 non-causal, Phi-3's 96 causal GQA, 24 (instance 32), and
# float32 at the wide instances' own widths: 64 non-causal MHA, 128
# causal GQA with a window
FLASH_FORMS = [(BF, 1, 64, 4, 2, 32, True, 0), (BF, 1, 64, 4, 2, 16, True, 24),
               (BF, 2, 128, 2, 2, 72, False, 0),
               (F32, 2, 128, 2, 2, 72, False, 0),
               (F32, 1, 128, 4, 2, 96, True, 0),
               (F32, 2, 64, 4, 2, 24, True, 24),
               (F32, 2, 128, 2, 2, 64, False, 0),
               (F32, 1, 128, 4, 2, 128, True, 24)]
# (S, P, N, chunk): the reference's SSD test at chunk 8, chunks of 24
# and 48, a head of 48 and a state of 12
SSD_FORMS = [(32, 16, 8, 8), (96, 16, 8, 24), (96, 16, 8, 48),
             (64, 48, 16, 16), (64, 16, 12, 16)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.float().numpy()


def _flash_inputs(b, s, hq, hkv, hd, dtype, seed):
    """q, k, v, dO drawn with numpy, as torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, hq, hd)).astype(np.float32)
             for _ in "qd")
    k, v = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
            for _ in "kv")
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v, do))


def _jnp(t):
    """A torch tensor as a jax array of the same type."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF else a


# the references' compile options: level 0 cuts XLA's CPU compile ~3x
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _run(fn, *args):
    """``fn`` on ``args``, jitted and compiled with ``_FAST``."""
    return jax.jit(fn).lower(*args).compile(_FAST)(*args)


@functools.cache
def _flash_refs(form):
    """One ``FLASH_FORMS`` entry's inputs (seed 42) and its references,
    computed once a module in one program: the Pallas kernel in
    interpret mode (blocks of 32) and ``jax.vjp`` of the reference's
    ``blockwise_sdpa`` (float32 on the inputs' values) at dO."""
    dtype, b, s, hq, hkv, hd, causal, window = form
    inputs = _flash_inputs(b, s, hq, hkv, hd, dtype, seed=42)
    g = hq // hkv

    def refs(qj, kj, vj, *f32):
        out = jfa.flash_attention(qj, kj, vj, g, causal=causal,
                                  window=window, q_block=32, kv_block=32,
                                  interpret=True)
        _, vjp = jax.vjp(lambda a, c, e: jattn.blockwise_sdpa(
            a, c, e, g, causal=causal, window=window, kv_block=32),
            *f32[:3])
        return out, vjp(f32[3])
    out, grads = _run(refs, *(_jnp(x) for x in inputs[:3]),
                      *(jnp.asarray(_np(x)) for x in inputs))
    return inputs, np.asarray(out, np.float32), [np.asarray(x)
                                                 for x in grads]


@pytest.mark.parametrize("dtype,b,s,hq,hkv,hd,causal,window", FLASH_FORMS)
def test_flash_forms_match_pallas(dtype, b, s, hq, hkv, hd, causal, window):
    """The plain attention (the op layer's CPU route) against the Pallas
    kernel in interpret mode (blocks of 32) on the same inputs."""
    (q, k, v, _), want, _ = _flash_refs((dtype, b, s, hq, hkv, hd, causal,
                                         window))
    got = ops.flash(q, k, v, hq // hkv, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(_np(got), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype,b,s,hq,hkv,hd,causal,window", FLASH_FORMS)
def test_flash_forms_backward_match_jax(dtype, b, s, hq, hkv, hd, causal,
                                        window):
    """The backward twin (the kernels' recompute from o and lse) and
    autograd through the op layer's CPU route against ``jax.vjp`` of
    the reference's ``blockwise_sdpa`` (float32 on the inputs' values)."""
    (q, k, v, do), _, want = _flash_refs((dtype, b, s, hq, hkv, hd, causal,
                                          window))
    g = hq // hkv
    o, lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    got = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (ops.flash(*leaves, g, causal=causal, window=window).float()
     * do.float()).sum().backward()
    for twin, auto, w in zip(got, leaves, want, strict=True):
        assert twin.dtype == dtype
        assert _rel(_np(twin), w) <= TOL[dtype]
        assert _rel(_np(auto.grad), w) <= TOL[dtype]


def _ssd_inputs(s, p, n, seed, h=2):
    """repro's SSD test inputs (b 2) and an output gradient."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm, cm = ((rng.standard_normal((2, s, n)) * 0.5).astype(np.float32)
              for _ in "bc")
    dy = rng.standard_normal((2, s, h, p)).astype(np.float32)
    return x, dt, a, bm, cm, dy


@functools.cache
def _ssd_refs(form):
    """One ``SSD_FORMS`` entry's inputs (seed 44) and its references,
    computed once a module in one program: the Pallas kernel in
    interpret mode and ``jax.vjp`` of the reference's ``ssd_chunked``
    (the gradient of y) at dy."""
    s, p, n, chunk = form
    inputs = _ssd_inputs(s, p, n, seed=44)

    def refs(*t):
        y = jssd.ssd_chunk_scan(*t[:5], chunk, interpret=True)
        _, vjp = jax.vjp(lambda *u: jssm.ssd_chunked(*u, chunk)[0], *t[:5])
        return y, vjp(t[5])
    y, grads = _run(refs, *(jnp.asarray(t) for t in inputs))
    return inputs, np.asarray(y), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS)
def test_ssd_forms_match_pallas(s, p, n, chunk):
    """The plain SSD scan against the Pallas kernel in interpret mode."""
    (x, dt, a, bm, cm, _), want, _ = _ssd_refs((s, p, n, chunk))
    got = ops.ssd(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), chunk)
    assert got.shape == (2, s, 2, p)
    assert _rel(got.numpy(), want) <= TOL[F32]


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS)
def test_ssd_forms_backward_match_jax(s, p, n, chunk):
    """The SSD backward twin and autograd through the op layer's CPU
    route against ``jax.vjp`` of the reference's ``ssd_chunked`` (the
    gradient of y), on inputs whose cum stays above −60 (``ssd_chunked``
    does not clip)."""
    (x, dt, a, bm, cm, dy), _, want = _ssd_refs((s, p, n, chunk))
    cum = (dt * a).reshape(2, s // chunk, chunk, 2).cumsum(axis=2)
    assert cum.min() > -60.0
    tensors = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    got = ref.ssd_chunk_scan_bwd_ref(*tensors, torch.from_numpy(dy), chunk)
    leaves = [t.clone().requires_grad_() for t in tensors]
    ops.ssd(*leaves, chunk).backward(torch.from_numpy(dy))
    for name, twin, auto, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                   leaves, want, strict=True):
        tol = 1e-3 if name == "dA" else TOL[F32]
        assert _rel(twin.numpy(), w) <= tol, name
        assert _rel(auto.grad.numpy(), w) <= tol, name


# --- the algebra of the forms, on the plain versions ------------------------

@pytest.mark.parametrize("hd,causal,window", [(72, False, 0), (24, True, 24),
                                              (96, True, 0), (20, True, 0)])
def test_attention_zero_columns_change_nothing(hd, causal, window):
    """q, k, v padded with zero columns to the instance's width, the
    logits scaled by the true width's 1/√hd (q times √(w / hd) here, as
    the kernels take the scale apart), give the true attention in the
    first hd columns, zeros past them, and the same gradients."""
    q, k, v, do = _flash_inputs(2, 64, 4, 2, hd, F32, seed=45)
    w = fa.instance(hd)

    def pad(x):
        return F.pad(x, (0, w - hd))
    qs = pad(q) * math.sqrt(w / hd)
    got = ref.attention_ref(qs, pad(k), pad(v), 2, causal, window)
    want = ref.attention_ref(q, k, v, 2, causal, window)
    assert _rel(got[..., :hd], want) <= TOL[F32]
    assert not got[..., hd:].any()
    o, lse = ref.attention_lse_ref(qs, pad(k), pad(v), 2, causal, window)
    grads = ref.attention_bwd_ref(qs, pad(k), pad(v), o, lse, pad(do), 2,
                                  causal, window)
    o0, lse0 = ref.attention_lse_ref(q, k, v, 2, causal, window)
    want = ref.attention_bwd_ref(q, k, v, o0, lse0, do, 2, causal, window)
    # dQ of the scaled q carries the scale once more
    scales = (math.sqrt(w / hd), 1.0, 1.0)
    for g_, w_, sc in zip(grads, want, scales, strict=True):
        assert _rel(g_[..., :hd] * sc, w_) <= TOL[F32]
        assert not g_[..., hd:].any()


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS + [(200, 20, 5, 100)])
def test_ssd_kernel_form_scans_the_chunk_asked_for(s, p, n, chunk):
    """``kernel_form``'s operands (each chunk's q tokens followed by
    tokens with dt = 0 and x, B, C = 0; x's columns to the head instance,
    B's and C's to a multiple of 8) scanned in the instance's chunk and
    cut back equal the scan at the chunk asked for, forward and
    backward."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t)
                            for t in _ssd_inputs(s, p, n, seed=46))
    xk, dtk, bk, ck, dyk, qk = ssd_scan.kernel_form(x, dt, bm, cm, chunk, dy)
    assert qk == ssd_scan.kernel_chunk(chunk)
    assert xk.shape == (2, s // chunk * qk, 2, ssd_scan.kernel_head(p))
    assert bk.shape[-1] == ssd_scan.kernel_state(n)
    y = ref.ssd_chunk_scan_ref(xk, dtk, a, bk, ck, qk)
    crop = ssd_scan._crop
    assert _rel(crop(y, s, chunk, qk, p).numpy(),
                ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk).numpy()) \
        <= 1e-6
    got = ref.ssd_chunk_scan_bwd_ref(xk, dtk, a, bk, ck, dyk, qk)
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk)
    cut = (crop(got[0], s, chunk, qk, p), crop(got[1], s, chunk, qk),
           got[2], crop(got[3], s, chunk, qk, n), crop(got[4], s, chunk, qk,
                                                       n))
    for name, g_, w in zip(("dx", "ddt", "dA", "dB", "dC"), cut, want,
                           strict=True):
        assert g_.shape == w.shape
        assert _rel(g_.numpy(), w.numpy()) <= (1e-3 if name == "dA"
                                               else TOL[F32]), name


def test_ssd_kernel_form_keeps_the_forms_it_fits():
    """A form the kernels are instantiated for is passed as it is: the
    inputs themselves, no copy."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t)
                            for t in _ssd_inputs(64, 32, 16, seed=47))
    got = ssd_scan.kernel_form(x, dt, bm, cm, 16, dy)
    assert all(g_ is w for g_, w in zip(got, (x, dt, bm, cm, dy),
                                        strict=False)) and got[-1] == 16


@pytest.mark.parametrize("pieces", [(32, 16), (16, 16, 16), (40, 8)])
def test_ssd_head_in_pieces_equals_the_whole(pieces):
    """A head of 48 scanned as column pieces (each with the head's dt and
    A) gives the whole head's y and gradients, each column apart."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t)
                            for t in _ssd_inputs(64, 48, 16, seed=48))
    want_y = ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, 16)
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 16)
    ys, dxs, ddt, da, db, dc = [], [], 0, 0, 0, 0
    c0 = 0
    for w in pieces:
        xp, dyp = x[..., c0:c0 + w], dy[..., c0:c0 + w]
        ys.append(ref.ssd_chunk_scan_ref(xp, dt, a, bm, cm, 16))
        g_ = ref.ssd_chunk_scan_bwd_ref(xp, dt, a, bm, cm, dyp, 16)
        dxs.append(g_[0])
        ddt, da, db, dc = ddt + g_[1], da + g_[2], db + g_[3], dc + g_[4]
        c0 += w
    assert _rel(torch.cat(ys, -1).numpy(), want_y.numpy()) <= TOL[F32]
    for g_, w in zip((torch.cat(dxs, -1), ddt, da, db, dc), want,
                     strict=True):
        assert _rel(g_.numpy(), w.numpy()) <= (1e-3 if g_.dim() == 1
                                               else TOL[F32])


def test_ssd_zero_state_columns_change_nothing():
    """B and C of d_state 12 zero-filled to 16 give the same y, and the
    same gradients in their first 12 columns (zeros past them)."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t)
                            for t in _ssd_inputs(64, 16, 12, seed=49))
    pad = (lambda t: F.pad(t, (0, 4)))
    y = ref.ssd_chunk_scan_ref(x, dt, a, pad(bm), pad(cm), 16)
    assert _rel(y.numpy(), ref.ssd_chunk_scan_ref(x, dt, a, bm, cm,
                                                  16).numpy()) <= 1e-6
    got = ref.ssd_chunk_scan_bwd_ref(x, dt, a, pad(bm), pad(cm), dy, 16)
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 16)
    for g_, w in zip(got[3:], want[3:], strict=True):
        assert _rel(g_[..., :12].numpy(), w.numpy()) <= 1e-6
        assert not g_[..., 12:].any()


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS)
def test_ssd_parallel_twin_at_the_new_chunks(s, p, n, chunk):
    """The kernel's chunk-parallel algorithm (``ssd_chunk_scan_parallel_
    ref``) equals the sequential plain scan at the new forms."""
    x, dt, a, bm, cm, _ = (torch.from_numpy(t)
                           for t in _ssd_inputs(s, p, n, seed=50))
    assert _rel(ref.ssd_chunk_scan_parallel_ref(x, dt, a, bm, cm,
                                                chunk).numpy(),
                ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk).numpy()) \
        <= TOL[F32]


# --- the wrappers' forms on meta tensors ------------------------------------

class _Log(list):
    def __call__(self, name, flops, nbytes):
        self.append((name, flops, nbytes))


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_instances_and_row_widths():
    """A head width runs on the narrowest instance that holds it, on rows
    of a 16-byte multiple."""
    assert [fa.instance(hd) for hd in (1, 16, 17, 24, 32, 33, 72, 96, 128)] \
        == [16, 16, 32, 32, 32, 64, 128, 128, 128]
    assert [fa.row_width(hd, BF) for hd in (8, 20, 72)] == [8, 24, 72]
    assert [fa.row_width(hd, F32) for hd in (6, 20, 72)] == [8, 20, 72]
    assert [ssd_scan.kernel_chunk(q) for q in (8, 16, 24, 48, 100, 256)] \
        == [16, 16, 32, 64, 128, 256]
    assert [ssd_scan.kernel_head(p) for p in (8, 16, 24, 48, 80, 128)] \
        == [16, 16, 32, 64, 128, 128]
    assert [ssd_scan.kernel_state(n) for n in (5, 8, 12, 128)] \
        == [8, 8, 16, 128]


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("hd", [8, 20, 24, 40, 72, 96, 100, 128])
def test_meta_flash_takes_every_width(dtype, hd):
    """On meta tensors the wrappers take every width up to 128 in both
    types, forward and backward, and record their work at the true
    width and in the inputs' type, under the small library's names up
    to 32 and ``flash_attention`` / ``flash_attention_bwd`` above;
    nothing launches."""
    b, s, hq, hkv, t = 2, 96, 4, 2, 96
    q, do = _meta(b, s, hq, hd, dtype=dtype), _meta(b, s, hq, hd, dtype=dtype)
    k = _meta(b, t, hkv, hd, dtype=dtype)
    lse = _meta(b, hq, s)
    small = hd <= 32
    name = "flash_attention_f32" if small else "flash_attention"
    dn = str(dtype).removeprefix("torch.")
    log = _Log()
    ops.reset_launch_counts()
    with meta.listening(log):
        out, l2 = fa.flash_attention(q, k, k, 2, True, 0, return_lse=True)
        grads = fa.flash_attention_bwd(q, k, k, out, lse, do, 2, True)
    assert [g_.shape for g_ in grads] == [q.shape, k.shape, k.shape]
    assert all(g_.dtype == dtype for g_ in grads)
    assert out.shape == q.shape and l2.shape == (b, hq, s)
    want = [(name, *fa.fwd_work(b, s, t, hq, hkv, hd, dn, True, lse=True)),
            (name + "_bwd", *fa.bwd_work(b, s, t, hq, hkv, hd, True,
                                         dtype_name=dn))]
    assert log == want
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS + [(200, 20, 5, 100)])
def test_meta_ssd_takes_every_form(s, p, n, chunk):
    """On meta tensors the SSD wrappers take every chunk up to 256 that
    divides S, any head and any d_state up to 128, and record the work
    at the true form; nothing launches."""
    b, h = 2, 3
    x, dy = _meta(b, s, h, p), _meta(b, s, h, p)
    dt, a, bm = _meta(b, s, h), _meta(h), _meta(b, s, n)
    log = _Log()
    ops.reset_launch_counts()
    with meta.listening(log):
        y = ssd_scan.ssd_chunk_scan(x, dt, a, bm, bm, chunk)
        grads = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, bm, dy, chunk)
    assert y.shape == x.shape
    assert [g_.shape for g_ in grads] == [x.shape, dt.shape, a.shape,
                                          bm.shape, bm.shape]
    assert log == [
        ("ssd_chunk_scan", *ssd_scan.fwd_work(b, s, h, p, n, chunk, 4)),
        ("ssd_chunk_scan_bwd", *ssd_scan.bwd_work(b, s, h, p, n, chunk, 4))]
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("form", ["flash_hd256", "ssd_n136", "ssd_q512",
                                  "ssd_q_not_dividing"])
def test_forms_still_queued_raise(device, form):
    """Attention wider than 128, a d_state over 128, a chunk over 256 and
    a chunk that does not divide S raise before any device check; the
    first three name ``ROADMAP.md``, where they are queued."""
    def t(*shape):
        return torch.zeros(shape, device=device)
    if form == "flash_hd256":
        q, kv = t(1, 64, 4, 256), t(1, 64, 2, 256)
        with pytest.raises(ValueError, match="head_dim 256.*ROADMAP"):
            fa.flash_attention(q, kv, kv, 2, True)
        return
    s, n, chunk = {"ssd_n136": (64, 136, 16), "ssd_q512": (1024, 16, 512),
                   "ssd_q_not_dividing": (96, 16, 64)}[form]
    x, dt, a, bm = t(1, s, 2, 32), t(1, s, 2), t(2), t(1, s, n)
    match = {"ssd_n136": "d_state 136.*ROADMAP",
             "ssd_q512": "chunk 512.*ROADMAP",
             "ssd_q_not_dividing": "chunk 64 must divide S=96"}[form]
    with pytest.raises(ValueError, match=match):
        ssd_scan.ssd_chunk_scan(x, dt, a, bm, bm, chunk)

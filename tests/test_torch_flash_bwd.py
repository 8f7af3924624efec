"""The flash backward's plain version on the CPU: ``ref.attention_bwd_ref``
(the recompute from the forward's output and row log-sum-exp) against
autograd through ``ref.attention_ref`` and against ``jax.vjp`` of the
reference's full-logits attention (``repro.models.attention._sdpa``;
the DiT's ``_joint_attention``, ``repro/models/dit.py:121-133``, for the
non-causal form), in the four forms (non-causal, causal, window, GQA) ×
float32 / bf16 × head width 64 / 128; ``attention_lse_ref`` against
``torch.logsumexp`` of the logits; the op layer's gradient on the CPU;
and the guard that keeps autograd away from the kernels with no
backward.

Tolerances, as max |got − want| / max |want| per gradient: float32 1e-5
(the same function, sums in other orders).  bf16 2e-2: the recompute
rounds P and dS to bf16 as the kernel's operands, where autograd rounds
the probabilities (P·V's operand) and the output's gradient through V
(dP in bf16), and takes D as Σ P·dP instead of rowsum(dO ∘ O) with O
already rounded; one bf16 rounding (2^-8) of terms that cancel in dS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import dit as jdit
from repro_torch.kernels import (build, dct, flash_attention, freqca_fused,
                                 ops, ref, ssd_scan)

# (B, S, Hq, Hkv, causal, window[, T]): the four forms of the kernel,
# T = S unless given; then the shapes of the kernel's tiles (128 keys or
# queries a block, 64 or 128 streamed): several key tiles, S off every
# tile, q_per_kv 8 (at 1152 tokens the kernel splits each group's heads
# over blocks), and T longer or shorter than S
FORMS = {
    "noncausal": (2, 40, 3, 3, False, 0),
    "causal": (1, 37, 4, 4, True, 0),
    "window": (2, 45, 2, 2, True, 9),
    "gqa": (1, 33, 8, 2, True, 0),
    "gqa_noncausal_window": (2, 30, 4, 1, False, 12),
    "noncausal_tiles": (1, 777, 4, 4, False, 0),
    "gqa8_tiles": (1, 700, 16, 2, True, 0),
    "gqa8_split": (1, 1152, 32, 4, True, 0),
    "longer_keys": (2, 200, 4, 4, False, 0, 328),
    "shorter_keys_gqa": (1, 333, 4, 2, False, 0, 190),
    "causal_longer_keys": (1, 300, 8, 2, True, 0, 420),
    "window_longer_keys": (1, 260, 4, 4, True, 100, 390),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(form, dtype, hd, seed=0):
    b, s, hq, hkv, causal, window, *t = FORMS[form]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, hq, hd), generator=g).to(dtype)
    k, v = (torch.randn((b, t[0] if t else s, hkv, hd), generator=g).to(dtype)
            for _ in "kv")
    do = torch.randn((b, s, hq, hd), generator=g).to(dtype)
    return q, k, v, do, hq // hkv, causal, window


def _err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _twin(q, k, v, do, g, causal, window):
    o, lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    return ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(FORMS))
def test_bwd_ref_matches_autograd(form, dtype, hd):
    q, k, v, do, g, causal, window = _inputs(form, dtype, hd)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ref.attention_ref(*leaves, g, causal, window)
    want = torch.autograd.grad(out, leaves, do)
    got = _twin(q, k, v, do, g, causal, window)
    for gt, w in zip(got, want, strict=True):
        assert gt.dtype == dtype and gt.shape == w.shape
        assert _err(gt, w) <= TOL[dtype]


def _numpy_mask(s, causal, window, t):
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    return m[None]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(FORMS))
def test_bwd_ref_matches_reference_vjp(form, dtype, hd):
    """Against ``jax.vjp`` of the reference's attention: ``_sdpa`` under
    the form's mask; the non-causal MHA form through the DiT's
    ``_joint_attention`` with an identity output projection."""
    q, k, v, do, g, causal, window = _inputs(form, dtype, hd, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(JNP[dtype])
                       for x in (q, k, v, do))
    b, s, hq, _ = q.shape
    if form == "noncausal":
        eye = jnp.eye(hq * hd, dtype=JNP[dtype]).reshape(hq, hd, hq * hd)

        def fn(a, bb, c):
            return jdit._joint_attention(a, bb, c, eye, JNP[dtype]).reshape(
                b, s, hq, hd)
    else:
        mask = jnp.asarray(_numpy_mask(s, causal, window, k.shape[1]))

        def fn(a, bb, c):
            return jattn._sdpa(a, bb, c, mask, g)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    want = [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in vjp(jdo)]
    got = _twin(q, k, v, do, g, causal, window)
    for gt, w in zip(got, want, strict=True):
        assert _err(gt, w) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(FORMS))
def test_lse_ref_is_logsumexp_of_the_logits(form, dtype):
    """The row log-sum-exp of the masked, scaled float32 logits (masked
    keys left out), beside an output equal to ``attention_ref``'s."""
    q, k, v, _, g, causal, window = _inputs(form, dtype, 64, seed=2)
    out, lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    b, s, hq, hd = q.shape
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert torch.equal(out, ref.attention_ref(q, k, v, g, causal, window))
    kr = k.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kr) / hd ** 0.5
    mask = torch.from_numpy(_numpy_mask(s, causal, window, k.shape[1]))
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    want = torch.logsumexp(logits, dim=-1)
    assert float((lse - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("form", list(FORMS))
def test_op_layer_flash_is_differentiable_on_the_cpu(form):
    """``ops.flash`` on CPU tensors is ``attention_ref``, which autograd
    differentiates to the recompute's gradients (float32)."""
    q, k, v, do, g, causal, window = _inputs(form, torch.float32, 64, seed=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash(*leaves, g, causal=causal, window=window)
    out.backward(do)
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    for leaf, w in zip(leaves, _twin(q, k, v, do, g, causal, window),
                       strict=True):
        assert _err(leaf.grad, w) <= 1e-5


def test_needs_grad_predicate():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    assert build.needs_grad(b, a) and not build.needs_grad(b, b)
    assert not build.needs_grad(b, 0.5, None)
    assert build.needs_grad(0.5, a)
    with torch.no_grad():
        assert not build.needs_grad(a)
    with torch.inference_mode():
        assert not build.needs_grad(b)


def _guarded_calls(leaf):
    """Each kernel wrapper with no backward, called on ``leaf`` (a [1, 64,
    64] tensor) where its inputs go."""
    x, hist = leaf, leaf[None].expand(1, 3, 64, 64)
    yield "band_split_spectral", lambda: dct.band_split_spectral(x, 0.0625)
    yield "token_basis_matmul", lambda: dct.token_basis_matmul(
        torch.eye(64), x)
    yield "band_split", lambda: dct.band_split(x, 0.0625)
    yield "freqca_predict_fused_spectral", \
        lambda: freqca_fused.freqca_predict_fused_spectral(
            x[:, :4], torch.zeros((64, 4)), hist, torch.zeros((1, 3)))
    yield "freqca_predict_fused", lambda: freqca_fused.freqca_predict_fused(
        x, hist[0][:, None], torch.ones(3), torch.tensor(0.5), 2)
    yield "ssd_chunk_scan", lambda: ssd_scan.ssd_chunk_scan(
        x.reshape(1, 64, 1, 64), x[..., 0].reshape(1, 64, 1), torch.ones(1),
        x[..., :16], x[..., :16], 64)


@pytest.mark.parametrize("name", [n for n, _ in _guarded_calls(
    torch.zeros((1, 64, 64)))])
def test_guarded_wrappers_raise_under_grad(name):
    """A wrapper whose kernel has no backward raises before anything else
    when autograd would record the call (the device check comes after);
    under ``no_grad`` the same call passes the guard and stops at the
    device check."""
    leaf = torch.zeros((1, 64, 64), requires_grad=True)
    call = dict(_guarded_calls(leaf))[name]
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_flash_bwd_wrapper_refuses_float32():
    """The backward kernel is bf16 only; a float32 call raises before
    any device check."""
    q = torch.zeros((1, 16, 2, 64))
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(NotImplementedError, match="bfloat16 only"):
        flash_attention.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        qb = q.to(torch.bfloat16)
        flash_attention.flash_attention_bwd(qb, qb, qb, qb, lse, qb)

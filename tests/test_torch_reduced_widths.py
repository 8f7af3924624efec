"""Port parity at the small widths the reduced configs reach, on the CPU:
float32 attention at head widths 16 and 32 in every form (kernels 3 and
7, ``flash_attention_f32``) and the SSD scan at heads of 16 and 32 in
chunks of 16 and 32 (kernels 6 and 8).

- The plain versions (the op layer's CPU route, the CUDA kernels'
  oracles) against repro's Pallas kernels in interpret mode, at the
  reference's own kernel tests' forms: 1e-5 relative to the largest
  output (float32; the two sum in different orders).
- Their backward twins against XLA's autodiff of the reference's
  attention (``_sdpa`` under the form's mask) and of ``ssd_chunked``:
  1e-5 relative to the largest gradient; the SSD's dA 1e-3 (a sum over
  every token whose terms cancel, as ``test_torch_ssd_bwd.py``).
- On ``meta`` tensors the wrappers take every new form and record their
  work (``fwd_work`` / ``bwd_work``); the forms still queued in
  ``ROADMAP.md`` raise, naming it, before any device check.
- One training step of reduced yi-9b at S 2048 (its attention on the
  blockwise route, the flash kernel's on the card) and of reduced
  mamba2-370m against ``jax.value_and_grad`` of repro's ``loss_fn``,
  parameters crossed with ``bridge``: the loss 1e-6 relative, every
  gradient leaf 1e-5 relative L2 (mamba2) and 1e-3 (yi-9b, whose
  reference init makes the softmax sharp: ``test_torch_lm_training.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import flash_attention as jfa
from repro.kernels import ssd_scan as jssd
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, ops, ref, ssd_scan
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw

TOL = 1e-5
# (S, Hq, Hkv, hd, causal, window): repro's flash tests at hd 16 (causal
# and window 24, GQA 4/2 and 6/2) and its dtype test's hd 32 causal GQA
FLASH_FORMS = [(64, 4, 2, 16, True, 0), (64, 4, 2, 16, True, 24),
               (64, 6, 2, 16, True, 0), (64, 6, 2, 16, True, 24),
               (64, 4, 2, 32, True, 0)]
# (S, P, N, chunk): repro's SSD test at heads of 16 and state 8 (chunks
# 16 and 32), and the reduced configs' heads of 32, state 16, chunk 16
SSD_FORMS = [(64, 16, 8, 16), (128, 16, 8, 32), (64, 32, 16, 16)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flash_inputs(s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((2, s, hq, hd)).astype(np.float32)
             for _ in "qd")
    k, v = (rng.standard_normal((2, s, hkv, hd)).astype(np.float32)
            for _ in "kv")
    return q, k, v, do


def _ssd_inputs(s, p, n, seed):
    """repro's SSD test inputs (b 2, h 2) and an output gradient."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, s, 2, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, 2)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(2) * 0.3).astype(np.float32)
    bm, cm = ((rng.standard_normal((2, s, n)) * 0.5).astype(np.float32)
              for _ in "bc")
    dy = rng.standard_normal((2, s, 2, p)).astype(np.float32)
    return x, dt, a, bm, cm, dy


@pytest.mark.parametrize("s,hq,hkv,hd,causal,window", FLASH_FORMS)
def test_flash_small_forms_match_pallas(s, hq, hkv, hd, causal, window):
    """The plain attention against the Pallas kernel in interpret mode
    (blocks of 32) and the reference's ``_sdpa``."""
    q, k, v, _ = _flash_inputs(s, hq, hkv, hd, seed=31)
    g = hq // hkv
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), g, causal=causal,
                               window=window, q_block=32, kv_block=32,
                               interpret=True)
    got = ops.flash(*(torch.from_numpy(a) for a in (q, k, v)), g,
                    causal=causal, window=window)
    assert _rel(got.numpy(), want) <= TOL
    mask = jattn.causal_mask(s, window=window)
    assert _rel(got.numpy(), jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), mask, g)) <= TOL


@pytest.mark.parametrize("s,hq,hkv,hd,causal,window", FLASH_FORMS)
def test_flash_small_forms_backward_match_jax(s, hq, hkv, hd, causal,
                                              window):
    """The backward twin (the kernels' recompute from o and lse) against
    ``jax.vjp`` of the reference's ``_sdpa`` under the same mask, and
    autograd of the op layer's CPU route against it."""
    q, k, v, do = _flash_inputs(s, hq, hkv, hd, seed=32)
    g = hq // hkv
    mask = jattn.causal_mask(s, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jattn._sdpa(a, b, c, mask, g),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.attention_lse_ref(tq, tk, tv, g, causal, window)
    got = ref.attention_bwd_ref(tq, tk, tv, o, lse, tdo, g, causal, window)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (ops.flash(*leaves, g, causal=causal, window=window) * tdo).sum(
    ).backward()
    for twin, auto, w in zip(got, leaves, want, strict=True):
        assert _rel(twin.numpy(), w) <= TOL
        assert _rel(auto.grad.numpy(), w) <= TOL


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS)
def test_ssd_small_forms_match_pallas(s, p, n, chunk):
    """The plain SSD scan against the Pallas kernel in interpret mode."""
    x, dt, a, bm, cm, _ = _ssd_inputs(s, p, n, seed=33)
    want = jssd.ssd_chunk_scan(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)),
                               chunk, interpret=True)
    got = ops.ssd(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), chunk)
    assert got.shape == (2, s, 2, p)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("s,p,n,chunk", SSD_FORMS)
def test_ssd_small_forms_backward_match_jax(s, p, n, chunk):
    """The SSD backward twin against ``jax.vjp`` of the reference's
    ``ssd_chunked`` (the gradient of y only), on inputs whose cum stays
    above −60 (``ssd_chunked`` does not clip); dA to 1e-3."""
    x, dt, a, bm, cm, dy = _ssd_inputs(s, p, n, seed=34)
    cum = (dt * a).reshape(2, s // chunk, chunk, 2).cumsum(axis=2)
    assert cum.min() > -60.0
    _, vjp = jax.vjp(lambda *t: jssm.ssd_chunked(*t, chunk)[0],
                     *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_chunk_scan_bwd_ref(
        *(torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy)), chunk)
    for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                           strict=True):
        assert _rel(gt.numpy(), w) <= (1e-3 if name == "dA" else TOL), name


class _Log(list):
    def __call__(self, name, flops, nbytes):
        self.append((name, flops, nbytes))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("g,causal,window", [(2, True, 0), (3, True, 24),
                                             (2, False, 0), (1, False, 40),
                                             (1, True, 100)])
def test_meta_flash_takes_every_small_form(hd, g, causal, window):
    """On meta tensors the wrappers take float32 at hd 16 and 32 in every
    form (T != S for the non-causal ones) and record their work under
    the small-width library's names; nothing launches."""
    b, s, hq = 2, 96, 6
    t = s if causal else 160
    q, do = _meta(b, s, hq, hd), _meta(b, s, hq, hd)
    k = _meta(b, t, hq // g, hd)
    lse = _meta(b, hq, s)
    log = _Log()
    ops.reset_launch_counts()
    with meta.listening(log):
        out, l2 = fa.flash_attention(q, k, k, g, causal, window,
                                     return_lse=True)
        dq, dk, dv = fa.flash_attention_bwd(q, k, k, out, lse, do, g, causal,
                                            window)
    assert out.shape == q.shape and l2.shape == (b, hq, s)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert log == [
        ("flash_attention_f32", *fa.fwd_work(b, s, t, hq, hq // g, hd,
                                             "float32", causal, window,
                                             lse=True)),
        ("flash_attention_f32_bwd", *fa.bwd_work(b, s, t, hq, hq // g, hd,
                                                 causal, window,
                                                 dtype_name="float32"))]
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("p,chunk", [(16, 16), (16, 32), (32, 16),
                                     (32, 32), (64, 16), (16, 64)])
def test_meta_ssd_takes_every_small_form(p, chunk):
    """On meta tensors the SSD wrappers take heads of 16 and 32 in chunks
    of 16 and 32 (and the new tiles beside heads of 64) and record
    ``fwd_work`` / ``bwd_work``; nothing launches."""
    b, s, h, n = 2, 128, 4, 16
    x, dy = _meta(b, s, h, p), _meta(b, s, h, p)
    dt, a = _meta(b, s, h), _meta(h)
    bm = _meta(b, s, n)
    log = _Log()
    ops.reset_launch_counts()
    with meta.listening(log):
        y = ssd_scan.ssd_chunk_scan(x, dt, a, bm, bm, chunk)
        grads = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, bm, dy, chunk)
    assert y.shape == x.shape and grads[0].shape == x.shape
    assert log == [
        ("ssd_chunk_scan", *ssd_scan.fwd_work(b, s, h, p, n, chunk, 4)),
        ("ssd_chunk_scan_bwd", *ssd_scan.bwd_work(b, s, h, p, n, chunk, 4))]
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forms_still_queued_raise(device):
    """Attention at hd 256, an SSD chunk of 512 and a d_state of 136
    raise before any device check, each naming ``ROADMAP.md``, where they
    are queued.  The float32 backward at hd 64, queued there until its
    kernel came, now passes the checks: on the CPU it stops at the device
    check, on meta tensors it records its work."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    q256 = t(1, 64, 4, 256, dtype=torch.bfloat16)
    kv256 = t(1, 64, 2, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 256 .*ROADMAP"):
        fa.flash_attention(q256, kv256, kv256, 2, True)
    q64, lse = t(1, 64, 2, 64), t(1, 2, 64)
    if device == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_bwd(q64, q64, q64, q64, lse, q64)
    else:
        grads = fa.flash_attention_bwd(q64, q64, q64, q64, lse, q64)
        assert [g.shape for g in grads] == [q64.shape] * 3
    dt, a, bm = t(1, 1024, 2), t(2), t(1, 1024, 16)
    with pytest.raises(ValueError, match="chunk 512 .*ROADMAP"):
        ssd_scan.ssd_chunk_scan(t(1, 1024, 2, 32), dt, a, bm, bm, 512)
    bn = t(1, 1024, 136)
    with pytest.raises(ValueError, match="d_state 136 .*ROADMAP"):
        ssd_scan.ssd_chunk_scan(t(1, 1024, 2, 48), dt, a, bn, bn, 16)


def _reference_init(specs, seed):
    """repro's init rules drawn with numpy, every leaf perturbed so that
    zero / one inits (norms, A_log, D, biases) take part (as
    ``test_torch_lm_training.py``)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            x = np.full(shape, 0.0 if spec.init == "zeros" else 1.0)
        else:
            fan_in = shape[1] if len(shape) == 3 else shape[0]
            std = spec.scale if spec.scale is not None else (
                0.02 if spec.init == "embed" else 1.0 / np.sqrt(fan_in))
            x = rng.standard_normal(shape) * std
        return jnp.asarray((x + 0.05 * rng.standard_normal(shape)).astype(
            np.float32))
    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@pytest.mark.parametrize("arch,s,grad_tol", [("yi-9b", 2048, 1e-3),
                                             ("mamba2-370m", 256, 1e-5)])
def test_reduced_train_step_matches_reference(arch, s, grad_tol):
    """One reduced training step on the CPU: the loss and every gradient
    leaf of the port's ``loss_fn`` against ``jax.value_and_grad`` of
    repro's on the same parameters and batch (one sequence of ``s``
    tokens; yi-9b at 2048, where both take the blockwise route that the
    flash kernel's takes on the card; mamba2's chunks of 16 through the
    SSD scan)."""
    cj = jconfigs.reduced(jconfigs.get_config(arch))
    ct = tconfigs.reduced(tconfigs.get_config(arch))
    assert (ct.head_dim, ct.dtype) == (32, "float32")
    pj = _reference_init(jtransformer.lm_specs(cj), seed=35)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    rng = np.random.default_rng(36)
    tok = rng.integers(0, ct.vocab_size, (1, s)).astype(np.int32)
    lab = rng.integers(0, ct.vocab_size, (1, s)).astype(np.int32)
    (lj, _), gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, cj),
        has_aux=True)(pj)
    leaves = tadamw.tree_map(lambda x: x.clone().requires_grad_(True), pt)
    lt, _ = ttransformer.loss_fn(leaves, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)},
                                 ct)
    lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-6 * abs(float(lj))
    got = tckpt._flatten_with_paths(jax.tree.map(np.asarray, (
        bridge.lm_params_to_jax_numpy(
            tadamw.tree_map(lambda x: x.grad, leaves), ct))))
    want = tckpt._flatten_with_paths(jax.tree.map(np.asarray, gj))
    assert sorted(got) == sorted(want)
    worst = max((float(np.linalg.norm(got[k] - want[k])
                       / np.linalg.norm(want[k])), k) for k in want)
    assert worst[0] <= grad_tol, worst

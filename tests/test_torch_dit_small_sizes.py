"""dit-small at the latent sizes whose joint attention reaches flash
(latent 64: 1024 tokens; 128: 4096), on the CPU against ``repro``.

dit-small's width (d_model 128 in 8 heads of 16, float32) with its 8
layers cut to 2.  At latent 64 the reference's ``_joint_attention``
takes its einsum route on the CPU (``REPRO_KERNELS`` unset: XLA), the
port's op layer its plain version; on the card the port sends the same
call to the float32 hd-16 kernels (``flash_attention_f32``), which
these tests reach on ``meta`` tensors, where the kernel wrappers check
their inputs and record their work.

Tolerances: the forward 1e-5 relative to its largest magnitude, the
loss 1e-6 relative and every gradient leaf 1e-5 relative L2 (float32
matrix products and their transposes summed in other orders, as in
``test_torch_training.py``); the sampled latents 1e-5 relative to their
largest magnitude over 6 Euler steps; activation counts exactly; the
plain attention against the Pallas kernel in interpret mode 1e-5
relative to the largest output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core import policies as jpol
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.diffusion import training as jtraining
from repro.kernels import flash_attention as jfa
from repro.models import dit as jdit
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tschedule
from repro_torch.diffusion import training as ttraining
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import dit as tdit
from repro_torch.optim import adamw as tadamw
from repro_torch.roofline import op_analysis
from test_torch_training import _flat, _reference_draws, _rel_l2

SIDE = 64           # latent 64: (64 / 2)^2 = 1024 tokens, the threshold
LAYERS = 2
SAMPLE_STEPS = 6


def _configs():
    cj = dataclasses.replace(jconfigs.get_config("dit-small"),
                             n_layers=LAYERS)
    ct = dataclasses.replace(tconfigs.get_config("dit-small"),
                             n_layers=LAYERS)
    for field in dataclasses.fields(ct):
        assert getattr(ct, field.name) == getattr(cj, field.name)
    assert ct.head_dim == 16 and ct.dtype == "float32"
    return cj, ct


@pytest.fixture(scope="module")
def model():
    """The port's init with every leaf perturbed by 0.02 of a numpy
    standard normal, so that every block contributes and every gradient
    is non-zero (the AdaLN-zero init makes each block an identity), and
    the same values in the reference's layout (``bridge``)."""
    cj, ct = _configs()
    pt = tdit.init_params(ct, seed=11, device="cpu")
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in tadamw.leaves(pt):
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    pj = jax.tree.map(lambda a: jnp.asarray(a.numpy()),
                      bridge.params_to_jax_numpy(pt, ct))
    return cj, ct, pj, pt


def _x(seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, SIDE, SIDE, 4)).astype(np.float32)


def test_the_joint_attention_reaches_flash_at_latent_64(model):
    """1024 tokens: both packages' routes pick flash there (the port's
    op layer; the reference's ``_flash_ok``, taken on a TPU), and the
    port's plain version runs on the CPU, launching nothing."""
    cj, ct, _, pt = model
    s = (SIDE // ct.patch_size) ** 2
    assert s == 1024 and tdit._flash_ok(s) and jdit._flash_ok(s)
    assert not tdit._flash_ok(((SIDE // 2) // ct.patch_size) ** 2)
    ops.reset_launch_counts()
    tdit.dit_forward(pt, torch.from_numpy(_x(1, 1)), torch.tensor([0.5]), ct)
    assert not any(ops.launch_counts().values())


def test_forward_matches_reference_at_latent_64(model):
    cj, ct, pj, pt = model
    x, t = _x(2), np.array([0.3, 0.8], np.float32)
    want = jax.jit(lambda p, x, t: jdit.dit_forward(p, x, t, cj))(
        pj, jnp.asarray(x), jnp.asarray(t))
    got = tdit.dit_forward(pt, torch.from_numpy(x), torch.from_numpy(t), ct)
    for g, w in ((got.velocity, want.velocity), (got.crf, want.crf)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_rf_loss_and_gradients_match_reference_at_latent_64(model):
    """The loss (1e-6) and every gradient leaf (1e-5 rel L2), read per
    leaf by its path; with the AdaLN-zero leaves perturbed, none is
    zero."""
    cj, ct, pj, _ = model
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    for p in tadamw.leaves(pt):
        p.requires_grad_(True)
    x = _x(3)
    rng = jax.random.key(4)
    (want, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jtraining.rf_loss(
            lambda q, x_t, tt: jdit.dit_forward(q, x_t, tt, cj).velocity, p,
            {"latents": jnp.asarray(x)}, rng), has_aux=True))(pj)
    t, noise = (np.array(a) for a in _reference_draws(rng, x))
    got, _ = ttraining.rf_loss(
        lambda q, x_t, tt: tdit.dit_forward(q, x_t, tt, ct).velocity, pt,
        {"latents": torch.from_numpy(x)}, t=torch.from_numpy(t),
        noise=torch.from_numpy(noise))
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    gt = tadamw.tree_map(lambda p: p.grad, pt)
    flat_j, flat_t = _flat(gj), _flat(bridge.params_to_jax_numpy(gt, ct))
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        assert np.any(flat_j[k]), k
        assert _rel_l2(flat_t[k], flat_j[k]) <= 1e-5, k


def test_freqca_sampling_matches_reference_at_latent_64(model):
    """FreqCa (interval 5: steps 0, 1, 2 and 5 full) over 6 steps on two
    lanes: ``n_full`` and ``n_full_lanes`` exactly the reference's, the
    latents to 1e-5."""
    cj, ct, pj, pt = model

    def jfull(x, t):
        out = jdit.dit_forward(pj, x, jnp.full((x.shape[0],), t), cj)
        return out.velocity, out.crf

    def jcrf(c, t):
        return jdit.dit_from_crf(pj, c, jnp.full((c.shape[0],), t), cj,
                                 SIDE, SIDE)

    def tfull(x, t):
        out = tdit.dit_forward(pt, x, t.expand(x.shape[0]), ct)
        return out.velocity, out.crf

    def tcrf(c, t):
        return tdit.dit_from_crf(pt, c, t.expand(c.shape[0]), ct, SIDE, SIDE)
    x0 = _x(5)
    crf_shape = (2, (SIDE // ct.patch_size) ** 2, ct.d_model)
    want = jsampler.sample(jfull, jcrf, jnp.asarray(x0),
                           jschedule.timesteps(SAMPLE_STEPS),
                           jpol.FreqCaPolicy(interval=5), crf_shape)
    got = tsampler.sample(tfull, tcrf, torch.from_numpy(x0),
                          tschedule.timesteps(SAMPLE_STEPS),
                          tpol.FreqCaPolicy(interval=5), crf_shape)
    assert got.n_full == int(want.n_full) == 4
    np.testing.assert_array_equal(got.n_full_lanes.numpy(),
                                  np.asarray(want.n_full_lanes))
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x,
                               atol=1e-5 * np.abs(want_x).max())


@pytest.mark.parametrize("s", [96, 160])
def test_plain_hd16_attention_matches_pallas(s):
    """The kernels' plain version at dit-small's heads (8 of 16), float32
    non-causal, against the reference's Pallas kernel in interpret mode
    (its blocks of 32 over S 96 and 160: several tiles)."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 8, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1, causal=False,
        q_block=32, kv_block=32, interpret=True))
    got, lse = ref.attention_lse_ref(*(torch.from_numpy(a)
                                       for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ops.flash(*(torch.from_numpy(a) for a in
                                           (q, k, v))).numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    assert lse.shape == (2, 8, s)


def test_plain_backward_keeps_float64_inputs_in_float64():
    """The float64 oracle of the hd-16 backward on the card: given
    float64 inputs, ``attention_bwd_ref`` (and the logits it recomputes)
    work in float64, so it agrees with autograd through
    ``attention_ref`` to 1e-12 where a float32 pass would miss by
    ~1e-7."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 96, 8, 16)))
                   for _ in range(4))
    o, lse = ref.attention_lse_ref(q, k, v)
    assert o.dtype == lse.dtype == torch.float64
    got = ref.attention_bwd_ref(q, k, v, o, lse, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (ref.attention_ref(*leaves) * do).sum().backward()
    for g, leaf in zip(got, leaves, strict=True):
        assert g.dtype == torch.float64
        want = leaf.grad
        assert (g - want).abs().max() <= 1e-12 * want.abs().max()


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("b,s,t", [(2, 4096, 4096), (16, 1024, 1024),
                                   (2, 1600, 1600), (1, 300, 520)])
def test_meta_route_records_the_float32_hd16_kernels(b, s, t):
    """On meta tensors ``ops.flash`` at float32 hd 16 takes the new
    kernels: their forward (with its lse, a gradient being needed) and
    backward record ``fwd_work`` / ``bwd_work``, both under the tf32 key
    (their tensor-core route), the outputs have the inputs' shapes, and
    no launch count moves."""
    calls = []
    ops.reset_launch_counts()
    q = _meta(b, s, 8, 16, grad=True)
    k, v = (_meta(b, t, 8, 16, grad=True) for _ in "kv")
    with meta.listening(lambda *c: calls.append(c)):
        out = ops.flash(q, k, v)
        out.sum().backward()
    assert out.shape == q.shape and k.grad.shape == k.shape
    assert calls == [
        ("flash_attention_f32", *fa.fwd_work(b, s, t, 8, 8, 16, "float32",
                                             lse=True)),
        ("flash_attention_f32_bwd", *fa.bwd_work(b, s, t, 8, 8, 16,
                                                 dtype_name="float32"))]
    assert set(calls[0][1]) == {"tf32"} and set(calls[1][1]) == {"tf32"}
    assert not any(ops.launch_counts().values())


def test_bwd_work_counts_float32_at_4_bytes():
    """Float32 under the tf32 key (the backward's tensor-core route) at
    4-byte elements, the FLOPs of ``test_torch_roofline.py``'s bf16 hand
    count (which holds bf16 as it was): q, o, dO, dQ and k, v, dK, dV
    twice as many bytes, the lse as before."""
    flops, nbytes = fa.bwd_work(1, 4, 4, 2, 1, 64, True,
                                dtype_name="float32")
    assert flops == {"tf32": 12800} and nbytes == 2 * 6144 + 32


@pytest.mark.parametrize("form", [
    dict(dtype=torch.bfloat16), dict(causal=True), dict(window=64),
    dict(q_per_kv=2)])
@pytest.mark.parametrize("wrapper", ["forward", "backward"])
def test_hd16_refuses_the_forms_the_kernels_lack(form, wrapper):
    """At head width 16 the kernels take float32 and bf16 in every form:
    a bf16, causal, window or GQA call passes the check, records its
    work on meta tensors and requires the card on the CPU (nothing there
    falls back to the plain version)."""
    dtype = form.get("dtype", torch.float32)
    g = form.get("q_per_kv", 1)
    for dev in ("meta", "cpu"):
        q = torch.zeros((1, 128, 4, 16), dtype=dtype, device=dev)
        kv = torch.zeros((1, 128, 4 // g, 16), dtype=dtype, device=dev)
        lse = torch.zeros((1, 4, 128), device=dev)
        kw = dict(q_per_kv=g, causal=form.get("causal", False),
                  window=form.get("window", 0))

        def call():
            if wrapper == "forward":
                return fa.flash_attention(q, kv, kv, **kw)
            return fa.flash_attention_bwd(q, kv, kv, q, lse, q, **kw)
        if dev == "meta":
            out = call()
            outs = (out,) if wrapper == "forward" else out
            assert outs[0].shape == q.shape and outs[0].is_meta
        else:
            with pytest.raises(ValueError, match="CUDA"):
                call()


def test_hd16_float32_calls_require_the_card():
    """At 16 the wrappers take a float32 call and then require the card
    (float32 at 64 stays refused: ``test_torch_flash_bwd.py``)."""
    lse = torch.zeros((1, 2, 16))
    q16 = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q16, q16, q16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q16, q16, q16, q16, lse, q16)


def test_dry_run_counts_dit_small_at_latent_128_on_the_new_forward():
    """The dry run builds dit-small at latent 128 (as the reference's
    ``build_dit``): one float32 hd-16 forward a layer on meta tensors,
    recorded by its formula; nothing launched."""
    assert dryrun.DIT_LATENT["dit-small"] == 128
    ops.reset_launch_counts()
    spec = steps.build_dit("dit-small", mesh_lib.one_card_mesh(), batch=2,
                           latent=128)
    counted = op_analysis.analyze(spec.fn, *spec.args)
    cfg = tconfigs.get_config("dit-small")
    work, nbytes = fa.fwd_work(2, 4096, 4096, 8, 8, 16, "float32")
    k = counted["by_kind"]["flash_attention_f32"]
    assert k["calls"] == cfg.n_layers
    assert k["flops_by_type"] == {"tf32": cfg.n_layers * work["tf32"]}
    assert k["bytes"] == cfg.n_layers * nbytes
    assert not any(ops.launch_counts().values())

"""Port parity: the modality prefix, llava-next-34b (``prefix_proj``
projects precomputed vision-frontend patch embeddings, prepended to the
token embeddings; the loss counts text positions only), against
``repro`` on the CPU in float32 at ``reduced()`` (2 layers, d 128, 4
query heads on 2 kv heads of 32, 16 prefix embeddings), through the
port's entry points: ``transformer.forward`` and ``loss_fn``,
``steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``, ``LMEngine`` (text tokens, as the reference's),
``train_lm`` and the bridge; parameters carried across by
``bridge.lm_params_from_jax_numpy``.

Parameters: as in ``test_torch_encdec.py``, the comparisons draw every
leaf at std 1/sqrt(its port fan-in) (``_fan_in_init``); under the
reference's own rule the stacked attention leaves draw at 1/sqrt(2), a
softmax sharp enough that the reference's own float32 logits lie 2.4e-5
to 1.2e-4 from a float64 run of the port over five seeds (the port's
2.2e-5 to 1.3e-4 from the reference's).  One forward runs at the
reference's draw, to 3e-4.

Tolerances, relative to each output's largest magnitude unless said:
the forward's logits and CRF and the prefill's logits 1e-5; the loss
1e-6 relative; every gradient leaf 1e-4 relative L2; AdamW's moments as
the gradients and the parameters 1e-6 plus 2·lr; decode over 16 tokens
1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpointing import checkpoint as jckpt
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.serving import engine as jengine
from repro.sharding import partitioning as jpart
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine
from test_torch_encdec import _fan_in_init
from test_torch_lm import _reference_init
from test_torch_lm_training import _flat, _leaf_grads, _port, _rel_l2
from test_torch_moe_lm import _batch, _close, _rel

ARCH = "llava-next-34b"
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
RUN_TOL = 1e-5
REF_DRAW_TOL = 3e-4


def _configs():
    return (jconfigs.reduced(jconfigs.get_config(ARCH)),
            tconfigs.reduced(tconfigs.get_config(ARCH)))


@functools.lru_cache(maxsize=None)
def _lm(seed=0, rule="fan_in"):
    """Both packages' parameters (read-only)."""
    cj, ct = _configs()
    specs = jtransformer.lm_specs(cj)
    pj = (_fan_in_init(specs, seed, cj.d_model) if rule == "fan_in"
          else _reference_init(specs, seed))
    return pj, _port(pj, ct)


def _prefix(ct, b=2, seed=11):
    return (np.random.default_rng(seed).standard_normal(
        (b, ct.n_prefix_tokens, ct.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    cj, ct = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert ct is tconfigs.REGISTRY[ARCH]
    if reduced:
        cj, ct = _configs()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    specs = ttransformer.lm_specs(ct)
    assert specs["prefix_proj"]["kernel"].shape == (ct.d_model, ct.d_model)
    assert specs["prefix_proj"]["kernel"].std() == 1 / np.sqrt(ct.d_model)
    for per in (2, 4):
        assert tsteps.param_bytes(ct, per) == jpart.param_bytes(cj, per)


def test_forward_with_the_prefix_matches_reference():
    """Logits and CRF over prefix and text positions; without the prefix
    the same parameters give the text-only forward."""
    cj, ct = _configs()
    pj, pt = _lm()
    tok, _ = _batch(ct.vocab_size)
    pe = _prefix(ct)
    fwd = jax.jit(lambda p, t, e: jtransformer.forward(p, t, cj,
                                                       prefix_embeds=e))
    want = fwd(pj, jnp.asarray(tok), jnp.asarray(pe))
    got = ttransformer.forward(pt, torch.from_numpy(tok), ct,
                               prefix_embeds=torch.from_numpy(pe))
    assert got.logits.shape == (2, ct.n_prefix_tokens + tok.shape[1],
                                ct.vocab_size)
    _close(got.logits, want.logits, FWD_TOL)
    _close(got.crf, want.crf, FWD_TOL)
    want = jax.jit(lambda p, t: jtransformer.forward(p, t, cj))(
        pj, jnp.asarray(tok))
    _close(ttransformer.forward(pt, torch.from_numpy(tok), ct).logits,
           want.logits, FWD_TOL)


def test_forward_at_the_reference_draw():
    """The forward with the prefix at the reference's own init rule (see
    the module's docstring for why 3e-4)."""
    cj, ct = _configs()
    pj, pt = _lm(rule="reference")
    tok, _ = _batch(ct.vocab_size)
    pe = _prefix(ct)
    want = jax.jit(lambda p, t, e: jtransformer.forward(
        p, t, cj, prefix_embeds=e))(pj, jnp.asarray(tok), jnp.asarray(pe))
    got = ttransformer.forward(pt, torch.from_numpy(tok), ct,
                               prefix_embeds=torch.from_numpy(pe))
    _close(got.logits, want.logits, REF_DRAW_TOL)


def test_loss_fn_and_every_gradient_leaf_match_reference():
    """The loss over the text positions (labels as long as the tokens),
    and every leaf's gradient, ``prefix_proj``'s among them."""
    cj, ct = _configs()
    pj, pt = _lm()
    tok, lab = _batch(ct.vocab_size)
    pe = _prefix(ct)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                "prefix_embeds": jnp.asarray(pe)}, cj), has_aux=True))(pj)
    leaves = _leaf_grads(pt)
    lt, mt = ttransformer.loss_fn(
        leaves, {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(lab),
                 "prefix_embeds": torch.from_numpy(pe)}, ct)
    lt.backward()
    assert _rel(lt, lj) <= 1e-6
    gt = _flat(bridge.lm_params_to_jax_numpy(
        tadamw.tree_map(lambda p: p.grad, leaves), ct))
    want = _flat(gj)
    assert sorted(gt) == sorted(want)
    assert "prefix_proj/kernel" in want and np.abs(
        want["prefix_proj/kernel"]).max() > 0
    worst = max((_rel_l2(gt[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst


def test_train_step_matches_reference():
    """One ``make_train_step`` step at two microbatches (the prefix
    embeddings split with the tokens) against the reference's."""
    cj, ct = _configs()
    pj, _ = _lm()
    tok, lab = _batch(ct.vocab_size, b=4, s=16, seed=5)
    pe = _prefix(ct, b=4)
    jstep, jopt = jsteps.make_train_step(cj, microbatch=2)
    tstep, topt = tsteps.make_train_step(ct, microbatch=2)
    pj2, sj, mj = jax.jit(jstep)(pj, jadamw.init(jopt, pj),
                                 {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab),
                                  "prefix_embeds": jnp.asarray(pe)})
    pt = _port(pj, ct)
    pt2, st, mt = tstep(pt, tadamw.init(topt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab),
                         "prefix_embeds": torch.from_numpy(pe)})
    assert sorted(mt) == sorted(mj)
    for k, tol in (("loss", 1e-6), ("lr", 1e-6), ("grad_norm", GRAD_TOL)):
        assert _rel(mt[k], mj[k]) <= tol, k
    for got, want in ((st.mu, sj.mu), (st.nu, sj.nu)):
        got = _flat(bridge.lm_params_to_jax_numpy(got, ct))
        want = _flat(want)
        worst = max((_rel_l2(got[k], want[k]), k) for k in want)
        assert worst[0] <= GRAD_TOL, worst
    got = _flat(bridge.lm_params_to_jax_numpy(pt2, ct))
    flip = 2 * float(mj["lr"])
    for k, want in _flat(pj2).items():
        np.testing.assert_allclose(got[k], want,
                                   atol=1e-6 * np.abs(want).max() + flip)


def test_prefill_step_matches_reference_and_forward():
    cj, ct = _configs()
    pj, pt = _lm()
    tok, _ = _batch(ct.vocab_size, b=2, s=24, seed=7)
    pe = _prefix(ct, seed=8)
    want = np.asarray(jax.jit(jsteps.make_prefill_step(cj))(
        pj, {"tokens": jnp.asarray(tok), "prefix_embeds": jnp.asarray(pe)}))
    got = tsteps.make_prefill_step(ct)(
        pt, {"tokens": torch.from_numpy(tok),
             "prefix_embeds": torch.from_numpy(pe)})
    assert got.shape == (2, ct.vocab_size)
    _close(got, want, FWD_TOL)
    full = ttransformer.forward(pt, torch.from_numpy(tok), ct,
                                prefix_embeds=torch.from_numpy(pe))
    _close(got, full.logits[:, -1].detach().numpy(), 1e-5)


def test_decode_step_and_lm_engine_serve_text_as_the_reference():
    """``make_decode_step`` over 16 text tokens from empty caches, and
    ``LMEngine``'s prefill logits and greedy tokens, against the
    reference's: both packages decode a prefix config's text only."""
    cj, ct = _configs()
    pj, pt = _lm(seed=5)
    toks = np.random.default_rng(6).integers(0, ct.vocab_size, (2, 16))
    cache_j = jblocks.stack_cache_zeros(cj, 2, 16, jnp.float32)
    cache_t = tblocks.stack_cache_zeros(ct, 2, 16, torch.float32)
    step_j = jax.jit(jsteps.make_decode_step(cj))
    step_t = tsteps.make_decode_step(ct)
    for i in range(toks.shape[1]):
        lj, cache_j = step_j(pj, jnp.asarray(toks[:, i:i + 1]), cache_j)
        lt, cache_t = step_t(pt, torch.tensor(toks[:, i:i + 1]), cache_t)
        _close(lt, lj, RUN_TOL)
    prompt = toks[:, :7]
    ej = jengine.LMEngine(pj, cj, 24)
    et = tengine.LMEngine(pt, ct, 24, device="cpu")
    lj, _ = ej._prefill(ej.params, jnp.asarray(prompt, jnp.int32),
                        ej.new_cache(2))
    lt, _ = et.prefill(torch.tensor(prompt))
    _close(lt, lj, FWD_TOL)
    assert et.generate(torch.tensor(prompt), 4).shape == (2, 11)


def test_params_and_checkpoints_cross_both_ways(tmp_path):
    cj, ct = _configs()
    pj, pt = _lm()
    want = _flat(pj)
    assert "prefix_proj/kernel" in want
    back = bridge.lm_params_to_jax_numpy(pt, ct)
    got = {k: v.numpy() for k, v in tckpt._flatten_with_paths(back).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    tckpt.save(str(tmp_path), 3, back, name=ct.arch_id)
    like = jax.tree.map(np.zeros_like, pj)       # the structure only
    restored = _flat(jckpt.restore(str(tmp_path), 3, like, name=cj.arch_id))
    for k in want:
        assert np.array_equal(restored[k], want[k]), k
    jckpt.save(str(tmp_path), 4, pj, name=cj.arch_id)
    loaded = bridge.lm_params_from_jax_numpy(
        tckpt.unflatten(tckpt.load_flat(str(tmp_path), 4, ct.arch_id)), ct,
        device="cpu")
    for a, b in zip(tadamw.leaves(loaded), tadamw.leaves(pt), strict=True):
        assert torch.equal(a, b)


def test_train_lm_draws_the_prefix(tmp_path, monkeypatch):
    """``train_lm`` at reduced llava: each step's batch carries
    ``prefix_embeds [batch, n_prefix_tokens, d]`` (0.1 scale) beside
    tokens and labels of ``seq``; finite losses, every leaf (the
    projection's too) with a non-zero gradient, the checkpoint restored
    by ``repro``."""
    cj, ct = _configs()
    batches, seen = [], []
    real = ttransformer.loss_fn

    def spy(params, batch, cfg):
        batches.append({k: tuple(v.shape) for k, v in batch.items()})
        return real(params, batch, cfg)
    monkeypatch.setattr(ttransformer, "loss_fn", spy)

    def on_step(i, metrics, grads):
        flat = tckpt._flatten_with_paths(grads)
        seen.append(all(g is not None and bool(g.any())
                        for g in flat.values()))
    params, losses = ttrain.train_lm(ct, 2, 2, 32, str(tmp_path),
                                     device="cpu", on_step=on_step,
                                     log_every=1)
    assert batches == [{"tokens": (2, 32), "labels": (2, 32),
                        "prefix_embeds": (2, ct.n_prefix_tokens,
                                          ct.d_model)}] * 2
    assert len(losses) == 2 and all(np.isfinite(losses)) and all(seen)
    like = jax.tree.map(np.zeros_like, _lm()[0])
    restored = _flat(jckpt.restore(str(tmp_path), 2, like, name=cj.arch_id))
    got = _flat(bridge.lm_params_to_jax_numpy(params, ct))
    for k in got:
        assert np.array_equal(restored[k], got[k]), k

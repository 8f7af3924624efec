"""Port parity: the enc-dec backbone, seamless-m4t-medium (``models
.encdec``, ``attention.cross_attention``), against ``repro`` on the CPU
in float32 at ``reduced()`` (2 encoder and 2 decoder layers, d 128, 4
heads of 32), through the port's entry points: ``encdec.forward`` and
``loss_fn``, ``steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` (with the encoder memory), ``train_lm`` and the
bridge; parameters carried across by ``bridge.lm_params_from_jax_numpy``.

Parameters: the comparisons draw every leaf at std 1/sqrt(its port
fan-in) (``_fan_in_init``).  Under the reference's own rule
(``test_torch_lm._reference_init``) the stacked attention leaves draw at
1/sqrt(2) at this depth, and the attention softmaxes, the
cross-attention's over the memory most of all, turn float32 round-off
into ~1e-3 of the logits: the reference's own float32 logits lie
1.4e-3 to 4.1e-3 from a float64 run of the port over six seeds, and the
port's 8e-4 to 7.5e-3 from the reference's (the memory 4e-5 to 1.5e-4,
before the cross-attention).  So the tight checks run at the fan-in
draw, and one forward runs at the reference's draw, its memory to 1e-3
and its logits to 1e-2; the specs are held to the reference's rule
apart.

Tolerances, relative to each output's largest magnitude unless said:
one cross-attention layer 1e-5; the memory, logits, CRF and prefill
logits 1e-5; the loss 1e-6 relative; every gradient leaf 1e-4 relative
L2; AdamW's moments as the gradients and the parameters 1e-6 plus
2·lr; decode over 16 tokens 1e-5 against the reference's and against
the port's own forward.
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.optim import adamw as jadamw
from repro.sharding import partitioning as jpart
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine
from test_torch_lm import _reference_init
from test_torch_lm_training import _flat, _leaf_grads, _port, _rel_l2
from test_torch_moe_lm import _batch, _close, _rel

ARCH = "seamless-m4t-medium"
TOL = 1e-5
GRAD_TOL = 1e-4
REF_DRAW_TOL = 1e-2


def _configs():
    return (jconfigs.reduced(jconfigs.get_config(ARCH)),
            tconfigs.reduced(tconfigs.get_config(ARCH)))


def _fan_in_init(specs, seed, d):
    """Every normal leaf at std 1/sqrt(its fan-in in the port's layout:
    d for the 4-D stacked attention leaves, dim 1 of a 3-D stacked
    leaf, dim 0 of a 2-D one; the embedding and head at their 0.02),
    every leaf then perturbed, as ``_reference_init`` does."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            a = np.full(shape, 0.0 if spec.init == "zeros" else 1.0)
        else:
            fan_in = {4: d, 3: shape[1]}.get(len(shape), shape[0])
            std = spec.scale if spec.scale is not None else (
                0.02 if spec.init == "embed" else 1.0 / np.sqrt(fan_in))
            a = rng.standard_normal(shape) * std
        return jnp.asarray((a + 0.05 * rng.standard_normal(shape)).astype(
            np.float32))
    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@functools.lru_cache(maxsize=None)
def _model(seed=0, rule="fan_in"):
    """Both packages' parameters (read-only)."""
    cj, ct = _configs()
    specs = jencdec.encdec_specs(cj)
    pj = (_fan_in_init(specs, seed, cj.d_model) if rule == "fan_in"
          else _reference_init(specs, seed))
    return pj, _port(pj, ct)


def _frames(b, t, d, seed):
    return (np.random.default_rng(seed).standard_normal((b, t, d)) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    cj, ct = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert ct is tconfigs.REGISTRY[ARCH]
    if reduced:
        cj, ct = _configs()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.is_encdec and ct.n_enc_layers == cj.n_enc_layers
    for per in (2, 4):
        assert tsteps.param_bytes(ct, per) == jpart.param_bytes(cj, per)


def test_specs_draw_with_the_reference_rule():
    """The reference reads dim 0 of its stacked 4-D attention leaves
    ``[n_layers, d, H, hd]`` as the fan-in: the encoder's at
    1/sqrt(n_enc_layers), the decoder's self- and cross-attention at
    1/sqrt(n_layers); the stacked FFN leaves and ``enc_proj`` at
    1/sqrt(d); embedding and head 0.02."""
    ct = tconfigs.get_config(ARCH)
    specs = tencdec.encdec_specs(ct)
    assert len(specs["encoder"]) == ct.n_enc_layers
    assert len(specs["decoder"]) == ct.n_layers
    d = ct.d_model
    for name in ("wq", "wk", "wv", "wo"):
        assert specs["encoder"][0]["attn"][name].std() == \
            1 / np.sqrt(ct.n_enc_layers)
        for part in ("self_attn", "cross_attn"):
            assert specs["decoder"][-1][part][name].std() == \
                1 / np.sqrt(ct.n_layers)
    assert specs["decoder"][0]["ffn"]["wo"].std() == 1 / np.sqrt(ct.d_ff)
    assert specs["enc_proj"]["kernel"].std() == 1 / np.sqrt(d)
    assert specs["head"]["kernel"].std() == 0.02
    assert specs["embed"]["embedding"].std() == 0.02


@pytest.mark.parametrize("s,t", [(8, 24), (1024, 4096)])
def test_cross_attention_matches_reference(s, t, monkeypatch):
    """One cross-attention layer; s·t >= 2048² (S 1024, T 4096) takes
    the blockwise route on both sides, below it the full logits."""
    cj, ct = _configs()
    pj, pt = _model()
    lj = jax.tree.map(lambda a: a[0], pj["decoder"]["cross_attn"])
    lt = pt["decoder"][0]["cross_attn"]
    x = _frames(1, s, ct.d_model, seed=s)
    mem = _frames(1, t, ct.d_model, seed=t) * 10
    calls = []
    real = tattn.blockwise_sdpa
    monkeypatch.setattr(tattn, "blockwise_sdpa",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    want = jax.jit(lambda p, a, m: jattn.cross_attention(p, a, m, cj))(
        lj, jnp.asarray(x), jnp.asarray(mem))
    got = tattn.cross_attention(lt, torch.from_numpy(x),
                                torch.from_numpy(mem), ct)
    assert len(calls) == (s * t >= 2048 ** 2)
    _close(got, want, TOL)


def test_encode_and_forward_match_reference():
    cj, ct = _configs()
    pj, pt = _model()
    tok, _ = _batch(ct.vocab_size)
    fr = _frames(2, 48, ct.d_model, seed=2)
    want = jax.jit(lambda p, f, t: jencdec.forward(p, f, t, cj))(
        pj, jnp.asarray(fr), jnp.asarray(tok))
    got = tencdec.forward(pt, torch.from_numpy(fr), torch.from_numpy(tok), ct)
    for name in ("memory", "crf", "logits"):
        _close(getattr(got, name), getattr(want, name), TOL)
    _close(tencdec.encode(pt, torch.from_numpy(fr), ct), want.memory, TOL)


def test_forward_at_the_reference_draw():
    """The same forward with the reference's own init rule (see the
    module's docstring for why 1e-2)."""
    cj, ct = _configs()
    pj, pt = _model(rule="reference")
    tok, _ = _batch(ct.vocab_size)
    fr = _frames(2, 48, ct.d_model, seed=2)
    want = jax.jit(lambda p, f, t: jencdec.forward(p, f, t, cj))(
        pj, jnp.asarray(fr), jnp.asarray(tok))
    got = tencdec.forward(pt, torch.from_numpy(fr), torch.from_numpy(tok), ct)
    _close(got.memory, want.memory, REF_DRAW_TOL / 10)
    _close(got.logits, want.logits, REF_DRAW_TOL)


def _train_batch(ct, b=2, s=32, t=40, seed=1):
    tok, lab = _batch(ct.vocab_size, b=b, s=s, seed=seed)
    return tok, lab, _frames(b, t, ct.d_model, seed=seed + 10)


def test_loss_fn_and_every_gradient_leaf_match_reference():
    cj, ct = _configs()
    pj, pt = _model()
    tok, lab, fr = _train_batch(ct)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jencdec.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                "frames": jnp.asarray(fr)}, cj), has_aux=True))(pj)
    leaves = _leaf_grads(pt)
    lt, mt = tencdec.loss_fn(leaves, {"tokens": torch.from_numpy(tok),
                                      "labels": torch.from_numpy(lab),
                                      "frames": torch.from_numpy(fr)}, ct)
    lt.backward()
    assert sorted(mt) == sorted(mj) == ["loss"]
    assert _rel(lt, lj) <= 1e-6
    gt = _flat(bridge.lm_params_to_jax_numpy(
        tadamw.tree_map(lambda p: p.grad, leaves), ct))
    want = _flat(gj)
    assert sorted(gt) == sorted(want)
    assert any("cross_attn" in k for k in want) and any(
        k.startswith("enc_proj") for k in want)
    worst = max((_rel_l2(gt[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst


def test_train_step_matches_reference():
    """One ``make_train_step`` step at two microbatches (the frames split
    with the tokens) against the reference's: metrics, AdamW's moments
    and the parameters."""
    cj, ct = _configs()
    pj, _ = _model()
    tok, lab, fr = _train_batch(ct, b=4, s=16, seed=5)
    jstep, jopt = jsteps.make_train_step(cj, microbatch=2)
    tstep, topt = tsteps.make_train_step(ct, microbatch=2)
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    pj2, sj, mj = jax.jit(jstep)(pj, jadamw.init(jopt, pj),
                                 {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab),
                                  "frames": jnp.asarray(fr)})
    pt = _port(pj, ct)
    pt2, st, mt = tstep(pt, tadamw.init(topt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab),
                         "frames": torch.from_numpy(fr)})
    assert pt2 is pt and st.step == 1
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


def test_global_norm_overflows_as_the_reference_does():
    """Finite bf16 gradients whose float32 sum of squares passes float32's
    range (8 entries of 2**63: 2**129): the reference's AdamW and the
    port's both report grad_norm inf, and both clip the gradient's part
    of the update to zero, so that one step moves the weights by the
    weight decay alone (the port's against the reference's to one bf16
    ulp, 2**-8 relative)."""
    rng = np.random.default_rng(7)
    grads = {"big": np.full((8,), 2.0 ** 63, np.float32),
             "small": rng.standard_normal((4, 16)).astype(np.float32)}
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in grads.items()}
    jcfg, tcfg = jadamw.AdamWConfig(), tadamw.AdamWConfig()
    gj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()}
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    pj2, _, mj = jadamw.update(jcfg, gj, jadamw.init(jcfg, pj), pj)
    gt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in grads.items()}
    pt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    assert all(bool(torch.isfinite(g).all()) for g in gt.values())
    pt2, _, mt = tadamw.update(tcfg, gt, tadamw.init(tcfg, pt), pt)
    assert np.isinf(float(mj["grad_norm"])) and np.isinf(float(mt["grad_norm"]))
    lr = float(mj["lr"])
    for k, v in params.items():
        want = np.asarray(pj2[k], np.float32)
        got = pt2[k].float().numpy()
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8)
        decayed = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32) * (
            1 - lr * jcfg.weight_decay)
        np.testing.assert_allclose(want, decayed, rtol=2.0 ** -8)


def test_prefill_step_matches_reference():
    cj, ct = _configs()
    pj, pt = _model()
    tok, _, fr = _train_batch(ct, s=24, t=56, seed=7)
    want = np.asarray(jax.jit(jsteps.make_prefill_step(cj))(
        pj, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(fr)}))
    got = tsteps.make_prefill_step(ct)(
        pt, {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(fr)})
    assert got.shape == (2, ct.vocab_size)
    _close(got, want, TOL)


def test_decode_step_matches_reference_and_forward():
    """``make_decode_step(params, tokens, cache, memory)`` over 16 tokens
    from empty caches against the reference's step (the caches compared
    at the end), and the logits against the port's own forward over the
    same tokens and frames."""
    cj, ct = _configs()
    pj, pt = _model(seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, ct.vocab_size, (2, 16))
    fr = _frames(2, 40, ct.d_model, seed=6)
    mem_j = jax.jit(lambda p, f: jencdec.encode(p, f, cj))(pj,
                                                         jnp.asarray(fr))
    with torch.no_grad():
        mem_t = tencdec.encode(pt, torch.from_numpy(fr), ct)
    _close(mem_t, mem_j, TOL)
    cache_j = jencdec.decode_cache_zeros(cj, 2, 16, jnp.float32)
    cache_t = tencdec.decode_cache_zeros(ct, 2, 16, torch.float32)
    step_j = jax.jit(jsteps.make_decode_step(cj))
    step_t = tsteps.make_decode_step(ct)
    outs = []
    for i in range(toks.shape[1]):
        lj, cache_j = step_j(pj, jnp.asarray(toks[:, i:i + 1]), cache_j,
                             mem_j)
        lt, cache_t = step_t(pt, torch.tensor(toks[:, i:i + 1]), cache_t,
                             mem_t)
        _close(lt, lj, TOL)
        outs.append(lt[:, 0])
    assert [c.index for c in cache_t] == [16] * ct.n_layers
    for field in ("k", "v"):
        _close(torch.stack([getattr(c, field) for c in cache_t]),
               getattr(cache_j, field), TOL)
    with torch.no_grad():
        full = tencdec.forward(pt, torch.from_numpy(fr), torch.tensor(toks),
                               ct).logits
    _close(torch.stack(outs, 1), full.numpy(), TOL)


def test_params_and_checkpoints_cross_both_ways(tmp_path):
    """The encoder and decoder stacks (``[n_layers, ...]`` leaves in the
    reference) cross exactly each way, and checkpoints both ways."""
    cj, ct = _configs()
    pj, pt = _model()
    want = _flat(pj)
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


def test_train_lm_trains_encdec(tmp_path, capsys):
    """``train_lm`` at reduced seamless: finite losses from ~ln(vocab),
    every leaf (the encoder's through the memory too) with a non-zero
    gradient, the checkpoint restored by ``repro``; ``main`` on the CPU
    the same way."""
    cj, ct = _configs()
    seen = []

    def on_step(i, metrics, grads):
        flat = tckpt._flatten_with_paths(grads)
        seen.append(all(g is not None and bool(g.any())
                        for g in flat.values()))
    params, losses = ttrain.train_lm(ct, 2, 2, 32, str(tmp_path),
                                     device="cpu", on_step=on_step,
                                     log_every=1)
    assert len(losses) == 2 and all(np.isfinite(losses)) and all(seen)
    assert abs(losses[0] - np.log(ct.vocab_size)) < 1.0
    like = jax.tree.map(np.zeros_like, _model()[0])
    restored = _flat(jckpt.restore(str(tmp_path), 2, like, name=cj.arch_id))
    got = _flat(bridge.lm_params_to_jax_numpy(params, ct))
    for k in got:
        assert np.array_equal(restored[k], got[k]), k
    ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                 "1", "--batch", "1", "--seq", "16"])
    assert "step    0 loss" in capsys.readouterr().out


def test_lm_engine_refuses_encdec():
    """The reference's ``LMEngine`` has no enc-dec form (it decodes
    ``params["stack"]``); the port's says so."""
    _, ct = _configs()
    with pytest.raises(NotImplementedError, match="enc-dec"):
        tengine.LMEngine(_model()[1], ct, 16, device="cpu")

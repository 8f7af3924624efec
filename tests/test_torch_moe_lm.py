"""Port parity: the LM paths with experts (``transformer.forward`` and
``loss_fn``, ``steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``, ``LMEngine``, ``train_lm`` and the LM bridge)
against ``repro`` on the CPU in float32, at ``reduced()``
granite-moe-3b-a800m and phi3.5-moe-42b-a6.6b (4 experts, top-2, every
layer) and the reference's tiny hybrid with an MoE FFN on every second
layer of its group of 8 (``tests/test_models.py``), parameters carried
across by ``bridge.lm_params_from_jax_numpy``.

Every test asserts first that each routing the port made clears
``test_torch_moe.ROUTE_MARGIN`` (k-th minus (k+1)-th probability).

Tolerances, relative to each output's largest magnitude unless said:
the forward's logits and CRF and the prefill's logits 1e-4, the loss
1e-6 relative, the load-balance and z-losses 1e-5 relative, every
gradient leaf 1e-3 relative L2 (the reference's init gives the stacked
attention projections std 1/sqrt(n_layers): a sharp softmax, as for
yi-9b in ``test_torch_lm.py`` / ``test_torch_lm_training.py``), AdamW's
moments as the gradients and the parameters 1e-6 plus 2·lr (the first
step moves an entry by ~lr·sign(g)); ``decode_step`` over 16 tokens
2e-4 against the reference's, 1e-4 against the port's own forward
(``test_torch_decode.py``'s bounds).  The dropped slots agree exactly
(``drop_fraction`` to one float32 ulp).

Decode routes each step's batch as one group, the forward groups of up
to 2048 tokens, so the two agree only where neither drops: decode's
capacity at batch 2 is at least 2 (nothing can drop), and the port's
decode is held to its forward at a capacity factor of at least
``n_experts / top_k``, where the forward's capacity is its whole group
(drop fraction 0, asserted); at batch 2 that changes no decode
capacity.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jckpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.serving import engine as jengine
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine
from test_torch_lm import _reference_init
from test_torch_lm_training import _flat, _port, _port_loss_and_grads, _rel_l2
from test_torch_moe import (_moe_configs, assert_margins, assert_same_drops,
                            route_spy)  # noqa: F401 (a fixture)

CASES = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "hybrid"]
FWD_TOL = 1e-4
AUX_TOL = 1e-5
GRAD_TOL = 1e-3
RUN_TOL = 2e-4       # decode_step over 16 tokens, port vs repro
SELF_TOL = 1e-4      # the port's decode against its own forward


def _hybrid(mod, moe_mod, ssm_mod, **moe_over):
    moe = dict(n_experts=4, top_k=2, every=2, capacity_factor=8.0)
    moe.update(moe_over)
    return mod(arch_id="tiny", family="hybrid", n_layers=8, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
               head_dim=16, dtype="float32", remat=False, attn_every=8,
               moe=moe_mod(**moe), ssm=ssm_mod(d_state=16, head_dim=16,
                                                chunk=8))


def _configs(case, **moe_over):
    if case == "hybrid":
        return (_hybrid(JModelConfig, JMoEConfig, JSSMConfig, **moe_over),
                _hybrid(TModelConfig, TMoEConfig, TSSMConfig, **moe_over))
    return _moe_configs(case, **moe_over)


@functools.lru_cache(maxsize=None)
def _lm(case, seed=0):
    """Both packages' parameters (read-only)."""
    cj, ct = _configs(case)
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    return pj, _port(pj, ct)


def _batch(vocab, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab[:, -3:] = -1
    lab[0, 5] = -1
    return tok, lab


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / abs(float(b))


def _n_slots(ct, tokens):
    """(token, k) slots routed over the whole stack (the aux is the
    mean over every layer, MoE or not)."""
    n_moe = sum(ct.is_moe_layer(i) for i in range(ct.n_layers))
    return tokens * ct.moe.top_k * n_moe, ct.n_layers / n_moe


def _same_aux(aux_t, aux_j, ct, tokens):
    assert _rel(aux_t.load_balance_loss, aux_j.load_balance_loss) <= AUX_TOL
    assert _rel(aux_t.router_z_loss, aux_j.router_z_loss) <= AUX_TOL
    slots, scale = _n_slots(ct, tokens)
    # per-layer fractions averaged over the stack: the count of drops
    assert_same_drops(aux_t.drop_fraction * scale,
                      jnp.asarray(aux_j.drop_fraction) * scale, slots)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case, route_spy):
    cj, ct = _configs(case)
    pj, pt = _lm(case)
    tok, _ = _batch(ct.vocab_size)
    want = jax.jit(lambda p, t: jtransformer.forward(p, t, cj))(
        pj, jnp.asarray(tok))
    got = ttransformer.forward(pt, torch.from_numpy(tok), ct)
    assert assert_margins(route_spy) == tok.size * sum(
        ct.is_moe_layer(i) for i in range(ct.n_layers))
    _close(got.logits, want.logits, FWD_TOL)
    _close(got.crf, want.crf, FWD_TOL)
    _same_aux(got.aux, want.aux, ct, tok.size)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_every_gradient_leaf_match_reference(case, route_spy):
    """The loss holds the aux terms (weights 0.01 and 1e-3); every leaf's
    gradient, the router's through the aux terms and the combine
    weights among them."""
    cj, ct = _configs(case)
    pj, pt = _lm(case)
    tok, lab = _batch(ct.vocab_size)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, cj),
        has_aux=True))(pj)
    lt, mt, gt = _port_loss_and_grads(pt, tok, lab, ct)
    assert_margins(route_spy)
    assert _rel(lt, lj) <= 1e-6
    assert sorted(mt) == sorted(mj) == ["drop_fraction", "lb_loss", "loss"]
    assert _rel(mt["lb_loss"], mj["lb_loss"]) <= AUX_TOL
    slots, scale = _n_slots(ct, tok.size)
    assert_same_drops(mt["drop_fraction"] * scale,
                      jnp.asarray(mj["drop_fraction"]) * scale, slots)
    # the aux terms are in the loss: without them it would be smaller
    aux = ttransformer.forward(pt, torch.from_numpy(tok), ct).aux
    extra = (ct.moe.aux_loss_weight * aux.load_balance_loss
             + ct.moe.router_z_weight * aux.router_z_loss)
    assert float(extra) > 1e-3 * float(lt)
    want = _flat(gj)
    assert sorted(gt) == sorted(want)
    assert any("router" in k for k in want)
    worst = max((_rel_l2(gt[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(case, microbatch, route_spy):
    """One ``make_train_step`` step (default AdamW, gradient accumulation
    over ``microbatch`` sub-batches) against the reference's: the
    metrics, AdamW's moments and the updated parameters."""
    cj, ct = _configs(case)
    pj, _ = _lm(case)
    tok, lab = _batch(ct.vocab_size, b=4, s=16, seed=5)
    jstep, jopt = jsteps.make_train_step(cj, microbatch=microbatch)
    tstep, topt = tsteps.make_train_step(ct, microbatch=microbatch)
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    pj2, sj, mj = jax.jit(jstep)(pj, jadamw.init(jopt, pj),
                                 {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab)})
    pt = _port(pj, ct)
    pt2, st, mt = tstep(pt, tadamw.init(topt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab)})
    assert_margins(route_spy)
    assert pt2 is pt and st.step == 1
    assert sorted(mt) == sorted(mj)
    for k, tol in (("loss", 1e-6), ("lr", 1e-6), ("lb_loss", AUX_TOL),
                   ("grad_norm", GRAD_TOL)):
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


@pytest.mark.parametrize("case", CASES)
def test_prefill_step_matches_reference(case, route_spy):
    cj, ct = _configs(case)
    pj, pt = _lm(case)
    tok, _ = _batch(ct.vocab_size, b=2, s=24, seed=7)
    want = np.asarray(jax.jit(jsteps.make_prefill_step(cj))(
        pj, {"tokens": jnp.asarray(tok)}))
    got = tsteps.make_prefill_step(ct)(pt, {"tokens": torch.from_numpy(tok)})
    assert_margins(route_spy)
    assert got.shape == (2, ct.vocab_size)
    _close(got, want, FWD_TOL)
    full = ttransformer.forward(pt, torch.from_numpy(tok), ct).logits[:, -1]
    _close(got, full.detach().numpy(), 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_decode_step_matches_reference_and_forward(case, route_spy):
    """``decode_step`` over 16 tokens from empty caches against the
    reference's (caches bridged back at the end), then against the
    port's own forward at the capacity factor that drops nothing."""
    cj, ct = _configs(case)
    pj, pt = _lm(case, seed=5)
    toks = np.random.default_rng(6).integers(0, ct.vocab_size, (2, 16))
    assert tmoe._capacity(ct, 2, 2048)[2] >= 2      # decode drops nothing
    cache_j = jblocks.stack_cache_zeros(cj, 2, 16, jnp.float32)
    cache_t = tblocks.stack_cache_zeros(ct, 2, 16, torch.float32)
    step_j = jax.jit(lambda p, t, c: jtransformer.decode_step(p, t, c, cj))
    outs = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lj, cache_j = step_j(pj, jnp.asarray(toks[:, i:i + 1]), cache_j)
            lt, cache_t = ttransformer.decode_step(
                pt, torch.tensor(toks[:, i:i + 1]), cache_t, ct)
            _close(lt, lj, RUN_TOL)
            outs.append(lt[:, 0])
        nodrop = dataclasses.replace(ct, moe=dataclasses.replace(
            ct.moe, capacity_factor=max(ct.moe.capacity_factor,
                                        ct.moe.n_experts / ct.moe.top_k)))
        assert tmoe._capacity(nodrop, 2, 2048) == tmoe._capacity(ct, 2,
                                                                 2048)
        full = ttransformer.forward(pt, torch.tensor(toks), nodrop)
    assert_margins(route_spy)
    assert float(full.aux.drop_fraction) == 0.0
    _close(torch.stack(outs, 1), full.logits.numpy(), SELF_TOL)
    back = bridge.lm_cache_to_jax_numpy(cache_t, ct)
    for layer, node in cache_j.items():
        for field, want in node._asdict().items():
            got = back[layer][field]
            if field == "index":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want, RUN_TOL)


@pytest.mark.parametrize("case", CASES)
def test_lm_engine_greedy_tokens_match_reference(case, route_spy):
    """``LMEngine``'s prefill logits (1e-4) and greedy tokens, equal up
    to the first position where the reference's top-2 logit margin is
    within 1e-4 of its largest logit (the rule of
    ``test_torch_lm_engine.py``)."""
    prompt_len, n_new = 11, 22
    cj, ct = _configs(case)
    pj, pt = _lm(case, seed=3)
    prompt = np.random.default_rng(4).integers(0, ct.vocab_size,
                                               (2, prompt_len))
    ej = jengine.LMEngine(pj, cj, 40)
    et = tengine.LMEngine(pt, ct, 40, device="cpu")
    lj, _ = ej._prefill(ej.params, jnp.asarray(prompt, jnp.int32),
                        ej.new_cache(2))
    lt, _ = et.prefill(torch.tensor(prompt))
    _close(lt, lj, FWD_TOL)
    want = np.asarray(ej.generate(jnp.asarray(prompt), n_new))
    got = et.generate(torch.tensor(prompt), n_new)
    assert_margins(route_spy)
    assert got.shape == want.shape == (2, prompt_len + n_new)
    logits = np.asarray(jax.jit(lambda p, t: jtransformer.forward(
        p, t, cj).logits)(pj, jnp.asarray(want[:, :-1])))[:, prompt_len - 1:]
    tol = 1e-4 * np.abs(logits).max()
    compared = 0
    for row in range(2):
        for i in range(n_new):
            top2 = np.sort(logits[row, i])[-2:]
            if top2[1] - top2[0] <= tol:
                break
            assert got[row, prompt_len + i] == want[row, prompt_len + i]
            compared += 1
    assert compared >= n_new     # the check is not vacuous


@pytest.mark.parametrize("case", CASES)
def test_params_and_checkpoints_cross_both_ways(case, tmp_path):
    """The router and the expert leaves (``[n_groups, e, d, f]`` in the
    reference) cross exactly each way: ``lm_params_to_jax_numpy``
    inverts ``lm_params_from_jax_numpy``; a checkpoint the port writes
    restores in ``repro``, and one ``repro`` writes loads in the port
    (``load_flat`` + ``unflatten`` + the bridge)."""
    cj, ct = _configs(case)
    pj, pt = _lm(case)
    want = _flat(pj)
    assert any(k.endswith("ffn/router") or "router" in k for k in want)
    back = bridge.lm_params_to_jax_numpy(pt, ct)
    got = {k: v.numpy() for k, v in tckpt._flatten_with_paths(back).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k],
                                                                want[k]), k
    tckpt.save(str(tmp_path), 3, back, name=ct.arch_id)
    like = jcommon.init_params(jtransformer.lm_specs(cj), jax.random.key(0))
    restored = _flat(jckpt.restore(str(tmp_path), 3, like, name=cj.arch_id))
    for k in want:
        assert np.array_equal(restored[k], want[k]), k
    jckpt.save(str(tmp_path), 4, pj, name=cj.arch_id)
    loaded = bridge.lm_params_from_jax_numpy(
        tckpt.unflatten(tckpt.load_flat(str(tmp_path), 4, ct.arch_id)), ct,
        device="cpu")
    for a, b in zip(tadamw.leaves(loaded), tadamw.leaves(pt), strict=True):
        assert torch.equal(a, b)


def test_train_lm_trains_an_moe_config_and_logs_its_aux(tmp_path, capsys):
    """``train_lm`` at reduced granite: finite losses, ``lb_loss`` and
    ``drop_fraction`` in each step's metrics and log line, every leaf
    (the router's too) with a non-zero gradient, the checkpoint saved;
    ``main`` on the CPU the same way."""
    _, ct = _configs("granite-moe-3b-a800m")
    seen = []

    def on_step(i, metrics, grads):
        flat = tckpt._flatten_with_paths(grads)
        seen.append((sorted(metrics), all(
            g is not None and bool(g.any()) for g in flat.values())))
    _, losses = ttrain.train_lm(ct, 3, 2, 32, "", device="cpu",
                                on_step=on_step, log_every=1)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert seen == [(["drop_fraction", "grad_norm", "lb_loss", "loss",
                      "lr"], True)] * 3
    out = capsys.readouterr().out
    assert "step    2 loss" in out and "lb_loss" in out and \
        "drop_fraction" in out
    ttrain.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device",
                 "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                 "--ckpt", str(tmp_path)])
    assert "saved" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path),
                             name="granite-moe-3b-a800m") == 2


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_stack_dispatches_by_the_config_impl(impl, monkeypatch):
    """``cfg.moe.impl`` picks the dispatch in every MoE layer, as the
    reference's ``_ffn``; both give the same forward."""
    _, ct = _configs("granite-moe-3b-a800m")
    ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, impl=impl))
    _, pt = _lm("granite-moe-3b-a800m")
    called = []
    for name in ("moe_ffn", "moe_ffn_gather"):
        real = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, real=real, name=name, **k:
                            (called.append(name), real(*a, **k))[1])
    tok, _ = _batch(ct.vocab_size, seed=9)
    got = ttransformer.forward(pt, torch.from_numpy(tok), ct).logits
    assert called == [{"einsum": "moe_ffn",
                       "gather": "moe_ffn_gather"}[impl]] * ct.n_layers
    other = dataclasses.replace(ct, moe=dataclasses.replace(
        ct.moe, impl="gather" if impl == "einsum" else "einsum"))
    _close(got, ttransformer.forward(pt, torch.from_numpy(tok),
                                     other).logits.detach().numpy(), 1e-6)

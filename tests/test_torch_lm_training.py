"""Port parity: LM training (``transformer.chunked_cross_entropy`` and
``loss_fn``, remat in ``blocks.stack_full``, ``launch.steps``,
``launch.train.train_lm`` and ``bridge.lm_params_to_jax_numpy``) against
``repro`` on the CPU, float32, at ``reduced()`` yi-9b (dense GQA) and
mamba2-370m (SSD), parameters carried across by
``bridge.lm_params_from_jax_numpy``.

Tolerances: the loss 1e-6 relative; the cross-entropy's gradients 1e-5
relative L2; every gradient leaf of ``loss_fn`` 1e-5 relative L2 for
mamba2-370m and 1e-3 for yi-9b, whose reference init (the stacked
attention projections at std 1/sqrt(n_layers) = 0.71) makes a softmax
sharp enough that float32 round-off reaches 6e-5 to 2.4e-4 of a leaf
over four parameter seeds (``test_torch_lm.py`` holds the forward to
1e-4 for the same reason); AdamW's moments after one step as the
gradients, and the parameters 1e-6 of each leaf's largest magnitude
(for yi-9b plus 2·lr: the first step moves an entry by ~lr·sign(g), and
an entry within round-off of 0 may flip sign);
the global gradient norm as the gradients; the prefill's logits 1e-4
relative to their largest (as the yi-9b forward); remat on against off
1e-6 (the same arithmetic, recomputed).
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
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.sharding import partitioning as jpart
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine

ARCHS = ["yi-9b", "mamba2-370m"]
GRAD_TOL = {"yi-9b": 1e-3, "mamba2-370m": 1e-5}


def _configs(arch, **over):
    cj = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                             **over)
    ct = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                             **over)
    return cj, ct


def _reference_init(specs, seed):
    """repro's init rules drawn with numpy, every leaf perturbed so that
    zero / one inits (norms, A_log, D, biases) take part."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            a = np.full(shape, 0.0 if spec.init == "zeros" else 1.0)
        else:
            fan_in = shape[1] if len(shape) == 3 else shape[0]
            std = spec.scale if spec.scale is not None else (
                0.02 if spec.init == "embed" else 1.0 / np.sqrt(fan_in))
            a = rng.standard_normal(shape) * std
        return jnp.asarray((a + 0.05 * rng.standard_normal(shape)).astype(
            np.float32))
    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@functools.lru_cache(maxsize=None)
def _lm(arch, seed=0):
    """Both packages' parameters of reduced ``arch`` (read-only)."""
    cj, ct = _configs(arch)
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    return pj, _port(pj, ct)


def _port(pj, ct):
    return bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                           device="cpu")


def _batch(vocab, b=2, s=64, seed=1):
    """Tokens and next-token labels, −1 masking the last positions and
    one inner position."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab[:, -3:] = -1
    lab[0, 5] = -1
    return tok, lab


def _leaf_grads(params):
    return tadamw.tree_map(lambda p: p.clone().requires_grad_(True), params)


def _flat(tree):
    """``{path: numpy}`` of a reference-layout tree."""
    return {k: np.asarray(v, np.float32) for k, v in
            tckpt._flatten_with_paths(jax.tree.map(np.asarray, tree)).items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_loss_and_grads(params, tok, lab, ct):
    leaves = _leaf_grads(params)
    loss, metrics = ttransformer.loss_fn(
        leaves, {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(lab)}, ct)
    loss.backward()
    grads = bridge.lm_params_to_jax_numpy(
        tadamw.tree_map(lambda p: p.grad, leaves), ct)
    return loss.detach(), metrics, _flat(grads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,chunk", [(64, 512), (600, 512), (40, 16)])
def test_chunked_cross_entropy_matches_reference(arch, s, chunk):
    """Value and gradients (hidden state and the embedding / head
    matrix); S 600 is not a multiple of 512 (chunks of 300), S 40 at a
    chunk of 16 takes chunks of 10; −1 labels are masked."""
    cj, ct = _configs(arch)
    pj, _ = _lm(arch)
    key = "embed" if ct.tie_embeddings else "head"
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, s, ct.d_model)).astype(np.float32)
    _, lab = _batch(ct.vocab_size, 2, s, seed=3)
    jp = {key: pj[key]}

    def jloss(p, hh):
        return jtransformer.chunked_cross_entropy(p, hh, jnp.asarray(lab), cj,
                                                  chunk)
    want, (gp, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(h))
    tp = {key: {k: torch.from_numpy(np.array(v)).requires_grad_()
                for k, v in jp[key].items()}}
    th = torch.from_numpy(h).requires_grad_()
    got = ttransformer.chunked_cross_entropy(tp, th, torch.from_numpy(lab),
                                             ct, chunk)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert _rel_l2(th.grad.numpy(), np.asarray(gh)) <= 1e-5
    for k, v in tp[key].items():
        assert _rel_l2(v.grad.numpy(), np.asarray(gp[key][k])) <= 1e-5


def test_chunked_cross_entropy_masks_every_label():
    """All labels −1: the loss is 0 (the count is held at 1)."""
    _, ct = _configs("yi-9b")
    _, pt = _lm("yi-9b")
    h = torch.randn(1, 8, ct.d_model)
    labels = torch.full((1, 8), -1, dtype=torch.int32)
    assert float(ttransformer.chunked_cross_entropy(pt, h, labels, ct)) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_leaf_match_reference(arch):
    cj, ct = _configs(arch)
    pj, pt = _lm(arch)
    tok, lab = _batch(ct.vocab_size)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, cj),
        has_aux=True)(pj)
    lt, mt, gt = _port_loss_and_grads(pt, tok, lab, ct)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    assert sorted(mt) == sorted(mj) == ["drop_fraction", "lb_loss", "loss"]
    assert float(mt["lb_loss"]) == float(mj["lb_loss"]) == 0.0
    want = _flat(gj)
    assert sorted(gt) == sorted(want)
    worst = max((_rel_l2(gt[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_TOL[arch], worst


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value_or_gradient(arch):
    """``cfg.remat`` on against off: the loss and every gradient leaf
    agree, and under ``no_grad`` the forward is the same call."""
    _, ct = _configs(arch)
    _, pt = _lm(arch)
    tok, lab = _batch(ct.vocab_size, seed=4)
    off = _port_loss_and_grads(pt, tok, lab, ct)
    on_cfg = dataclasses.replace(ct, remat=True)
    on = _port_loss_and_grads(pt, tok, lab, on_cfg)
    assert abs(float(on[0]) - float(off[0])) <= 1e-6 * abs(float(off[0]))
    for k, g in off[2].items():
        np.testing.assert_allclose(on[2][k], g, atol=1e-6 * np.abs(g).max())
    with torch.no_grad():
        a = ttransformer.forward(pt, torch.from_numpy(tok), on_cfg).logits
        b = ttransformer.forward(pt, torch.from_numpy(tok), ct).logits
    assert torch.equal(a, b)


def test_remat_runs_each_group_under_checkpoint(monkeypatch):
    """With grad on, a remat config routes each group through
    ``torch.utils.checkpoint``; with grad off, or ``remat=False``, it
    does not."""
    _, ct = _configs("mamba2-370m", remat=True)
    _, pt = _lm("mamba2-370m")
    calls = []
    real = tblocks.checkpoint

    def spy(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)
    monkeypatch.setattr(tblocks, "checkpoint", spy)
    x = torch.randn(1, 32, ct.d_model, requires_grad=True)
    tblocks.stack_full(pt["stack"], x, ct)
    assert calls == [False] * ct.n_layers
    with torch.no_grad():
        tblocks.stack_full(pt["stack"], x, ct)
    tblocks.stack_full(pt["stack"], x, ct, remat=False)
    assert len(calls) == ct.n_layers


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(arch, microbatch):
    """One ``make_train_step`` step (default AdamW, gradient
    accumulation over ``microbatch`` sub-batches) against the
    reference's: the metrics, AdamW's moments (the clipped gradient and
    its square) and the updated parameters."""
    cj, ct = _configs(arch)
    pj, _ = _lm(arch)
    tok, lab = _batch(ct.vocab_size, b=4, s=32, seed=5)
    jstep, jopt = jsteps.make_train_step(cj, microbatch=microbatch)
    tstep, topt = tsteps.make_train_step(ct, microbatch=microbatch)
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    pj2, sj, mj = jstep(pj, jadamw.init(jopt, pj),
                        {"tokens": jnp.asarray(tok),
                         "labels": jnp.asarray(lab)})
    pt = _port(pj, ct)
    pt2, st, mt = tstep(pt, tadamw.init(topt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab)})
    assert pt2 is pt and st.step == 1
    assert sorted(mt) == sorted(mj)
    for k, tol in (("loss", 1e-6), ("lr", 1e-6),
                   ("grad_norm", GRAD_TOL[arch])):
        assert abs(float(mt[k]) - float(mj[k])) <= tol * abs(float(mj[k]))
    for got, want in ((st.mu, sj.mu), (st.nu, sj.nu)):
        got = _flat(bridge.lm_params_to_jax_numpy(got, ct))
        want = _flat(want)
        worst = max((_rel_l2(got[k], want[k]), k) for k in want)
        assert worst[0] <= max(GRAD_TOL[arch], 1e-5), worst
    got = _flat(bridge.lm_params_to_jax_numpy(pt2, ct))
    # AdamW's first step moves an entry by ~lr·sign(g): a yi-9b gradient
    # entry within round-off of 0 may flip sign, 2·lr apart
    flip = 2 * float(mj["lr"]) if arch == "yi-9b" else 0.0
    for k, want in _flat(pj2).items():
        np.testing.assert_allclose(got[k], want,
                                   atol=1e-6 * np.abs(want).max() + flip)


def test_train_step_accumulation_splits_the_batch():
    """``microbatch=2`` equals the average of the two half batches'
    gradients: the same first moment as one step on the whole batch,
    since the loss is a mean over equally many valid labels."""
    _, ct = _configs("mamba2-370m")
    pj, _ = _lm("mamba2-370m")
    tok, lab = _batch(ct.vocab_size, b=4, s=32, seed=6)
    lab[:, -3:] = -1
    lab[0, 5] = lab[2, 5] = -1
    moments = []
    for mb in (1, 2):
        step, opt = tsteps.make_train_step(ct, microbatch=mb)
        pt = _port(pj, ct)
        _, st, _ = step(pt, tadamw.init(opt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab)})
        moments.append(_flat(bridge.lm_params_to_jax_numpy(st.mu, ct)))
    for k, g in moments[0].items():
        assert _rel_l2(moments[1][k], g) <= 1e-5, k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    cj, ct = _configs(arch)
    pj, pt = _lm(arch)
    tok, _ = _batch(ct.vocab_size, b=2, s=48, seed=7)
    want = np.asarray(jsteps.make_prefill_step(cj)(
        pj, {"tokens": jnp.asarray(tok)}))
    got = tsteps.make_prefill_step(ct)(pt, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (2, ct.vocab_size)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    full = ttransformer.forward(pt, torch.from_numpy(tok), ct).logits[:, -1]
    np.testing.assert_allclose(got.numpy(), full.detach().numpy(),
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_bytes_matches_reference(arch, reduced):
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        cj, ct = jconfigs.reduced(cj), tconfigs.reduced(ct)
    for per in (2, 4):
        assert tsteps.param_bytes(ct, per) == jpart.param_bytes(cj, per)


@pytest.mark.parametrize("what", ["prefix", "encdec"])
def test_unported_configs_raise(what):
    """Enc-dec and modality-prefix configs raised here until they were
    ported (their parity: ``test_torch_encdec.py``, ``test_torch_vlm.py``);
    now the train and prefill steps build and ``train_lm`` trains one
    step on each.  What is still refused is ``LMEngine`` on an enc-dec
    config: the reference's has no enc-dec form."""
    _, ct = _configs("yi-9b")
    ct = dataclasses.replace(ct, **({"n_prefix_tokens": 4} if what == "prefix"
                                    else {"is_encdec": True,
                                          "n_enc_layers": 2}))
    assert callable(tsteps.make_train_step(ct)[0])
    assert callable(tsteps.make_prefill_step(ct))
    params, losses = ttrain.train_lm(ct, 1, 1, 8, "", device="cpu")
    assert np.isfinite(losses).all()
    if what == "encdec":
        with pytest.raises(NotImplementedError, match="enc-dec"):
            tengine.LMEngine(params, ct, 8, device="cpu")
    else:
        assert "prefix_proj" in params


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch, tmp_path):
    """``lm_params_to_jax_numpy`` inverts ``lm_params_from_jax_numpy``
    exactly, and a checkpoint the port writes restores in ``repro``."""
    cj, ct = _configs(arch)
    pj, pt = _lm(arch)
    back = bridge.lm_params_to_jax_numpy(pt, ct)
    want = _flat(pj)
    got = {k: v.numpy() for k, v in tckpt._flatten_with_paths(back).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k],
                                                                want[k]), k
    again = bridge.lm_params_from_jax_numpy(back, ct, device="cpu")
    for a, b in zip(tadamw.leaves(again), tadamw.leaves(pt), strict=True):
        assert torch.equal(a, b)
    tckpt.save(str(tmp_path), 3, back, name=ct.arch_id)
    like = jcommon.init_params(jtransformer.lm_specs(cj), jax.random.key(0))
    restored = _flat(jckpt.restore(str(tmp_path), 3, like, name=cj.arch_id))
    for k in want:
        assert np.array_equal(restored[k], want[k]), k


def test_train_lm_loss_falls_and_its_checkpoint_loads_in_repro(tmp_path,
                                                              capsys):
    """The port of ``tests/test_system.py``'s LM training check at
    reduced yi-9b, run longer (150 steps at batch 4, seq 32): with the
    port's random streams the loss over 15 steps is noise (ln 512 ±
    0.03 in both packages), so the mean of the last ten steps is held
    below the first ten's, and the last below the first.  The saved
    checkpoint restores in ``repro``, whose forward equals the trained
    port's."""
    cj, ct = _configs("yi-9b")
    params, losses = ttrain.train_lm(ct, 150, 4, 32, str(tmp_path),
                                     device="cpu", log_every=50)
    assert len(losses) == 150 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert losses[-1] < losses[0]
    assert "step  149" in capsys.readouterr().out
    assert not any(p.requires_grad for p in tadamw.leaves(params))
    like = jcommon.init_params(jtransformer.lm_specs(cj), jax.random.key(0))
    pj = jckpt.restore(str(tmp_path), 150, like, name=cj.arch_id)
    tok, _ = _batch(ct.vocab_size, b=1, s=32, seed=8)
    want = np.asarray(jtransformer.forward(pj, jnp.asarray(tok), cj).logits)
    got = ttransformer.forward(params, torch.from_numpy(tok), ct).logits
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_train_lm_on_step_sees_metrics_and_gradients():
    _, ct = _configs("mamba2-370m")
    seen = []

    def on_step(i, metrics, grads):
        flat = tckpt._flatten_with_paths(grads)
        seen.append((i, sorted(metrics), all(
            g is not None and bool(g.any()) for g in flat.values())))
    _, losses = ttrain.train_lm(ct, 2, 2, 32, "", device="cpu",
                                on_step=on_step)
    assert seen == [(i, ["grad_norm", "loss", "lr"], True) for i in (0, 1)]
    assert len(losses) == 2


def test_main_trains_mamba2_on_the_cpu(tmp_path, capsys):
    ttrain.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    1 loss" in out and "saved" in out
    assert tckpt.latest_step(str(tmp_path), name="mamba2-370m") == 2

"""Port parity: jamba-1.5-large-398b (the hybrid stack: 7 mamba2 layers
and 1 attention layer a group, the MoE FFN on every other layer, SSD
heads of 128) against ``repro`` on the CPU in float32 at ``reduced()``
(one group of 8 layers, d 128, 4 experts top-2, SSD heads of 32),
through the port's entry points: ``transformer.forward`` and
``loss_fn``, ``steps.make_train_step`` / ``make_prefill_step`` /
``make_decode_step``, ``LMEngine``, ``train_lm`` and the LM bridge;
parameters carried across by ``bridge.lm_params_from_jax_numpy``.  Also
the head split by which the SSD kernels take heads of 128 (``ssd_scan
.split_heads`` / ``merge_head_grads``), held on the plain versions.

Every routing comparison first asserts that each routing the port made
clears ``test_torch_moe.ROUTE_MARGIN``.  Tolerances are
``test_torch_moe_lm``'s: the forward's logits and CRF and the prefill's
logits 1e-4 of the largest magnitude, the loss 1e-6 relative, the aux
losses 1e-5 relative, every gradient leaf 1e-3 relative L2, AdamW's
moments as the gradients and the parameters 1e-6 plus 2·lr, decode over
16 tokens 2e-4; the drops exactly.  The head split: 1e-5 of each
output's largest magnitude (float32 sums of the same terms in another
order; dA 1e-4: a sum over every token whose terms cancel).
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
from repro_torch.kernels import ref, ssd_scan
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw
from repro_torch.serving import engine as tengine
from test_torch_lm import _reference_init
from test_torch_lm_training import _flat, _port, _port_loss_and_grads, _rel_l2
from test_torch_moe import assert_margins, route_spy  # noqa: F401 (fixture)
from test_torch_moe_lm import _batch, _close, _rel, _same_aux

ARCH = "jamba-1.5-large-398b"
FWD_TOL = 1e-4
GRAD_TOL = 1e-3
RUN_TOL = 2e-4
SPLIT_TOL = {"dA": 1e-4}


def _configs():
    return (jconfigs.reduced(jconfigs.get_config(ARCH)),
            tconfigs.reduced(tconfigs.get_config(ARCH)))


@functools.lru_cache(maxsize=None)
def _lm(seed=0):
    """Both packages' parameters (read-only)."""
    cj, ct = _configs()
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    return pj, _port(pj, ct)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """Field for field, the cadence (attention at l7, MoE on l1, l3, l5,
    l7), the parameter bytes, and registered."""
    cj, ct = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    assert ct is tconfigs.REGISTRY[ARCH]
    if reduced:
        cj, ct = _configs()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.layer_kinds()[:8] == ("ssm",) * 7 + ("attn",)
    assert [i for i in range(8) if ct.is_moe_layer(i)] == [1, 3, 5, 7]
    assert (ct.d_inner, ct.n_ssm_heads) == (cj.d_inner, cj.n_ssm_heads)
    for per in (2, 4):
        assert tsteps.param_bytes(ct, per) == jpart.param_bytes(cj, per)


def test_forward_matches_reference(route_spy):
    cj, ct = _configs()
    pj, pt = _lm()
    tok, _ = _batch(ct.vocab_size)
    want = jax.jit(lambda p, t: jtransformer.forward(p, t, cj))(
        pj, jnp.asarray(tok))
    got = ttransformer.forward(pt, torch.from_numpy(tok), ct)
    assert assert_margins(route_spy) == tok.size * 4
    _close(got.logits, want.logits, FWD_TOL)
    _close(got.crf, want.crf, FWD_TOL)
    _same_aux(got.aux, want.aux, ct, tok.size)


@functools.lru_cache(maxsize=None)
def _reference_grads():
    """The reference's loss, metrics and gradients on ``_batch`` (one
    compile serves two tests)."""
    cj, ct = _configs()
    pj, _ = _lm()
    tok, lab = _batch(ct.vocab_size)
    return jax.jit(jax.value_and_grad(
        lambda p: jtransformer.loss_fn(
            p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, cj),
        has_aux=True))(pj)


def test_loss_fn_and_every_gradient_leaf_match_reference(route_spy):
    cj, ct = _configs()
    pj, pt = _lm()
    tok, lab = _batch(ct.vocab_size)
    (lj, mj), gj = _reference_grads()
    lt, mt, gt = _port_loss_and_grads(pt, tok, lab, ct)
    assert_margins(route_spy)
    assert _rel(lt, lj) <= 1e-6
    assert _rel(mt["lb_loss"], mj["lb_loss"]) <= 1e-5
    want = _flat(gj)
    assert sorted(gt) == sorted(want)
    assert any("ssm/A_log" in k for k in want) and any("router" in k
                                                       for k in want)
    worst = max((_rel_l2(gt[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_TOL, worst


def test_train_step_matches_reference(route_spy):
    """One ``make_train_step`` step (default AdamW) against the
    reference's: the metrics, AdamW's moments and the parameters.  The
    reference's step at one microbatch is its gradients and
    ``adamw.update``; it is taken so, from ``_reference_grads``'s
    compile."""
    cj, ct = _configs()
    pj, _ = _lm()
    tok, lab = _batch(ct.vocab_size)
    _, jopt = jsteps.make_train_step(cj)
    tstep, topt = tsteps.make_train_step(ct)
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    (_, mj), gj = _reference_grads()
    pj2, sj, om = jax.jit(lambda g, st, p: jadamw.update(jopt, g, st, p))(
        gj, jadamw.init(jopt, pj), pj)
    mj = {**mj, **om}
    pt = _port(pj, ct)
    pt2, st, mt = tstep(pt, tadamw.init(topt, pt),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(lab)})
    assert_margins(route_spy)
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


def test_prefill_step_matches_reference(route_spy):
    cj, ct = _configs()
    pj, pt = _lm()
    tok, _ = _batch(ct.vocab_size, b=2, s=48, seed=7)
    want = np.asarray(jax.jit(jsteps.make_prefill_step(cj))(
        pj, {"tokens": jnp.asarray(tok)}))
    got = tsteps.make_prefill_step(ct)(pt, {"tokens": torch.from_numpy(tok)})
    assert_margins(route_spy)
    assert got.shape == (2, ct.vocab_size)
    _close(got, want, FWD_TOL)


def test_decode_step_matches_reference(route_spy):
    """``make_decode_step`` over 16 tokens from empty caches (seven SSM
    caches and one KV cache a group) against the reference's, the caches
    bridged back at the end."""
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
    assert_margins(route_spy)
    back = bridge.lm_cache_to_jax_numpy(cache_t, ct)
    for layer, node in cache_j.items():
        for field, want in node._asdict().items():
            got = back[layer][field]
            if field == "index":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want, RUN_TOL)


def test_lm_engine_prefill_and_greedy_tokens_match_reference(route_spy):
    """``LMEngine``'s prefill logits (1e-4) and greedy tokens, equal up
    to the first position where the reference's top-2 logit margin is
    within 1e-4 of its largest logit (``test_torch_lm_engine.py``'s
    rule)."""
    prompt_len, n_new = 11, 22
    cj, ct = _configs()
    pj, pt = _lm(seed=3)
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


def test_params_and_checkpoints_cross_both_ways(tmp_path):
    """The SSM, attention, router and expert leaves cross exactly each
    way, and checkpoints both ways."""
    cj, ct = _configs()
    pj, pt = _lm()
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


def test_train_lm_trains_jamba(tmp_path):
    """``train_lm`` at reduced jamba: finite losses with the aux metrics,
    every leaf (the SSM's and the router's too) with a non-zero
    gradient, the checkpoint restored by ``repro``."""
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
    like = jax.tree.map(np.zeros_like, _lm()[0])   # the structure only
    restored = _flat(jckpt.restore(str(tmp_path), 2, like, name=cj.arch_id))
    got = _flat(bridge.lm_params_to_jax_numpy(params, ct))
    assert sorted(restored) == sorted(got)
    for k in got:
        assert np.array_equal(restored[k], got[k]), k


# ---------------------------------------------------------------------------
# heads of 128 through the kernels' heads of 64
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, h, p, n, seed):
    """x, B and C as column slices of one conv output (as the mamba2
    block passes them), float32 dt and A, and an output gradient."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(
        (rng.standard_normal((b, s, h * p + 2 * n)) * 0.5).astype(np.float32))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, s, h)) - 1.0)).astype(np.float32))
    a = torch.from_numpy(-np.exp(rng.standard_normal(h) * 0.3)
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p))
                          .astype(np.float32))
    return x, dt, a, bm, cm, dy


def _near(name, got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, (name, err)


@pytest.mark.parametrize("p,n,chunk", [(128, 16, 16), (128, 32, 64),
                                       (192, 16, 32)])
def test_split_heads_is_the_scan_on_wide_heads(p, n, chunk):
    """The scan and all five gradients on heads of ``p`` equal the same
    on ``p / 64`` heads of 64 a head (the kernels' view), forward and
    backward, through the plain versions: x split as a view of the
    column slice (no copy), dt and A repeated per head, ddt and dA summed
    back."""
    x, dt, a, bm, cm, dy = _scan_inputs(2, 128, 3, p, n, seed=p + n)
    xs, dts, As = ssd_scan.split_heads(x, dt, a)
    r = p // ssd_scan.HEAD_DIM
    assert xs.shape == (2, 128, 3 * r, 64) and xs.data_ptr() == x.data_ptr()
    assert xs.stride()[:2] == x.stride()[:2]
    want = ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk)
    got = ref.ssd_chunk_scan_ref(xs, dts, As, bm, cm, chunk)
    _near("y", got.reshape(x.shape), want, 1e-5)
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk)
    got = ssd_scan.merge_head_grads(ref.ssd_chunk_scan_bwd_ref(
        xs, dts, As, bm, cm, dy.reshape(xs.shape), chunk), p)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                          strict=True):
        _near(name, g, w, SPLIT_TOL.get(name, 1e-5))


def test_kernel_check_admits_multiples_of_64_only():
    """The wrapper's check takes a head of 64·r (128, jamba's) as it is
    and another width too (96 runs on zero columns up to 128, two heads
    of 64), stopping at the device check; a d_state over 128 is refused,
    naming ROADMAP.md, before it looks at the device."""
    x, dt, a, bm, cm, _ = _scan_inputs(1, 64, 2, 128, 16, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan._check("t", x, dt, a, bm, cm, 64)
    x96 = torch.zeros((1, 64, 2, 96))
    assert ssd_scan.kernel_head(96) == 128 and ssd_scan.kernel_head(128) \
        == 128
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan._check("t", x96, dt, a, bm, cm, 64)
    b136 = torch.zeros((1, 64, 136))
    with pytest.raises(ValueError, match="d_state 136.*ROADMAP"):
        ssd_scan._check("t", x96, dt, a, b136, b136, 64)

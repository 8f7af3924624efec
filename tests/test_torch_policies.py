"""Port parity: the policy protocol, rings and FreqCa update/predict
(``repro_torch.core.policies`` vs ``repro.core.policies``), on the CPU.

Ring contents and timestamps are copies, so they are held equal; the
float32 forecasts to 1e-5 absolute (unit-scale inputs, different
summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpol
from repro.core.policies import base as jbase
from repro_torch.core import policies as tpol
from repro_torch.core.policies import base as tbase

ATOL = 1e-5


def _push_both(k, feat, n_push, seed=0, b=3):
    rng = np.random.default_rng(seed)
    jring = jbase.ring_init(b, k, feat)
    tring = tbase.ring_init(b, k, feat)
    for t in np.linspace(1.0, 0.3, n_push).astype(np.float32):
        v = rng.standard_normal((b,) + feat).astype(np.float32)
        jring = jbase.ring_push(jring, jnp.asarray(v), t)
        tring = tbase.ring_push(tring, torch.from_numpy(v), torch.tensor(t))
    return jring, tring


@pytest.mark.parametrize("k,n_push", [(3, 2), (3, 4), (4, 9)])
def test_ring_contents_match_reference(k, n_push):
    """Slot contents, timestamps and heads after the head wraps."""
    jring, tring = _push_both(k, (6, 5), n_push)
    np.testing.assert_array_equal(tring.vals.numpy(), np.asarray(jring.vals))
    np.testing.assert_array_equal(tring.ts.numpy(), np.asarray(jring.ts))
    np.testing.assert_array_equal(tring.head.numpy(), np.asarray(jring.head))
    jts, jvals = jbase.ring_ordered(jring)
    tts, tvals = tbase.ring_ordered(tring)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(tbase.ring_last(tring).numpy(),
                                  np.asarray(jbase.ring_last(jring)))


@pytest.mark.parametrize("order", [1, 2])
def test_ring_weights_and_predict_match_reference(order):
    jring, tring = _push_both(3, (6, 5), 5)
    t_q = np.float32(0.2)
    np.testing.assert_allclose(
        tbase.ring_slot_weights(tring, torch.tensor(t_q), order).numpy(),
        np.asarray(jbase.ring_slot_weights(jring, t_q, order)), atol=ATOL)
    np.testing.assert_allclose(
        tbase.ring_predict(tring, torch.tensor(t_q), order).numpy(),
        np.asarray(jbase.ring_predict(jring, t_q, order)), atol=1e-4)


def _ctx(pkg_base, step, t, x, feat):
    return pkg_base.StepContext(step_idx=step, t_now=t, x=x, batch=x.shape[0],
                                feat_shape=feat)


@pytest.mark.parametrize("method", ["dct", "fft", "none"])
@pytest.mark.parametrize("low_order,high_order", [(0, 2), (0, 0), (1, 1)])
def test_freqca_update_predict_match_reference(method, low_order,
                                               high_order):
    """Four activations (the high ring wraps), then a forecast; every
    step's decide mask and the final state and prediction agree."""
    b, feat = 2, (32, 8)
    kw = dict(interval=3, method=method, rho=0.125, low_order=low_order,
              high_order=high_order)
    jp, tp = jpol.FreqCaPolicy(**kw), tpol.FreqCaPolicy(**kw)
    js, ts_ = jp.init(b, feat), tp.init(b, feat, device="cpu")
    rng = np.random.default_rng(3)
    x = np.zeros((b, 4, 4, 2), np.float32)
    grid = np.linspace(1.0, 0.0, 11).astype(np.float32)
    for step in range(7):
        jctx = _ctx(jbase, jnp.int32(step), jnp.float32(grid[step]),
                    jnp.asarray(x), feat)
        tctx = _ctx(tbase, step, torch.tensor(grid[step]),
                    torch.from_numpy(x), feat)
        js, jmask = jp.decide(js, jctx)
        ts_, tmask = tp.decide(ts_, tctx)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        if bool(tmask[0]):
            crf = rng.standard_normal((b,) + feat).astype(np.float32)
            js = jp.update(js, jnp.asarray(crf), jctx)
            ts_ = tp.update(ts_, torch.from_numpy(crf), tctx)
    for jleaf, tleaf in zip(jax.tree.leaves(js), tbase.tree_leaves(ts_),
                            strict=True):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   atol=ATOL)
    jctx = _ctx(jbase, jnp.int32(7), jnp.float32(grid[7]), jnp.asarray(x),
                feat)
    tctx = _ctx(tbase, 7, torch.tensor(grid[7]), torch.from_numpy(x), feat)
    np.testing.assert_allclose(tp.predict(ts_, tctx).numpy(),
                               np.asarray(jp.predict(js, jctx)), atol=1e-4)


def test_state_bytes_and_keys_match_reference():
    feat = (256, 64)
    for jp, tp in [(jpol.FreqCaPolicy(interval=5), tpol.FreqCaPolicy()),
                   (jpol.FreqCaPolicy(method="fft", rho=0.25),
                    tpol.FreqCaPolicy(method="fft", rho=0.25)),
                   (jpol.NoCachePolicy(), tpol.NoCachePolicy())]:
        jstate = jax.eval_shape(lambda jp=jp: jp.init(2, feat))
        assert tp.state_bytes(tp.init(2, feat, device="meta")) == \
            jp.state_bytes(jstate)
        assert tp.compatibility_key() == jp.compatibility_key()
        assert tp.needed_history == jp.needed_history
        assert tp.cache_units == jp.cache_units


def test_bank_flags_and_mixed_lanes():
    fq = tpol.FreqCaPolicy()
    bank = tpol.bank(fq, 2)
    assert bank.scalar_decision and not bank.always_full
    assert tpol.bank(tpol.NoCachePolicy(), 1).always_full
    assert isinstance(tpol.bank([fq, fq], 2), tpol.UniformBank)
    mixed = tpol.bank([fq, tpol.NoCachePolicy()], 2)
    assert isinstance(mixed, tpol.MixedBank)
    assert not mixed.scalar_decision and not mixed.always_full
    assert not mixed.uses_error_feedback
    assert tpol.bank([tpol.NoCachePolicy(interval=1),
                      tpol.NoCachePolicy(interval=2)], 2).always_full
    with pytest.raises(ValueError):
        tpol.bank([fq], 2)
    with pytest.raises(TypeError):
        tpol.resolve("freqca")


def test_lane_select_and_clone_leave_old_state_intact():
    """Rings push in place; the per-lane path clones before updating."""
    pol = tpol.FreqCaPolicy(high_order=1)
    state = pol.init(2, (16, 4), device="cpu")
    before = tbase.tree_clone(state)
    crf = torch.randn(2, 16, 4)
    ctx = _ctx(tbase, 0, torch.tensor(1.0), torch.zeros(2, 1), (16, 4))
    mask = torch.tensor([True, False])
    new = tbase.lane_select(mask, pol.update(tbase.tree_clone(state), crf,
                                             ctx), state)
    for a, b in zip(tbase.tree_leaves(state), tbase.tree_leaves(before),
                    strict=True):
        assert torch.equal(a, b)
    assert int(new.n_valid[0]) == 1 and int(new.n_valid[1]) == 0
    assert torch.equal(new.high.vals[1], state.high.vals[1])

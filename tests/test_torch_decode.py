"""Port parity: the LM decode path (the input shapes and ``for_shape``,
``KVCache`` / ``decode_self_attention`` with its ring, ``SSMCache`` /
``ssd_recurrent_step`` / ``ssm_decode_step``, ``blocks.stack_decode``,
``transformer.decode_step`` and ``steps.make_decode_step``) against
``repro`` on the CPU in float32, caches carried both ways by
``bridge.lm_cache_from_jax_numpy`` / ``lm_cache_to_jax_numpy``.

Tolerances, as max |port − reference| over max |reference| of each
output: 1e-5 for one layer's decode (the two sum in other orders); 2e-4
for ``decode_step`` over 16 tokens (the reference's own decode-against-
forward bound, ``tests/test_models.py``, at its tiny configs), and 1e-4
for the port's decode against its own forward.  Attention at logical
positions near 524288 (long_500k) has its own, 1e-5, measured: the RoPE
angle of the first frequency is ~5e5 rad there, so a frequency one
float32 ulp off would move the output by ~1e-3 (seen at theta 5e6, head
width 128, where one of 64 frequencies differs).  At the port configs'
theta 5e5 the two packages' frequencies agree bitwise (tested below),
``sin`` / ``cos`` of one float32 angle agree to an ulp, and the layer
differs by 1.6e-7 to 1.5e-6 at positions 524279 and 524288 over four
seeds, as at small positions (2e-7 to 7e-7).  Cache entries the step
does not write are compared bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
import repro_torch.configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import engine as tengine
from test_torch_lm import _configs, _reference_init

STEP_TOL = 1e-5        # one layer's decode
LONG_POS_TOL = 1e-5    # one attention layer at positions near 524288
RUN_TOL = 2e-4         # decode_step over 16 tokens, port vs repro
SELF_TOL = 1e-4        # the port's decode against its own forward


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------

def test_input_shapes_match_reference():
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    assert tconfigs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("shape", sorted(jconfigs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(tconfigs.REGISTRY))
def test_for_shape_matches_reference(arch, shape):
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if isinstance(ct, tconfigs.ModelConfig):
        assert (tconfigs.needs_sliding_window(ct, shape)
                == jconfigs.needs_sliding_window(cj, shape))
    assert (dataclasses.asdict(tconfigs.for_shape(ct, shape))
            == dataclasses.asdict(jconfigs.for_shape(cj, shape)))


# ---------------------------------------------------------------------------
# one attention layer
# ---------------------------------------------------------------------------

def _attn_layer(seed=0):
    """Reduced yi-9b (d 128, 4 query heads on 2 kv heads of 32): both
    packages' first attention layer."""
    cj, ct = _configs("yi-9b")
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    return (cj, ct, jax.tree.map(lambda a: a[0], pj["stack"]["l0"]["attn"]),
            pt["stack"][0]["l0"]["attn"])


def _attn_case(max_len, window, pos, seed, batch=2):
    cj, ct, lj, lt = _attn_layer(seed)
    rng = _rng(seed + 1)
    shape = (batch, max_len, ct.n_kv_heads, ct.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((batch, 1, ct.d_model)).astype(np.float32)
    cache_j = jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    yj, new_j = jattn.decode_self_attention(lj, jnp.asarray(x), cj, cache_j,
                                            window=window)
    cache_t = tattn.KVCache(torch.tensor(k), torch.tensor(v), pos)
    yt, new_t = tattn.decode_self_attention(lt, torch.tensor(x), ct, cache_t,
                                            window=window)
    return yj, new_j, yt, new_t


@pytest.mark.parametrize("max_len,window,pos", [
    (16, 0, 5),          # no window
    (16, 0, 15),         # the last free slot
    (8, 8, 3),           # a ring not yet full: logical positions < 0
    (8, 8, 43),          # the ring wrapped five times
    (16, 6, 37),         # a window shorter than the ring
], ids=["full", "last-slot", "ring-filling", "ring-wrapped",
        "window-lt-ring"])
def test_decode_self_attention_matches_reference(max_len, window, pos):
    yj, new_j, yt, new_t = _attn_case(max_len, window, pos, seed=pos)
    _close(yt, yj, STEP_TOL)
    assert new_t.index == int(new_j.index) == pos + 1
    slot = pos % max_len if window else pos
    for name in ("k", "v"):
        got, want = getattr(new_t, name), np.asarray(getattr(new_j, name))
        _close(got[:, slot], want[:, slot], STEP_TOL)
        keep = [i for i in range(max_len) if i != slot]
        np.testing.assert_array_equal(got[:, keep].numpy(), want[:, keep])


@pytest.mark.parametrize("pos", [524279, 524288])
def test_decode_attention_at_long_500k_positions(pos):
    """An 8192-slot ring (long_500k's window) at logical positions near
    524288, with its own tolerance (the module docstring)."""
    w = jconfigs.LONG_CONTEXT_WINDOW
    yj, new_j, yt, new_t = _attn_case(w, w, pos, seed=7, batch=1)
    _close(yt, yj, LONG_POS_TOL)
    _close(new_t.k[:, pos % w], np.asarray(new_j.k)[:, pos % w],
           LONG_POS_TOL)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
def test_rope_frequencies_bitwise(arch):
    """What keeps RoPE at long_500k positions within the tolerance: the
    float32 frequencies of the full and the reduced config equal the
    reference's bit for bit."""
    for ct in (tconfigs.get_config(arch), _configs(arch)[1]):
        np.testing.assert_array_equal(
            tcommon.rope_frequencies(ct.head_dim, ct.rope_theta).numpy(),
            np.asarray(jcommon.rope_frequencies(ct.head_dim, ct.rope_theta)))


@pytest.mark.parametrize("max_len,window,pos", [
    (8, 8, 3), (8, 8, 43), (16, 6, 37), (16, 0, 5)])
def test_decode_mask_matches_reference_rule(max_len, window, pos):
    """The slot rule, against a direct enumeration: slot i is valid iff
    it holds a logical position p <= pos seen within the window."""
    want = np.zeros(max_len, bool)
    for p in range(max(0, pos - (window or pos + 1) + 1), pos + 1):
        if window or p < max_len:
            want[p % max_len] = True
    got = tattn.decode_mask(pos, max_len, window, batch=3)
    assert got.shape == (3, 1, max_len)
    np.testing.assert_array_equal(got[0, 0].numpy(), want)


def test_full_cache_without_window_raises():
    _, ct, _, lt = _attn_layer()
    cache = tattn.KVCache.zeros(1, 4, ct.n_kv_heads, ct.head_dim,
                                torch.float32)
    cache.index = 4
    with pytest.raises(ValueError, match="cache full"):
        tattn.decode_self_attention(lt, torch.zeros(1, 1, ct.d_model), ct,
                                    cache)
    # with a window the same cache is a ring and takes the token
    _, cache = tattn.decode_self_attention(lt, torch.zeros(1, 1, ct.d_model),
                                           ct, cache, window=4)
    assert cache.index == 5


# ---------------------------------------------------------------------------
# one mamba2 layer
# ---------------------------------------------------------------------------

def _ssm_layer(seed=0):
    cj, ct = _configs("mamba2-370m")
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    return (cj, ct, jax.tree.map(lambda a: a[0], pj["stack"]["l0"]["ssm"]),
            pt["stack"][0]["l0"]["ssm"])


def test_ssd_recurrent_step_matches_reference():
    rng = _rng(3)
    b, h, p, n = 3, 4, 8, 16
    x, state = (rng.standard_normal(s).astype(np.float32)
                for s in ((b, h, p), (b, h, p, n)))
    dt = rng.uniform(0.01, 0.5, (b, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, n)).astype(np.float32) for _ in "BC")
    yj, sj = jssm.ssd_recurrent_step(*map(jnp.asarray, (x, dt, a, bm, cm,
                                                        state)))
    st = torch.tensor(state)
    yt, st_out = tssm.ssd_recurrent_step(
        *map(torch.tensor, (x, dt, a, bm, cm)), st)
    assert st_out is st                   # updated in place
    _close(yt, yj, STEP_TOL)
    _close(st, sj, STEP_TOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_ssm_decode_step_matches_reference(batch):
    cj, ct, lj, lt = _ssm_layer(seed=batch)
    rng = _rng(batch + 10)
    cache_t = tssm.SSMCache.zeros(batch, ct, torch.float32)
    cache_t.conv.copy_(torch.tensor(
        rng.standard_normal(tuple(cache_t.conv.shape)).astype(np.float32)))
    cache_t.state.copy_(torch.tensor(
        rng.standard_normal(tuple(cache_t.state.shape)).astype(np.float32)))
    cache_j = jssm.SSMCache(jnp.asarray(cache_t.conv.numpy()),
                            jnp.asarray(cache_t.state.numpy()))
    x = rng.standard_normal((batch, 1, ct.d_model)).astype(np.float32)
    yj, new_j = jssm.ssm_decode_step(lj, jnp.asarray(x), cj, cache_j)
    yt, new_t = tssm.ssm_decode_step(lt, torch.tensor(x), ct, cache_t)
    assert new_t is cache_t
    _close(yt, yj, STEP_TOL)
    _close(new_t.conv, new_j.conv, STEP_TOL)
    _close(new_t.state, new_j.state, STEP_TOL)


# ---------------------------------------------------------------------------
# decode_step over 16 tokens: the reference's test_models cases
# ---------------------------------------------------------------------------

def _tiny(mod, **kw):
    base = {"arch_id": "tiny", "family": "dense", "n_layers": 2,
            "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
            "vocab_size": 256, "head_dim": 16, "dtype": "float32",
            "remat": False}
    base.update(kw)
    return mod(**base)


_SSM = {"d_state": 16, "head_dim": 16, "chunk": 8}
CASES = {
    "dense": ({}, 0, 16),
    "ssm": ({"family": "ssm", "d_ff": 0, "n_kv_heads": 4, "ssm": _SSM}, 0,
            16),
    "hybrid": ({"family": "hybrid", "n_layers": 8, "attn_every": 8,
                "d_ff": 64, "ssm": _SSM}, 0, 16),
    "window": ({"sliding_window": 8}, 8, 8),
}


def _tiny_pair(name):
    over, window, cache_len = CASES[name]

    def cfg(mod, ssm_mod):
        kw = dict(over)
        if "ssm" in kw:
            kw["ssm"] = ssm_mod(**kw["ssm"])
        return _tiny(mod, **kw)
    return (cfg(JModelConfig, JSSMConfig), cfg(TModelConfig, TSSMConfig),
            window, cache_len)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_step_matches_reference_and_forward(name):
    cj, ct, window, cache_len = _tiny_pair(name)
    pj = _reference_init(jtransformer.lm_specs(cj), seed=5)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    toks = _rng(6).integers(0, ct.vocab_size, (2, 16))
    cache_j = jblocks.stack_cache_zeros(cj, 2, cache_len, jnp.float32)
    cache_t = tblocks.stack_cache_zeros(ct, 2, cache_len, torch.float32)
    step_j = jax.jit(lambda p, t, c: jtransformer.decode_step(
        p, t, c, cj, window=window))
    outs = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lj, cache_j = step_j(pj, jnp.asarray(toks[:, i:i + 1]), cache_j)
            lt, cache_t = ttransformer.decode_step(
                pt, torch.tensor(toks[:, i:i + 1]), cache_t, ct,
                window=window)
            _close(lt, lj, RUN_TOL)
            outs.append(lt[:, 0])
        full = ttransformer.forward(pt, torch.tensor(toks), ct)
    _close(torch.stack(outs, 1), full.logits.numpy(), SELF_TOL)
    back = bridge.lm_cache_to_jax_numpy(cache_t, ct)
    for layer, node in cache_j.items():
        for field, want in node._asdict().items():
            got = back[layer][field]
            if field == "index":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want, RUN_TOL)


def test_make_decode_step_matches_reference():
    """One step of each package's ``make_decode_step`` from the same
    non-empty cache (the reference's, bridged)."""
    cj, ct, window, cache_len = _tiny_pair("hybrid")
    pj = _reference_init(jtransformer.lm_specs(cj), seed=8)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    rng = _rng(9)
    cache_j = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))
        if a.ndim > 1 else a + 11,
        jblocks.stack_cache_zeros(cj, 2, cache_len, jnp.float32))
    cache_t = bridge.lm_cache_from_jax_numpy(
        jax.tree.map(np.asarray, cache_j), ct, device="cpu")
    assert [g["l7"].index for g in cache_t] == [11]
    toks = rng.integers(0, ct.vocab_size, (2, 1))
    lj, new_j = jsteps.make_decode_step(cj)(pj, jnp.asarray(toks), cache_j)
    lt, new_t = tsteps.make_decode_step(ct)(pt, torch.tensor(toks), cache_t)
    assert new_t is cache_t
    _close(lt, lj, STEP_TOL)
    back = bridge.lm_cache_to_jax_numpy(new_t, ct)
    for layer, node in new_j.items():
        for field, want in node._asdict().items():
            _close(back[layer][field].float(), np.asarray(want, np.float32),
                   STEP_TOL)


def test_make_decode_step_encdec_raises():
    """An enc-dec config's decode step (``test_torch_encdec.py`` holds it
    to the reference) takes the encoder memory, as the reference's:
    called without one it raises; and ``LMEngine``, which has no enc-dec
    form in the reference either, raises ``NotImplementedError``."""
    ct = dataclasses.replace(_tiny(TModelConfig), is_encdec=True,
                             n_enc_layers=2)
    step = tsteps.make_decode_step(ct)
    with pytest.raises(TypeError, match="memory"):
        step({}, torch.zeros((1, 1), dtype=torch.int64), [])
    with pytest.raises(NotImplementedError, match="enc-dec"):
        tengine.LMEngine({}, ct, 8, device="cpu")


@pytest.mark.parametrize("name", ["dense", "hybrid"])
def test_cache_bridge_round_trip(name):
    _, ct, _, _ = _tiny_pair(name)
    cache = tblocks.stack_cache_zeros(ct, 2, 16, torch.float32)
    gen = torch.Generator().manual_seed(0)
    for group in cache:
        for c in group.values():
            for t in vars(c).values():
                if isinstance(t, torch.Tensor):
                    t.normal_(generator=gen)
            if isinstance(c, tattn.KVCache):
                c.index = 9
    tree = bridge.lm_cache_to_jax_numpy(cache, ct)
    back = bridge.lm_cache_from_jax_numpy(
        {k: {f: v.numpy() for f, v in node.items()}
         for k, node in tree.items()}, ct, device="cpu")
    for g0, g1 in zip(cache, back, strict=True):
        for key in g0:
            assert type(g0[key]) is type(g1[key])
            for f, a in vars(g0[key]).items():
                b = vars(g1[key])[f]
                assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                        else a == b)


def test_cache_bridge_refuses_layers_at_other_positions():
    _, ct, _, _ = _tiny_pair("dense")
    tree = bridge.lm_cache_to_jax_numpy(
        tblocks.stack_cache_zeros(ct, 2, 16, torch.float32), ct)
    tree["l0"]["index"][1] = 3
    with pytest.raises(ValueError, match="positions"):
        bridge.lm_cache_from_jax_numpy(tree, ct, device="cpu")

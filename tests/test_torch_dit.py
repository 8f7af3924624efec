"""Port parity: the MMDiT denoiser (``repro_torch.models.dit`` vs
``repro.models.dit``) on ``reduced(flux1-dev)``, parameters carried
across with ``params_from_jax_numpy``, on the CPU.

Tolerance: float32, 1e-5 relative to each output's largest magnitude
(two stacks of matmuls summed in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import common as jcommon
from repro.models import dit as jdit
import repro_torch.configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit

SIDE = 8


def _configs(**over):
    cj = dataclasses.replace(jconfigs.reduced(
        jconfigs.get_config("flux1-dev")), **over)
    ct = dataclasses.replace(tconfigs.reduced(
        tconfigs.get_config("flux1-dev")), **over)
    assert dataclasses.asdict(cj).keys() >= dataclasses.asdict(ct).keys()
    for field in dataclasses.fields(ct):
        assert getattr(ct, field.name) == getattr(cj, field.name)
    return cj, ct


def jax_params(cfg, seed=0):
    """repro's init with the AdaLN-zero leaves perturbed, so every block
    contributes (the zero init makes each block an identity)."""
    params = jcommon.init_params(jdit.dit_specs(cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_text", [False, True])
def test_dit_forward_and_from_crf_match_reference(with_text):
    cj, ct = _configs()
    pj = jax_params(cj)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, SIDE, SIDE, cj.in_channels)).astype(
        np.float32)
    t = np.array([0.9, 0.35], np.float32)
    txt = rng.standard_normal((2, cj.n_text_tokens, cj.text_dim)).astype(
        np.float32) if with_text else None
    want = jdit.dit_forward(pj, jnp.asarray(lat), jnp.asarray(t), cj,
                            None if txt is None else jnp.asarray(txt))
    got = tdit.dit_forward(pt, torch.from_numpy(lat), torch.from_numpy(t),
                           ct, None if txt is None else torch.from_numpy(txt))
    assert got.crf.shape == (2, (SIDE // 2) ** 2, ct.d_model)
    _close(got.velocity, want.velocity)
    _close(got.crf, want.crf)
    _close(tdit.dit_from_crf(pt, got.crf, torch.from_numpy(t), ct, SIDE,
                             SIDE),
           jdit.dit_from_crf(pj, want.crf, jnp.asarray(t), cj, SIDE, SIDE))


def test_flash_route_matches_reference(monkeypatch):
    """Both packages forced onto their flash routes (threshold lowered,
    Pallas in interpret mode for repro): the port calls its op layer —
    the kernel on a card, the plain version here — in each of the
    n_double + n_layers blocks, once per double block."""
    cj, ct = _configs(n_heads=1)            # head_dim 64: a kernel width
    pj = jax_params(cj, seed=2)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    monkeypatch.setattr(jdit, "_FLASH_MIN_SEQ", 8)
    monkeypatch.setattr(tdit, "_FLASH_MIN_SEQ", 8)
    calls = []
    real_flash = ops.flash
    monkeypatch.setattr(ops, "flash",
                        lambda *a: calls.append(a[0].shape) or real_flash(*a))
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, SIDE, SIDE, cj.in_channels)).astype(
        np.float32)
    t = np.array([0.5], np.float32)
    txt = rng.standard_normal((1, cj.n_text_tokens, cj.text_dim)).astype(
        np.float32)
    want = jdit.dit_forward(pj, jnp.asarray(lat), jnp.asarray(t), cj,
                            jnp.asarray(txt))
    got = tdit.dit_forward(pt, torch.from_numpy(lat), torch.from_numpy(t),
                           ct, torch.from_numpy(txt))
    assert len(calls) == ct.n_double + ct.n_layers
    _close(got.velocity, want.velocity)
    _close(got.crf, want.crf)


def test_flash_threshold_and_widths(monkeypatch):
    """Only the sequence threshold routes; a CUDA-routed call at a head
    width the kernel lacks raises instead of running the plain version."""
    assert tdit._flash_ok(4608) and tdit._flash_ok(1024)
    assert not tdit._flash_ok(1023)
    monkeypatch.setattr(tdit, "_FLASH_MIN_SEQ", 8)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    ops.reset_launch_counts()
    q = torch.zeros((1, 16, 2, 96))
    with pytest.raises(ValueError, match="head_dim 96"):
        tdit._attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 0


def test_init_params_follow_reference_rules():
    """Same distributions as repro's init: zeros/ones where it has them,
    and the fan-in rule's std — including the stacked 4-D attention
    leaves, whose fan-in is the layer count (1/sqrt(n_layers))."""
    cfg_j = jconfigs.get_config("dit-small")
    cfg_t = tconfigs.get_config("dit-small")
    pj = jcommon.init_params(jdit.dit_specs(cfg_j), jax.random.key(0))
    pt = tdit.init_params(cfg_t, seed=0, device="cpu")
    n = cfg_t.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        want = float(np.std(np.asarray(pj["single"]["attn"][name])))
        got = float(torch.stack([layer["attn"][name]
                                 for layer in pt["single"]]).std())
        assert abs(want - 1 / np.sqrt(n)) < 0.01 * want
        assert abs(got - want) < 0.01 * want
    want = float(np.std(np.asarray(pj["single"]["mlp"]["wi"])))
    got = float(torch.stack([layer["mlp"]["wi"]
                             for layer in pt["single"]]).std())
    assert abs(got - want) < 0.01 * want
    assert all(float(layer["mod"]["kernel"].abs().max()) == 0.0
               for layer in pt["single"])
    assert float(pt["final_proj"].abs().max()) == 0.0
    assert torch.equal(pt["single"][0]["attn"]["q_norm"],
                       torch.ones(cfg_t.head_dim))
    # one tensor per reference leaf, at the port's shapes
    counts = tcommon.map_specs(lambda s: 1, tdit.dit_specs(cfg_t))
    assert len(counts["single"]) == n


def test_bridge_splits_layers_and_flattens_projections():
    cj, ct = _configs()
    pj = jax.tree.map(np.asarray, jax_params(cj))
    pt = bridge.params_from_jax_numpy(pj, ct, device="cpu")
    d = ct.d_model
    assert len(pt["single"]) == ct.n_layers
    assert len(pt["double"]) == ct.n_double
    for i in range(ct.n_layers):
        np.testing.assert_array_equal(
            pt["single"][i]["attn"]["wq"].numpy(),
            pj["single"]["attn"]["wq"][i].reshape(d, d))
        np.testing.assert_array_equal(
            pt["single"][i]["attn"]["wo"].numpy(),
            pj["single"]["attn"]["wo"][i].reshape(d, d))
    np.testing.assert_array_equal(pt["double"][0]["txt"]["mlp"]["wi"].numpy(),
                                  pj["double"]["txt"]["mlp"]["wi"][0])

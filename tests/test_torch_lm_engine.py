"""Port parity: ``serving.engine.LMEngine`` (prefill through the decode
step, then greedy generation) against ``repro.serving.engine.LMEngine``
on the CPU in float32, at ``reduced()`` yi-9b (with and without a
sliding window) and mamba2-370m, parameters carried across by
``bridge.lm_params_from_jax_numpy``.

Tolerance: LOGIT_TOL = 1e-4 of the largest |logit| (float32 sums in
other orders over a few layers; the prefill's logits differ by ~1e-6 of
it).  The greedy tokens must be equal up to the first position where
the reference's top-2 logit margin is within that tolerance: past it
the two may rightly pick different tokens and then diverge.  The
margins come from the reference's ``forward`` over its own generated
sequence (decode equals forward, ``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch.checkpointing import bridge
from repro_torch.serving import engine as tengine
from test_torch_lm import _configs, _reference_init

LOGIT_TOL = 1e-4
# the teacher-forced forward runs PROMPT + N_NEW - 1 tokens, a multiple
# of the reduced mamba2's SSD chunk (16)
PROMPT, N_NEW = 11, 22

CASES = {"yi-9b": ("yi-9b", 0, 40), "yi-9b-window": ("yi-9b", 8, 40),
         "mamba2-370m": ("mamba2-370m", 0, 40)}


def _pair(name):
    arch, window, max_len = CASES[name]
    cj, ct = _configs(arch)
    pj = _reference_init(jtransformer.lm_specs(cj), seed=3)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    prompt = np.random.default_rng(4).integers(0, ct.vocab_size,
                                               (2, PROMPT))
    return (jengine.LMEngine(pj, cj, max_len, window=window),
            tengine.LMEngine(pt, ct, max_len, window=window, device="cpu"),
            prompt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_logits_match_reference(name):
    ej, et, prompt = _pair(name)
    lj, _ = ej._prefill(ej.params, jnp.asarray(prompt, jnp.int32),
                        ej.new_cache(prompt.shape[0]))
    lt, cache = et.prefill(torch.tensor(prompt))
    lj = np.asarray(lj)
    assert lt.shape == lj.shape and lt.dtype == torch.float32
    err = np.abs(lt.numpy() - lj).max() / np.abs(lj).max()
    assert err <= LOGIT_TOL, err
    kv = [c for g in cache for c in g.values() if hasattr(c, "index")]
    assert all(c.index == PROMPT for c in kv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_matches_reference(name):
    ej, et, prompt = _pair(name)
    want = np.asarray(ej.generate(jnp.asarray(prompt), N_NEW))
    got = et.generate(torch.tensor(prompt), N_NEW)
    assert got.shape == want.shape == (2, PROMPT + N_NEW)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got[:, :PROMPT].numpy(), prompt)
    # the reference's logits at every generated position, teacher-forced
    logits = np.asarray(jtransformer.forward(
        ej.params, jnp.asarray(want[:, :-1]), ej.cfg,
        window=ej.window).logits)[:, PROMPT - 1:]
    tol = LOGIT_TOL * np.abs(logits).max()
    compared = 0
    for row in range(want.shape[0]):
        for i in range(N_NEW):
            top2 = np.sort(logits[row, i])[-2:]
            if top2[1] - top2[0] <= tol:
                break
            assert got[row, PROMPT + i] == want[row, PROMPT + i], (row, i)
            compared += 1
    assert compared >= N_NEW     # the check is not vacuous


def test_generate_twice_starts_from_a_fresh_cache():
    _, et, prompt = _pair("yi-9b-window")
    first = et.generate(torch.tensor(prompt), 4)
    assert torch.equal(et.generate(torch.tensor(prompt), 4), first)


def test_window_defaults_to_the_config():
    _, ct = _configs("yi-9b")
    ct = dataclasses.replace(ct, sliding_window=8)
    _, et, _ = _pair("yi-9b")
    engine = tengine.LMEngine(et.params, ct, 64, device="cpu")
    assert engine.window == 8
    cache = engine.new_cache(1)
    assert cache[0]["l0"].k.shape[1] == 8


def test_device_none_without_cuda_raises(monkeypatch):
    _, et, _ = _pair("mamba2-370m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.LMEngine(et.params, et.cfg, 32)


def test_parameters_off_the_device_raise():
    _, et, _ = _pair("mamba2-370m")
    params = dict(et.params, final_norm={
        "scale": et.params["final_norm"]["scale"].to("meta")})
    with pytest.raises(ValueError, match="lie elsewhere"):
        tengine.LMEngine(params, et.cfg, 32, device="cpu")

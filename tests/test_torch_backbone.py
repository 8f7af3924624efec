"""Port parity: FreqCa on an assigned architecture — reduced mamba2-370m
as the denoiser (``dit.backbone_denoiser_forward`` / ``_from_crf``)
against ``repro`` on the CPU, as a function, under ``sampler.sample``
and served by the engine.  Parameters cross by
``bridge.lm_params_from_jax_numpy``.

Tolerance: float32, 1e-5 relative to each output's largest magnitude
(the port's SSD scan on the CPU is the kernel's arithmetic, the
reference's ``ssd_chunked`` sums in another order).  Activation counts
(``n_full``, ``n_full_lanes``, per-request ``n_full_steps``) are equal
exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import policies as jpol
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.serving.engine import DiffusionEngine as JaxEngine
from repro.serving.engine import DiffusionRequest as JaxRequest
import repro_torch.configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tschedule
from repro_torch.kernels import ops
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest

SIDE = 16                      # latent 16x16x4: 64 tokens, four chunks
LATENT = (SIDE, SIDE, 4)
CRF = ((SIDE // 2) ** 2, 128)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _model():
    """reduced mamba2-370m as a denoiser in both packages; repro's init
    with every leaf perturbed (the zero-initialised ``final_proj`` would
    make the velocity exactly zero)."""
    cj = jconfigs.reduced(jconfigs.get_config("mamba2-370m"))
    ct = tconfigs.reduced(tconfigs.get_config("mamba2-370m"))
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    pj = jcommon.init_params(jdit.backbone_denoiser_specs(cj),
                             jax.random.key(0))
    rng = np.random.default_rng(0)
    pj = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        pj)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")

    def jfull(x, t):
        out = jdit.backbone_denoiser_forward(pj, x, jnp.full((x.shape[0],), t),
                                             cj)
        return out.velocity, out.crf

    def jcrf(c, t):
        return jdit.backbone_denoiser_from_crf(pj, c, cj, SIDE, SIDE)

    def tfull(x, t):
        out = tdit.backbone_denoiser_forward(pt, x, t.expand(x.shape[0]), ct)
        return out.velocity, out.crf

    def tcrf(c, t):
        return tdit.backbone_denoiser_from_crf(pt, c, ct, SIDE, SIDE)
    return cj, ct, pj, pt, (jfull, jcrf), (tfull, tcrf)


def test_backbone_forward_and_from_crf_match_reference():
    cj, ct, pj, pt, _, _ = _model()
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2,) + LATENT).astype(np.float32)
    t = np.array([0.9, 0.3], np.float32)
    want = jdit.backbone_denoiser_forward(pj, jnp.asarray(lat),
                                          jnp.asarray(t), cj)
    got = tdit.backbone_denoiser_forward(pt, torch.from_numpy(lat),
                                         torch.from_numpy(t), ct)
    assert tuple(got.crf.shape) == (2,) + CRF
    _close(got.velocity, want.velocity)
    _close(got.crf, want.crf)
    crf = rng.standard_normal((2,) + CRF).astype(np.float32)
    _close(tdit.backbone_denoiser_from_crf(pt, torch.from_numpy(crf), ct,
                                           SIDE, SIDE),
           jdit.backbone_denoiser_from_crf(pj, jnp.asarray(crf), cj, SIDE,
                                           SIDE))


def test_backbone_specs_follow_reference():
    """The same leaves at the port's shapes; ``final_proj`` zero."""
    cj, ct, _, _, _, _ = _model()
    jspec = jdit.backbone_denoiser_specs(cj)
    tspec = tdit.backbone_denoiser_specs(ct)
    for name in ("patch_proj", "time_mlp1", "time_mlp2"):
        assert tspec[name]["kernel"].shape == jspec[name]["kernel"].shape
    assert tspec["final_proj"].init == "zeros"
    assert len(tspec["stack"]) == ct.n_layers
    pt = tcommon.init_params(tspec, seed=0, device="cpu")
    assert float(pt["final_proj"].abs().max()) == 0.0


@pytest.mark.parametrize("interval", [3, 4])
def test_freqca_sample_matches_reference(interval):
    """FreqCa over the mamba2 backbone through ``sampler.sample``: the
    same full-step counts, per lane too, and the same latents."""
    cj, ct, _, _, (jfull, jcrf), (tfull, tcrf) = _model()
    x0 = np.random.default_rng(2).standard_normal((2,) + LATENT).astype(
        np.float32)
    kw = dict(interval=interval, method="dct", rho=0.25)
    want = jsampler.sample(jfull, jcrf, jnp.asarray(x0),
                           jschedule.timesteps(12), jpol.FreqCaPolicy(**kw),
                           (2,) + CRF)
    got = tsampler.sample(tfull, tcrf, torch.from_numpy(x0),
                          tschedule.timesteps(12), tpol.FreqCaPolicy(**kw),
                          (2,) + CRF)
    assert got.n_full == int(want.n_full) < 12
    np.testing.assert_array_equal(got.n_full_lanes.numpy(),
                                  np.asarray(want.n_full_lanes))
    _close(got.x, want.x)
    assert ops.launch_counts()["ssd_chunk_scan"] == 0   # the CPU route


def test_engine_full_steps_match_reference():
    """Three requests served by each package's engine (max_batch 2):
    every request's ``n_full_steps`` is equal."""
    _, _, _, _, (jfull, jcrf), (tfull, tcrf) = _model()
    kw = dict(interval=3, method="dct", rho=0.25)
    jeng = JaxEngine(jfull, jcrf, LATENT, CRF, jpol.FreqCaPolicy(**kw),
                     n_steps=8, max_batch=2)
    teng = DiffusionEngine(tfull, tcrf, LATENT, CRF, tpol.FreqCaPolicy(**kw),
                           n_steps=8, max_batch=2, device="cpu")
    for i in range(3):
        jeng.submit(JaxRequest(request_id=i, seed=i))
        teng.submit(DiffusionRequest(request_id=i, seed=i))
    want = {r.request_id: r.n_full_steps for r in jeng.serve_until_drained()}
    got = {r.request_id: r.n_full_steps for r in teng.serve_until_drained()}
    assert got == want and len(got) == 3

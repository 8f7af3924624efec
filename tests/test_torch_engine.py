"""The port's serving engine on the CPU: each request's result equals the
port's own ``sample`` of that lane alone; per-request activation counts
and cache footprints equal ``repro``'s engine's; and entry points called
without ``device="cpu"`` raise when there is no CUDA device.

Tolerance for batch-vs-solo latents: 1e-5 relative to the largest
magnitude (a batched matmul may sum in another order than a solo one).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import policies as jpol
from repro.serving.engine import DiffusionEngine as JaxEngine
from repro.serving.engine import DiffusionRequest as JaxRequest
from repro_torch import device as device_lib
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol
from repro_torch.diffusion import sampler as tsampler
from repro_torch.models import dit as tdit
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
from test_torch_dit import SIDE, _configs, jax_params
from test_torch_sampler import denoisers

STEPS = 8
LATENT = (SIDE, SIDE, 16)


@pytest.fixture(scope="module")
def model():
    cj, ct = _configs()
    pj = jax_params(cj, seed=8)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    # one prompt for every lane, so a lane's result cannot depend on
    # its position in a batch
    txt = np.repeat(np.random.default_rng(9).standard_normal(
        (1, cj.n_text_tokens, cj.text_dim)).astype(np.float32), 4, axis=0)
    return cj, ct, pt, denoisers(cj, ct, pj, pt, txt)


def _crf_shape(cfg):
    return ((SIDE // 2) ** 2, cfg.d_model)


def test_engine_lanes_equal_solo_samples(model):
    _, ct, _, (_, (tfull, tcrf)) = model
    pol = tpol.FreqCaPolicy(interval=3, method="fft", rho=0.25)
    eng = DiffusionEngine(tfull, tcrf, LATENT, _crf_shape(ct), pol,
                          n_steps=STEPS, max_batch=2, device="cpu")
    assert eng.warmup() >= 0.0
    reqs = [DiffusionRequest(request_id=i, seed=20 + i) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    results = eng.serve_until_drained()
    assert sorted(r.request_id for r in results) == [0, 1, 2]
    assert sorted(r.bucket for r in results) == [1, 2, 2]
    for res in results:
        noise = torch.randn(LATENT, generator=torch.Generator().manual_seed(
            20 + res.request_id))
        solo = tsampler.sample(tfull, tcrf, noise[None], eng._ts, pol,
                               (1,) + _crf_shape(ct))
        assert res.n_full_steps == int(solo.n_full_lanes[0])
        want = solo.x[0]
        torch.testing.assert_close(res.latents, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    summary = eng.metrics.summary()
    assert summary["requests"] == 3 and summary["batches"] == 2
    assert summary["cache_state_bytes_per_lane"] == eng.state_bytes(1)


@pytest.mark.parametrize("which", ["freqca", "none"])
def test_engine_full_steps_match_reference(model, which):
    cj, ct, _, ((jfull, jcrf), (tfull, tcrf)) = model
    if which == "none":
        jp, tp = jpol.NoCachePolicy(), tpol.NoCachePolicy()
    else:
        jp = jpol.FreqCaPolicy(interval=3, method="dct", rho=0.25)
        tp = tpol.FreqCaPolicy(interval=3, method="dct", rho=0.25)
    jeng = JaxEngine(jfull, jcrf, LATENT, _crf_shape(cj), jp,
                     n_steps=STEPS, max_batch=2)
    teng = DiffusionEngine(tfull, tcrf, LATENT, _crf_shape(ct), tp,
                           n_steps=STEPS, max_batch=2, device="cpu")
    for i in range(3):
        jeng.submit(JaxRequest(request_id=i, seed=i))
        teng.submit(DiffusionRequest(request_id=i, seed=i))
    want = {r.request_id: r.n_full_steps for r in jeng.serve_until_drained()}
    got = {r.request_id: r.n_full_steps for r in teng.serve_until_drained()}
    assert got == want
    assert teng.state_bytes(2) == jeng.state_bytes(2)


def test_engine_editing_lane_starts_from_noised_reference(model):
    _, ct, _, (_, (tfull, tcrf)) = model
    eng = DiffusionEngine(tfull, tcrf, LATENT, _crf_shape(ct),
                          tpol.NoCachePolicy(), n_steps=2, max_batch=2,
                          device="cpu")
    ref = torch.ones(LATENT)
    eng.submit(DiffusionRequest(request_id=0, seed=3, init_latents=ref,
                                edit_strength=0.25))
    plan = eng.scheduler.form_batch(flush=True)
    x = eng.build_x_init(plan)
    noise = torch.randn(LATENT, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(x[0], 0.75 * ref + 0.25 * noise)


def test_entry_points_raise_without_cuda(model):
    """No silent CPU fallback: ``device=None`` means the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ct, _, (_, (tfull, tcrf)) = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionEngine(tfull, tcrf, LATENT, _crf_shape(ct),
                        tpol.FreqCaPolicy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdit.init_params(ct, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax_numpy({}, ct)
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_shape_ladder_rejects_undeclared_shapes(model):
    from repro_torch.serving.scheduler import ShapeMismatchError
    _, ct, _, (_, (tfull, tcrf)) = model
    eng = DiffusionEngine(tfull, tcrf, LATENT, _crf_shape(ct),
                          tpol.FreqCaPolicy(), n_steps=2, device="cpu")
    with pytest.raises(ShapeMismatchError):
        eng.submit(DiffusionRequest(request_id=0, seed=0,
                                    latent_shape=(4, 4, 16)))

"""The five examples' twins on the port (``examples/torch_*.py``) on the
CPU at their smallest sizes, against ``repro`` where the reference
scripts compute something of their own, and standing alone: none
imports ``jax``, ``repro``, ``benchmarks`` or ``chip_smoke``, none reads
the environment at import, and none falls back to the CPU.

Tolerances: the sampled latents within 1e-5 of their largest magnitude
(float32 over 10 Euler steps, as ``test_torch_sampler``); the Fig-2
statistics within 1e-5 absolute (cosine similarities and norm ratios of
float32 bands, the port's bands from the same transforms).
"""
import ast
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from benchmarks import fig2_freq_analysis as jfig2
from repro.checkpointing import checkpoint as jckpt
from repro.core import policies as jpol
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro_torch import configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol

REPO = Path(__file__).resolve().parents[1]
TWINS = ("torch_quickstart", "torch_edit_image", "torch_freq_analysis",
         "torch_serve_batch", "torch_lm_backbones")
STEPS = 10


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twins():
    return {name: _load(name) for name in TWINS}


@pytest.fixture(scope="module")
def dit_small():
    """dit-small's reference init, AdaLN-zero leaves perturbed so every
    block acts, in both packages."""
    cj = jconfigs.get_config("dit-small")
    pj = jcommon.init_params(jdit.dit_specs(cj), jax.random.key(11))
    rng = np.random.default_rng(11)
    pj = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype), pj)
    ct = tconfigs.get_config("dit-small")
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    return cj, pj, ct, pt


def _reference_sample(cj, pj, x0: np.ndarray, ts, policy):
    """The reference scripts' sampling of ``x0`` over ``ts``."""
    side = x0.shape[1]

    def full_fn(x, t):
        out = jdit.dit_forward(pj, x, jnp.full((x.shape[0],), t), cj)
        return out.velocity, out.crf

    def from_crf_fn(crf, t):
        return jdit.dit_from_crf(pj, crf, jnp.full((crf.shape[0],), t), cj,
                                 side, side)
    crf_shape = (x0.shape[0], (side // cj.patch_size) ** 2, cj.d_model)
    full = jsampler.sample(full_fn, from_crf_fn, jnp.asarray(x0), ts,
                           jpol.NoCachePolicy(), crf_shape=crf_shape)
    fast = jsampler.sample(full_fn, from_crf_fn, jnp.asarray(x0), ts, policy,
                           crf_shape=crf_shape)
    return full, fast


def _same_run(got: dict, full, fast):
    assert got["full_steps"] == int(full.n_full) == STEPS
    assert got["freqca_steps"] == int(fast.n_full) < STEPS
    for key, want in (("x_full", full.x), ("x_freqca", fast.x)):
        want = np.asarray(want)
        np.testing.assert_allclose(got[key].numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


def test_quickstart_sampling_matches_reference(twins, dit_small):
    cj, pj, ct, pt = dit_small
    got = twins["torch_quickstart"].sample(pt, ct, n_steps=STEPS,
                                           n_images=2, device="cpu")
    full, fast = _reference_sample(
        cj, pj, got["x0"].numpy(), jschedule.timesteps(STEPS),
        jpol.FreqCaPolicy(interval=5, method="dct", rho=0.0625))
    _same_run(got, full, fast)


def test_edit_sampling_matches_reference(twins, dit_small):
    cj, pj, ct, pt = dit_small
    mod = twins["torch_edit_image"]
    got = mod.edit(pt, ct, n_steps=STEPS, device="cpu")
    full, fast = _reference_sample(
        cj, pj, got["x0"].numpy(), jschedule.timesteps(STEPS) * mod.TAU,
        jpol.FreqCaPolicy(interval=5, method="fft"))
    _same_run(got, full, fast)


@pytest.mark.parametrize("method,rho", [("dct", 0.0625), ("dct", 0.25),
                                        ("fft", 0.0625), ("fft", 0.25)])
def test_fig2_statistics_match_reference(twins, method, rho):
    """The twin's three Fig-2 functions on one seeded CRF series against
    the benchmark's own, which run ``repro.core.frequency.decompose`` and
    ``cosine_similarity``."""
    mod = twins["torch_freq_analysis"]
    crfs = np.random.default_rng(12).standard_normal(
        (12, 2, 64, 16)).astype(np.float32)
    crfs = np.cumsum(crfs, axis=0)          # a trajectory, not white noise
    low, high = mod.band_series(torch.from_numpy(crfs), rho, method)
    jlow, jhigh = jfig2.band_series(jnp.asarray(crfs), rho, method)
    for got, want in ((low, jlow), (high, jhigh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
        sims = mod.similarity_at_intervals(got, mod.INTERVALS)
        jsims = jfig2.similarity_at_intervals(jnp.asarray(want),
                                              list(mod.INTERVALS))
        assert sims.keys() == jsims.keys()
        for k in sims:
            assert abs(sims[k] - jsims[k]) <= 1e-5, (k, sims, jsims)
        assert abs(mod.continuity(got)
                   - jfig2.continuity(jnp.asarray(want))) <= 1e-5


def test_quickstart_run(twins):
    res = twins["torch_quickstart"].run(train_steps=2, batch=2,
                                        n_steps=STEPS, n_images=2,
                                        device="cpu")
    assert res["policies"] == tpol.available()
    assert (res["full_steps"], res["freqca_steps"]) == (STEPS, 4)
    assert res["saving"] == STEPS / 4
    assert 0 < res["rel_err"] < 1
    assert res["x_freqca"].shape == (2, 32, 32, 4)
    assert bool(torch.isfinite(res["x_freqca"]).all())


def test_edit_run(twins):
    res = twins["torch_edit_image"].run(train_steps=2, batch=2,
                                        n_steps=STEPS, device="cpu")
    assert (res["full_steps"], res["freqca_steps"]) == (STEPS, 4)
    assert 0 < res["rel_err"] < 1
    assert bool(torch.isfinite(res["x_freqca"]).all())


def test_freq_analysis_run(twins, tmp_path):
    mod = twins["torch_freq_analysis"]
    out = tmp_path / "fig2.json"
    res = mod.run(out=str(out), train_steps=2, n_steps=STEPS,
                  ckpt_dir=str(tmp_path / "no_ckpt"), device="cpu")
    assert res["crfs"].shape == (STEPS, 2, 256, 128)
    assert len(res["rows"]) == len(mod.BANDS) * (len(mod.INTERVALS) + 1)
    assert out.read_text().count('"method"') == len(res["rows"])
    assert set(res["claims"]) == set(mod.BANDS)
    assert all(math.isfinite(r["cos_sim_low"]) and
               math.isfinite(r["cos_sim_high"]) for r in res["rows"])


def test_freq_analysis_restores_reference_checkpoint(twins, dit_small,
                                                     tmp_path):
    """A ``dit`` step that ``repro`` saved in the bench checkpoint
    directory is what the twin runs on."""
    _, pj, ct, pt = dit_small
    jckpt.save(str(tmp_path), 7, pj, name="dit")
    cfg, params = twins["torch_freq_analysis"].get_model(
        ckpt_dir=str(tmp_path), device="cpu")
    assert cfg is ct
    got = bridge.params_to_jax_numpy(params, ct)
    want = bridge.params_to_jax_numpy(pt, ct)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(g, w)


def _reference_serve_argv():
    """The list ``examples/serve_batch.py`` assigns to ``sys.argv``, past
    the program name."""
    tree = ast.parse((REPO / "examples" / "serve_batch.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "sys.argv"):
            return [ast.literal_eval(e) for e in node.value.elts[1:]]
    raise AssertionError("no sys.argv assignment in serve_batch.py")


def test_serve_arguments_are_the_reference_scripts(twins):
    assert twins["torch_serve_batch"].arguments() == _reference_serve_argv()


def test_serve_run(twins):
    res = twins["torch_serve_batch"].run(
        "cpu", requests=4, steps=4, train_steps=2, batch=2, rate=50.0,
        clients=2)
    outs = res["freqca"]["outs"]
    assert [o.request_id for o in outs] == list(range(4))
    # freqca, fora, freqca_a cycling: the freqca lanes take the warm-up
    # steps 0-2 of its Hermite history
    assert [o.n_full_steps for o in outs[::3]] == [3, 3]
    assert all(o.n_full_steps == 4 for o in res["full"]["outs"])
    assert all(bool(torch.isfinite(torch.as_tensor(o.latents)).all())
               for o in outs)


def test_lm_backbones_run(twins):
    out = twins["torch_lm_backbones"].run(steps=1, device="cpu")
    assert list(out) == tconfigs.ASSIGNED
    for arch, res in out.items():
        cfg = tconfigs.reduced(tconfigs.get_config(arch))
        assert res["family"] == cfg.family
        assert len(res["losses"]) == 1 and math.isfinite(res["losses"][0])
        if cfg.is_encdec or cfg.n_prefix_tokens:
            assert res["tokens"] is None
        else:
            assert len(res["tokens"]) == 4 + 6
            assert res["tokens"][:4] == res["prompt"][0].tolist()
            assert all(0 <= t < cfg.vocab_size for t in res["tokens"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_only_the_port(name):
    path = REPO / "examples" / f"{name}.py"
    bad = [m for m in _imports(path) if m.split(".")[0] in
           ("jax", "jaxlib", "repro", "benchmarks", "chip_smoke")]
    assert bad == []


_BLOCKED = """
import importlib.abc, importlib.util, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks",
                                  "chip_smoke"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(
        name, "examples/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len(sys.argv) - 1)
"""


def test_twins_import_with_jax_repro_and_benchmarks_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, *TWINS], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(TWINS)}" in out.stdout


def test_twins_read_no_environment_at_import():
    from repro_torch.analysis.core import analyze_paths
    paths = [REPO / "examples" / f"{name}.py" for name in TWINS]
    assert analyze_paths(paths, root=REPO) == []


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_cuda(twins, name, monkeypatch):
    """No ``--device``: the card, and no falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twins[name].main([])


def test_list_archs_is_the_references():
    assert tconfigs.list_archs() == jconfigs.list_archs()

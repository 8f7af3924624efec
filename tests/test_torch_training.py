"""Port parity: DiT training (``repro_torch.diffusion.training``,
``optim.adamw``, ``data.synthetic``, ``launch.train`` and the checkpoint
both ways) against ``repro`` on the CPU, float32, at ``reduced(
dit-small)`` and ``reduced(flux1-dev)``.

The two packages' random streams differ, so each test rebuilds the
reference's draws (times, noise, shape parameters, token steps) from
its key and hands them to the port.  Tolerances: the loss 1e-6
relative; every gradient leaf 1e-5 relative L2 (two stacks of matmuls
and their transposes summed in different orders); one AdamW step 1e-6
relative to each leaf's largest magnitude (the same float32 arithmetic,
one rounding apart where XLA contracts a multiply-add), bf16 moments
within one bf16 rounding of it (2^-8 relative); the rendered shapes
1e-5 (the pixel grids differ by one float32 rounding, 1.2e-7: XLA's
``linspace`` rounds as it fuses, jitted or not, and the steepest edge,
a sigmoid of slope 16 over a radius of 0.2, amplifies that ~20x); the
token streams exactly; the trained checkpoint's forward 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpointing import checkpoint as jckpt
from repro.data import synthetic as jdata
from repro.diffusion import training as jtraining
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.optim import adamw as jadamw
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.data import synthetic as tdata
from repro_torch.diffusion import training as ttraining
from repro_torch.launch import train as ttrain
from repro_torch.models import dit as tdit
from repro_torch.optim import adamw as tadamw

SIDE = 8
ARCHS = ["dit-small", "flux1-dev"]


def _configs(arch):
    cj = jconfigs.reduced(jconfigs.get_config(arch))
    ct = tconfigs.reduced(tconfigs.get_config(arch))
    for field in dataclasses.fields(ct):
        assert getattr(ct, field.name) == getattr(cj, field.name)
    return cj, ct


def _jax_params(cfg, seed=0):
    """repro's init with every leaf perturbed, so that every block
    contributes and every gradient is non-zero (the AdaLN-zero init
    makes each block an identity and the velocity zero)."""
    params = jcommon.init_params(jdit.dit_specs(cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)


def _flat(tree):
    """``{path: numpy}`` of a reference-layout tree (JAX or torch)."""
    return {k: np.asarray(v) for k, v in tckpt._flatten_with_paths(
        jax.tree.map(np.asarray, tree)).items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _latents(cfg, seed=1, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, SIDE, SIDE, cfg.in_channels)).astype(
        np.float32)


def _reference_draws(rng, x):
    """The t and noise ``repro``'s rf_loss draws from ``rng``."""
    k_t, k_n = jax.random.split(rng)
    t = jax.nn.sigmoid(jax.random.normal(k_t, (x.shape[0],)))
    noise = jax.random.normal(k_n, x.shape, x.dtype)
    return np.asarray(t), np.asarray(noise)


def _apply_fns(cj, ct, text):
    def japply(p, x_t, t):
        return jdit.dit_forward(p, x_t, t, cj, None if text is None
                                else jnp.asarray(text)).velocity

    def tapply(p, x_t, t):
        return tdit.dit_forward(p, x_t, t, ct, None if text is None
                                else torch.from_numpy(text)).velocity
    return japply, tapply


@pytest.mark.parametrize("arch,with_text", [("dit-small", False),
                                            ("flux1-dev", False),
                                            ("flux1-dev", True)])
def test_rf_loss_and_gradients_match_reference(arch, with_text):
    """The loss value (1e-6) and every gradient leaf (1e-5 rel L2), read
    per leaf by its path after ``params_to_jax_numpy``, never by leaf
    order.  Without text, flux1-dev's double blocks and ``text_proj``
    are unused: the reference's gradient there is exactly zero, the
    port's is None (counted as zero)."""
    cj, ct = _configs(arch)
    pj = _jax_params(cj)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    for p in tadamw.leaves(pt):
        p.requires_grad_(True)
    x = _latents(cj)
    text = (np.random.default_rng(2).standard_normal(
        (2, cj.n_text_tokens, cj.text_dim)).astype(np.float32)
        if with_text else None)
    japply, tapply = _apply_fns(cj, ct, text)
    rng = jax.random.key(3)
    (want, _), gj = jax.value_and_grad(
        lambda p: jtraining.rf_loss(japply, p, {"latents": jnp.asarray(x)},
                                    rng), has_aux=True)(pj)
    t, noise = (np.array(a) for a in _reference_draws(rng, x))
    got, aux = ttraining.rf_loss(tapply, pt, {"latents": torch.from_numpy(x)},
                                 t=torch.from_numpy(t),
                                 noise=torch.from_numpy(noise))
    assert aux["loss"] is got and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    gt = tadamw.tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, pt)
    flat_j, flat_t = _flat(gj), _flat(bridge.params_to_jax_numpy(gt, ct))
    assert flat_j.keys() == flat_t.keys()
    unused = [k for k in flat_j if not np.any(flat_j[k])]
    assert unused == ([] if with_text or arch == "dit-small" else
                      [k for k in flat_j if k.startswith(("double/",
                                                          "text_proj/"))])
    for k in flat_j:
        if k in unused:
            assert not np.any(flat_t[k]), k
        else:
            assert _rel_l2(flat_t[k], flat_j[k]) <= 1e-5, k


def test_rf_loss_draws_logit_normal_times_and_noise():
    """Without t and noise the port draws them from the generator: t in
    (0, 1) as sigmoid(N(0, 1)), noise in the latents' type, the same
    draws for the same seed."""
    x = torch.zeros((3, SIDE, SIDE, 4), dtype=torch.bfloat16)
    seen = []

    def apply_fn(p, x_t, t):
        seen.append((x_t, t))
        return torch.zeros_like(x_t)
    losses = [ttraining.rf_loss(apply_fn, None, {"latents": x},
                                torch.Generator().manual_seed(5))[0]
              for _ in range(2)]
    (xa, ta), (xb, tb) = seen
    assert torch.equal(xa, xb) and torch.equal(ta, tb)
    assert xa.dtype == torch.bfloat16 and ta.shape == (3,)
    assert bool(((ta > 0) & (ta < 1)).all())
    assert torch.equal(losses[0], losses[1]) and losses[0] > 0


def _adamw_inputs(rng, clip, moment_dtype):
    shapes = {"w": (6, 5), "b": (5,), "stack": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    scale = 100.0 if clip else 1e-2     # global norm above / below 1.0
    grads = {k: (scale * rng.standard_normal(s) / np.sqrt(50)).astype(
        np.float32) for k, s in shapes.items()}
    mu = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (0.01 * rng.random(s)).astype(np.float32)
          for k, s in shapes.items()}
    if moment_dtype == "bfloat16":      # representable in both
        mu, nu = ({k: np.asarray(jnp.asarray(v, jnp.bfloat16)
                                 .astype(jnp.float32)) for k, v in m.items()}
                  for m in (mu, nu))
    return params, grads, mu, nu


def _torch_tree(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [10, 40])        # warmup, cosine
@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_reference(clip, step, moment_dtype):
    """One update from a non-zero state: parameters and moments."""
    cfg_kw = dict(lr=1e-2, warmup_steps=20, total_steps=60,
                  weight_decay=0.05, moment_dtype=moment_dtype)
    cj, ct = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    params, grads, mu, nu = _adamw_inputs(np.random.default_rng(step), clip,
                                          moment_dtype)
    jdt = jnp.dtype(moment_dtype)
    sj = jadamw.OptState(mu=jax.tree.map(lambda a: jnp.asarray(a, jdt), mu),
                         nu=jax.tree.map(lambda a: jnp.asarray(a, jdt), nu),
                         step=jnp.asarray(step, jnp.int32))
    pj, sj, mj = jadamw.update(cj, jax.tree.map(jnp.asarray, grads), sj,
                               jax.tree.map(jnp.asarray, params))
    tdt = getattr(torch, moment_dtype)
    st = tadamw.OptState(mu=_torch_tree(mu, tdt), nu=_torch_tree(nu, tdt),
                         step=step)
    pt, st, mt = tadamw.update(ct, _torch_tree(grads), st,
                               _torch_tree(params))
    assert st.step == step + 1
    gnorm = float(mj["grad_norm"])
    assert (gnorm > ct.clip_norm) == clip
    assert abs(float(mt["grad_norm"]) - gnorm) <= 1e-6 * gnorm
    assert abs(float(mt["lr"]) - float(mj["lr"])) <= 1e-7 * float(mj["lr"])
    moment_tol = 1e-6 if moment_dtype == "float32" else 2.0 ** -8
    for name, got, want, tol in (("params", pt, pj, 1e-6),
                                 ("mu", st.mu, sj.mu, moment_tol),
                                 ("nu", st.nu, sj.nu, moment_tol)):
        for k in want:
            w = np.asarray(jnp.asarray(want[k], jnp.float32))
            g = got[k].float().numpy()
            assert got[k].dtype == (torch.float32 if name == "params"
                                    else tdt)
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), (name, k)


def test_adamw_missing_gradient_counts_as_zero():
    """A leaf with no gradient (``None``: unused by the forward) moves as
    the reference's leaf with a zero gradient: the moments decay and the
    weight decay still shrinks it."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    params, grads, mu, nu = _adamw_inputs(np.random.default_rng(7), False,
                                          "float32")
    grads_j = dict(grads, b=np.zeros_like(grads["b"]))
    sj = jadamw.OptState(mu=jax.tree.map(jnp.asarray, mu),
                         nu=jax.tree.map(jnp.asarray, nu),
                         step=jnp.asarray(4, jnp.int32))
    pj, sj, _ = jadamw.update(jadamw.AdamWConfig(**cfg_kw),
                              jax.tree.map(jnp.asarray, grads_j), sj,
                              jax.tree.map(jnp.asarray, params))
    grads_t = dict(_torch_tree(grads), b=None)
    st = tadamw.OptState(mu=_torch_tree(mu), nu=_torch_tree(nu), step=4)
    pt, st, _ = tadamw.update(tadamw.AdamWConfig(**cfg_kw), grads_t, st,
                              _torch_tree(params))
    assert not np.allclose(pt["b"].numpy(), params["b"])
    for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
        for k in want:
            w = np.asarray(want[k])
            assert np.abs(got[k].numpy() - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("step", [0, 1, 7, 20, 21, 45, 60, 90])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=2e-3, warmup_steps=20, total_steps=60, min_lr_ratio=0.1)
    want = float(jadamw.lr_schedule(jadamw.AdamWConfig(**kw),
                                    jnp.asarray(step, jnp.int32)))
    got = tadamw.lr_schedule(tadamw.AdamWConfig(**kw), step)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= 1e-7 * max(want, 1e-12)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(8)
    tree = {"a": rng.standard_normal((7, 3)).astype(np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32)] * 2}
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = tadamw.global_norm({"a": torch.from_numpy(tree["a"]),
                              "b": [torch.from_numpy(x) for x in tree["b"]]})
    assert abs(float(got) - want) <= 1e-6 * want


@pytest.mark.parametrize("seed,batch,size,channels", [
    (0, 2, 32, 4), (1, 5, 16, 16), (2, 3, 24, 1)])
def test_render_shapes_matches_reference_draws(seed, batch, size, channels):
    """The port's render of the reference's own draws equals the
    reference's ``shapes_batch`` (every kind occurs across the cases)."""
    rng = jax.random.key(seed)
    want = np.asarray(jdata.shapes_batch(rng, batch, size, channels))
    keys = jax.random.split(rng, 6)
    u = lambda i, lo, hi: jax.random.uniform(keys[i], (batch, 1, 1),
                                             minval=lo, maxval=hi)
    draws = {"cx": u(0, -0.5, 0.5), "cy": u(1, -0.5, 0.5),
             "rx": u(2, 0.2, 0.6), "ry": u(3, 0.2, 0.6),
             "kind": jax.random.randint(keys[4], (batch, 1, 1), 0, 3),
             "phase": u(5, 0, np.pi)}
    got = tdata.render_shapes(
        **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
        size=size, channels=channels)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_shapes_batch_draws_from_the_generator():
    a, b = (tdata.shapes_batch(torch.Generator().manual_seed(3), 4, 16, 4)
            for _ in range(2))
    assert a.shape == (4, 16, 16, 4) and torch.equal(a, b)
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    it = tdata.data_iterator("shapes", 2, seed=1, size=8, channels=3)
    first, second = next(it), next(it)
    assert first["latents"].shape == (2, 8, 8, 3)
    assert not torch.equal(first["latents"], second["latents"])


@pytest.mark.parametrize("seed,vocab", [(0, 512), (1, 64000), (2, 7)])
def test_lm_batch_recurrence_matches_reference(seed, vocab):
    """Given the reference's start and steps, the port's stream and
    labels equal the reference's exactly."""
    rng = jax.random.key(seed)
    want = jdata.lm_batch(rng, 3, 40, vocab)
    k1, k2 = jax.random.split(rng)
    start = jax.random.randint(k1, (3, 1), 0, vocab)
    steps = jax.random.randint(k2, (3, 40), 1, 7)
    got = tdata.markov_tokens(torch.from_numpy(np.array(start)),
                              torch.from_numpy(np.array(steps)), vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    drawn = tdata.lm_batch(torch.Generator().manual_seed(seed), 3, 40, vocab)
    assert drawn["tokens"].shape == (3, 40)
    assert int(drawn["tokens"].max()) < vocab
    assert int(drawn["labels"][0, -1]) == -1


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_jax_numpy_inverts_params_from_jax_numpy(arch):
    cj, ct = _configs(arch)
    tree = jax.tree.map(np.asarray, _jax_params(cj))
    pt = bridge.params_from_jax_numpy(tree, ct, device="cpu")
    back = _flat(bridge.params_to_jax_numpy(pt, ct))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape
        np.testing.assert_array_equal(back[k], want[k])
    again = bridge.params_from_jax_numpy(bridge.params_to_jax_numpy(pt, ct),
                                         ct, device="cpu")
    for a, b in zip(tadamw.leaves(again), tadamw.leaves(pt), strict=True):
        assert torch.equal(a, b)


def _forward_pair(cj, ct, pj, pt, with_text):
    x = _latents(cj, seed=9)
    t = np.array([0.8, 0.3], np.float32)
    text = (np.random.default_rng(10).standard_normal(
        (2, cj.n_text_tokens, cj.text_dim)).astype(np.float32)
        if with_text and cj.text_dim else None)
    want = jdit.dit_forward(pj, jnp.asarray(x), jnp.asarray(t), cj,
                            None if text is None else jnp.asarray(text))
    got = tdit.dit_forward(pt, torch.from_numpy(x), torch.from_numpy(t), ct,
                           None if text is None else torch.from_numpy(text))
    return got.velocity.numpy(), np.asarray(want.velocity)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_dit_checkpoint_restores_in_reference(arch, tmp_path, capsys):
    """The port's ``train_dit`` (3 steps on the CPU) trains and saves; the
    reference's ``checkpoint.restore`` loads the file into its own tree,
    and the reference's forward on it equals the port's on the trained
    parameters (with text where the config has it, so the double blocks
    and ``text_proj`` are read back too)."""
    cj, ct = _configs(arch)
    steps = []
    pt = ttrain.train_dit(ct, 3, 2, str(tmp_path), log_every=1, size=SIDE,
                          device="cpu",
                          on_step=lambda i, m, g: steps.append(m))
    assert [sorted(m) for m in steps] == [["grad_norm", "loss", "lr"]] * 3
    assert all(np.isfinite(m["loss"]) for m in steps)
    assert "step     2" in capsys.readouterr().out
    assert not any(p.requires_grad for p in tadamw.leaves(pt))
    like = jcommon.init_params(jdit.dit_specs(cj), jax.random.key(0))
    pj = jckpt.restore(str(tmp_path), 3, like, name="dit")
    got, want = _forward_pair(cj, ct, pj, pt, with_text=True)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # trained: the AdaLN-zero leaves moved off zero
    assert np.any(np.asarray(pj["final_proj"]))


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """A checkpoint the reference's ``train_dit`` wrote serves the same
    forward in the port."""
    cj, ct = _configs("flux1-dev")
    pj = jtrain.train_dit(cj, 2, 2, str(tmp_path), size=SIDE)
    pt = bridge.params_from_checkpoint(str(tmp_path), 2, ct, device="cpu")
    got, want = _forward_pair(cj, ct, pj, pt, with_text=True)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())

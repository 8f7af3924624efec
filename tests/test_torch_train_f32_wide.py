"""Training a float32 DiT whose heads are wider than 32, on the CPU:
``launch.train.train_dit`` (the port; its joint attention at latent 64,
S 1024, goes through the op layer's flash entry, which on the card runs
kernels 3 and 7 in float32 and on the CPU the plain version) against
``jax.value_and_grad`` of the reference's loss on the same draws.

dit-small's architecture at d_model 512 and 576 in its 8 heads (head
widths 64 and 72, the wide instances' own width and one run on the
instance 128), cut to 2 and 1 layers, batch 2.  The port's step draws
its shapes batch, times and noise from one generator; the test draws
them again from the same seed and hands them to the reference's
arithmetic (``schedule.add_noise``, ``velocity_target``,
``dit_forward``, the mean squared error of ``rf_loss``).  Parameters:
the reference's init with every leaf perturbed (so that every block
contributes: AdaLN-zero makes each an identity), bridged to the port.

Tolerances, float32 on both sides, summed in different orders over 1024
tokens: the loss 5e-6 relative, every gradient leaf 2e-5 relative L2
(read: the loss 2.3e-7 and 4.4e-7, the worst leaf 2.5e-6 and 2.8e-6;
the training slice's own limits, 1e-6 and 1e-5, are for 16 tokens); a
leaf the forward
does not use (no text: ``text_proj``, where the config has one) zero on
both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.diffusion import schedule as jschedule
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw

SIZE = 64     # latent side: S = (64 / 2)² = 1024, the flash threshold
BATCH = 2
SEED = 3
TOL = {"loss": 5e-6, "grad": 2e-5}
# the references' compile options: level 0 cuts XLA's CPU compile ~3x
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _configs(d_model, n_layers):
    kw = dict(d_model=d_model, d_ff=4 * d_model, n_layers=n_layers)
    cj = dataclasses.replace(jconfigs.get_config("dit-small"), **kw)
    ct = dataclasses.replace(tconfigs.get_config("dit-small"), **kw)
    assert ct.dtype == "float32" and ct.head_dim == cj.head_dim > 32
    return cj, ct


def _flat(tree):
    return {k: np.asarray(v) for k, v in tckpt._flatten_with_paths(
        jax.tree.map(np.asarray, tree)).items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("d_model,n_layers", [(512, 2), (576, 1)])
def test_train_dit_step_matches_reference(monkeypatch, d_model, n_layers):
    """One ``train_dit`` step: its loss and every gradient leaf (read by
    path after ``params_to_jax_numpy``) against the reference's, each
    layer's attention through ``ops.flash`` at [2, 1024, 8, hd]."""
    cj, ct = _configs(d_model, n_layers)
    params = jcommon.init_params(jdit.dit_specs(cj), jax.random.key(0))
    rng = np.random.default_rng(0)
    pj = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    flash_calls = []
    real_flash = ops.flash

    def flash(q, *args, **kw):
        flash_calls.append(tuple(q.shape))
        return real_flash(q, *args, **kw)
    monkeypatch.setattr(ops, "flash", flash)
    seen = {}

    def on_step(i, metrics, grads):
        # the step's gradient of each leaf (None where the forward does
        # not use it: zeros)
        seen["loss"] = metrics["loss"]
        seen["grads"] = tadamw.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None
            else p.grad.detach().clone(), pt)
        assert sum(g is not None for g in tadamw.leaves(grads)) == sum(
            p.grad is not None for p in tadamw.leaves(pt))
    ttrain.train_dit(ct, 1, BATCH, "", seed=SEED, log_every=1, size=SIZE,
                     device="cpu", params=pt, on_step=on_step)
    assert flash_calls == [(BATCH, 1024, ct.n_heads, ct.head_dim)] * n_layers

    # the step's draws, as train_dit makes them
    gen = torch.Generator().manual_seed(SEED * 7919)
    x = tdata.shapes_batch(gen, BATCH, size=SIZE, channels=ct.in_channels,
                           device="cpu")
    t = torch.sigmoid(torch.randn((BATCH,), generator=gen))
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype)

    def loss_fn(p, xj, tj, nj):
        v = jdit.dit_forward(p, jschedule.add_noise(xj, nj, tj), tj,
                             cj).velocity
        target = jschedule.velocity_target(xj, nj)
        return jnp.mean(jnp.square(v.astype(jnp.float32)
                                   - target.astype(jnp.float32)))
    args = (pj, *(jnp.asarray(a.numpy()) for a in (x, t, noise)))
    want, gj = jax.jit(jax.value_and_grad(loss_fn)).lower(*args).compile(
        _FAST)(*args)
    assert abs(seen["loss"] - float(want)) <= TOL["loss"] * abs(float(want))
    flat_j = _flat(gj)
    flat_t = _flat(bridge.params_to_jax_numpy(seen["grads"], ct))
    assert flat_j.keys() == flat_t.keys()
    unused = sorted(k for k in flat_j if not np.any(flat_j[k]))
    assert all(k.startswith("text_proj/") for k in unused)
    for k in flat_j:
        if k in unused:
            assert not np.any(flat_t[k]), k
        else:
            assert _rel_l2(flat_t[k], flat_j[k]) <= TOL["grad"], k

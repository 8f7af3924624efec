"""The port's checkpoint format against ``repro.checkpointing.checkpoint``:
a dit-small checkpoint written by ``repro`` loads into the port's
parameters, leaf for leaf equal to ``bridge.params_from_jax_numpy`` of
the same tree, and the port's engine serves the same latents from it,
bit for bit; the port's own save / restore round-trips float32 and
bfloat16 trees, and ``repro`` restores a file the port wrote.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpointing import checkpoint as jckpt
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro_torch.checkpointing import bridge
from repro_torch.checkpointing import checkpoint as tckpt
from repro_torch.core import policies as tpol
from repro_torch.models import dit as tdit
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest

SIDE = 8


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = jconfigs.reduced(jconfigs.get_config("dit-small"))
    params = jcommon.init_params(jdit.dit_specs(cfg), jax.random.key(4))
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    directory = str(tmp_path_factory.mktemp("ckpt"))
    jckpt.save(directory, 7, params, name="dit")
    return directory, params


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_reference_checkpoint_loads_into_port_params(saved):
    directory, params = saved
    ct = tconfigs.reduced(tconfigs.get_config("dit-small"))
    assert tckpt.latest_step(directory, "dit") == 7
    assert tckpt.latest_step(directory + "/missing", "dit") == -1
    got = bridge.params_from_checkpoint(directory, 7, ct, device="cpu")
    want = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, params),
                                        ct, device="cpu")
    assert len(_leaves(got)) == len(_leaves(want))
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_engine_serves_the_same_latents_from_a_checkpoint(saved):
    directory, params = saved
    ct = tconfigs.reduced(tconfigs.get_config("dit-small"))
    outs = []
    for pt in (bridge.params_from_checkpoint(directory, 7, ct, device="cpu"),
               bridge.params_from_jax_numpy(jax.tree.map(np.asarray, params),
                                            ct, device="cpu")):
        def full_fn(x, t, pt=pt):
            out = tdit.dit_forward(pt, x, t.expand(x.shape[0]), ct)
            return out.velocity, out.crf

        def from_crf_fn(c, t, pt=pt):
            return tdit.dit_from_crf(pt, c, t.expand(c.shape[0]), ct, SIDE,
                                     SIDE)
        eng = DiffusionEngine(full_fn, from_crf_fn, (SIDE, SIDE, 4),
                              ((SIDE // 2) ** 2, ct.d_model),
                              tpol.FreqCaPolicy(interval=3), n_steps=6,
                              max_batch=2, device="cpu")
        outs.append(eng.run_batch([DiffusionRequest(request_id=i, seed=i)
                                   for i in range(2)]))
    for a, b in zip(*outs, strict=True):
        assert torch.isfinite(a.latents).all()
        assert torch.equal(a.latents, b.latents)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_save_restore_round_trip(tmp_path, dtype):
    tree = {"w": torch.randn(3, 4).to(dtype),
            "blocks": [{"b": torch.arange(5, dtype=torch.int32)},
                       {"b": torch.ones(5, dtype=torch.int32)}],
            "pair": (torch.zeros(2).to(dtype), torch.full((1,), 2.5))}
    tckpt.save(str(tmp_path), 3, tree)
    tckpt.save(str(tmp_path), 12, tree)
    assert tckpt.latest_step(str(tmp_path)) == 12
    back = tckpt.restore(str(tmp_path), 3, tree)
    assert back["w"].dtype == dtype and torch.equal(back["w"], tree["w"])
    assert torch.equal(back["blocks"][1]["b"], tree["blocks"][1]["b"])
    assert isinstance(back["pair"], tuple)
    assert torch.equal(back["pair"][1], tree["pair"][1])
    flat = tckpt.load_flat(str(tmp_path), 3)
    assert sorted(flat) == ["blocks/0/b", "blocks/1/b", "pair/0", "pair/1",
                            "w"]
    assert tckpt.unflatten(flat)["blocks"][0]["b"].tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), 3, dict(tree, w=torch.zeros(4, 3)))


def test_reference_bfloat16_leaves_load_as_bfloat16(tmp_path):
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    jckpt.save(str(tmp_path), 0, {"x": x, "y": jnp.ones(2)})
    flat = tckpt.load_flat(str(tmp_path), 0)
    assert flat["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(flat["x"].float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    assert flat["y"].dtype == torch.float32


def test_reference_restores_a_port_file(tmp_path):
    tree = {"a": {"k": torch.randn(2, 3)}, "b": torch.arange(4.0)}
    tckpt.save(str(tmp_path), 1, tree, name="dit")
    like = {"a": {"k": jnp.zeros((2, 3))}, "b": jnp.zeros(4)}
    back = jckpt.restore(str(tmp_path), 1, like, name="dit")
    np.testing.assert_array_equal(np.asarray(back["a"]["k"]),
                                  tree["a"]["k"].numpy())
    np.testing.assert_array_equal(np.asarray(back["b"]), tree["b"].numpy())

"""Port parity: the LM full-sequence path (configs, RMSNorm, RoPE,
embeddings, attention, SwiGLU, the mamba2 block, the layer stack and
``transformer.forward``) against ``repro`` on the CPU, at ``reduced()``
sizes of yi-9b (dense GQA, q_per_kv 2) and mamba2-370m (SSD), with
parameters carried across by ``bridge.lm_params_from_jax_numpy``.

Tolerance: float32, 1e-5 relative to each output's largest magnitude
(the two sum in different orders; the port's SSD scan on the CPU is the
kernel's arithmetic with its −60 clip, the reference's the unclipped
``ssd_chunked``, which these inputs never push past the clip).  One
exception, the two-layer yi-9b stack and forward: 1e-4.  The reference's
init gives the stacked attention projections std 1/sqrt(n_layers) = 0.71,
so the logits reach ±60 and the CRF ~350; a softmax that sharp turns
float32 round-off into a few 1e-5 of the output: the two packages
differ by 1.9e-5 to 6.4e-5 over five parameter seeds, and the
reference's own float32 result lies as far from a float64 run of the
port (3e-5 to 1.6e-4).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
import repro_torch.configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer

ARCHS = ["yi-9b", "mamba2-370m"]


def _configs(arch, **over):
    cj = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                             **over)
    ct = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                             **over)
    return cj, ct


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=rtol * np.abs(want).max())


def _reference_init(specs, seed):
    """repro's init rules (``common._initializer``: zeros, ones, the
    0.02 embedding, an explicit scale, else fan-in — dim 1 of a 3-D leaf,
    dim 0 otherwise) drawn with numpy, every leaf then perturbed so zero
    / one inits (biases, norms, A_log, D) take part in the comparison."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        shape = spec.shape
        if spec.init in ("zeros", "ones"):
            a = np.full(shape, 0.0 if spec.init == "zeros" else 1.0)
        else:
            fan_in = shape[1] if len(shape) == 3 else shape[0]
            std = spec.scale if spec.scale is not None else (
                0.02 if spec.init == "embed" else 1.0 / np.sqrt(fan_in))
            a = rng.standard_normal(shape) * std
        return jnp.asarray((a + 0.05 * rng.standard_normal(shape)).astype(
            np.float32))
    return jax.tree.map(draw, specs,
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@functools.lru_cache(maxsize=None)
def _lm(arch, seed=0):
    """Both packages' parameters of reduced ``arch``, built once per
    file (read-only)."""
    cj, ct = _configs(arch)
    pj = _reference_init(jtransformer.lm_specs(cj), seed)
    pt = bridge.lm_params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                         device="cpu")
    return cj, ct, pj, pt


def _layer(pj, pt, kind):
    """The first layer's mixer params of both trees."""
    return (jax.tree.map(lambda a: a[0], pj["stack"]["l0"][kind]),
            pt["stack"][0]["l0"][kind])


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for pair in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                 _configs(arch)):
        cj, ct = pair
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert (ct.q_per_kv, ct.d_inner, ct.n_ssm_heads) == \
            (cj.q_per_kv, cj.d_inner, cj.n_ssm_heads)
        assert ct.layer_kinds() == cj.layer_kinds()
        assert not any(ct.is_moe_layer(i) for i in range(ct.n_layers))


@pytest.mark.parametrize("field, value, match", [
    ("n_prefix_tokens", 16, "prefix"), ("use_bias", True, "biases")])
def test_unported_config_options_raise(field, value, match):
    """Attention biases (set by no assigned config) raise rather than
    build a model without them.  Modality-prefix tokens raised here until
    the prefix was ported (``test_torch_vlm.py``); they now build their
    projection, ``prefix_proj``."""
    ct = dataclasses.replace(tconfigs.get_config("yi-9b"), **{field: value})
    if field == "n_prefix_tokens":
        assert ttransformer.lm_specs(ct)[f"{match}_proj"]["kernel"].shape \
            == (ct.d_model, ct.d_model)
        return
    with pytest.raises(NotImplementedError, match=match):
        ttransformer.lm_specs(ct)


def test_rmsnorm_rope_embed_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)),
           jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    pos = np.tile(np.arange(10), (2, 1)) + 5
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e4),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tcommon.rmsnorm({"scale": torch.ones(32)}, xb).dtype == \
        torch.bfloat16
    assert tcommon.apply_rope(xb, torch.from_numpy(pos), 1e4).dtype == \
        torch.bfloat16
    table = rng.standard_normal((50, 8)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7))
    e = tcommon.embed({"embedding": torch.from_numpy(table)},
                      torch.from_numpy(tok))
    _close(e, jcommon.embed({"embedding": jnp.asarray(table)},
                            jnp.asarray(tok)))
    _close(tcommon.unembed({"embedding": torch.from_numpy(table)}, e),
           jcommon.unembed({"embedding": jnp.asarray(table)},
                           jnp.asarray(e.numpy())))


@pytest.mark.parametrize("s,causal,window", [
    (64, True, 0), (64, True, 16), (64, False, 0),
    (2048, True, 0), (2048, True, 512), (2048, False, 0)])
def test_self_attention_matches_reference(s, causal, window):
    """Below 2048 tokens both take the full-logits ``_sdpa``; from 2048
    on, ``blockwise_sdpa`` (the port's CPU route; on a card the flash
    kernel)."""
    cj, ct, pj, pt = _lm("yi-9b")
    jp, tp = _layer(pj, pt, "attn")
    x = _x(1, s, ct.d_model, seed=3)
    want = jattn.self_attention(jp, jnp.asarray(x), cj, window=window,
                                causal=causal)
    got = tattn.self_attention(tp, torch.from_numpy(x), ct, window=window,
                               causal=causal)
    _close(got, want)


@pytest.mark.parametrize("q_per_kv,causal,window", [
    (1, False, 0), (2, True, 0), (4, True, 48)])
def test_blockwise_sdpa_matches_reference(q_per_kv, causal, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 128, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, 4 // q_per_kv, 16)).astype(
        np.float32) for _ in "kv")
    kw = dict(causal=causal, window=window, q_block=32, kv_block=32)
    want = jattn.blockwise_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                                q_per_kv, **kw)
    got = tattn.blockwise_sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_per_kv, **kw)
    _close(got, want)
    _close(ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                             q_per_kv, causal, window), want)
    for kw in (dict(window=3), dict(offset=5), dict(window=3, offset=5)):
        np.testing.assert_array_equal(
            tattn.causal_mask(8, **kw).numpy(),
            np.asarray(jattn.causal_mask(8, **kw)))


def test_long_self_attention_takes_the_flash_route(monkeypatch):
    """On a CUDA tensor at 2048 tokens or more ``self_attention`` calls
    the op layer's flash entry with the config's GQA ratio, causal and
    window; below 2048 it never does.  (Routing forced here; the call
    runs the plain version.)"""
    cj, ct, pj, pt = _lm("yi-9b")
    jp, tp = _layer(pj, pt, "attn")
    calls = []

    def spy(q, k, v, q_per_kv=1, causal=False, window=0):
        calls.append((q.shape, k.shape, q_per_kv, causal, window))
        return ref.attention_ref(q, k, v, q_per_kv, causal, window)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flash", spy)
    x = _x(1, 2048, ct.d_model, seed=6)
    got = tattn.self_attention(tp, torch.from_numpy(x), ct, window=256)
    want = jattn.self_attention(jp, jnp.asarray(x), cj, window=256)
    _close(got, want)
    assert calls == [((1, 2048, 4, 32), (1, 2048, 2, 32), 2, True, 256)]
    tattn.self_attention(tp, torch.from_numpy(x[:, :2047]), ct)
    assert len(calls) == 1


def test_mlp_and_ssm_block_match_reference():
    cj, ct, pj, pt = _lm("yi-9b")
    jp = jax.tree.map(lambda a: a[0], pj["stack"]["l0"]["ffn"])
    x = _x(2, 32, ct.d_model, seed=8)
    _close(tmlp.mlp(pt["stack"][0]["l0"]["ffn"], torch.from_numpy(x)),
           jmlp.mlp(jp, jnp.asarray(x)))
    cj, ct, pj, pt = _lm("mamba2-370m")
    jp, tp = _layer(pj, pt, "ssm")
    x = _x(2, 64, ct.d_model, seed=10)       # four chunks of 16
    want = jax.jit(jssm.ssm_block, static_argnums=2)(jp, jnp.asarray(x), cj)
    _close(tssm.ssm_block(tp, torch.from_numpy(x), ct), want)


def test_ssm_pieces_match_reference():
    """``_split_proj``, ``_causal_conv`` (with and without history) and
    the reference's own ``ssd_chunked`` with its final state, against
    the port's plain scan asked for the state."""
    cj, ct, pj, pt = _lm("mamba2-370m")
    jp, tp = _layer(pj, pt, "ssm")
    x = _x(2, 32, ct.d_model, seed=12)
    for g, w in zip(tssm._split_proj(tp, torch.from_numpy(x), ct),
                    jssm._split_proj(jp, jnp.asarray(x), cj), strict=True):
        _close(g, w)
    xbc = _x(2, 32, ct.d_inner + 2 * ct.ssm.d_state, seed=13)
    prefix = _x(2, 3, xbc.shape[-1], seed=14)
    for pre in (None, prefix):
        got = tssm._causal_conv(tp, torch.from_numpy(xbc), ct,
                                None if pre is None else
                                torch.from_numpy(pre))
        want = jssm._causal_conv(jp, jnp.asarray(xbc), cj,
                                 None if pre is None else jnp.asarray(pre))
        for g, w in zip(got, want, strict=True):
            _close(g, w)
    rng = np.random.default_rng(15)
    xs = (rng.standard_normal((2, 64, 4, 16)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 64, 4)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(4) * 0.3).astype(np.float32)
    bm, cm = ((rng.standard_normal((2, 64, 8)) * 0.5).astype(np.float32)
              for _ in "bc")
    ins = (xs, dt, a, bm, cm)
    got = ref.ssd_chunk_scan_ref(*(torch.from_numpy(t) for t in ins), 16,
                                 return_state=True)
    want = jssm.ssd_chunked(*(jnp.asarray(t) for t in ins), 16)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_and_forward_match_reference(arch):
    cj, ct, pj, pt = _lm(arch)
    tokens = np.random.default_rng(17).integers(0, ct.vocab_size, (2, 64))
    want = jtransformer.forward(pj, jnp.asarray(tokens), cj)
    got = ttransformer.forward(pt, torch.from_numpy(tokens), ct)
    rtol = 1e-4 if arch == "yi-9b" else 1e-5     # see the module note
    _close(got.logits, want.logits, rtol)
    _close(got.crf, want.crf, rtol)
    for g, w in zip(got.aux, want.aux, strict=True):
        assert float(g) == float(w) == 0.0
    # the non-causal stack (the backbone denoiser's), on an input at the
    # embedding's scale (std 0.02), as ``forward`` feeds it
    x = 0.02 * _x(2, 64, ct.d_model, seed=18)
    h, _ = tblocks.stack_full(pt["stack"], torch.from_numpy(x), ct,
                              causal=False)
    jh, _ = jblocks.stack_full(pj["stack"], jnp.asarray(x), cj,
                               causal=False)
    _close(h, jh, rtol)
    _close(ttransformer._embedding_matrix(pt, ct),
           jtransformer._embedding_matrix(pj, cj))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follow_reference_rules(arch):
    """Same distributions as repro's init (4 layers, narrowed): the
    stacked 4-D attention leaves draw with std 1/sqrt(n_layers), 3-D
    leaves with 1/sqrt(dim 1), the embedding 0.02, the head 0.02, the
    conv kernel 0.1; zeros and ones where the reference has them."""
    cfg = dataclasses.replace(tconfigs.get_config(arch), n_layers=4,
                              d_model=256, d_ff=512, n_heads=8,
                              n_kv_heads=2, vocab_size=1024)
    pt = tcommon.init_params(ttransformer.lm_specs(cfg), seed=0,
                             device="cpu")
    layer = [g["l0"] for g in pt["stack"]]

    def std(leaves):
        return float(torch.stack(leaves).std())

    def near(got, want):
        assert abs(got - want) < 0.02 * want, (got, want)
    near(std([pt["embed"]["embedding"]]), 0.02)
    if arch == "yi-9b":
        near(std([p["attn"]["wq"] for p in layer]), 1 / np.sqrt(4))
        near(std([p["attn"]["wo"] for p in layer]), 1 / np.sqrt(4))
        near(std([p["ffn"]["wi_gate"] for p in layer]),
             1 / np.sqrt(cfg.d_model))
        near(std([p["ffn"]["wo"] for p in layer]), 1 / np.sqrt(cfg.d_ff))
        near(std([pt["head"]["kernel"]]), 0.02)
    else:
        assert "head" not in pt
        near(std([p["ssm"]["in_proj"] for p in layer]),
             1 / np.sqrt(cfg.d_model))
        near(std([p["ssm"]["out_proj"] for p in layer]),
             1 / np.sqrt(cfg.d_inner))
        near(std([p["ssm"]["conv_kernel"] for p in layer]), 0.1)
        assert all(float(p["ssm"]["A_log"].abs().max()) == 0.0 and
                   bool((p["ssm"]["D"] == 1).all()) for p in layer)
    assert all(bool((p["norm1"]["scale"] == 1).all()) for p in layer)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_stacked_leaves(arch):
    cj, ct, pj, pt = _lm(arch)
    pj = jax.tree.map(np.asarray, pj)
    assert len(pt["stack"]) == ct.n_layers
    for i in range(ct.n_layers):
        block = pj["stack"]["l0"]
        if arch == "yi-9b":
            a = pt["stack"][i]["l0"]["attn"]
            np.testing.assert_array_equal(
                a["wq"].numpy(),
                block["attn"]["wq"][i].reshape(ct.d_model, -1))
            np.testing.assert_array_equal(
                a["wk"].numpy(),
                block["attn"]["wk"][i].reshape(ct.d_model, -1))
            np.testing.assert_array_equal(
                a["wo"].numpy(),
                block["attn"]["wo"][i].reshape(-1, ct.d_model))
        else:
            np.testing.assert_array_equal(
                pt["stack"][i]["l0"]["ssm"]["in_proj"].numpy(),
                block["ssm"]["in_proj"][i])
            np.testing.assert_array_equal(
                pt["stack"][i]["l0"]["ssm"]["A_log"].numpy(),
                block["ssm"]["A_log"][i])
    np.testing.assert_array_equal(pt["embed"]["embedding"].numpy(),
                                  pj["embed"]["embedding"])
    # every leaf at the shape the port's own specs give it
    shapes = tcommon.map_specs(lambda s: s.shape, ttransformer.lm_specs(ct))
    for name, leaves in shapes["stack"][0]["l0"].items():
        got = pt["stack"][0]["l0"][name]
        assert {k: tuple(v.shape) for k, v in got.items()} == leaves

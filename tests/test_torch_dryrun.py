"""The dry run's abstract steps against the reference's
(``repro.launch.steps``): the abstract inputs and decode caches of every
LM config and input shape against the reference's ``ShapeDtypeStruct``s;
at reduced configs on one CPU device, ``build``'s argument bytes against
the reference's ``compiled.memory_analysis().argument_size_in_bytes``
and the step cost counter's FLOPs against the reference's
``hlo_analysis`` of the compiled step (relative 1e-6, after the
differences by design below are added back exactly); the dry-run CLI.

Differences by design, each added back in the comparison:
* the optimizer's step count and a KV cache's position are host ints in
  the port (the reference's are int32 arrays: 4 bytes, and 4 a layer);
* the port's train step runs each cross-entropy chunk's head product
  twice, in the forward and again in the backward
  (``torch.utils.checkpoint``), as the reference's program is written;
  at these sizes its one chunk is a one-iteration scan, and XLA merges
  the forward's product with the recompute (common-subexpression
  elimination) where the head is its own matrix, so for an untied head
  the reference's count has one 2·B·S·d·V product fewer;
* the reference's compile keeps its unused arguments
  (``keep_unused=True``: a decode step's encoder weights), as the port's
  step is handed them;
* where the port routes the SSD scan to kernels 6 and 8 (mamba2,
  jamba), their FLOPs are their own formulas: the dense part is held
  against the reference's total less its ``ssd_chunked`` dots, counted
  on their own, and each kernel's count against a hand count.
"""
import dataclasses
from contextlib import ExitStack
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import ssm as ref_ssm
from repro.roofline import hlo_analysis
from repro_torch import configs
from repro_torch.kernels import ssd_scan
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import blocks, encdec
from repro_torch.roofline import op_analysis

LM_ARCHS = list(configs.ASSIGNED)
SHAPES = list(configs.INPUT_SHAPES)
# the reduced runs' shapes: batch 2 of 256 tokens (the long decode: one
# request on 512 slots)
SMALL = {"train_4k": {"seq_len": 256, "global_batch": 2, "kind": "train"},
         "prefill_32k": {"seq_len": 256, "global_batch": 2,
                         "kind": "prefill"},
         "decode_32k": {"seq_len": 256, "global_batch": 2, "kind": "decode"},
         "long_500k": {"seq_len": 512, "global_batch": 1, "kind": "decode"}}
FLOP_RTOL = 1e-6


def _torch_dtype(jdt):
    return getattr(torch, jnp.dtype(jdt).name)


def _small(mod, cfg):
    """``reduced(cfg)``; an SSM in heads of 64 and chunks of 64, which
    kernels 6 and 8 take (the reduced 32 and 16 they refuse)."""
    c = mod.reduced(cfg)
    if getattr(c, "ssm", None) is not None:
        c = dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, head_dim=64, chunk=64))
    return c


def _patched(stack: ExitStack):
    """Both packages' configs reduced and their input shapes SMALL."""
    for mod in (ref_configs, configs):
        orig = mod.get_config
        stack.enter_context(mock.patch.object(mod, "INPUT_SHAPES", SMALL))
        stack.enter_context(mock.patch.object(
            mod, "get_config", lambda a, m=mod, o=orig: _small(m, o(a))))


_COMPILED = {}


def _reference(arch, shape):
    """(hlo FLOPs, argument bytes) of the reference's reduced step,
    compiled once on one CPU device (an Auto-axes mesh)."""
    if (arch, shape) not in _COMPILED:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        with ExitStack() as stack:
            _patched(stack)
            with mesh:
                spec = ref_steps.build(arch, shape, mesh)
                compiled = jax.jit(
                    spec.fn, in_shardings=spec.in_shardings,
                    out_shardings=spec.out_shardings,
                    donate_argnums=spec.donate_argnums,
                    keep_unused=True).lower(*spec.args).compile()
        _COMPILED[arch, shape] = (
            hlo_analysis.analyze(compiled.as_text())["flops"],
            compiled.memory_analysis().argument_size_in_bytes)
    return _COMPILED[arch, shape]


def _port(arch, shape):
    with ExitStack() as stack:
        _patched(stack)
        spec = steps.build(arch, shape, mesh_lib.one_card_mesh())
        cfg = configs.get_config(arch)
        return spec, cfg, op_analysis.analyze(spec.fn, *spec.args)


def _leaves(tree):
    return list(op_analysis._tensors(tree))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    """Every input's shape and type, the decode cache buffer by buffer
    (the reference's stacked leaves unstacked), at full size; nothing is
    allocated (meta tensors)."""
    cfg = configs.for_shape(configs.get_config(arch), shape)
    ref_cfg = ref_configs.for_shape(ref_configs.get_config(arch), shape)
    mine = steps.input_specs(cfg, shape)
    ref = ref_steps.input_specs(ref_cfg, shape)
    assert set(mine) == set(ref)
    for key in mine:
        if key == "cache":
            continue
        assert tuple(mine[key].shape) == ref[key].shape, key
        assert mine[key].dtype == _torch_dtype(ref[key].dtype), key
        assert mine[key].is_meta
    if "cache" not in mine:
        return
    cache = mine["cache"]
    ref_cache = ref["cache"]
    if cfg.is_encdec:       # the reference's input_specs stacks a KV cache
        groups = [{"l0": c} for c in cache]
    else:
        groups = cache
    for i, group in enumerate(groups):
        for name, c in group.items():
            ref_c = ref_cache[name]
            for field, t in vars(c).items():
                if not isinstance(t, torch.Tensor):
                    continue                 # the position: a host int
                r = getattr(ref_c, field)
                assert (r.shape[0],) + tuple(t.shape) == r.shape
                assert t.dtype == _torch_dtype(r.dtype) and t.is_meta


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m",
                                  "seamless-m4t-medium"])
def test_cache_abstract_and_axes(arch):
    """The abstract caches allocate nothing and mirror the zero caches;
    the axes name the reference's cache axes less "layer"."""
    cfg = configs.get_config(arch)
    if cfg.is_encdec:
        c = encdec.decode_cache_abstract(cfg, 4, 64, torch.bfloat16)
        z = encdec.decode_cache_zeros(cfg, 4, 64, torch.bfloat16, "cpu")
        assert [tuple(x.shape) for x in _leaves(c)] == \
            [tuple(x.shape) for x in _leaves(z)]
        return
    c = blocks.stack_cache_abstract(cfg, 4, 64, torch.bfloat16)
    z = blocks.stack_cache_zeros(cfg, 2, 8, torch.bfloat16, "cpu")
    assert all(t.is_meta for t in _leaves(c))
    assert len(c) == len(z)
    axes = blocks.stack_cache_axes(cfg)
    ref_axes = jax.tree.leaves(
        ref_steps.blocks.stack_cache_axes(ref_configs.get_config(arch)),
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    mine = [a for g in axes[:1] for cc in g.values()
            for a in vars(cc).values() if isinstance(a, tuple)]
    assert sorted(mine, key=str) == sorted(
        (tuple(a for a in r if a != "layer") for r in ref_axes
         if r != ("layer",)), key=str)


# (arch, shape): the reduced steps compiled on the reference's side
ARG_CASES = [("yi-9b", "train_4k"), ("yi-9b", "prefill_32k"),
             ("yi-9b", "decode_32k"), ("mamba2-370m", "decode_32k"),
             ("seamless-m4t-medium", "decode_32k"),
             ("llava-next-34b", "prefill_32k"),
             ("granite-moe-3b-a800m", "train_4k"),
             ("jamba-1.5-large-398b", "long_500k")]


@pytest.mark.parametrize("arch,shape", ARG_CASES)
def test_argument_bytes_match_the_compiled_reference(arch, shape):
    """build's argument bytes (the counter's, each storage once) equal the
    reference's compiled argument size, less its int32 step count (4
    bytes) and int32 KV positions (4 bytes an attention layer), which the
    port keeps on the host."""
    spec, cfg, counted = _port(arch, shape)
    _, ref_bytes = _reference(arch, shape)
    host_ints = 0
    if SMALL[shape]["kind"] == "train":
        host_ints += 4
    if SMALL[shape]["kind"] == "decode":
        kinds = cfg.layer_kinds() if not cfg.is_encdec else \
            ["attn"] * cfg.n_layers
        host_ints += 4 * sum(k == "attn" for k in kinds)
    assert counted["argument_bytes"] + host_ints == ref_bytes
    assert counted["argument_bytes"] == sum(
        t.untyped_storage().nbytes() for t in _leaves(spec.args))


def _head_recompute(cfg, shape) -> int:
    """The port's extra head product of a train step, 2·B·S·d·V, where
    the reference's count lacks it: an untied head (see the module
    docstring)."""
    info = SMALL[shape]
    if info["kind"] != "train" or cfg.tie_embeddings:
        return 0
    text = info["seq_len"] - (cfg.n_prefix_tokens or 0)
    return 2 * info["global_batch"] * text * cfg.d_model * cfg.vocab_size


# reduced prefill and train steps whose kernel routes stay below their
# thresholds (S 256 < 2048: no flash); the dit-small full step below
FLOP_CASES = [(a, s) for a in ("yi-9b", "granite-moe-3b-a800m",
                               "seamless-m4t-medium", "llava-next-34b")
              for s in ("prefill_32k", "train_4k")]


@pytest.mark.parametrize("arch,shape", FLOP_CASES)
def test_flops_match_the_reference(arch, shape):
    spec, cfg, counted = _port(arch, shape)
    ref_flops, _ = _reference(arch, shape)
    assert set(counted["by_kind"]) <= {"dense", "other"}
    got = counted["flops"] - _head_recompute(cfg, shape)
    assert got == pytest.approx(ref_flops, rel=FLOP_RTOL)


def test_dit_full_step_flops_match_the_reference():
    """dit-small's full denoiser forward at the dry run's latent 128 (S
    4096, batch 2), where the port's joint attention is the float32
    hd-16 flash kernel: its work is ``fwd_work``'s 4·hd FLOP a pair and
    head, the same count as the reference's two attention einsums (its
    CPU route), so the totals agree at ``FLOP_RTOL``, and the dense part
    is the reference's less those einsums."""
    from repro.launch import steps as rs
    from repro.roofline import hlo_analysis as ha
    from repro_torch.kernels import flash_attention as fa
    latent = dryrun.DIT_LATENT["dit-small"]
    assert latent == 128
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with mesh:
        ref = rs.build_dit("dit-small", mesh, batch=2, latent=latent)
        compiled = jax.jit(ref.fn, in_shardings=ref.in_shardings,
                           keep_unused=True).lower(*ref.args).compile()
    spec = steps.build_dit("dit-small", mesh_lib.one_card_mesh(), batch=2,
                           latent=latent)
    counted = op_analysis.analyze(spec.fn, *spec.args)
    cfg = configs.get_config("dit-small")
    s = (latent // cfg.patch_size) ** 2
    flash = counted["by_kind"]["flash_attention_f32"]
    work, nbytes = fa.fwd_work(2, s, s, cfg.n_heads, cfg.n_heads,
                               cfg.head_dim, "float32")
    assert set(counted["by_kind"]) == {"dense", "other",
                                       "flash_attention_f32"}
    assert flash["calls"] == cfg.n_layers
    assert flash["flops_by_type"] == {"tf32": cfg.n_layers
                                      * work["tf32"]}
    assert flash["bytes"] == cfg.n_layers * nbytes
    ref_flops = ha.analyze(compiled.as_text())["flops"]
    assert counted["flops"] == pytest.approx(ref_flops, rel=FLOP_RTOL)
    assert counted["by_kind"]["dense"]["flops"] == pytest.approx(
        ref_flops - flash["flops"], rel=FLOP_RTOL)
    assert counted["argument_bytes"] == \
        compiled.memory_analysis().argument_size_in_bytes


def _ssd_dots(cfg, shape) -> float:
    """FLOPs of the reference's ``ssd_chunked`` dots at one layer's shape,
    compiled alone: the forward, and for a train step its vjp too."""
    info = SMALL[shape]
    b, s = info["global_batch"], info["seq_len"]
    h, p, n = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((b, s, h, p), jnp.dtype(cfg.dtype)),
            jax.ShapeDtypeStruct((b, s, h), f32),
            jax.ShapeDtypeStruct((h,), f32),
            jax.ShapeDtypeStruct((b, s, n), jnp.dtype(cfg.dtype)),
            jax.ShapeDtypeStruct((b, s, n), jnp.dtype(cfg.dtype)))

    def fwd(*a):
        return ref_ssm.ssd_chunked(*a, cfg.ssm.chunk)[0]

    def train(*a):
        y, vjp = jax.vjp(fwd, *a)
        return vjp(y)
    fn = train if info["kind"] == "train" else fwd
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze(text)["flops"]


@pytest.mark.parametrize("arch,shape", [("mamba2-370m", "prefill_32k"),
                                        ("mamba2-370m", "train_4k"),
                                        ("jamba-1.5-large-398b",
                                         "prefill_32k")])
def test_ssd_steps_dense_part_and_kernel_counts(arch, shape):
    """With the scan on kernels 6 and 8: the dense part equals the
    reference's total less its ssd_chunked dots (one layer's, counted on
    their own, times the SSM layers), and each kernel's FLOPs are its
    work formula at the layer's shape, once a layer (twice in a train
    step's forward under remat: not at reduced size)."""
    spec, cfg, counted = _port(arch, shape)
    ref_flops, _ = _reference(arch, shape)
    ref_cfg = _small(ref_configs, ref_configs.get_config(arch))
    n_ssm = sum(k == "ssm" for k in cfg.layer_kinds())
    dense = counted["by_kind"]["dense"]["flops"]
    want = ref_flops - n_ssm * _ssd_dots(ref_cfg, shape) \
        + _head_recompute(cfg, shape)
    assert dense == pytest.approx(want, rel=FLOP_RTOL)
    info = SMALL[shape]
    b, s = info["global_batch"], info["seq_len"]
    dims = (b, s, cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk)
    fwd = counted["by_kind"]["ssd_chunk_scan"]
    assert fwd["calls"] == n_ssm
    assert fwd["flops"] == n_ssm * sum(ssd_scan.fwd_work(
        *dims, 2)[0].values())
    if info["kind"] == "train":
        bwd = counted["by_kind"]["ssd_chunk_scan_bwd"]
        assert bwd["calls"] == n_ssm
        assert bwd["flops"] == n_ssm * ssd_scan.scan_bwd_flops(*dims)


def test_dryrun_cli_writes_records(tmp_path):
    """Two combos on the 16 x 16 mesh and one on the card with a
    per-card batch: exit 0, one JSON each with the reference's keys and
    the roofline terms; no collective term on the abstract mesh."""
    import json
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "dit-small", "--shape", "cached_step",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--mesh", "1x1", "--batch", "1",
                        "--out", str(out)]) == 0
    recs = {p.name: json.loads(p.read_text()) for p in out.iterdir()}
    assert sorted(recs) == [
        "dit-small__cached_step__pod16x16.json",
        "mamba2-370m__long_500k__1x1.json",
        "yi-9b__decode_32k__pod16x16.json"]
    for rec in recs.values():
        assert {"arch", "shape", "mesh", "n_devices", "memory", "flops",
                "bytes_accessed", "collectives", "roofline"} <= set(rec)
    big = recs["yi-9b__decode_32k__pod16x16.json"]
    assert big["n_devices"] == 256 and big["collectives"]["total_bytes"] \
        is None and big["roofline"]["collective_s"] is None
    one = recs["mamba2-370m__long_500k__1x1.json"]
    assert one["collectives"]["total_bytes"] == 0.0
    assert one["memory"]["argument_size_bytes"] > 0


def test_dryrun_per_device_arithmetic():
    """On the 16 x 16 mesh the FLOPs are the one-card step's at the global
    batch split 256 ways, and the argument bytes each argument's shard."""
    big = mesh_lib.make_production_mesh()
    spec = steps.build("yi-9b", "long_500k", big)
    counted = op_analysis.analyze(spec.fn, *spec.args)
    rec = dryrun.record_for(spec, counted, "yi-9b", "long_500k", big)
    assert rec["flops"] == counted["flops"] / 256
    shard = dryrun.shard_bytes(spec.args, spec.in_shardings, big)
    assert rec["memory"]["argument_size_bytes"] == shard
    assert shard < counted["argument_bytes"]


def test_dryrun_exit_status_on_a_failed_combo(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "build_spec", boom)
    assert dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                        "--out", ""]) == 1

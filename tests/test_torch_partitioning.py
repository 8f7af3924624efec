"""The port's sharding rules and meshes against the reference's
(``repro.sharding.partitioning``, ``repro.launch.mesh``): for every
config, both production meshes (the reference's side on a
``jax.sharding.AbstractMesh``), both modes and every shape kind, the
rules are equal and the per-device parameter bytes (the sum of the
reference's ``NamedSharding.shard_shape`` over its stacked leaves
against the port's ``shard_shape`` over its per-group ones) are equal
exactly; building them allocates nothing.  Also the meshes, the batch
placements, the one-card identity and the refusal to run a step on a
mesh of more than one device, and one drawn leaf per spec builder
pinned bit for bit (the axes change no draw)."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import common as ref_common
from repro.models import dit as ref_dit
from repro.sharding import partitioning as ref_pt
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import common, dit, encdec, transformer
from repro_torch.sharding import partitioning as pt

LM_ARCHS = [a for a, c in configs.REGISTRY.items()
            if isinstance(c, configs.ModelConfig)]
DIT_ARCHS = [a for a, c in configs.REGISTRY.items()
             if isinstance(c, configs.DiTConfig)]
MESHES = {"pod16x16": (False, (16, 16), ("data", "model")),
          "pod2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}
MODES = [(mode, kind) for mode in ("train", "serve")
         for kind in ("train", "prefill", "decode")]


def _meshes(name):
    multi, sizes, names = MESHES[name]
    return (mesh_lib.make_production_mesh(multi_pod=multi),
            AbstractMesh(sizes, names))


def _ref_bytes(specs, rules, mesh) -> int:
    """Per-device bytes (bf16) of the reference's spec tree."""
    shard = ref_pt.shardings_for_specs(specs, rules, mesh)
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, ref_common.ParamSpec))
    shs = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    return sum(math.prod(sh.shard_shape(s.shape)) * 2
               for s, sh in zip(leaves, shs, strict=True))


def _port_bytes(specs, rules, mesh) -> int:
    placements = []
    common.map_specs(lambda s: placements.append(
        (s, pt.placement(s, rules, mesh))), specs)
    return sum(math.prod(pt.shard_shape(s.shape, p, mesh)) * 2
               for s, p in placements)


def test_meshes_have_the_reference_shapes():
    for multi in (False, True):
        mine = mesh_lib.make_production_mesh(multi_pod=multi)
        sizes = (2, 16, 16) if multi else (16, 16)
        names = ("pod", "data", "model") if multi else ("data", "model")
        assert (mine.axis_sizes, mine.axis_names) == (sizes, names)
        assert dict(AbstractMesh(sizes, names).shape) == mine.shape
    assert mesh_lib.make_test_mesh(8).shape == {"data": 4, "model": 2}
    assert mesh_lib.one_card_mesh().size == 1
    assert mesh_lib.parse_mesh("2x16x16") == \
        mesh_lib.make_production_mesh(multi_pod=True)
    assert mesh_lib.parse_mesh("1x1") == mesh_lib.one_card_mesh()
    with pytest.raises(ValueError):
        mesh_lib.make_test_mesh(3)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_rules_and_per_device_bytes(arch, mesh_name):
    """Rules equal and per-device parameter bytes equal, for both modes
    and every shape kind (the head-width fallback at decode)."""
    mine_mesh, ref_mesh = _meshes(mesh_name)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    specs, ref_specs = steps.model_specs(cfg), ref_steps.model_specs(ref_cfg)
    assert pt.dp_axes(mine_mesh) == ref_pt.dp_axes(ref_mesh)
    assert pt.param_bytes(cfg) == ref_pt.param_bytes(ref_cfg)
    for mode, kind in MODES:
        rules = pt.model_rules(cfg, mine_mesh, mode, shape_kind=kind)
        ref_rules = ref_pt.model_rules(ref_cfg, ref_mesh, mode,
                                       shape_kind=kind)
        assert rules == ref_rules, (mode, kind)
        assert _port_bytes(specs, rules, mine_mesh) == \
            _ref_bytes(ref_specs, ref_rules, ref_mesh), (mode, kind)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DIT_ARCHS)
def test_dit_rules_and_per_device_bytes(arch, mesh_name):
    mine_mesh, ref_mesh = _meshes(mesh_name)
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    rules = pt.dit_rules(cfg, mine_mesh)
    ref_rules = ref_pt.dit_rules(ref_cfg, ref_mesh)
    assert rules == ref_rules
    assert _port_bytes(dit.dit_specs(cfg), rules, mine_mesh) == \
        _ref_bytes(ref_dit.dit_specs(ref_cfg), ref_rules, ref_mesh)


class _Record(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_building_placements_allocates_nothing():
    """Rules, placements and shard shapes of llama3-405b on the 2 x 16 x
    16 mesh dispatch no tensor operation at all."""
    mesh = mesh_lib.make_production_mesh(multi_pod=True)
    cfg = configs.get_config("llama3-405b")
    with _Record() as rec:
        rules = pt.model_rules(cfg, mesh, "train")
        total = _port_bytes(steps.model_specs(cfg), rules, mesh)
    assert rec.ops == [] and total > 0


@pytest.mark.parametrize("gb,ndim", [(256, 2), (32, 3), (1, 2), (24, 4)])
def test_batch_placements_match(gb, ndim):
    for name in MESHES:
        mine_mesh, ref_mesh = _meshes(name)
        ref = ref_pt.batch_spec(ref_mesh, gb, ndim).spec
        mine = pt.batch_spec(mine_mesh, gb, ndim)
        assert tuple(ref) + (None,) * (ndim - len(ref)) == mine


def test_merged_dimensions_keep_each_components_guard():
    """wq [d, H·hd] of a config whose 56 heads do not divide the model
    axis: at decode the head width takes the axis (both dims' product is
    divisible either way, the guard reads the components)."""
    mesh = mesh_lib.make_production_mesh()
    cfg = configs.get_config("deepseek-coder-33b")
    spec = steps.model_specs(cfg)["stack"][0]["l0"]["attn"]["wq"]
    assert spec.components()[1] == (("heads", 56), ("head_dim", 128))
    prefill = pt.model_rules(cfg, mesh, "serve", shape_kind="prefill")
    decode = pt.model_rules(cfg, mesh, "serve", shape_kind="decode")
    assert pt.placement(spec, prefill, mesh)[1] is None
    assert pt.placement(spec, decode, mesh)[1] == "model"
    with pytest.raises(ValueError):
        pt.shard_shape((56,), ("model",), mesh)


def test_one_card_identity_and_larger_meshes_refuse_to_run():
    x = torch.ones(2, 3, 4)
    assert pt.constraint(x, mesh_lib.one_card_mesh()) is x
    big = mesh_lib.make_production_mesh()
    meta = torch.empty(2, 3, 4, device="meta")
    assert pt.constraint(meta, big) is meta
    with pytest.raises(NotImplementedError):
        pt.constraint(x, big)
    assert steps.activation_constrain(None) is None
    assert steps.activation_constrain(mesh_lib.one_card_mesh())(x) is x
    spec = steps.build("mamba2-370m", "long_500k", big)
    real = [torch.zeros(t.shape, dtype=t.dtype) if isinstance(
        t, torch.Tensor) else t for t in spec.args[:2]]
    with pytest.raises(NotImplementedError):
        spec.fn(*real, spec.args[2])


# one drawn leaf per spec builder at reduced size, seed 3: the first
# three entries (float.hex) and the float64 sum, as the port drew them
# before the specs carried axes
PINNED = {
    "dit": ("flux1-dev", ["single", 0, "attn", "wq"],
            ['-0x1.080c1a0000000p+0', '-0x1.4282d80000000p+0',
             '-0x1.8516e20000000p-3', '-0x1.5486e72c04000p+3']),
    "transformer": ("llava-next-34b", ["prefix_proj", "kernel"],
                    ['0x1.1f043c0000000p-6', '-0x1.29a7200000000p-4',
                     '-0x1.9e61c20000000p-6', '0x1.119c108af4000p+3']),
    "blocks+attention": ("yi-9b", ["stack", 1, "l0", "attn", "wo"],
                         ['-0x1.8b17840000000p+0', '-0x1.f6d3a60000000p-2',
                          '-0x1.b001120000000p-3', '0x1.5905402d91000p+5']),
    "mlp": ("yi-9b", ["stack", 0, "l0", "ffn", "wi_up"],
            ['0x1.be070a0000000p-6', '-0x1.9b20ec0000000p-7',
             '-0x1.74a2d00000000p-5', '0x1.bd9c3f493d200p+1']),
    "moe": ("granite-moe-3b-a800m", ["stack", 0, "l0", "ffn", "wi_gate"],
            ['-0x1.8057780000000p-1', '0x1.ffffa40000000p-2',
             '-0x1.253e860000000p-1', '0x1.d02285db59f90p+6']),
    "ssm": ("mamba2-370m", ["stack", 1, "l0", "ssm", "in_proj"],
            ['-0x1.6c33520000000p-4', '-0x1.bc9b840000000p-6',
             '-0x1.4acc460000000p-3', '0x1.ee7d0c7c924d0p+3']),
    "encdec": ("seamless-m4t-medium", ["head", "kernel"],
               ['-0x1.7c37a60000000p-6', '0x1.1788ac0000000p-5',
                '-0x1.49bd1a0000000p-8', '-0x1.f70d8ef23de00p+2']),
}


@pytest.mark.parametrize("builder", sorted(PINNED))
def test_init_params_draws_unchanged(builder):
    """The same bits as before the axes: the first entries exactly, the
    float64 sum to 1e-12."""
    arch, path, want = PINNED[builder]
    cfg = configs.reduced(configs.get_config(arch))
    specs = (dit.dit_specs(cfg) if builder == "dit" else
             encdec.encdec_specs(cfg) if builder == "encdec" else
             transformer.lm_specs(cfg))
    leaf = common.init_params(specs, seed=3, dtype=torch.float32,
                              device="cpu")
    for key in path:
        leaf = leaf[key]
    got = leaf.flatten()[:3].tolist()
    assert [float.hex(v) for v in got] == want[:3]
    assert np.isclose(float(leaf.double().sum()), float.fromhex(want[3]),
                      rtol=1e-12, atol=0)


def test_every_spec_has_the_reference_axes_count():
    """Every leaf's axes flatten to the reference's leaf's axes less its
    "layer" axis, in order, and its components multiply to its shape
    (all twelve configs)."""
    for arch, cfg in configs.REGISTRY.items():
        ref_cfg = ref_configs.get_config(arch)
        if isinstance(cfg, configs.DiTConfig):
            specs, ref_specs = dit.dit_specs(cfg), ref_dit.dit_specs(ref_cfg)
        else:
            specs = steps.model_specs(cfg)
            ref_specs = ref_steps.model_specs(ref_cfg)
        ref_axes = {tuple(a for a in s.axes if a != "layer")
                    for s in jax.tree.leaves(ref_specs, is_leaf=lambda x:
                                             isinstance(x,
                                                        ref_common.ParamSpec))}
        mine = set()
        common.map_specs(lambda s: mine.add(tuple(
            n for comp in s.components() for n, _ in comp)), specs)
        assert mine == ref_axes, arch

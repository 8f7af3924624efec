"""The port stands alone: no module of ``src/repro_torch`` — and not
``chip_smoke.py`` — imports ``jax`` or anything of ``repro``."""
import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_every_port_module_imports_without_a_card():
    """Every module imports here, with no card, nvcc or triton: kernels
    are built and loaded at first launch, never at import."""
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)


@pytest.mark.parametrize("name", [
    "repro_torch.configs.yi_9b", "repro_torch.configs.mamba2_370m",
    "repro_torch.models.attention", "repro_torch.models.mlp",
    "repro_torch.models.ssm", "repro_torch.models.blocks",
    "repro_torch.models.transformer", "repro_torch.kernels.ssd_scan",
    "repro_torch.core.policies.freqca_eb",
    "repro_torch.serving.async_engine", "repro_torch.serving.metrics",
    "repro_torch.checkpointing.checkpoint", "repro_torch.optim.adamw",
    "repro_torch.data.synthetic", "repro_torch.diffusion.training",
    "repro_torch.launch.train", "repro_torch.launch.serve",
    "repro_torch.analysis.runtime", "repro_torch.analysis.graphs",
    "repro_torch.serving.fleet.router", "repro_torch.serving.fleet.worker",
    "repro_torch.serving.fleet.supervisor",
    "repro_torch.serving.fleet.faults",
    "repro_torch.serving.fleet.fleet_metrics", "repro_torch.launch.steps",
    "repro_torch.kernels.ops", "repro_torch.checkpointing.bridge",
    "repro_torch.serving.engine", "repro_torch.models.moe",
    "repro_torch.configs.granite_moe_3b", "repro_torch.configs.phi35_moe_42b",
    "repro_torch.configs.deepseek_coder_33b",
    "repro_torch.configs.llama3_405b",
    "repro_torch.configs.command_r_plus_104b",
    "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
    "repro_torch.sharding.partitioning", "repro_torch.roofline.analysis",
    "repro_torch.roofline.op_analysis", "repro_torch.kernels.meta",
    "repro_torch.analysis.core", "repro_torch.analysis.locks",
    "repro_torch.analysis.recompile", "repro_torch.analysis.__main__"])
def test_assigned_backbone_modules_are_walked(name):
    """The third, seventh, eighth, tenth, eleventh, thirteenth,
    fourteenth and sixteenth slices' modules are among the files walked
    above."""
    walked = {".".join(p.relative_to(REPO / "src").with_suffix("").parts)
              for p in FILES if p.is_relative_to(REPO / "src")}
    assert name in walked
    importlib.import_module(name)


def test_fleet_worker_imports_no_torch():
    """A spawned replica imports the fleet package (for ``worker_main``)
    before it applies its env; torch must come in only with the factory,
    after the env, so the env can still pin threads or the card."""
    import subprocess
    import sys
    code = ("import sys, repro_torch.serving.fleet.worker, "
            "repro_torch.serving.fleet; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'numpy', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert out.stdout.strip() == "[]"


def test_decode_path_imports_without_jax_or_repro():
    """The decode path's names (caches, steps, ``LMEngine``, the cache
    bridge, the input shapes) import in a fresh interpreter that then
    holds no ``jax`` or ``repro`` module."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from repro_torch.configs import INPUT_SHAPES, for_shape\n"
        "from repro_torch.models.attention import KVCache, "
        "decode_self_attention\n"
        "from repro_torch.models.ssm import SSMCache, ssd_recurrent_step, "
        "ssm_decode_step\n"
        "from repro_torch.models.blocks import stack_cache_zeros, "
        "stack_decode\n"
        "from repro_torch.models.transformer import decode_step\n"
        "from repro_torch.launch.steps import make_decode_step\n"
        "from repro_torch.serving.engine import LMEngine\n"
        "from repro_torch.checkpointing.bridge import "
        "lm_cache_from_jax_numpy, lm_cache_to_jax_numpy\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert out.stdout.strip() == "[]"


def test_dry_run_and_linter_import_without_jax_or_repro():
    """The dry run, the counter, the rules and the linter import in a
    fresh interpreter that then holds no ``jax`` or ``repro`` module;
    the linter alone pulls in no torch either."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "import repro_torch.analysis.__main__, repro_torch.analysis.locks\n"
        "heavy = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "from repro_torch.roofline import analysis, op_analysis\n"
        "from repro_torch.sharding import partitioning\n"
        "print(heavy, sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert out.stdout.strip() == "[] []"

"""Device meshes (counterpart of ``repro.launch.mesh``).

A mesh here is abstract: axis names and sizes, with no devices, the
counterpart of ``jax.sharding.AbstractMesh``.  The port runs on one card
(``one_card_mesh``, 1 x 1); the production meshes of the reference
(``make_production_mesh``: 16 x 16 ``("data", "model")``, 2 x 16 x 16
with ``"pod"``) and its test mesh ((n/2) x 2) serve only the per-device
arithmetic of the dry run (``launch.dryrun``): the sharding rules, the
per-device shard shapes and an even split of a step's work.  A step
built for a mesh of more than one device raises ``NotImplementedError``
when it is run on real tensors (``launch.steps``): it never runs
replicated without saying so.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, no devices."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or \
                min(self.axis_sizes, default=1) < 1:
            raise ValueError(f"mesh {self.axis_names} x {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes, strict=True))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """The dry run's mesh tag: ``pod16x16``, ``pod2x16x16``, ``1x1``."""
        dims = "x".join(str(n) for n in self.axis_sizes)
        return dims if self.size == 1 else f"pod{dims}"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(n_devices: int = 8) -> Mesh:
    """The reference's small test mesh, (n/2) x 2 ``("data", "model")``."""
    if n_devices % 2:
        raise ValueError(f"a test mesh needs an even device count, got "
                         f"{n_devices}")
    return Mesh(("data", "model"), (n_devices // 2, 2))


def one_card_mesh() -> Mesh:
    """The 1 x 1 mesh the port runs on."""
    return Mesh(("data", "model"), (1, 1))


def parse_mesh(text: str) -> Mesh:
    """``"1x1"`` / ``"16x16"`` -> ``("data", "model")``; ``"2x16x16"`` ->
    ``("pod", "data", "model")``."""
    sizes = tuple(int(n) for n in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if names is None:
        raise ValueError(f"mesh {text!r}: give DATAxMODEL or PODxDATAxMODEL")
    return Mesh(names, sizes)

"""What a kernel wrapper does with tensors on the ``meta`` device.

The dry run (``launch.dryrun``) runs a whole step on meta tensors, which
hold shapes and types and no data.  The op layer routes a meta tensor as
it routes the card's (``ops._on_cuda``), so every kernel the step would
launch is reached; there each wrapper checks its inputs as for a launch,
then returns empty meta outputs of the kernel's shapes and records the
kernel's work from its own formulas (kept beside its shape predicates:
``flash_attention.fwd_work``, ``ssd_scan.fwd_work`` and so on) instead
of launching.  Each records under its library's name and its operands'
type: attention at head widths up to 32 (dit-small's, the reduced LM
configs') records as ``flash_attention_f32`` / ``flash_attention_f32_bwd``
(the small-width library, either type), float32 with TF32 FLOPs, which
``roofline.analysis`` puts at the TF32 peak, bf16 with bf16 FLOPs; every
kernel records its work at the true head width.
Nothing is built or loaded, and the wrapper's launch count does not
move.  ``roofline.op_analysis`` listens while it counts a step.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

# (name, flops by operand type, bytes) -> None
Listener = Callable[[str, Dict[str, float], int], None]
_LISTENERS: List[Listener] = []


@contextlib.contextmanager
def listening(fn: Listener):
    """Call ``fn`` for every kernel a meta call stands in for."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


def stand_in(name: str, work, *outs: torch.Tensor):
    """Record ``work`` (``(flops by operand type, bytes)``) for kernel
    ``name``; returns ``outs`` (one tensor alone)."""
    flops, nbytes = work
    for fn in list(_LISTENERS):
        fn(name, dict(flops), int(nbytes))
    return outs[0] if len(outs) == 1 else outs

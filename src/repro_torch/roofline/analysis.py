"""Roofline terms on one NVIDIA H100 (counterpart of
``repro.roofline.analysis``, whose constants are a TPU's).

compute term    = FLOPs / (cards x peak FLOP/s of the step's type)
memory term     = bytes / (cards x HBM rate)
collective term = collective bytes / (cards x link rate)

The FLOPs and bytes come from the step cost counter
(``roofline.op_analysis``) or from a card run.  The peaks are the H100
SXM's published dense rates (NVIDIA H100 Tensor Core GPU data sheet),
the same as ``chip_smoke.bound_ms`` uses.  The link rate is NVLink 4's
450 GB/s per direction per GPU (18 links of 25 GB/s; the same data
sheet's 900 GB/s counts both directions).  The reference parses
collective bytes out of XLA's optimized HLO; the port has no HLO and
reports the collectives its step issues (``op_analysis``): none on one
card.  On an abstract multi-device mesh it reports no collective term,
because nothing models how the port would shard a step there.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "tf32": 495e12,        # dense tensor-core TF32
              "float32": 67e12}      # float32 outside the tensor cores
HBM_BW = 3.35e12                     # bytes/s per card
HBM_BYTES = 80e9                     # device memory per card
LINK_BW = 450e9                      # NVLink 4, bytes/s per direction

NO_COLLECTIVE_TERM = (
    "no collective term: the mesh is abstract and the port runs one "
    "card, so nothing models the collectives a sharded step would issue")


def collectives(counted: Dict[str, float], n_devices: int) -> Dict:
    """The collectives of a dry-run record: what the step issued on one
    card (``counted``, from the counter: none), or no term on more."""
    if n_devices == 1:
        out = {k: v for k, v in counted.items() if k != "total_bytes"}
        out["total_bytes"] = float(counted.get("total_bytes", 0.0))
        return out
    return {"total_bytes": None, "note": NO_COLLECTIVE_TERM}


def memory_dict(counted: Optional[Dict] = None) -> Dict[str, int]:
    """The memory figures of a step: a dry run's from the counter
    (``op_analysis.analyze``'s result), else the card's, from
    ``torch.cuda.memory_stats`` (the peak since the last reset)."""
    if counted is not None:
        return {"argument_size_bytes": int(counted["argument_bytes"]),
                "temp_size_bytes": int(counted["temp_bytes"]),
                "peak_bytes": int(counted["peak_bytes"])}
    import torch
    stats = torch.cuda.memory_stats()
    return {"allocated_bytes": int(stats["allocated_bytes.all.current"]),
            "peak_bytes": int(stats["allocated_bytes.all.peak"]),
            "reserved_bytes": int(stats["reserved_bytes.all.peak"])}


def compute_seconds(flops: Union[float, Dict[str, float]],
                    dtype: str = "bfloat16") -> float:
    """FLOPs over the peak of their type; a dict ``{type: FLOPs}`` (the
    counter's ``flops_by_type``: bfloat16, float32 or tf32) adds each
    type's time."""
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    return sum(f / PEAK_FLOPS[t] for t, f in flops.items())


def roofline_terms(flops: Union[float, Dict[str, float]],
                   bytes_accessed: float, coll_bytes: Optional[float],
                   n_chips: int, dtype: str = "bfloat16") -> Dict:
    """Seconds of each term on ``n_chips`` cards and the largest one;
    ``flops`` a number (at ``dtype``'s peak) or ``{type: FLOPs}``;
    ``coll_bytes`` None gives no collective term."""
    terms = {"compute_s": compute_seconds(flops, dtype) / n_chips,
             "memory_s": bytes_accessed / (n_chips * HBM_BW),
             "collective_s": (None if coll_bytes is None
                              else coll_bytes / (n_chips * LINK_BW))}
    terms["bottleneck"] = max((k for k in terms if terms[k] is not None),
                              key=lambda k: terms[k])
    return terms


def model_flops(n_params_active: float, n_tokens: float,
                train: bool) -> float:
    """6·N·D for train (forward + backward), 2·N·D for inference."""
    return (6.0 if train else 2.0) * n_params_active * n_tokens

"""Dry run: every (architecture x input shape) counted on a mesh, with
nothing allocated (counterpart of ``repro.launch.dryrun``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape prefill_32k --mesh 1x1 --batch 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Each combo builds its step with abstract (meta) arguments
(``launch.steps.build`` / ``build_dit``) and counts one run of it
(``roofline.op_analysis.analyze``): FLOPs (dense products and each
kernel by its own formula), eager bytes, argument bytes and the peak of
live storage.  Where the reference lowers and compiles for XLA, this
runs the step's eager ops on the ``meta`` device: it takes seconds and
runs on any host.

On the one-card mesh (``--mesh 1x1``; ``--batch`` sets the per-card
batch) the record is the card's: the counter's figures as they are.  On
an abstract multi-device mesh (the default 16 x 16, or 2 x 16 x 16 with
``--multi-pod``) the argument bytes are each argument's per-device shard
(``sharding.partitioning``: the reference's rules and placements); the
FLOPs, bytes and temporaries are the step's at the global batch split
evenly over the devices, the least each device must do (the port runs
one card, so nothing models replicated work or collectives, and the
record says so: no collective term).  The roofline terms are one H100's
(``roofline.analysis``).

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
the reference's keys (``arch``, ``shape``, ``mesh``, ``n_devices``,
``memory``, ``flops``, ``bytes_accessed``, ``collectives``) and the
roofline terms.  The DiT steps are ``denoise_step`` and ``cached_step``
for ``flux1-dev`` (1024², latent 128) and ``dit-small`` at latent 128
(4096 tokens, as the reference's ``build_dit``: its joint attention
reaches the float32 flash kernels of head width 16).  Exit status 1 on
any failed combo.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs as config_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import op_analysis
from repro_torch.sharding import partitioning as pt

DIT_ARCHS = ("flux1-dev", "dit-small")
DIT_SHAPES = ("denoise_step", "cached_step")
DIT_LATENT = {"flux1-dev": 128, "dit-small": 128}
DIT_BATCH = 64          # the reference's build_dit batch


def shard_bytes(arg, placement, mesh: mesh_lib.Mesh) -> int:
    """Per-device bytes of an argument tree under its placement tree."""
    if isinstance(arg, torch.Tensor):
        shape = pt.shard_shape(arg.shape, placement, mesh)
        return math.prod(shape) * arg.element_size()
    if isinstance(arg, dict):
        return sum(shard_bytes(arg[k], placement[k], mesh) for k in arg)
    if isinstance(arg, (list, tuple)):
        return sum(shard_bytes(a, p, mesh)
                   for a, p in zip(arg, placement, strict=True))
    if hasattr(arg, "__dataclass_fields__"):
        return sum(shard_bytes(v, getattr(placement, k), mesh)
                   for k, v in vars(arg).items()
                   if isinstance(v, torch.Tensor))
    return 0


def build_spec(arch: str, shape: str, mesh: mesh_lib.Mesh,
               overrides: Optional[Dict[str, Any]] = None):
    ov = overrides or {}
    if arch in DIT_ARCHS:
        return steps_lib.build_dit(
            arch, mesh, batch=int(ov.get("batch") or DIT_BATCH),
            latent=DIT_LATENT[arch], cached_step=(shape == "cached_step"))
    return steps_lib.build(arch, shape, mesh, overrides=ov)


def record_for(spec, counted: Dict[str, Any], arch: str, shape: str,
               mesh: mesh_lib.Mesh) -> Dict[str, Any]:
    """The dry-run record of one counted step on ``mesh``."""
    n = mesh.size
    per = float(n)
    if n == 1:
        memory = roofline.memory_dict(counted)
    else:
        arg = shard_bytes(spec.args, spec.in_shardings, mesh)
        temp = int(counted["temp_bytes"] / per)
        memory = {"argument_size_bytes": arg, "temp_size_bytes": temp,
                  "peak_bytes": arg + temp}
    flops = counted["flops"] / per
    nbytes = counted["bytes_accessed"] / per
    coll = roofline.collectives(counted["collectives"], n)
    terms = roofline.roofline_terms(
        {t: f / per for t, f in counted["flops_by_type"].items()}, nbytes,
        coll["total_bytes"], 1)
    return {
        "arch": arch, "shape": shape,
        "mesh": mesh.name, "n_devices": n,
        "memory": memory, "flops": flops, "bytes_accessed": nbytes,
        "collectives": coll,
        "by_kind": {k: {"flops": v["flops"] / per, "bytes": v["bytes"] / per,
                        "calls": v["calls"]}
                    for k, v in counted["by_kind"].items()},
        "roofline": terms,
        "fits_hbm": memory["peak_bytes"] <= roofline.HBM_BYTES,
        "device": "NVIDIA H100 (published peaks: 989 TFLOP/s bf16, "
                  "3.35 TB/s, 80 GB)",
    }


def run_one(arch: str, shape: str, mesh: mesh_lib.Mesh,
            out_dir: Optional[str] = "results/dryrun_torch",
            verbose: bool = True, overrides=None) -> dict:
    t0 = time.perf_counter()
    spec = build_spec(arch, shape, mesh, overrides)
    counted = op_analysis.analyze(spec.fn, *spec.args)
    record = record_for(spec, counted, arch, shape, mesh)
    record["count_s"] = round(time.perf_counter() - t0, 2)
    if verbose:
        mem = record["memory"]
        kinds = ", ".join(f"{k} {v['flops']:.3e}"
                          for k, v in record["by_kind"].items()
                          if v["flops"])
        print(f"[dryrun] {arch} x {shape} on {record['mesh']}: "
              f"argbytes/dev={mem['argument_size_bytes'] / 1e9:.3f}GB "
              f"temp/dev={mem['temp_size_bytes'] / 1e9:.3f}GB "
              f"peak/dev={mem['peak_bytes'] / 1e9:.3f}GB "
              f"flops={record['flops']:.4e} ({kinds}) "
              f"bytes={record['bytes_accessed']:.4e} "
              f"compute={record['roofline']['compute_s']:.4g}s "
              f"memory={record['roofline']['memory_s']:.4g}s "
              f"bottleneck={record['roofline']['bottleneck']} "
              f"({record['count_s']}s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{shape}__{record['mesh']}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def all_combos():
    return ([(a, s) for a in config_lib.ASSIGNED
             for s in config_lib.INPUT_SHAPES]
            + [(a, s) for a in DIT_ARCHS for s in DIT_SHAPES])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(config_lib.INPUT_SHAPES) + list(DIT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL or PODxDATAxMODEL (default 16x16, "
                         "2x16x16 with --multi-pod); 1x1 is one card")
    ap.add_argument("--batch", type=int, default=None,
                    help="the per-card batch on the one-card mesh")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--moe-impl", default=None, choices=["einsum", "gather"])
    ap.add_argument("--moe-pad", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh:
        mesh = mesh_lib.parse_mesh(args.mesh)
    else:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod)
    if args.batch and mesh.size != 1:
        ap.error("--batch sets the per-card batch of the 1x1 mesh")
    if args.all:
        combos = all_combos()
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    overrides = {"moe_impl": args.moe_impl, "moe_pad": args.moe_pad,
                 "batch": args.batch}
    failures = []
    for arch, shape in combos:
        try:
            run_one(arch, shape, mesh, args.out, overrides=overrides)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"dry-run OK: {len(combos)} combo(s) on {mesh.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one H100.

Phases, each of which raises (and so exits non-zero) on failure:

1. device    — card name, power limit and compute capability (9, 0);
2. build     — nvcc builds the three kernels from ``csrc/`` in parallel;
3. kernels   — each kernel against its plain PyTorch version at the
               shapes the FLUX.1-dev main path gives it, in bf16 and
               float32, with the stated tolerance, plus its time, the
               plain version's time, the bound and (attention) the
               PyTorch library call's time;
4. reference — a small DiT served on the card (kernels forced) agrees
               with the same requests served on the CPU (plain versions);
5. serve     — a ``DiffusionEngine`` at full flux1-dev width serves four
               1024² requests under FreqCa, then one under ``none``;
               launch counters show the main path ran the kernels.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit, and before that a ``kernels`` JSON
line.  Run from the repository root:  ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # float32 outside the tensor cores
# max |kernel − plain| / max |plain| allowed: float32 differs by the
# order of long float32 sums; bf16 by one rounding of the output (and,
# for attention, the plain version's bf16 rounding of probabilities)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
N_STEPS = 20                          # Euler steps of the serve phase


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(name: str, dtype: str, got, want):
    """-> (max abs err, max abs err / max |plain|) over all outputs."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = rel = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs plain "
                                 f"{w.shape}/{w.dtype}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        d = (g.float() - w.float()).abs().max().item()
        err = max(err, d)
        rel = max(rel, d / max(w.float().abs().max().item(), 1e-30))
    if rel > TOLERANCE[dtype]:
        raise AssertionError(f"{name} [{dtype}]: max rel err {rel:.3e} > "
                             f"{TOLERANCE[dtype]:.0e}")
    return err, rel


def kernel_phase(main_dtype: dict) -> dict:
    """Each kernel vs its plain version at FLUX shapes; returns the
    main-path dtype's row per kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import frequency
    from repro_torch.kernels import (dct, flash_attention, freqca_fused,
                                     ops, ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, D, K = 2, 4096, 3072, 3
    rows = {}

    def row(name, dtype, kern, plain, nbytes, flops, library=None,
            reps=10):
        got, want = kern(), plain()
        err, rel = compare(name, dtype, got, want)
        del got, want
        t_k = time_ms(kern, reps)
        t_p = time_ms(plain, reps)
        t_l = time_ms(library, reps) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        log(f"kernel {name} [{dtype}] max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (tol {TOLERANCE[dtype]:.0e}) "
            f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) library_ms="
            f"{'null' if t_l is None else f'{t_l:.4f}'}")
        if dtype == main_dtype.get(name):
            rows[name] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": t_l}

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        es = torch.finfo(dt).bits // 8
        # band split: the CRF of two lanes, dct and fft widths
        x = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        for method in ("dct", "fft"):
            m = frequency.spectral_kept_bins(S, 0.0625, method)
            name = "band_split_spectral"
            nb = 2 * B * S * D * es + B * m * D * es + m * S * 4
            fl = B * 2 * (2 * m * S * D)
            row(name if method == "dct" else name + "[fft]", dtype_name,
                lambda x=x, method=method: dct.band_split_spectral(
                    x, 0.0625, method),
                lambda x=x, method=method: ref.band_split_spectral_ref(
                    x, 0.0625, method),
                nb, fl)
        del x
        # fused cached step: ring of K=3, per-lane weights
        m = frequency.spectral_kept_bins(S, 0.0625, "dct")
        low = torch.randn((B, m, D), generator=gen, device=dev).to(dt)
        hist = torch.randn((B, K, S, D), generator=gen, device=dev).to(dt)
        synth = frequency.low_band_basis(S, 0.0625, "dct", device=dev).T
        ts = torch.tensor([[0.9, 0.85, 0.75], [0.75, 0.9, 0.85]],
                          device=dev)
        w = ops.hermite_weights(ts, torch.tensor(0.7, device=dev), 2)
        nb = ((B * m * D + B * K * S * D + B * S * D) * es
              + (S * m + w.numel()) * 4)
        fl = B * (2 * S * m * D + 2 * K * S * D)
        row("freqca_predict_fused_spectral", dtype_name,
            lambda low=low, hist=hist, w=w:
                freqca_fused.freqca_predict_fused_spectral(low, synth, hist,
                                                           w),
            lambda low=low, hist=hist, w=w:
                ref.freqca_predict_spectral_ref(low, synth, hist, w),
            nb, fl)
        del low, hist
        # joint attention of one FLUX block: 512 text + 4096 image tokens,
        # at one lane and at the serve phase's two (the kernels line's row)
        for lanes in (1, 2):
            shape = (lanes, 4608, 24, 128)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            nb = 4 * q.numel() * es
            fl = 4 * shape[0] * shape[2] * shape[1] ** 2 * shape[3]
            row("flash_attention" + ("" if lanes == 2 else "[B=1]"),
                dtype_name,
                lambda q=q, k=k, v=v: flash_attention.flash_attention(q, k,
                                                                      v),
                lambda q=q, k=k, v=v: ref.attention_ref(q, k, v), nb, fl,
                library=lambda qt=qt, kt=kt, vt=vt:
                    F.scaled_dot_product_attention(qt, kt, vt),
                reps=5)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


def redraw_zero_leaves(params, seed: int, std: float = 0.02):
    """Give the AdaLN-zero leaves (``mod``, ``final_mod``, ``final_proj``)
    random values.  The reference initialises them to zero, which makes
    every block an identity and the velocity exactly zero; with random
    weights and no trained checkpoint, redrawing them is what makes the
    blocks and the velocity non-trivial, so the run exercises the model."""
    import torch
    leaves = [params["final_mod"]["kernel"], params["final_mod"]["bias"],
              params["final_proj"]]
    for layer in params["single"]:
        leaves += [layer["mod"]["kernel"], layer["mod"]["bias"]]
    for layer in params.get("double", []):
        for s in ("img", "txt"):
            leaves += [layer[s]["mod"]["kernel"], layer[s]["mod"]["bias"]]
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen,
                               device=leaf.device) * std)


def make_fns(params, cfg, side: int, text):
    from repro_torch.models import dit

    def full_fn(x, t):
        out = dit.dit_forward(params, x, t.expand(x.shape[0]), cfg,
                              text[:x.shape[0]])
        return out.velocity, out.crf

    def from_crf_fn(crf, t):
        return dit.dit_from_crf(params, crf, t.expand(crf.shape[0]), cfg,
                                side, side)
    return full_fn, from_crf_fn


def reference_phase(devices=("cpu", "cuda")) -> None:
    """A small DiT (head_dim 64, every attention forced onto the flash
    kernel) served on the card must agree with the same requests served
    on the CPU through the plain versions."""
    import torch

    from repro_torch.configs.base import DiTConfig
    from repro_torch.core.policies import FreqCaPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    cfg = DiTConfig(arch_id="smoke", n_layers=2, n_double=1, d_model=128,
                    n_heads=2, d_ff=256, patch_size=2, in_channels=16,
                    text_dim=32, n_text_tokens=8, dtype="float32")
    side = 16
    params_cpu = dit.init_params(cfg, seed=3, device="cpu")
    redraw_zero_leaves(params_cpu, seed=4)
    text_cpu = torch.randn((2, 8, 32), generator=torch.Generator()
                           .manual_seed(5))
    latents = {}
    saved = dit._FLASH_MIN_SEQ
    dit._FLASH_MIN_SEQ = 0
    try:
        for idx, dev in enumerate(devices):
            params = _to(params_cpu, dev)
            full_fn, from_crf_fn = make_fns(params, cfg, side,
                                            text_cpu.to(dev))
            for method in ("dct", "fft"):
                eng = DiffusionEngine(
                    full_fn, from_crf_fn, (side, side, 16),
                    ((side // 2) ** 2, cfg.d_model),
                    FreqCaPolicy(interval=3, method=method, rho=0.125),
                    n_steps=10, max_batch=2, device=dev)
                ops.reset_launch_counts()
                res = eng.run_batch([DiffusionRequest(request_id=i, seed=i)
                                     for i in range(2)])
                latents[idx, method] = torch.stack(
                    [r.latents for r in res]).cpu()
                if dev == "cuda" and min(ops.launch_counts().values()) < 1:
                    raise AssertionError(f"reference run skipped a kernel: "
                                         f"{ops.launch_counts()}")
    finally:
        dit._FLASH_MIN_SEQ = saved
    for method in ("dct", "fft"):
        want, got = latents[0, method], latents[1, method]
        rel = ((got - want).norm() / want.norm()).item()
        log(f"reference [{method}] card vs CPU: rel L2 {rel:.3e} "
            "(tol 1e-4)")
        if not torch.isfinite(got).all() or rel > 1e-4:
            raise AssertionError(f"reference [{method}]: rel L2 {rel:.3e}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def serve_phase(n_steps: int, cfg=None, side: int = 128,
                device: str = "cuda") -> dict:
    """flux1-dev at full width, bf16, 1024² (latent 128x128x16, CRF
    4096x3072), FreqCa(interval=5, dct), max_batch=2."""
    import torch

    from repro_torch import configs
    from repro_torch.core.policies import FreqCaPolicy, NoCachePolicy
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    cfg = cfg or configs.get_config("flux1-dev")
    crf_shape = ((side // cfg.patch_size) ** 2, cfg.d_model)
    t0 = time.perf_counter()
    params = dit.init_params(cfg, seed=0, device=device)
    redraw_zero_leaves(params, seed=1)
    n_params = sum(p.numel() for p in _leaves(params))
    text = torch.randn((2, cfg.n_text_tokens, cfg.text_dim), device=device,
                       generator=torch.Generator(device=device)
                       .manual_seed(2)).to(dit.torch_dtype(cfg.dtype))
    log(f"serve: {cfg.arch_id} params {n_params / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    full_fn, from_crf_fn = make_fns(params, cfg, side, text)
    eng = DiffusionEngine(full_fn, from_crf_fn, (side, side, 16), crf_shape,
                          FreqCaPolicy(interval=5, method="dct"),
                          n_steps=n_steps, max_batch=2, device=device)
    log(f"serve: warmup (build + each bucket once) "
        f"{eng.warmup():.1f} s")

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        eng.submit(DiffusionRequest(request_id=i, seed=100 + i))
    results = eng.serve_until_drained()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = eng.metrics.n_batches
    full = sorted(r.n_full_steps for r in results)
    want_full = len([i for i in range(n_steps) if i % 5 == 0 or i < 3])
    log(f"serve: {len(results)} requests in {n_batches} batches, "
        f"n_full_steps per request {[r.n_full_steps for r in results]}, "
        f"batch walls (s) {[round(w, 3) for w in eng.metrics.batch_walls]}, "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"serve: launch counts {counts} "
        f"(per batch {({k: v / max(n_batches, 1) for k, v in counts.items()})})")
    if len(results) != 4 or full != [want_full] * 4:
        raise AssertionError(f"expected 4 requests with {want_full} full "
                             f"steps, got {full}")
    fulls, cached = want_full, n_steps - want_full
    per_batch = {"band_split_spectral": fulls,
                 "freqca_predict_fused_spectral": cached,
                 "flash_attention": fulls * (cfg.n_double + cfg.n_layers)}
    for name, n in per_batch.items():
        if counts[name] != n * n_batches:
            raise AssertionError(f"{name}: {counts[name]} launches, "
                                 f"expected {n} per batch x {n_batches}")
    x_freqca = next(r.latents for r in results if r.request_id == 0)
    if tuple(x_freqca.shape) != (side, side, 16) or \
            not all(torch.isfinite(r.latents).all() for r in results):
        raise AssertionError("serve: latents of wrong shape or non-finite")

    eng_none = DiffusionEngine(full_fn, from_crf_fn, (side, side, 16),
                               crf_shape, NoCachePolicy(), n_steps=n_steps,
                               max_batch=1, device=device)
    t0 = time.perf_counter()
    (none_res,) = eng_none.run_batch([DiffusionRequest(request_id=0,
                                                       seed=100)])
    none_wall = time.perf_counter() - t0
    rel = ((x_freqca - none_res.latents).norm()
           / none_res.latents.norm()).item()
    log(f"serve: none request {none_res.n_full_steps} full steps in "
        f"{none_wall:.2f} s; FreqCa latents vs none: rel L2 {rel:.4f}")
    if not math.isfinite(rel) or none_res.n_full_steps != n_steps:
        raise AssertionError("serve: the none reference failed")

    # where a batch's time goes: the same functions, timed alone at the
    # batch's two lanes
    t = torch.tensor(0.75, device=device)
    x2 = torch.randn((2, side, side, 16), device=device)
    crf2 = torch.randn((2,) + crf_shape, device=device)
    qkv = torch.randn((2, crf_shape[0] + cfg.n_text_tokens, cfg.n_heads,
                       cfg.head_dim), device=device).to(text.dtype)
    full_ms = time_ms(lambda: full_fn(x2, t), reps=3)
    attn_ms = time_ms(lambda: ops.flash(qkv, qkv, qkv), reps=5)
    final_ms = time_ms(lambda: from_crf_fn(crf2, t), reps=10)
    n_attn = cfg.n_double + cfg.n_layers
    log(f"serve: breakdown, 2 lanes: full forward {full_ms:.2f} ms, of it "
        f"attention {n_attn} x {attn_ms:.3f} ms = {n_attn * attn_ms:.2f} ms; "
        f"final layer alone {final_ms:.3f} ms; a batch runs {fulls} full "
        f"and {cached} cached steps")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the kernel and reference phases")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {smi}; capability {cap}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability (9, 0), "
                         f"got {cap}")

    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {secs} (wall {time.perf_counter() - t0:.1f} s)")
    for name, text in build.ptxas_report.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    main_dtype = {"band_split_spectral": "bfloat16",
                  "freqca_predict_fused_spectral": "float32",
                  "flash_attention": "bfloat16"}
    rows = kernel_phase(main_dtype)
    reference_phase()
    # launches are read only from the serve phase's counters; without
    # that phase nothing was counted and the line says null
    counts = {}
    if not args.skip_serve:
        counts = serve_phase(N_STEPS)

    replaces = {
        "band_split_spectral": ("src/repro_torch/kernels/csrc/"
                                "band_split_spectral.cu",
                                "src/repro/kernels/dct.py:138"),
        "freqca_predict_fused_spectral": (
            "src/repro_torch/kernels/csrc/freqca_fused_spectral.cu",
            "src/repro/kernels/freqca_fused.py:94"),
        "flash_attention": ("src/repro_torch/kernels/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts.get(name), **rows[name])
               for name, (src, rep) in replaces.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one H100.

Phases, each of which raises (and so exits non-zero) on failure:

1. device    — card name, power limit and compute capability (9, 0);
2. build     — nvcc builds the nine kernel libraries from ``csrc/`` in
               parallel;
               the SASS of the two flash libraries (forward and
               backward) must hold wgmma (HGMMA) and TMA loads
               (UTMALDG), and ptxas must report no spills, no ignored
               setmaxnreg (C7508) and no serialised wgmma (C7512) for
               the forward's bf16 kernels and every backward kernel;
               the forward's float32 kernels (the 3xTF32 template) must
               each hold TF32 mma.sync (HMMA) and spill nothing;
               the SASS of token_basis_matmul, ssd_scan, ssd_scan_bwd,
               band_split_spectral and freqca_fused_spectral must hold
               mma.sync (HMMA), with no spills in any of their kernels;
               in flash_attention_f32 (float32 at head width 16), kernel
               by kernel, the two forward kernels must hold TF32 HMMA
               and the three backward kernels FFMA and no HMMA or
               HGMMA, with no spills in any;
3. kernels   — each kernel against its plain PyTorch version at the
               shapes its paths give it (FLUX.1-dev, one yi-9b attention
               layer, one mamba2-370m SSD layer; the FreqCa cache
               kernels also at mamba2-370m's CRF width and at one FLUX
               lane, as a mixed-policy batch launches them), in bf16 and
               float32, with the stated tolerance, plus its time, the
               plain version's time, the bound and, where one PyTorch
               call computes the same function, that call's time; the
               flash backward (bf16) at the DiT, train and causal GQA
               shapes, its two launches bitwise equal, each of its three
               launches timed apart, and the forward that writes the
               log-sum-exp; the SSD-scan backward at one mamba2-370m
               layer in bf16 and float32, each output to its stated
               tolerance, two launches bitwise equal, each launch timed
               apart; kernels 6 and 8 at one jamba-1.5-large layer
               (heads of 128, run as two heads of 64), bf16 and float32;
               kernels 3 and 7 in float32 at head width 16 (dit-small's
               8 heads at S 4096, 1024 on batch 16, and the ragged 1600):
               the forward with and without its log-sum-exp, the
               backward against a float64 oracle, two backward launches
               bitwise equal, a TF32 control of the plain version that
               must miss each tolerance;
4. reference — a small DiT served on the card (kernels forced) agrees
               with the same requests served on the CPU (plain
               versions), and so does a mixed batch of a FreqCa and a
               ``freqca_eb`` request on a variant of it whose budget
               both skips and fires; so do a dit-small sampling loop
               driven by the legacy function-style cache API, two
               full-width mamba2-370m layers as a denoiser and two
               yi-9b-shaped layers through the LM forward at 2048
               tokens; one training step of a small DiT at S 1024
               (flash forward and backward kernels) with its AdamW
               update; and one LM training step each of 2 mamba2-370m
               layers (float32, SSD forward and backward kernels) and 2
               yi-9b-shaped layers (bf16, causal GQA flash forward and
               backward) at S 2048, with their AdamW updates;
5. analysis  — at full flux1-dev width: the uncached reference
               trajectory, the paper's Fig-2 band statistics (kernel
               route against the plain transform route) and the legacy
               cache API over that trajectory; launch counters show the
               path ran the band-split and fused legacy-step kernels;
6. serve     — a ``DiffusionEngine`` at full flux1-dev width serves four
               1024² requests under FreqCa, then one under ``none``;
               launch counters show the main path ran its kernels;
7. slo       — at full flux1-dev width, an ``AsyncDiffusionEngine``
               cutting mixed-policy batches serves one FreqCa request
               and three ``freqca_eb`` requests with a ``max_error``
               tier (a ``MixedBank`` batch and a uniform one), then two
               of them alone: each lane matches its solo run, realized
               errors stay within the budget, the metrics' wire format
               round-trips and merges, and the launch counters equal the
               launches the recorded per-step masks imply;
8. backbone  — FreqCa on an assigned architecture: mamba2-370m (48
               layers, d 1024) as the denoiser at S 4096, four requests
               served by the engine, 48 SSD launches per full forward;
9. lm        — yi-9b (48 layers, d 4096) ``transformer.forward`` on one
               32768-token sequence, 48 causal GQA flash launches; then
               ``make_prefill_step`` on the same tokens, its last-token
               logits equal to the forward's last row; the flash launch
               at that shape held against its plain version on the first
               and the last 1024 queries;
10. decode   — the LM decode path (``steps.make_decode_step``, no
               kernel) at full width, one warm and 8 timed greedy steps
               from a seeded cache each: yi-9b (the lm phase's
               parameters) at decode_32k on batch 16 (32768 slots) and,
               through ``for_shape``, at long_500k on an 8192-slot ring
               at position 524279; mamba2-370m (48 layers) at decode_32k
               on batch 128 and at long_500k; each step's wall, tokens/s,
               peak memory, bound and attention / SSM share; one step
               card against CPU at 2 layers (bf16, float32); ``LMEngine``
               prefill against ``transformer.forward`` (yi-9b cut to 4
               layers on 2048 tokens, flash; mamba2-370m cut to 16 on
               512, the SSD scan; bf16, each also against the float32
               forward, and float32, mamba2 cut to 8) and 16 greedy tokens
               against the teacher-forced forward;
11. train    — ``launch.train.train_dit`` at full flux1-dev width (16
               single blocks, 2.7 B parameters) for 4 steps on two 1024²
               latents (S 4096): 16 flash forward and 16 backward
               launches a step, finite losses, every used leaf's
               gradient non-zero; its checkpoint, reloaded through
               ``bridge``, serves one FreqCa request (6 full steps);
12. lm_train — ``launch.train.train_lm`` for 4 steps at S 4096, bf16,
               the stack rematerialised: mamba2-370m at full depth (48
               layers) on batch 8, 96 SSD forward and 48 SSD backward
               launches a step; yi-9b at full width cut to 16 layers
               (3.3 B parameters) on batch 2, 32 flash forward and 16
               backward launches a step; finite losses, every leaf's
               gradient non-zero; yi's checkpoint reloaded through
               ``bridge`` runs one ``make_prefill_step``;
13. moe      — the mixture of experts at full width, bf16:
               granite-moe-3b-a800m at full depth (32 layers, 40
               experts top-8): ``make_prefill_step`` on 32768 tokens
               (einsum dispatch twice, gather once), one MoE layer's
               two dispatches held against each other and timed, its
               causal GQA flash (group 3, hd 64) against the plain
               version, decode at decode_32k (batch 16) and long_500k,
               ``train_lm`` 4 steps at S 4096 on batch 8; card against
               CPU at 2 layers in float32 (forward, loss, every
               gradient leaf, one decode step; each routing clear of 4δ
               and equal); ``LMEngine`` against the forward at 4
               layers; phi3.5-moe-42b-a6.6b cut to 16 layers
               (prefill, flash group 4, decode_32k on batch 8) and to 2
               (``train_lm`` 2 steps);
14. lm_configs — deepseek-coder-33b (62 layers), llama3-405b (8 of 126)
               and command-r-plus-104b (16 of 64): one
               ``make_prefill_step`` each on 32768 tokens, the flash
               launch at each shape (groups 7, 16, 12) against its plain
               version; each at 2 layers card against CPU in float32;
15. jamba    — jamba-1.5-large-398b: one full-width group (7 mamba2
               layers and 1 attention layer, the MoE FFN on every other
               one, 44 B parameters) layer at a time over 32768 tokens,
               each layer's parameters drawn and freed in turn: 7 SSD
               launches at heads of 128 and 1 flash launch; l0's backward
               at S 4096 (one SSD-backward launch); l0 card against CPU in
               float32 at full SSM width (output and every gradient, a
               TF32 control);
16. encdec   — seamless-m4t-medium at full width and depth (12 + 12
               layers): ``make_prefill_step`` on 32768 frames and tokens
               (36 flash launches: 12 non-causal, 12 causal, 12
               cross-attention), the new flash forms against their plain
               versions and SDPA, decode at decode_32k (batch 16) against
               a 32768-frame memory, ``train_lm`` for 3 steps at S 4096
               on batch 8 (the flash backward at its forms), 2 + 2
               layers card against CPU in float32;
17. vlm      — llava-next-34b: ``make_prefill_step`` at full depth (60
               layers) on 2880 prefix embeddings and 29888 text tokens,
               ``train_lm`` cut to 4 layers (2 steps, batch 8, S 4096),
               2 layers card against CPU in float32;
18. launcher — ``launch.serve.main`` in this process at dit-small, three
               times: closed-loop bursts, the threaded open loop and two
               replica processes; every request its 4 full steps, a
               finite PSNR against the uncached run, 0 steady-state
               first runs; kernels 1 and 2 held against their plain
               versions at its shapes;
19. fleet    — two replica processes on the card behind a
               ``FleetRouter``, each with its own copy of the train
               phase's flux1-dev cut (shipped as a numpy tree): six
               1024² requests, one replica SIGKILLed mid-stream, every
               future resolved once, the slot restarted and serving two
               more, six more timed; then the same engine in this
               process serves the same requests: 6 full steps each,
               latents bitwise at the same bucket, kernels 1-3 launched;
20. dit_small — dit-small at full width (8 layers, 8 heads of 16,
               float32) where its attention reaches the float32 hd-16
               kernels: ``launch.serve.main`` on the card with the shape
               ladder 32, 64, 128 (six requests; full steps and latents
               against the same FreqCa stream on the CPU; kernels 1-3
               called at 64 and 128, flash never at 32), ``train_dit``
               for 3 steps on batch 16 at latent 64 and 128, a training
               step card against CPU at 64 and kernels against the plain
               route at 128 (with a TF32 control), and the dry run's
               dit-small step at latent 128 against the card (``PHASES``
               runs it after vlm, before launcher);
21. dryrun   — first, ``launch.dryrun --all`` on the 16 x 16 mesh in
               this process (10 LM configs x 4 shapes and the two DiTs'
               full and cached steps on meta tensors, the CPU's work):
               one ``dryrun_row`` line each, failing on any failed
               combo; then the prediction of the one-card mesh against
               the card for five steps (``DRYRUN_ROWS``: flux1-dev's full
               and cached steps at batch 2 on the serve phase's weights,
               yi-9b prefill_32k on the lm phase's, mamba2-370m train_4k
               at batch 8 and granite prefill_32k at batch 1 on weights
               drawn here): argument bytes equal, the peak and its ratio,
               the FLOPs by kind, the bound, the wall and the share of
               the bf16 peak, one ``dryrun_card`` line each.

The flux1-dev parameters (~26 GB in bf16) are built once for phases 5
to 7 and freed before phase 8; each later phase frees its model before
it draws the next (each fleet replica holds its own 5.5 GB copy).  The
last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that a ``kernels`` JSON
line.  Run from the repository root: ``python3 chip_smoke.py``;
``--phases jamba,encdec`` runs the build and kernel phases and then only
the phases named (``PHASES``), in their usual order.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "tf32": 495e12,         # dense tensor-core TF32
              "float32": 67e12}       # float32 outside the tensor cores
# max |kernel − plain| / max |plain| allowed: float32 differs by the
# order of long float32 sums; bf16 by one rounding of the output (for
# attention, kernel and plain version both round the probabilities to
# bf16 before P·V, so they differ by the order of the sums, the
# unnormalised rounding of the kernel's p and the output's rounding)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
N_STEPS = 20                          # Euler steps of the full-width phases
# the slo phase: the realized-error and latent tolerances of an eb lane
# served in a batch of two against the same request served alone (bf16
# dense layers at batch 2 against batch 1); and the margin, as a share of
# the budget, that a measured spend must keep from it (the warmup's
# smallest rate below a tier, for that tier to count as leaving a cached
# step; every spend of the small card-vs-CPU run, so float32 cannot tie)
SLO_REL_TOL = 5e-2
SLO_TIER_MARGIN = 0.05
# the kernels of the served main path (the others run on the analysis
# path)
SERVE_KERNELS = ("band_split_spectral", "freqca_predict_fused_spectral",
                 "flash_attention")
# the rows of this run at the forms the jamba, encdec and vlm phases add,
# and the float32 hd-16 rows ({"<kernel>[<form>]": {dtype: numbers}}),
# for the kernels line
FORM_ROWS = {}
FORM_TAGS = ("jamba", "seamless", "llava", "f32_hd16")


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


def bound_ms(nbytes: float, flops, op_dtype: str):
    """The larger of bytes over the memory rate and operations over the
    peak rate of the type the function computes in.  ``flops`` may be a
    dict {type: operations} for a function whose products run in more
    than one type; their times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if not isinstance(flops, dict):
        flops = {op_dtype: flops}
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops.items()) * 1e3
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


def log_bound(label: str, nbytes: float, flops, op_dtype: str) -> None:
    """Log a bound beside a row's own (another peak or another count)."""
    b_ms, b_by = bound_ms(nbytes, flops, op_dtype)
    log(f"kernel {label} bound_ms={b_ms:.4f} ({b_by})")


def log_f32_fwd_bounds(label: str, nbytes: float, flops) -> None:
    """Beside a float32 flash forward row (its bound: ``fwd_work``'s
    count once at the TF32 peak), the same work at the float32 FMA peak
    and the design's (3 TF32 products, the hi + lo split)."""
    log_bound(f"{label} at the float32 FMA peak", nbytes, flops, "float32")
    log_bound(f"{label} the design's (3 TF32 products)", nbytes, 3 * flops,
              "tf32")


def rate(flops: float, ms: float, b_ms: float) -> str:
    """A kernel's rate and its share of the bound, for the log."""
    return (f"rate={flops / ms / 1e9:.1f} TFLOP/s "
            f"bound/ms={b_ms / ms:.3f}")


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s library (cuobjdump)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    return subprocess.run(
        [str(cuobjdump), "-sass", str(build.lib_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout


def ptxas_spills(name: str, entry: str = "") -> dict:
    """{kernel: spill bytes (stores + loads)} from the ptxas report of
    ``name``'s library, for the kernels whose mangled name holds
    ``entry``; -1 where the report gives no spill line."""
    from repro_torch.kernels import build
    spills = {}
    for part in build.ptxas_log(name).split("Compiling entry function")[1:]:
        if entry in part.splitlines()[0]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
            spills[part.split("'")[1]] = (int(m.group(1)) + int(m.group(2))
                                          if m else -1)
    return spills


def sass_functions(name: str) -> dict:
    """{mangled kernel name: its SASS} of ``name``'s library, the
    cuobjdump listing split at each ``Function :`` header."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass(name), flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def tf32_hmma(code: str) -> int:
    """The TF32 tensor-core instructions (mma.sync m16n8k8) in SASS."""
    return sum(1 for line in code.splitlines()
               if "HMMA" in line and "TF32" in line)


def flash_build_checks() -> None:
    """The two bf16 flash libraries are the Hopper design: each one's SASS
    holds wgmma (HGMMA) and TMA loads (UTMALDG), and ptxas reports no
    spills, no ignored setmaxnreg (warning C7508) and no wgmma serialised
    for want of registers (warning C7512): for the forward's bf16
    kernels, and for every kernel of the backward.  The forward's eight
    float32 kernels (the 3xTF32 template, ``tf32_fwd_kernel``: hd 64 and
    128, masked or not, with or without the LSE) each hold TF32 HMMA and
    spill nothing."""
    from repro_torch.kernels import build
    funcs = sass_functions("flash_attention")
    tf32 = {n: tf32_hmma(c) for n, c in funcs.items()
            if "tf32_fwd_kernel" in n}
    spills = ptxas_spills("flash_attention", "tf32_fwd_kernel")
    log(f"flash_attention float32 kernels: TF32 HMMA "
        f"{sorted(tf32.values())}; spill bytes {sorted(spills.values())}")
    if len(tf32) != 8 or min(tf32.values()) == 0 or len(spills) != 8 \
            or any(spills.values()):
        raise AssertionError(f"flash_attention float32 build: TF32 HMMA "
                             f"{tf32}, spills {spills}")
    for name, entry in (("flash_attention", "flash_fwd_hopper_kernel"),
                        ("flash_attention_bwd", "")):
        code = sass(name)
        counts = {op: code.count(op) for op in ("HGMMA", "UTMALDG")}
        report = build.ptxas_log(name)
        spills = ptxas_spills(name, entry)
        warnings = {w: w in report for w in ("C7508", "C7512")}
        log(f"{name} SASS: {counts}; kernels checked {len(spills)}, spill "
            f"bytes {sorted(set(spills.values()))}; "
            + ", ".join(f"{w} {'present' if on else 'absent'}"
                        for w, on in warnings.items()))
        if min(counts.values()) == 0 or not spills or any(spills.values()) \
                or any(warnings.values()):
            raise AssertionError(f"{name} build: SASS {counts}, spills "
                                 f"{spills}, warnings {warnings}")


def mma_build_checks() -> None:
    """token_basis_matmul, the SSD scan and its backward and the two
    FreqCa cache kernels run their products on the tensor cores: each
    library's SASS holds mma.sync (HMMA), and ptxas reports no spills for
    any of its kernels."""
    for name in ("token_basis_matmul", "ssd_scan", "ssd_scan_bwd",
                 "band_split_spectral", "freqca_fused_spectral"):
        hmma = sass(name).count("HMMA")
        spills = ptxas_spills(name)
        log(f"{name} SASS: HMMA {hmma}; kernels {len(spills)}, spill bytes "
            f"{sorted(set(spills.values()))}")
        if hmma == 0 or not spills or any(spills.values()):
            raise AssertionError(f"{name} build: HMMA {hmma}, spills "
                                 f"{spills}")


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
    # the backbone-width rows draw from their own generator, so that the
    # other rows' inputs do not depend on them
    gen_bb = torch.Generator(device=dev).manual_seed(1)
    # and so do the one-lane rows (how a MixedBank lane launches the two
    # cache kernels)
    gen_b1 = torch.Generator(device=dev).manual_seed(2)
    B, S, D, K = 2, 4096, 3072, 3
    rows = {}

    def row(name, dtype, kern, plain, nbytes, flops, library=None,
            reps=10, op_dtype=None, library_ms=None, checked=None):
        """``checked``: (max abs err, max rel err) the caller already
        held to its own per-output tolerances, else ``compare``'s."""
        if checked is None:
            got, want = kern(), plain()
            err, rel = compare(name, dtype, got, want)
            del got, want
        else:
            err, rel = checked
        t_k = time_ms(kern, reps)
        t_p = time_ms(plain, reps)
        t_l = time_ms(library, reps) if library is not None else library_ms
        b_ms, b_by = bound_ms(nbytes, flops, op_dtype or dtype)
        log(f"kernel {name} [{dtype}] max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (tol {TOLERANCE[dtype]:.0e}) "
            f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) library_ms="
            f"{'null' if t_l is None else f'{t_l:.4f}'}"
            + (f" {rate(flops, t_k, b_ms)}" if name.startswith(
                ("flash", "band_split_spectral",
                 "freqca_predict_fused_spectral"))
               else ""))
        numbers = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l}
        if dtype == main_dtype.get(name):
            rows[name] = numbers
        if any(tag in name for tag in FORM_TAGS):
            FORM_ROWS.setdefault(name, {})[dtype] = numbers

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        es = torch.finfo(dt).bits // 8
        # The two FreqCa cache kernels, on the CRF of two lanes at FLUX
        # width (the band split in dct and fft), at mamba2-370m's (d
        # 1024), and of one lane at FLUX width.  Their arithmetic is
        # float32 whatever the CRF's type, run on the TF32 tensor cores:
        # the bound of the kernels line counts the function's products
        # once at the TF32 peak.
        # Logged beside it: the same work at the float32 FMA peak, and
        # the design's own count of TF32 products (the basis always
        # split hi + lo; a bf16 operand exact in TF32, a float32 one
        # split: the band split 2 + 3 products in bf16, 3 + 3 in
        # float32; the cached step 2 or 3).
        n_op = 2 if dtype_name == "bfloat16" else 3
        for b, d, methods, g in ((B, D, ("dct", "fft"), gen),
                                 (B, 1024, ("dct",), gen_bb),
                                 (1, D, ("dct",), gen_b1)):
            wide = ", ".join(t for t in ("" if d == D else f"D={d}",
                                         "" if b == B else f"B={b}") if t)
            x = torch.randn((b, S, d), generator=g, device=dev).to(dt)
            for method in methods:
                m = frequency.spectral_kept_bins(S, 0.0625, method)
                tag = ", ".join(t for t in ("" if method == "dct" else method,
                                            wide) if t)
                name = "band_split_spectral" + (f"[{tag}]" if tag else "")
                work, nb = dct.spectral_work(b, S, d, m, es)
                prod = work["tf32"] // 2
                row(name, dtype_name,
                    lambda x=x, method=method: dct.band_split_spectral(
                        x, 0.0625, method),
                    lambda x=x, method=method: ref.band_split_spectral_ref(
                        x, 0.0625, method),
                    nb, work["tf32"], op_dtype="tf32")
                log_bound(f"{name} [{dtype_name}] at the float32 FMA peak",
                          nb, 2 * prod, "float32")
                log_bound(f"{name} [{dtype_name}] the design's ({n_op} + 3 "
                          "TF32 products)", nb, (n_op + 3) * prod, "tf32")
            del x
            # fused cached step: ring of K=3, per-lane weights
            m = frequency.spectral_kept_bins(S, 0.0625, "dct")
            low = torch.randn((b, m, d), generator=g, device=dev).to(dt)
            hist = torch.randn((b, K, S, d), generator=g, device=dev).to(dt)
            synth = frequency.low_band_basis(S, 0.0625, "dct", device=dev).T
            ts = torch.tensor([[0.9, 0.85, 0.75], [0.75, 0.9, 0.85]],
                              device=dev)[:b]
            w = ops.hermite_weights(ts, torch.tensor(0.7, device=dev), 2)
            work, nb = freqca_fused.spectral_work(b, K, S, d, m, es)
            prod, fma = 2 * b * S * m * d, 2 * b * K * S * d
            name = "freqca_predict_fused_spectral" + (f"[{wide}]" if wide
                                                      else "")
            row(name, dtype_name,
                lambda low=low, hist=hist, w=w, synth=synth:
                    freqca_fused.freqca_predict_fused_spectral(low, synth,
                                                               hist, w),
                lambda low=low, hist=hist, w=w, synth=synth:
                    ref.freqca_predict_spectral_ref(low, synth, hist, w),
                nb, work["tf32"], op_dtype="tf32")
            log_bound(f"{name} [{dtype_name}] at the float32 FMA peak", nb,
                      prod + fma, "float32")
            log_bound(f"{name} [{dtype_name}] the design's ({n_op} TF32 "
                      "products)", nb, {"tf32": n_op * prod, "float32": fma},
                      "tf32")
            del low, hist
            torch.cuda.empty_cache()
        # the token-axis basis product: as dct_tokens (DCT-II basis) and
        # as the band split (projection L, high in the same epilogue),
        # on the CRF of two lanes.  Its arithmetic is float32 whatever
        # x's type, as in the reference, and the kernel runs it on the
        # TF32 tensor cores: the least the card could take is the dense
        # product once at the TF32 peak, the bound of the kernels line.
        # Logged beside it: the same product at the float32 FMA peak,
        # and the design's own count (2 TF32 products for bf16 x, exact
        # in TF32; 3 for float32 x).  The kernels line reports the
        # dct_tokens row, which torch.matmul computes too.  The band
        # split runs that same dense product; its own rank-m work (low =
        # Cₘᵀ(Cₘ·x)) is logged beside it.
        x = torch.randn((B, S, D), generator=gen, device=dev).to(dt)
        nb_x = B * S * D * es
        c = frequency.dct_basis(S, device=dev)
        work, nb = dct.basis_work(B, S, D, es)
        dense = work["tf32"]
        n_tf32 = 2 if dtype_name == "bfloat16" else 3
        row("token_basis_matmul", dtype_name,
            lambda x=x, c=c: dct.token_basis_matmul(c, x),
            lambda x=x, c=c: ref.token_basis_matmul_ref(c, x),
            nb, dense,
            library=lambda x=x, c=c: torch.matmul(c, x.float()), reps=5,
            op_dtype="tf32")
        log_bound(f"token_basis_matmul [{dtype_name}] at the float32 FMA "
                  "peak", nb, dense, "float32")
        log_bound(f"token_basis_matmul [{dtype_name}] the design's "
                  f"({n_tf32} TF32 products)", nb, n_tf32 * dense, "tf32")
        nb = dct.basis_work(B, S, D, es, with_high=True)[1]
        for method in ("dct", "fft"):
            name = f"token_basis_matmul[band_split {method}]"
            row(name, dtype_name,
                lambda x=x, method=method: dct.band_split(x, 0.0625, method),
                lambda x=x, method=method: ref.band_split_ref(x, 0.0625,
                                                              method),
                nb, dense, reps=5, op_dtype="tf32")
            log_bound(f"{name} [{dtype_name}] at the float32 FMA peak",
                      nb, dense, "float32")
            m = frequency.spectral_kept_bins(S, 0.0625, method)
            log_bound(f"{name} [{dtype_name}] the rank-{m} split's own",
                      m * S * 4 + 3 * nb_x, 2 * (2 * B * m * S * D),
                      "float32")
        # the legacy cached step: K-major history, one shared ts [K].  The
        # row times the launch alone (weights on the device already),
        # which is what its bytes bound describes; the wrapper adds the
        # Hermite fold's small launches, host-bound, and is logged apart.
        hist = torch.randn((K, B, S, D), generator=gen, device=dev).to(dt)
        ts = torch.tensor([0.75, 0.5, 0.25], device=dev)
        t_q = torch.tensor(0.2, device=dev)
        w = freqca_fused.hermite_eval_weights(ts, t_q, 2)
        work, nb = freqca_fused.legacy_work(K, B * S * D, es, dtype_name)
        row("freqca_predict_fused", dtype_name,
            lambda x=x, hist=hist, w=w:
                freqca_fused.launch_fused(x, hist, w),
            lambda x=x, hist=hist, w=w: (
                x.float() + torch.einsum("k,kbsd->bsd", w, hist.float())
            ).to(x.dtype),
            nb, work[dtype_name])
        wrap = (lambda x=x, hist=hist, ts=ts, t_q=t_q:
                freqca_fused.freqca_predict_fused(x, hist, ts, t_q, 2))
        plain = (lambda x=x, hist=hist, ts=ts, t_q=t_q:
                 ref.freqca_predict_ref(x, hist, ts, t_q, 2))
        err, rel = compare("freqca_predict_fused (wrapper)", dtype_name,
                           wrap(), plain())
        log(f"kernel freqca_predict_fused [{dtype_name}] wrapper with its "
            f"Hermite fold: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
            f"wrapper_ms={time_ms(wrap, 10):.4f} "
            f"plain_ms={time_ms(plain, 10):.4f}")
        del x, hist
        torch.cuda.empty_cache()
        # joint attention of one FLUX block: 512 text + 4096 image tokens,
        # at one lane and at the serve phase's two (the kernels line's row)
        for lanes in (1, 2):
            shape = (lanes, 4608, 24, 128)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            work, nb = flash_attention.fwd_work(
                lanes, shape[1], shape[1], shape[2], shape[2], shape[3],
                dtype_name)
            (op, fl), = work.items()   # float32 runs on the TF32 cores
            name = "flash_attention" + ("" if lanes == 2 else "[B=1]")
            row(name, dtype_name,
                lambda q=q, k=k, v=v: flash_attention.flash_attention(q, k,
                                                                      v),
                lambda q=q, k=k, v=v: ref.attention_ref(q, k, v), nb, fl,
                library=lambda qt=qt, kt=kt, vt=vt:
                    F.scaled_dot_product_attention(qt, kt, vt),
                reps=5, op_dtype=op)
            if op == "tf32":
                log_f32_fwd_bounds(f"{name} [float32]", nb, fl)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
        lm_attention_rows(row, dt, dtype_name, gen)
        ssd_rows(row, dt, dtype_name, gen)
        ssd_bwd_rows(row, dt, dtype_name)
        ssd_jamba_rows(row, dt, dtype_name)
        if dtype_name == "bfloat16":
            flash_bwd_rows(row, gen)
        else:
            f32_hd16_rows(row)
    return rows


def lm_attention_rows(row, dt, dtype_name: str, gen) -> None:
    """The LM's attention forms at one yi-9b layer's shape, 4096 tokens:
    32 query heads on 4 kv heads of 128 — causal GQA (bf16 and float32),
    the same with a 1024 window (bf16) and non-causal GQA (bf16).  The
    library call is SDPA with GQA (a boolean mask for the window).  The
    bound counts the (query, key) pairs each mask keeps."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    dev = torch.device("cuda")
    es = torch.finfo(dt).bits // 8
    s, hq, hkv, hd = 4096, 32, 4, 128
    q = torch.randn((1, s, hq, hd), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((1, s, hkv, hd), generator=gen, device=dev).to(dt)
            for _ in "kv")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    forms = [("causal", True, 0), ("window1024", True, 1024),
             ("noncausal", False, 0)]
    if dtype_name == "float32":
        forms = forms[:1]
    for label, causal, window in forms:
        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)

        def lib(mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        work, nb = flash_attention.fwd_work(1, s, s, hq, hkv, hd, dtype_name,
                                            causal, window)
        (op, fl), = work.items()   # float32 runs on the TF32 cores
        name = f"flash_attention[{label} gqa 32/4]"
        row(name, dtype_name,
            lambda causal=causal, window=window:
                flash_attention.flash_attention(q, k, v, hq // hkv, causal,
                                                window),
            lambda causal=causal, window=window:
                ref.attention_ref(q, k, v, hq // hkv, causal, window),
            nb, fl, library=lib, reps=5, op_dtype=op)
        if op == "tf32":
            log_f32_fwd_bounds(f"{name} [float32]", nb, fl)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def flash_bwd_rows(row, gen) -> None:
    """The flash backward (bf16) beside its recompute twin: at the DiT
    joint shape [2, 4608, 24, 128] (the kernels line's row), at the train
    phase's [2, 4096, 24, 128] and in causal GQA at one yi-9b layer's [1,
    4096, 32/4, 128]; and, at the DiT shape, the forward that writes the
    log-sum-exp, re-timed beside the plain forward's row."""
    for label, shape, causal in (
            ("", (2, 4608, 24, 24), False),
            ("[train 2x4096]", (2, 4096, 24, 24), False),
            ("[causal gqa 32/4]", (1, 4096, 32, 4), True)):
        flash_bwd_row(row, gen, label, shape, causal)


def bwd_design_flops(b: int, s: int, t: int, hq: int, hkv: int, hd: int,
                     causal: bool, window: int = 0) -> dict:
    """The operations the backward kernel's passes run, as it walks its
    tiles (``flash_attention_bwd.cu``): pass (b), per 128-key block and
    kv head, each warpgroup's 64 keys against every streamed 64-query
    tile of the block's query range that keeps some pair, for each of
    the group's query heads, four products (Sᵀ, dPᵀ, dV, dK) of 2·hd a
    pair; pass (c), per 128-query block and head, each warpgroup's 64
    queries against every streamed key tile (128 at hd 128, 64 at hd 64)
    of the block's range that keeps some pair, three products (S, dP,
    dQ).  Masked and ragged pairs inside a visited tile count.  Returns
    {"kv": ..., "q": ...}."""
    bm, bn = 64, 128 if hd == 128 else 64

    def none(k0, bk, q0, bq):
        return (q0 >= s or k0 >= t or (causal and k0 > q0 + bq - 1)
                or (window > 0 and k0 + bk - 1 <= q0 - window))
    kv = 0
    for k0 in range(0, t, 128):
        q_begin = k0 if causal else 0
        q_end = min(s, min(k0 + 128, t) - 1 + window) if window else s
        for q0 in range(q_begin // bm * bm, q_end, bm):
            kv += sum(64 * bm for kw in (k0, k0 + 64)
                      if not none(kw, 64, q0, bm))
    q = 0
    for q0 in range(0, s, 128):
        k_end = min(t, q0 + 128) if causal else t
        k_begin = max(0, q0 - window + 1) if window else 0
        for k0 in range(k_begin // bn * bn, k_end, bn):
            q += sum(64 * bn for qw in (q0, q0 + 64)
                     if not none(k0, bn, qw, 64))
    return {"kv": b * hq * 8 * hd * kv, "q": b * hq * 6 * hd * q}


def device_ms(fn, reps: int) -> dict:
    """{kernel: (ms per call of ``fn``, launches recorded)} from
    ``torch.profiler``'s device times over ``reps`` calls after one
    warm-up call; each launch of the flash backward and of the SSD scan's
    forward and backward libraries keyed by its kernel's name.  The
    profiler can drop launches in a process that has run long (the
    lm_train phase), so the counts are returned beside the times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            m = re.search(r"((?:flash_bwd|ssd)_\w+?)_kernel", e.key)
            name = m.group(1) if m else e.key[:60]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + us / 1e3 / reps, n + e.count)
    return out


def flash_bwd_row(row, gen, label: str, shape, causal: bool) -> None:
    """One backward row at ``shape`` (B, S, Hq, Hkv), head width 128.  It
    checks dQ, dK and dV (each logged) and that two launches are bitwise
    equal.  The bound counts 10·hd·H FLOP a kept (query, key) pair (S
    again, dV, dP, dQ, dK) at the bf16 peak; logged beside it: the
    operations the kernel's tiles run (``bwd_design_flops``, S and dP in
    both passes: 14 a pair where the tiles hold no masked pair) and
    each launch's own device time (``torch.profiler``: the statistics
    pass, dK/dV, dQ) beside its share of them.  The library time is
    SDPA's backward: ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention`` less its forward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    b, s, hq, hkv = shape
    g, hd = hq // hkv, 128
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in "kv")
    do = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    pairs = b * fa.attention_pairs(s, causal, 0)
    if not label:
        # the forward with its log-sum-exp written, as training runs it
        work, nb = fa.fwd_work(b, s, s, hq, hkv, hd, "bfloat16", lse=True)
        row("flash_attention[lse]", "bfloat16",
            lambda: fa.flash_attention(q, k, v, return_lse=True),
            lambda: ref.attention_lse_ref(q, k, v), nb, work["bfloat16"],
            reps=5)
    o, lse = fa.flash_attention(q, k, v, g, causal, return_lse=True)
    name = "flash_attention_bwd" + label

    def kern():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal)

    def plain():
        return ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal)
    got, again, want = kern(), kern(), plain()
    errs = [compare(f"{name} d{x}", "bfloat16", a, w)[1]
            for x, a, w in zip("qkv", got, want, strict=True)]
    same = all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    log(f"kernel {name} [bfloat16] max_rel_err dq={errs[0]:.3e} "
        f"dk={errs[1]:.3e} dv={errs[2]:.3e}; two launches bitwise equal: "
        f"{same}")
    if not same:
        raise AssertionError(f"{name}: two launches differ")
    del got, again, want
    torch.cuda.empty_cache()
    leaves = [a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v)]
    d_out = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=g > 1)
    t_fwd = time_ms(sdpa, 5)
    t_both = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, d_out), 5)
    work, nbytes = fa.bwd_work(b, s, s, hq, hkv, hd, causal)
    row(name, "bfloat16", kern, plain, nbytes, work["bfloat16"], reps=5,
        library_ms=t_both - t_fwd)
    log(f"kernel {name}: SDPA forward {t_fwd:.4f} ms, forward + backward "
        f"{t_both:.4f} ms")
    design = bwd_design_flops(b, s, s, hq, hkv, hd, causal)
    total = sum(design.values())
    per_pair = total / (hq * hd * pairs)
    log_bound(f"{name} [bfloat16] the design's ({per_pair:.2f} FLOP per "
              "kept pair and head width: S and dP in both passes)",
              nbytes, total, "bfloat16")
    # each launch's device time; the two product passes beside the
    # operations their tiles run
    parts = []
    for n, (ms, _) in sorted(device_ms(kern, 5).items()):
        ops_n = design.get(n.removeprefix("flash_bwd_"))
        parts.append(f"{n} {ms:.4f} ms" + ("" if ops_n is None else (
            f" ({rate(ops_n, ms, bound_ms(0, ops_n, 'bfloat16')[0])}, "
            "of its tiles' operations)")))
    log(f"kernel {name} per launch (torch.profiler, 5 calls): "
        + "; ".join(parts))
    del q, k, v, do, o, lse, leaves, d_out
    torch.cuda.empty_cache()


def ssd_rows(row, dt, dtype_name: str, gen) -> None:
    """One mamba2-370m layer's SSD scan at two lanes of 4096 tokens: x
    [2, 4096, 32, 64], B and C [2, 4096, 128] as column slices of the
    conv output (strided, as the block passes them), dt float32, chunk
    256.  The bound counts the operations of ``ssd_scan.scan_flops`` at
    the bf16 tensor-core peak, where the kernel runs every product (the
    least the card could take); the same operations at their operands' peaks
    (float32 FMAs for the per-head products) are logged beside it.  No
    single PyTorch call computes the scan."""
    import torch

    from repro_torch.kernels import ref, ssd_scan
    dev = torch.device("cuda")
    es = torch.finfo(dt).bits // 8
    b, s, h, p, n, q = 2, 4096, 32, 64, 128, 256
    xbc = (torch.randn((b, s, h * p + 2 * n), generator=gen, device=dev)
           * 0.5).to(dt)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dts = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev) - 2.0)
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.3)
    nbytes = ssd_scan.fwd_work(b, s, h, p, n, q, es)[1]
    need = ssd_scan.scan_flops(b, s, h, p, n, q, dtype_name)
    row("ssd_chunk_scan", dtype_name,
        lambda: ssd_scan.ssd_chunk_scan(x, dts, a, bm, cm, q),
        lambda: ref.ssd_chunk_scan_ref(x, dts, a, bm, cm, q),
        nbytes, {"bfloat16": sum(need.values())}, reps=5)
    log_bound(f"ssd_chunk_scan [{dtype_name}] at its operands' peaks",
              nbytes, need, dtype_name)
    # the design's own count: every product on the tensor cores in bf16;
    # at bf16 C Bᵀ takes 1 product and each per-head product 2 (one
    # float32 operand split into hi + lo), at float32 all take 3
    need = ssd_scan.scan_flops(b, s, h, p, n, q, "bfloat16")
    k = (1, 2) if dtype_name == "bfloat16" else (3, 3)
    log_bound(f"ssd_chunk_scan [{dtype_name}] the design's (bf16 products: "
              f"C Bᵀ x{k[0]}, per head x{k[1]})", nbytes,
              k[0] * need["bfloat16"] + k[1] * need["float32"], "bfloat16")
    del xbc, x, bm, cm
    torch.cuda.empty_cache()


def ssd_bwd_design_flops(b: int, s: int, h: int, p: int, n: int, q: int,
                         dtype_name: str) -> int:
    """The operations kernel 8's design runs on the tensor cores, on
    whole 64 x 64 tiles (the chunk's Q/64 (Q/64 + 1)/2 tile pairs; N
    padded to 16), each product counted as many times as the design
    repeats it: dy·xᵀ once at bf16, the others twice (one split
    operand); all three times at float32.  The forward's rerun passes 1-3
    included (C Bᵀ and the chunk states)."""
    tq, chunks, np_ = q // 64, b * (s // q), -(-n // 16) * 16
    pairs = tq * (tq + 1) // 2
    one, two = (1, 2) if dtype_name == "bfloat16" else (3, 3)
    tile = 2 * 64 * 64
    per_chunk = pairs * tile * np_ * one + 2 * pairs * tile * np_ * two
    per_head = (pairs * tile * p * (one + two)      # dy·xᵀ, (dt ∘ M)ᵀ dy
                + 5 * 2 * q * np_ * p * two)        # the five state products
    return chunks * (per_chunk + h * per_head)


# the SSD-scan backward's tolerances per output, as max |kernel − plain|
# / max |plain|: dx, dB and dC as any output of the type (TOLERANCE); ddt
# in float32 whatever the type, 1e-4 (float32 sums over 256-token chunks,
# the states recomputed by the forward's bf16 hi + lo products, ~2^-16);
# dA 1e-3 (a sum over every token of dt·R whose terms cancel: two
# float32 runs of exact formulas differ by up to 1.5e-4 of it)
SSD_BWD_TOL = {"ddt": 1e-4, "dA": 1e-3}


def ssd_bwd_check(name: str, dtype_name: str, got, again, want):
    """Kernel 8's outputs against the plain version's, each to its own
    tolerance, and two launches bitwise equal; returns (max abs err,
    max rel err) over the outputs."""
    import torch
    err = worst = 0.0
    parts = []
    for out, g, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again, want,
                            strict=True):
        tol = SSD_BWD_TOL.get(out, TOLERANCE[dtype_name])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {out}: {g.shape}/{g.dtype} vs "
                                 f"plain {w.shape}/{w.dtype}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {out}: non-finite kernel output")
        d = (g.float() - w.float()).abs().max().item()
        rel = d / max(w.float().abs().max().item(), 1e-30)
        parts.append(f"{out}={rel:.3e} (tol {tol:.0e})")
        if rel > tol:
            raise AssertionError(f"{name} [{dtype_name}] {out}: max rel err "
                                 f"{rel:.3e} > {tol:.0e}")
        if not torch.equal(g, a):
            raise AssertionError(f"{name} [{dtype_name}] {out}: two "
                                 "launches differ")
        err, worst = max(err, d), max(worst, rel)
    log(f"kernel {name} [{dtype_name}] max_rel_err " + " ".join(parts)
        + "; two launches bitwise equal: True")
    return err, worst


def ssd_bwd_split(label: str, fn, reps: int) -> None:
    """Log each launch of one kernel-8 call ``fn`` apart: the forward's
    passes 1-3 that the wrapper reruns (``ssd_gram``, ``ssd_chunk_state``,
    ``ssd_state_pass``) and the backward's own launches (``ssd_bwd_*``),
    device times from ``torch.profiler``.  Each of them launches once a
    call, so a launch's time is its mean over the launches the profiler
    recorded; where it recorded fewer than ``reps``, the log says so."""
    rec = device_ms(fn, reps)
    parts = {n: ms * reps / k for n, (ms, k) in rec.items()}
    short = {n: k for n, (_, k) in rec.items() if k != reps}
    total = sum(parts.values())
    log(f"{label} per launch (torch.profiler, {reps} calls, sum "
        f"{total:.4f} ms): " + "; ".join(
            f"{n} {ms:.4f} ms ({ms / total:.1%})"
            for n, ms in sorted(parts.items(), key=lambda kv: -kv[1]))
        + (f"; launches recorded other than {reps}: {short}" if short
           else ""))


def ssd_bwd_inputs(b: int, dt, s: int = 4096, h: int = 32, n: int = 128,
                   p: int = 64):
    """Kernel 8's inputs on ``b`` lanes of ``s`` tokens, ``h`` heads of
    ``p`` and state ``n`` (by default one mamba2-370m layer's widths): x,
    B and C as column slices of one conv output at 0.5, dt =
    softplus(N(0, 1) − 2) float32, A = −exp(N(0, 0.3)), and a random
    output gradient dy, on the card from a generator of its own (seed 3);
    returns (x, dt, A, B, C, dy)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    xbc = (torch.randn((b, s, h * p + 2 * n), generator=gen, device=dev)
           * 0.5).to(dt)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dts = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev) - 2.0)
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.3)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dt)
    return x, dts, a, bm, cm, dy


# the float32 flash forward rows of ``ab_trace``: (label, B, S, Hq, Hkv,
# hd, causal) — the DiT joint attention, one yi-9b layer's causal GQA
# and dit-small's hd-16 shapes (``F32_HD16_ROWS``)
AB_F32_ROWS = (("DiT", 2, 4608, 24, 24, 128, False),
               ("causal gqa 32/4", 1, 4096, 32, 4, 128, True),
               ("hd16", 2, 4096, 8, 8, 16, False),
               ("hd16 16x1024", 16, 1024, 8, 8, 16, False),
               ("hd16 2x1600", 2, 1600, 8, 8, 16, False))


def ab_trace() -> None:
    """The pieces the float32 flash forward touches, for an A/B of two
    trees in one call; it checks nothing.  Kernel 3 in float32 at
    ``AB_F32_ROWS`` beside SDPA's float32 forward on the same inputs
    (CUDA events, 5 calls each); then dit-small's ``train_dit`` at latent
    128 (batch ``DIT_SMALL_TRAIN_BATCH``, ``DIT_SMALL_TRAIN_STEPS``
    steps: step walls and the last step's split) and
    ``launch.serve.main(DIT_SMALL_SERVE_ARGS)`` (each engine's wall and
    latency; the trained AdaLN-zero leaves redrawn as in the dit_small
    phase), in this fresh process.  It runs the kernel sources and the
    package of the tree it is imported from, so from the root of an
    earlier checkout (this file copied there) it measures that tree:
    ``python3 -c 'import chip_smoke; chip_smoke.ab_trace()'``."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, train
    from repro_torch.models import dit
    log(f"ab_trace: {nvidia_smi()}; build {build.build()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, s, hq, hkv, hd, causal in AB_F32_ROWS:
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
                for _ in "kv")
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        t_k = time_ms(lambda: fa.flash_attention(q, k, v, hq // hkv,
                                                 causal), 5)
        t_s = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=hkv != hq), 5)
        log(f"ab_trace flash_attention float32 {label} [{b}, {s}, "
            f"{hq}/{hkv}, {hd}] causal {causal}: kernel {t_k:.4f} ms, SDPA "
            f"{t_s:.4f} ms a call (CUDA events)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    cfg = configs.get_config("dit-small")
    params = dit.init_params(cfg, seed=83, device="cuda")
    redraw_zero_leaves(params, seed=84)
    records = []
    train.train_dit(cfg, DIT_SMALL_TRAIN_STEPS, DIT_SMALL_TRAIN_BATCH, "",
                    seed=85, log_every=DIT_SMALL_TRAIN_STEPS, size=128,
                    device="cuda", params=params,
                    on_step=lambda i, m, g: records.append(m))
    log("ab_trace dit_small train_dit at latent 128, batch "
        f"{DIT_SMALL_TRAIN_BATCH}: step walls (ms) "
        f"{[round(m['step_ms'], 2) for m in records]}, forward / backward "
        f"/ AdamW of the last {records[-1]['forward_ms']:.2f} / "
        f"{records[-1]['backward_ms']:.2f} / {records[-1]['adamw_ms']:.2f}")
    del params
    torch.cuda.empty_cache()
    real_train = serve.train_dit

    def train_redrawn(*a, **kw):
        trained = real_train(*a, **kw)
        with torch.no_grad():
            redraw_zero_leaves(trained, seed=89)
        return trained
    with mock.patch.object(serve, "train_dit", train_redrawn):
        res = serve.main(DIT_SMALL_SERVE_ARGS + ["--device", "cuda"])
    for name in ("freqca", "full"):
        run = res[name]
        log(f"ab_trace dit_small serve {name}: {len(run['outs'])} requests "
            f"in {run['wall']:.4f} s, latency p50/p95 "
            f"{run['summary']['request_latency_p50_s']:.4f}/"
            f"{run['summary']['request_latency_p95_s']:.4f} s")


# ``fwd_variants``: edits of flash_fwd_tf32.cuh, each compiled into a
# copy of the two float32 flash libraries.  "as built" is the source;
# the hd-16 row layouts (m16 tiles, warps, blocks an SM) and the split
# (common.cuh's cvt.rna form) it rejected; and two diagnostics that give
# wrong numbers: one TF32 product instead of three (the tensor cores'
# share) and no split (the splits' share)
FWD_VARIANTS = {
    "as built": (),
    "hd16 one m16 tile, 8 warps": (
        ("kMT = HD == 16 ? 2 : 1;", "kMT = 1;"),
        ("kWarps = HD == 16 ? 4 : 8;", "kWarps = 8;")),
    "hd16 two m16 tiles, 8 warps, 1 block": (
        ("kWarps = HD == 16 ? 4 : 8;", "kWarps = 8;"),
        ("kMinBlocks = HD == 16 ? 2 : 1;", "kMinBlocks = 1;")),
    "one product (diagnostic)": (
        ("  rt::mma_tf32(d, al, bh0, bh1);\n"
         "  rt::mma_tf32(d, ah, bl0, bl1);\n", ""),),
    "split by cvt.rna (rt::split)": (
        ("  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;",
         "  rt::split(v, hi, lo);"),),
    "no split (diagnostic)": (
        ("  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;",
         "  hi = __float_as_uint(v);\n  lo = hi;"),),
}


def fwd_variants(reps: int = 20) -> None:
    """Each of ``FWD_VARIANTS`` built beside the tree's own libraries
    (under ``build/fwd_variants/``) and timed in turn, twice, at
    ``AB_F32_ROWS`` with CUDA events; its max rel err against the plain
    version is logged beside (the diagnostics' are wrong by design).  It
    checks nothing: ``python3 -c 'import chip_smoke;
    chip_smoke.fwd_variants()'``."""
    import ctypes
    import shutil

    import torch

    from repro_torch.kernels import build, ref
    root = ROOT / "build" / "fwd_variants"
    shutil.rmtree(root, ignore_errors=True)
    csrc = build.CSRC
    base = (csrc / "flash_fwd_tf32.cuh").read_text()
    procs = {}
    for i, (name, edits) in enumerate(FWD_VARIANTS.items()):
        text = base
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"fwd_variants {name}: {old!r} absent")
            text = text.replace(old, new)
        d = root / str(i)
        shutil.copytree(csrc, d)
        (d / "flash_fwd_tf32.cuh").write_text(text)
        for lib in ("flash_attention", "flash_attention_f32"):
            procs[name, lib] = d / f"{lib}.so", subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, lib), (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"fwd_variants {name} {lib}:\n{out}")
        regs = re.findall(r"tf32_fwd_kernelILi(\d+)ELb0ELb0E.*?Used (\d+) "
                          r"registers", out, flags=re.S)
        log(f"fwd_variants {name}: {lib} registers (hd, unmasked) {regs}")
        libs[name, lib] = ctypes.CDLL(str(path))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for label, b, s, hq, hkv, hd, causal in AB_F32_ROWS:
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
                for _ in "kv")
        out = torch.empty_like(q)
        # the plain version of the causal row's 32 heads at 4096 is 2 GB
        # of logits: held on its last 512 queries
        tail = slice(-512, None) if causal else slice(None)
        want = (ref.sdpa_ref(q[:, tail], k, v, ref.attention_mask(
            s, s, True, 0, dev)[:, tail], hq // hkv) if causal
            else ref.attention_ref(q, k, v))
        for rnd in range(2):
            for name in FWD_VARIANTS:
                if hd == 16:
                    fn = libs[name, "flash_attention_f32"]
                    fn = fn.flash_attention_f32_fwd
                    fn.argtypes, fn.restype = [P] * 5 + [I] * 4 + [P], I
                    args = (b, s, s, hq, stream)
                else:
                    fn = libs[name, "flash_attention"].flash_attention_fwd
                    fn.argtypes, fn.restype = [P] * 5 + [I] * 9 + [P], I
                    args = (b, s, s, hq, hkv, hd, int(causal), 0, 0, stream)

                def call(fn=fn, args=args):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, *args)
                if call() != 0:
                    raise RuntimeError(f"fwd_variants {name}: launch")
                torch.cuda.synchronize()
                err = max_rel(out[:, tail], want)
                log(f"fwd_variants {label} [{b}, {s}, {hq}/{hkv}, {hd}] "
                    f"round {rnd} {name}: {time_ms(call, reps):.4f} ms, "
                    f"max rel err {err:.1e}")
        del q, k, v, out, want
        torch.cuda.empty_cache()


def ssd_bwd_rows(row, dt, dtype_name: str) -> None:
    """Kernel 8, the SSD-scan backward, at one mamba2-370m layer's shape
    (as ``ssd_rows``: x [2, 4096, 32, 64] and B, C [2, 4096, 128] as
    column slices of one conv output, dt float32, chunk 256) with a
    random output gradient, from its own generator: each output against
    the plain version (``SSD_BWD_TOL``), two launches bitwise equal.
    The bound counts ``ssd_scan.scan_bwd_flops`` at the bf16 tensor-core
    peak (the least the card could take, where this design runs every
    product);
    the design's own count (``ssd_bwd_design_flops``: split products
    repeated, whole tiles) is logged beside it, and each launch's device
    time (``ssd_bwd_split``).  No single PyTorch call computes the
    gradients (library null); as a yardstick only, autograd of the plain
    forward is timed and logged.  Then ``ops.ssd`` under autograd: one
    forward and one backward launch."""
    import torch

    from repro_torch.kernels import ops, ref, ssd_scan
    es = torch.finfo(dt).bits // 8
    b, s, h, p, n, q = 2, 4096, 32, 64, 128, 256
    x, dts, a, bm, cm, dy = ssd_bwd_inputs(b, dt)
    name = "ssd_chunk_scan_bwd"

    def kern():
        return ssd_scan.ssd_chunk_scan_bwd(x, dts, a, bm, cm, dy, q)

    def plain():
        return ref.ssd_chunk_scan_bwd_ref(x, dts, a, bm, cm, dy, q)
    checked = ssd_bwd_check(name, dtype_name, kern(), kern(), plain())
    torch.cuda.empty_cache()
    work, nbytes = ssd_scan.bwd_work(b, s, h, p, n, q, es)
    need = work["bfloat16"]
    row(name, dtype_name, kern, plain, nbytes, {"bfloat16": need}, reps=5,
        checked=checked)
    ssd_bwd_split(f"kernel {name} [{dtype_name}]", kern, 5)
    log_bound(f"{name} [{dtype_name}] the design's (bf16 products: dy·xᵀ "
              f"x{1 if dtype_name == 'bfloat16' else 3}, the others "
              f"x{2 if dtype_name == 'bfloat16' else 3}, on whole tiles)",
              nbytes, ssd_bwd_design_flops(b, s, h, p, n, q, dtype_name),
              "bfloat16")
    leaves = [t.detach().clone().requires_grad_() for t in (x, dts, a, bm, cm)]

    def autograd_plain():
        y = ref.ssd_chunk_scan_ref(*leaves, q)
        return torch.autograd.grad(y, leaves, dy)
    t_fwd = time_ms(lambda: ref.ssd_chunk_scan_ref(*leaves, q), 2)
    t_both = time_ms(autograd_plain, 2)
    log(f"kernel {name} [{dtype_name}] yardstick only: autograd of the "
        f"plain forward {t_both - t_fwd:.4f} ms (forward {t_fwd:.4f} ms, "
        f"forward + backward {t_both:.4f} ms)")
    ops.reset_launch_counts()
    y = ops.ssd(*leaves, q)
    y.backward(dy)
    counts = ops.launch_counts()
    if counts["ssd_chunk_scan"] != 1 or counts["ssd_chunk_scan_bwd"] != 1:
        raise AssertionError(f"{name}: ops.ssd under autograd launched "
                             f"{counts}")
    del x, bm, cm, dy, leaves, y
    torch.cuda.empty_cache()


# one jamba-1.5-large layer's SSD scan: 128 heads of 128 (d_inner 16384),
# state 128, chunk 256, one lane of 4096 tokens
JAMBA_SSD_SHAPE = (1, 4096, 128, 128, 128, 256)


def ssd_jamba_rows(row, dt, dtype_name: str) -> None:
    """Kernels 6 and 8 at one jamba layer's shape (``JAMBA_SSD_SHAPE``:
    heads of 128, which the wrappers run as two heads of 64 each), x, B
    and C column slices of one conv output, from ``ssd_bwd_inputs``:
    each against its plain version (kernel 8 per output, ``SSD_BWD_TOL``,
    two launches bitwise), timed, with the bounds of ``ssd_scan.fwd_work`` and
    ``bwd_work`` at the bf16 tensor-core peak, as the mamba2 rows
    count them; kernel 8's launches timed apart."""
    import torch

    from repro_torch.kernels import ref, ssd_scan
    es = torch.finfo(dt).bits // 8
    b, s, h, p, n, q = JAMBA_SSD_SHAPE
    x, dts, a, bm, cm, dy = ssd_bwd_inputs(b, dt, s, h, n, p)
    work, nbytes = ssd_scan.fwd_work(b, s, h, p, n, q, es)
    row("ssd_chunk_scan[jamba]", dtype_name,
        lambda: ssd_scan.ssd_chunk_scan(x, dts, a, bm, cm, q),
        lambda: ref.ssd_chunk_scan_ref(x, dts, a, bm, cm, q),
        nbytes, work, reps=5)
    name = "ssd_chunk_scan_bwd[jamba]"

    def kern():
        return ssd_scan.ssd_chunk_scan_bwd(x, dts, a, bm, cm, dy, q)

    def plain():
        return ref.ssd_chunk_scan_bwd_ref(x, dts, a, bm, cm, dy, q)
    checked = ssd_bwd_check(name, dtype_name, kern(), kern(), plain())
    torch.cuda.empty_cache()
    work, nbytes = ssd_scan.bwd_work(b, s, h, p, n, q, es)
    row(name, dtype_name, kern, plain, nbytes, work, reps=5,
        checked=checked)
    ssd_bwd_split(f"kernel {name} [{dtype_name}]", kern, 5)
    del x, dts, a, bm, cm, dy
    torch.cuda.empty_cache()


def redraw_zero_leaves(params, seed: int, std: float = 0.02):
    """Give the zero-initialised leaves (a DiT's AdaLN-zero ``mod`` and
    ``final_mod``, and ``final_proj`` of a DiT or a backbone denoiser)
    random values.  The reference initialises them to zero, which makes
    every DiT block an identity and the velocity exactly zero; with
    random weights and no trained checkpoint, redrawing them is what
    makes the blocks and the velocity non-trivial, so the run exercises
    the model."""
    import torch
    leaves = []
    if "final_mod" in params:
        leaves += [params["final_mod"]["kernel"], params["final_mod"]["bias"]]
    leaves.append(params["final_proj"])
    for layer in params.get("single", []):
        leaves += [layer["mod"]["kernel"], layer["mod"]["bias"]]
    for layer in params.get("double", []):
        for s in ("img", "txt"):
            leaves += [layer[s]["mod"]["kernel"], layer[s]["mod"]["bias"]]
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen,
                               device=leaf.device) * std)


def make_fns(params, cfg, side: int, text=None):
    from repro_torch.models import dit

    def full_fn(x, t):
        out = dit.dit_forward(params, x, t.expand(x.shape[0]), cfg,
                              None if text is None else text[:x.shape[0]])
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
                counts = ops.launch_counts()
                if dev == "cuda" and min(counts[k] for k in SERVE_KERNELS) < 1:
                    raise AssertionError(f"reference run skipped a kernel: "
                                         f"{counts}")
        slo_reference(cfg, text_cpu, side, devices)
    finally:
        dit._FLASH_MIN_SEQ = saved
    for method in ("dct", "fft"):
        want, got = latents[0, method], latents[1, method]
        rel = ((got - want).norm() / want.norm()).item()
        log(f"reference [{method}] card vs CPU: rel L2 {rel:.3e} "
            "(tol 1e-4)")
        if not torch.isfinite(got).all() or rel > 1e-4:
            raise AssertionError(f"reference [{method}]: rel L2 {rel:.3e}")
    legacy_reference(devices)
    backbone_reference(devices)
    lm_reference(devices)
    train_reference(devices)
    lm_train_reference(devices)


def slo_reference(cfg, text_cpu, side: int,
                  devices=("cpu", "cuda")) -> None:
    """The error-budget path where it caches: the reference phase's small
    DiT, its zero-initialised leaves redrawn with std 5e-4 (the flux1-dev
    run's band rates exceed every tier, so its eb lanes never cache),
    serves one FreqCa and one ``freqca_eb`` request (``max_error`` 0.2)
    in one mixed-policy batch on each device.  Card and CPU must agree:
    per-request full steps and budget events exactly, realized error and
    latents to 1e-4 relative; every spend the budget is held against
    sits at least ``SLO_TIER_MARGIN`` of it clear, so the float32
    threshold cannot tie."""
    import torch

    from repro_torch.core.policies import (FreqCaErrorBudgetPolicy,
                                           FreqCaPolicy)
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    params_cpu = dit.init_params(cfg, seed=3, device="cpu")
    redraw_zero_leaves(params_cpu, seed=7, std=5e-4)
    text_one = text_cpu[:1].expand(2, -1, -1)   # one prompt, both lanes
    fq = FreqCaPolicy(interval=3, method="dct", rho=0.125)
    eb = FreqCaErrorBudgetPolicy(method="dct", rho=0.125)
    spends, decide = [], FreqCaErrorBudgetPolicy.decide

    def spy(self, state, ctx):
        spend = state.acc + (state.rate_low + state.rate_high)
        spends.extend((v, self.budget) for v, n in zip(
            spend.tolist(), state.n_valid.tolist(), strict=True)
            if n >= self.needed_history + 1)
        return decide(self, state, ctx)
    out = {}
    FreqCaErrorBudgetPolicy.decide = spy
    try:
        for dev in devices:
            full_fn, from_crf_fn = make_fns(_to(params_cpu, dev), cfg, side,
                                            text_one.to(dev))
            eng = DiffusionEngine(full_fn, from_crf_fn, (side, side, 16),
                                  ((side // 2) ** 2, cfg.d_model), fq,
                                  n_steps=10, max_batch=2,
                                  group_policies=False, device=dev)
            ops.reset_launch_counts()
            res = eng.run_batch([
                DiffusionRequest(request_id=0, seed=8),
                DiffusionRequest(request_id=1, seed=9, policy=eb,
                                 max_error=0.2)])
            counts = ops.launch_counts()
            if dev == "cuda" and min(counts[k] for k in SERVE_KERNELS) < 1:
                raise AssertionError(f"reference slo run skipped a kernel: "
                                     f"{counts}")
            out[dev] = {r.request_id: r for r in res}
    finally:
        FreqCaErrorBudgetPolicy.decide = decide
    margin = min(abs(v - b) / b for v, b in spends)
    (want, got) = (out[d] for d in devices)
    eb_err = (abs(got[1].realized_error - want[1].realized_error)
              / want[1].realized_error)
    lat = max(rel_l2(got[i].latents, want[i].latents) for i in (0, 1))
    full = [[r[i].n_full_steps for i in (0, 1)] for r in (got, want)]
    log(f"reference slo (freqca + freqca_eb at max_error 0.2, mixed "
        f"batch) card vs CPU: full steps {full[0]} / {full[1]}, budget events "
        f"{got[1].budget_events} / {want[1].budget_events}, realized "
        f"{got[1].realized_error:.6f} / {want[1].realized_error:.6f} (rel "
        f"diff {eb_err:.2e}), latents rel L2 {lat:.2e} (tol 1e-4); spends "
        f"at least {margin:.3f} of the budget clear of it")
    if (margin < SLO_TIER_MARGIN or want[1].budget_events < 1
            or want[1].n_full_steps >= 10
            or full[0] != full[1]
            or got[1].budget_events != want[1].budget_events
            or not eb_err <= 1e-4 or not lat <= 1e-4
            or not want[1].realized_error <= 0.2 + 1e-6):
        raise AssertionError("reference slo: card and CPU disagree, or the "
                             "run does not exercise the budget")


def full_steps(n_steps: int, interval: int) -> int:
    """A FreqCa request's full steps: every ``interval``-th, and the
    first three (the history its Hermite forecast needs)."""
    return len([i for i in range(n_steps) if i % interval == 0 or i < 3])


def rel_l2(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


def backbone_reference(devices=("cpu", "cuda")) -> None:
    """Two layers of mamba2-370m at full width (d 1024, 32 SSD heads of
    64, d_state 128), float32, as the denoiser over a 64x64x4 latent (S
    1024: four chunks of 256), on the card (the SSD kernel in each
    layer) against the CPU (its plain version); rel L2 1e-4."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import common, dit
    cfg = dataclasses.replace(configs.get_config("mamba2-370m"), n_layers=2,
                              dtype="float32")
    params_cpu = common.init_params(dit.backbone_denoiser_specs(cfg), seed=10,
                                    device="cpu")
    params_cpu["final_proj"].normal_(0.0, 0.02,
                                     generator=torch.Generator()
                                     .manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    lat = torch.randn((1, 64, 64, 4), generator=gen)
    t = torch.tensor([0.7])
    outs = {}
    for dev in devices:
        ops.reset_launch_counts()
        out = dit.backbone_denoiser_forward(_to(params_cpu, dev), lat.to(dev),
                                            t.to(dev), cfg)
        outs[dev] = out
        n = ops.launch_counts()["ssd_chunk_scan"]
        if torch.device(dev).type == "cuda" and n != cfg.n_layers:
            raise AssertionError(f"backbone reference: {n} SSD launches, "
                                 f"expected {cfg.n_layers}")
    want, got = outs[devices[0]], outs[devices[1]]
    for name in ("velocity", "crf"):
        rel = rel_l2(getattr(got, name), getattr(want, name))
        log(f"reference mamba2-370m x2 backbone [{name}] card vs CPU: rel L2 "
            f"{rel:.3e} (tol 1e-4)")
        if not torch.isfinite(getattr(got, name)).all() or rel > 1e-4:
            raise AssertionError(f"backbone reference [{name}]: {rel:.3e}")


def lm_params(cfg, n_layers: int, seed: int, device: str):
    """Random params of ``cfg`` cut to its first ``n_layers`` layers,
    drawn from the full depth's distribution (the reference's fan-in rule
    gives the stacked attention leaves std 1/sqrt(n_layers))."""
    import torch

    from repro_torch.models import common, transformer
    specs = transformer.lm_specs(cfg)
    specs["stack"] = specs["stack"][:n_layers]
    return common.init_params(specs, seed=seed, device=device,
                              dtype=getattr(torch, cfg.dtype))


def lm_reference(devices=("cpu", "cuda")) -> None:
    """Two layers of a yi-9b-shaped config (d 4096, 32 query heads on 4
    kv heads of 128, d_ff 11008; vocabulary cut to 8192), float32,
    through ``transformer.forward`` at 2048 tokens, so that every
    attention takes the causal GQA flash route on the card; against the
    CPU (blockwise attention); rel L2 1e-3.  The looser bound is the
    model's conditioning, not the kernel's (whose float32 rows hold it
    to ~3e-7 of its plain version): drawn as the full 48-layer model is,
    the stacked attention projections have std 1/sqrt(48) (the
    reference's fan-in rule), so at d 4096 the logits are large (the
    check logs the first layer's largest) and a softmax that sharp turns
    float32 summation-order differences of the card and the CPU into
    ~1e-4 of each layer's output.  A control, the card's forward with
    TF32 matmuls, must fail the limit (on an H100 80GB HBM3: 3.6e-2,
    against the float32 route's 1.35e-4; 3.7e-4 while the card computed
    its own RoPE frequencies)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    full = dataclasses.replace(configs.get_config("yi-9b"), vocab_size=8192,
                               dtype="float32")
    cfg = dataclasses.replace(full, n_layers=2)
    params_cpu = lm_params(full, 2, seed=13, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048),
                           generator=torch.Generator().manual_seed(14))
    outs = {}
    for dev in devices:
        ops.reset_launch_counts()
        params = _to(params_cpu, dev)
        outs[dev] = transformer.forward(params, tokens.to(dev), cfg)
        n = ops.launch_counts()["flash_attention"]
        if torch.device(dev).type == "cuda" and n != cfg.n_layers:
            raise AssertionError(f"lm reference: {n} flash launches, "
                                 f"expected {cfg.n_layers}")
    # a control for the limit: the card's forward again with TF32 matmuls
    # (products of operands rounded to 10 mantissa bits)
    control = None
    if torch.device(devices[1]).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = transformer.forward(params, tokens.to(devices[1]), cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    del params
    # the first layer's logits, head 0, the first 256 queries
    from repro_torch.models import attention, common
    layer = params_cpu["stack"][0]["l0"]
    x = common.rmsnorm(layer["norm1"],
                       common.embed(params_cpu["embed"], tokens))
    q, k, _ = attention._qkv(layer["attn"], x, cfg,
                             torch.arange(2048).expand(1, 2048))
    logits = q[0, :256, 0] @ k[0, :, 0].T / cfg.head_dim ** 0.5
    log(f"reference yi-9b x2: layer-0 logits (head 0, 256 queries) max |.| "
        f"{logits.abs().max().item():.1f}, std {logits.std().item():.1f}")
    want, got = outs[devices[0]], outs[devices[1]]
    for name in ("logits", "crf"):
        rel = rel_l2(getattr(got, name), getattr(want, name))
        ctrl = (None if control is None else
                rel_l2(getattr(control, name), getattr(want, name)))
        log(f"reference yi-9b x2 forward at S=2048 [{name}] card vs CPU: rel "
            f"L2 {rel:.3e} (tol 1e-3)" + ("" if ctrl is None else
                                          f", the TF32 control: {ctrl:.3e}"))
        if not torch.isfinite(getattr(got, name)).all() or rel > 1e-3:
            raise AssertionError(f"lm reference [{name}]: {rel:.3e}")
        # the limit must tell the float32 route from a lower-precision one
        if ctrl is not None and not ctrl > 1e-3:
            raise AssertionError(f"lm reference [{name}]: the TF32 control "
                                 f"{ctrl:.3e} passes the 1e-3 limit")


def train_reference(devices=("cpu", "cuda")) -> None:
    """One DiT training step on the card (the flash forward and backward
    kernels in every layer) against the same step on the CPU (autograd
    through the plain attention): a small DiT at S 1024 (latent
    64x64x16, patch 2; d 256, 4 heads of 64, 2 single blocks, d_ff 1024),
    bf16 activations over float32 parameters, one ``rf_loss`` gradient on
    a shapes batch of two with the same t and noise on both devices, then
    one AdamW update (lr 1e-3, no warmup).  Tolerances: the loss 1e-2
    relative; each gradient leaf and each updated parameter 3e-2
    relative L2 (bf16 dense layers, attention and their transposes
    summed in other orders on the two devices).  The update itself is
    logged, not held: AdamW's first step is ~lr·sign(g), and where a
    gradient entry is near 0 its sign differs between the devices.  So
    every leaf that initialises to zero (the AdaLN-zero leaves, the final
    projection, the dense biases) is redrawn with std 0.02: a zero leaf's
    updated value would be that step alone, its sign flips unscaled."""
    import torch

    from repro_torch.checkpointing import checkpoint
    from repro_torch.configs.base import DiTConfig
    from repro_torch.data import synthetic
    from repro_torch.diffusion import training
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    from repro_torch.optim import adamw
    cfg = DiTConfig(arch_id="train-smoke", n_layers=2, d_model=256,
                    n_heads=4, d_ff=1024, patch_size=2, in_channels=16,
                    dtype="bfloat16")
    side = 64
    params_cpu = dit.init_params(cfg, seed=50, device="cpu",
                                 dtype=torch.float32)
    gen = torch.Generator().manual_seed(51)
    for p in adamw.leaves(params_cpu):
        if not p.any():
            p.normal_(0.0, 0.02, generator=gen)
    latents = synthetic.shapes_batch(gen, 2, size=side, channels=16)
    t = torch.sigmoid(torch.randn((2,), generator=gen))
    noise = torch.randn(latents.shape, generator=gen)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                                weight_decay=1e-4)
    out = {}
    for dev in devices:
        params = adamw.tree_map(
            lambda p, dev=dev: p.to(dev, copy=True).requires_grad_(True),
            params_cpu)
        ops.reset_launch_counts()
        loss, _ = training.rf_loss(
            lambda p, x, tt: dit.dit_forward(p, x, tt, cfg).velocity, params,
            {"latents": latents.to(dev)}, t=t.to(dev), noise=noise.to(dev))
        loss.backward()
        grads = adamw.tree_map(lambda p: p.grad, params)
        adamw.update(opt_cfg, grads, adamw.init(opt_cfg, params), params)
        counts = ops.launch_counts()
        if torch.device(dev).type == "cuda" and not (
                counts["flash_attention"] == counts["flash_attention_bwd"]
                == cfg.n_layers):
            raise AssertionError(f"train reference: launches {counts}, "
                                 f"expected {cfg.n_layers} forward and "
                                 "backward flash launches")
        flat = checkpoint._flatten_with_paths
        out[dev] = (loss.item(),
                    {k: g.cpu() for k, g in flat(grads).items()},
                    {k: p.detach().cpu() for k, p in flat(params).items()})
    (l_want, g_want, p_want), (l_got, g_got, p_got) = (out[d]
                                                       for d in devices)
    before = checkpoint._flatten_with_paths(params_cpu)
    loss_rel = abs(l_got - l_want) / abs(l_want)

    def worst(rels):
        k = max(rels, key=rels.get)
        return rels[k], k
    grad_rel = worst({k: rel_l2(g_got[k], g_want[k]) for k in g_want})
    param_rel = worst({k: rel_l2(p_got[k], p_want[k]) for k in p_want})
    step_rel = worst({k: rel_l2(p_got[k] - before[k], p_want[k] - before[k])
                      for k in p_want})
    finite = all(bool(torch.isfinite(g).all()) for g in g_got.values())
    log(f"reference train step (DiT d 256, S 1024, bf16 over float32 "
        f"params) card vs CPU: loss {l_got:.6f} / {l_want:.6f} (rel "
        f"{loss_rel:.2e}, tol 1e-2); worst gradient leaf rel L2 "
        f"{grad_rel[0]:.2e} ({grad_rel[1]}; tol 3e-2) over {len(g_got)} "
        f"leaves; worst updated parameter rel L2 {param_rel[0]:.2e} "
        f"({param_rel[1]}; tol 3e-2); worst AdamW step rel L2 "
        f"{step_rel[0]:.2e} ({step_rel[1]}; logged)")
    grad_rel, param_rel = grad_rel[0], param_rel[0]
    if not (finite and loss_rel <= 1e-2 and grad_rel <= 3e-2
            and param_rel <= 3e-2):
        raise AssertionError("train reference: card and CPU disagree")


def lm_train_reference(devices=("cpu", "cuda")) -> None:
    """One LM training step of each backbone on the card (its kernels
    forward and backward, every layer rematerialised) against the same
    step on the CPU (autograd through the plain versions), then one AdamW
    update (lr 1e-3, no warmup), on a Markov token batch of one sequence
    of 2048 tokens, so that every layer takes its kernel route:

    - mamba2-370m, 2 layers at full width (d 1024, 32 SSD heads of 64,
      d_state 128, chunk 256; vocabulary cut to 8192), float32: the SSD
      scan's float32 forward and backward kernels.  Tolerances: the loss
      1e-4 relative, each gradient leaf 1e-3 relative L2 (float32 dense
      layers summed in other orders; the kernels' own outputs within
      1e-4 of their plain versions);
    - yi-9b, 2 layers at full width (d 4096, 32 query heads on 4 kv heads
      of 128; d_ff cut to 2048 and the vocabulary to 8192), bf16
      activations over float32 parameters: the causal GQA flash forward
      and backward.  Its attention projections are drawn with std
      1/sqrt(fan-in): drawn as the 48-layer model's (std 1/sqrt(48), the
      reference's rule for stacked 4-D leaves), the logits' std is ~84
      and the softmax so sharp that bf16 rounding alone moves a gradient
      leaf by O(1) (the first run of this check: 0.30 relative L2 card
      vs CPU on layer 0's norm1 scale, the losses 1.3e-4 apart).
      Tolerances: the loss 1e-2; each gradient leaf 5e-2, since the
      CPU's bf16 step alone lies some 2.5e-2 from its float32 step
      (logged each run as the control) and two bf16 runs that round in
      other places can lie ~1.4x that apart.

    Each updated parameter is held to 3e-2 relative L2 (AdamW's first
    step is ~lr·sign(g), which flips where a gradient entry is near 0;
    the zero-initialised leaves are redrawn with std 0.02, as in
    ``train_reference``).  Launches on the card: two forward launches of
    the layer's kernel and one backward per layer."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.checkpointing import checkpoint
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import common, transformer
    from repro_torch.optim import adamw
    cases = (
        ("mamba2-370m", dataclasses.replace(
            configs.get_config("mamba2-370m"), n_layers=2, vocab_size=8192,
            dtype="float32"), ("ssd_chunk_scan", "ssd_chunk_scan_bwd"),
         (1e-4, 1e-3)),
        ("yi-9b", dataclasses.replace(configs.get_config("yi-9b"), n_layers=2,
                                      vocab_size=8192, d_ff=2048),
         ("flash_attention", "flash_attention_bwd"), (1e-2, 5e-2)))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    flat = checkpoint._flatten_with_paths

    def step(params_cpu, data, cfg, dev):
        params = adamw.tree_map(
            lambda p: p.to(dev, copy=True).requires_grad_(True), params_cpu)
        ops.reset_launch_counts()
        loss, _ = transformer.loss_fn(
            params, {k: v.to(dev) for k, v in data.items()}, cfg)
        loss.backward()
        grads = adamw.tree_map(lambda p: p.grad, params)
        adamw.update(opt_cfg, grads, adamw.init(opt_cfg, params), params)
        return (loss.item(), {k: g.cpu() for k, g in flat(grads).items()},
                {k: p.detach().cpu() for k, p in flat(params).items()},
                ops.launch_counts())

    def worst(rels):
        k = max(rels, key=rels.get)
        return rels[k], k
    for seed, (arch, cfg, kernels, (l_tol, g_tol)) in enumerate(cases,
                                                                start=60):
        params_cpu = common.init_params(transformer.lm_specs(cfg), seed=seed,
                                        device="cpu")
        gen = torch.Generator().manual_seed(seed + 10)
        for p in adamw.leaves(params_cpu):
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
        for group in params_cpu["stack"]:
            for w in group["l0"].get("attn", {}).values():
                w.copy_(torch.randn(w.shape, generator=gen)
                        / w.shape[0] ** 0.5)
        data = synthetic.lm_batch(gen, 1, 2048, cfg.vocab_size)
        out = {}
        for dev in devices:
            out[dev] = step(params_cpu, data, cfg, dev)
            counts = out[dev][3]
            want = {kernels[0]: 2 * cfg.n_layers, kernels[1]: cfg.n_layers}
            if torch.device(dev).type == "cuda" and (
                    any(counts[k] != n for k, n in want.items())
                    or sum(counts.values()) != sum(want.values())):
                raise AssertionError(f"lm train reference {arch}: launches "
                                     f"{counts}, expected {want}")
        (l_want, g_want, p_want, _), (l_got, g_got, p_got, _) = (
            out[d] for d in devices)
        loss_rel = abs(l_got - l_want) / abs(l_want)
        grad_rel = worst({k: rel_l2(g_got[k], g_want[k]) for k in g_want})
        param_rel = worst({k: rel_l2(p_got[k], p_want[k]) for k in p_want})
        control = ""
        if cfg.dtype != "float32":
            # the control: the CPU's own step in float32
            g32 = step(params_cpu, data,
                       dataclasses.replace(cfg, dtype="float32"),
                       devices[0])[1]
            c = worst({k: rel_l2(g_want[k], g32[k]) for k in g32})
            control = (f"; the control, the CPU's {cfg.dtype} step against "
                       f"its float32 step: worst leaf {c[0]:.2e} ({c[1]})")
        finite = all(bool(torch.isfinite(g).all()) for g in g_got.values())
        log(f"reference lm train step ({arch}, {cfg.n_layers} layers, d "
            f"{cfg.d_model}, {cfg.dtype}, S 2048) card vs CPU: loss "
            f"{l_got:.6f} / {l_want:.6f} (rel {loss_rel:.2e}, tol "
            f"{l_tol:.0e}); worst gradient leaf rel L2 {grad_rel[0]:.2e} "
            f"({grad_rel[1]}; tol {g_tol:.0e}) over {len(g_got)} leaves; "
            f"worst updated parameter rel L2 {param_rel[0]:.2e} "
            f"({param_rel[1]}; tol 3e-2)" + control)
        if not (finite and loss_rel <= l_tol and grad_rel[0] <= g_tol
                and param_rel[0] <= 3e-2):
            raise AssertionError(f"lm train reference {arch}: card and CPU "
                                 "disagree")


def legacy_loop(full_fn, from_crf_fn, x0, ts, policy, crf_shape):
    """Euler sampling driven by the legacy function-style cache API
    (``kind="freqca"``, ``low_order=0``): ``update`` on activated steps
    (the band-split kernel on the card), and on cached steps the fused
    legacy step ``ops.freqca_predict`` (the plain version on the CPU).
    Returns ``(x, full steps)``."""
    from repro_torch.core import cache
    from repro_torch.kernels import ops
    state = cache.init_state(policy, crf_shape, device=x0.device)
    x, n_full = x0, 0
    for i in range(ts.shape[0] - 1):
        t_now, t_next = ts[i], ts[i + 1]
        if bool(cache.should_activate(policy, state, i)):
            v, crf = full_fn(x, t_now)
            state = cache.update(policy, state, crf, t_now)
            n_full += 1
        else:
            crf_hat = ops.freqca_predict(state.low_hist[-1], state.high_hist,
                                         state.ts_high, t_now,
                                         policy.high_order)
            v = from_crf_fn(crf_hat, t_now)
        x = x + (t_next - t_now).to(x.dtype) * v.to(x.dtype)
    return x, n_full


def legacy_reference(devices=("cpu", "cuda")) -> None:
    """dit-small (S = 256, D = 128) sampled through the legacy API on
    the card, with the band-split and fused legacy-step kernels, agrees
    with the same loop on the CPU through the plain versions."""
    import torch

    from repro_torch import configs
    from repro_torch.core import cache
    from repro_torch.diffusion import schedule
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    cfg, side = configs.get_config("dit-small"), 32
    crf_shape = (2, (side // cfg.patch_size) ** 2, cfg.d_model)
    params_cpu = dit.init_params(cfg, seed=6, device="cpu")
    redraw_zero_leaves(params_cpu, seed=7)
    x0_cpu = torch.randn((2, side, side, cfg.in_channels),
                         generator=torch.Generator().manual_seed(8))
    out = {}
    for idx, dev in enumerate(devices):
        full_fn, from_crf_fn = make_fns(_to(params_cpu, dev), cfg, side)
        for method in ("dct", "fft"):
            policy = cache.CachePolicy(kind="freqca", interval=3,
                                       method=method, rho=0.125)
            ops.reset_launch_counts()
            x, n_full = legacy_loop(full_fn, from_crf_fn, x0_cpu.to(dev),
                                    schedule.timesteps(10, device=dev),
                                    policy, crf_shape)
            out[idx, method] = x.cpu(), n_full
            counts = ops.launch_counts()
            if dev == "cuda" and min(counts["token_basis_matmul"],
                                     counts["freqca_predict_fused"]) < 1:
                raise AssertionError(f"legacy reference skipped a kernel: "
                                     f"{counts}")
    for method in ("dct", "fft"):
        (want, n_want), (got, n_got) = out[0, method], out[1, method]
        rel = ((got - want).norm() / want.norm()).item()
        log(f"reference legacy freqca [{method}] dit-small card vs CPU: "
            f"rel L2 {rel:.3e} (tol 1e-4), full steps {n_got}/{n_want} "
            "of 10")
        if not torch.isfinite(got).all() or rel > 1e-4 or n_got != n_want:
            raise AssertionError(f"legacy reference [{method}]: rel L2 "
                                 f"{rel:.3e}, full steps {n_got} vs "
                                 f"{n_want}")


def _to(tree, dev, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _to(v, dev, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev, copy) for v in tree]
    return tree.to(dev, copy=copy)


def flux_model(cfg=None, side: int = 128, device: str = "cuda") -> dict:
    """flux1-dev at full width, bf16, 1024² (latent 128x128x16, CRF
    4096x3072), random weights from a seed: built once, shared by the
    analysis and serve phases."""
    import torch

    from repro_torch import configs
    from repro_torch.models import dit
    cfg = cfg or configs.get_config("flux1-dev")
    t0 = time.perf_counter()
    params = dit.init_params(cfg, seed=0, device=device)
    redraw_zero_leaves(params, seed=1)
    n_params = sum(p.numel() for p in _leaves(params))
    text = torch.randn((2, cfg.n_text_tokens, cfg.text_dim), device=device,
                       generator=torch.Generator(device=device)
                       .manual_seed(2)).to(dit.torch_dtype(cfg.dtype))
    log(f"model: {cfg.arch_id} params {n_params / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    full_fn, from_crf_fn = make_fns(params, cfg, side, text)
    return dict(cfg=cfg, side=side, device=device, text=text, params=params,
                full_fn=full_fn, from_crf_fn=from_crf_fn,
                crf_shape=((side // cfg.patch_size) ** 2, cfg.d_model))


FIG2_INTERVALS = (1, 2, 4, 8)
FIG2_BANDS = [(m, r) for m in ("dct", "fft") for r in (0.0625, 0.25)]


def fig2_stats(crfs, split) -> dict:
    """The paper's Fig-2 statistics over a CRF trajectory ``[T, B, S,
    D]``, with the arithmetic of ``benchmarks/fig2_freq_analysis.py``:
    per (method, rho), the mean temporal cosine similarity of each band
    at intervals 1, 2, 4, 8, and each band's continuity ratio
    ||second difference|| / ||first difference|| (differences taken in
    float32); also the low band's share of the energy over the
    trajectory.  ``split(z, rho, method) -> (low, high)``."""
    import torch

    from repro_torch.core import frequency
    t = crfs.shape[0]
    out = {}
    for method, rho in FIG2_BANDS:
        lows, highs = zip(*(split(crfs[i], rho, method) for i in range(t)))
        stats = {}
        for band, series in (("low", lows), ("high", highs)):
            for k in FIG2_INTERVALS:
                sims = [frequency.cosine_similarity(series[i],
                                                    series[i + k]).item()
                        for i in range(0, t - k, max(1, (t - k) // 8))]
                stats[f"sim_{band}@{k}"] = sum(sims) / len(sims)
            f = [s.float() for s in series]
            n1 = sum((f[i + 1] - f[i]).square().sum() for i in range(t - 1))
            n2 = sum((f[i + 2] - 2 * f[i + 1] + f[i]).square().sum()
                     for i in range(t - 2))
            stats[f"cont_{band}"] = (torch.sqrt(n2)
                                     / torch.clamp(torch.sqrt(n1),
                                                   min=1e-9)).item()
            del f
        e_low = sum(x.float().square().sum() for x in lows)
        e_high = sum(x.float().square().sum() for x in highs)
        stats["low_energy_share"] = (e_low / (e_low + e_high)).item()
        out[method, rho] = stats
        del lows, highs
    return out


def analysis_phase(model: dict, n_steps: int) -> dict:
    """The paper's frequency analysis and the legacy cache API at the
    model's width: the uncached trajectory of two lanes, its Fig-2
    statistics through ``frequency.decompose`` (the band-split kernel
    on the card) held against the same statistics from the plain
    transform route, then ``freqca`` (dct, fft), ``taylorseer`` and
    ``fora`` over that trajectory, each cached ``freqca`` step also
    through the fused legacy step.  Returns the phase's launch
    counts."""
    import torch

    from repro_torch.core import cache, frequency
    from repro_torch.diffusion import sampler, schedule
    from repro_torch.kernels import ops, ref
    dev, side, cfg = model["device"], model["side"], model["cfg"]
    x0 = torch.randn((2, side, side, cfg.in_channels), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    ts = schedule.timesteps(n_steps, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, crfs = sampler.reference_features(model["full_fn"], x0, ts)
    if not torch.isfinite(crfs).all():
        raise AssertionError("analysis: non-finite CRFs")
    log(f"analysis: reference trajectory {tuple(crfs.shape)} "
        f"{crfs.dtype} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kern = fig2_stats(crfs, lambda z, rho, m: frequency.decompose(z, rho, m))
    t_kern = time.perf_counter() - t0
    plain = fig2_stats(crfs, ref.band_split_ref)
    diff = max(abs(kern[b][k] - plain[b][k]) for b in kern for k in kern[b])
    for (method, rho), stats in kern.items():
        log(f"analysis fig2 [{method} rho={rho}] " + " ".join(
            f"{k}={v:.4f}" for k, v in stats.items()))
    log(f"analysis fig2: {t_kern:.1f} s; kernel vs plain route: max |diff| "
        f"{diff:.2e} over {sum(len(v) for v in kern.values())} statistics "
        "(tol 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError(f"analysis fig2: kernel vs plain {diff:.2e}")

    n_fig2 = ops.launch_counts()["token_basis_matmul"]
    interval = 5
    specs = [cache.CachePolicy(kind="freqca", interval=interval, method=m)
             for m in ("dct", "fft")]
    specs += [cache.CachePolicy(kind=k, interval=interval)
              for k in ("taylorseer", "fora")]
    n_freqca_act = n_fused = 0
    for spec in specs:
        state = cache.init_state(spec, tuple(crfs.shape[1:]), device=dev)
        n_act, mse, fused_rel = 0, [], 0.0
        for i in range(n_steps):
            if bool(cache.should_activate(spec, state, i)):
                state = cache.update(spec, state, crfs[i], ts[i])
                n_act += 1
                continue
            pred = cache.predict(spec, state, ts[i])
            true = crfs[i].float()
            mse.append(((pred.float() - true).square().sum()
                        / true.square().sum()).item())
            if spec.kind == "freqca":
                fused = ops.freqca_predict(state.low_hist[-1],
                                           state.high_hist, state.ts_high,
                                           ts[i], spec.high_order)
                _, rel = compare("freqca_predict_fused (legacy step)",
                                 "float32", fused, pred)
                fused_rel = max(fused_rel, rel)
                n_fused += 1
        name = spec.kind + (f"[{spec.method}]" if spec.kind == "freqca"
                            else "")
        log(f"analysis legacy {name} interval={interval}: {n_act} full + "
            f"{n_steps - n_act} cached steps; relative MSE vs the true CRF "
            f"mean {sum(mse) / len(mse):.4e} max {max(mse):.4e}; "
            f"cache_bytes {cache.cache_bytes(state, spec)} "
            f"(raw {cache.cache_bytes(state)})"
            + (f"; fused step vs cache.predict max rel err {fused_rel:.2e} "
               "(tol 1e-4)" if spec.kind == "freqca" else ""))
        want_act = len([i for i in range(n_steps) if i % interval == 0
                        or i < cache._needed_history(spec)])
        if n_act != want_act or not all(math.isfinite(e) for e in mse):
            raise AssertionError(f"analysis legacy {name}: {n_act} full "
                                 f"steps, expected {want_act}")
        if spec.kind == "freqca":
            n_freqca_act += n_act
        del state
    counts = ops.launch_counts()
    want = {"token_basis_matmul": n_fig2 + n_freqca_act,
            "freqca_predict_fused": n_fused}
    log(f"analysis: launch counts {counts}; Fig-2 band splits {n_fig2} "
        f"(expected {n_steps * len(FIG2_BANDS)})")
    on_card = torch.device(dev).type == "cuda"   # the CPU launches none
    if on_card and (n_fig2 != n_steps * len(FIG2_BANDS) or any(
            counts[k] != v for k, v in want.items())):
        raise AssertionError(f"analysis: launches {counts}, expected "
                             f"{want} and {n_steps * len(FIG2_BANDS)} "
                             "Fig-2 band splits")
    return counts


def serve_phase(model: dict, n_steps: int) -> dict:
    """Four requests under FreqCa(interval=5, dct), max_batch=2, then
    one under ``none``."""
    import torch

    from repro_torch.core.policies import FreqCaPolicy, NoCachePolicy
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    cfg, side, device = model["cfg"], model["side"], model["device"]
    crf_shape, text = model["crf_shape"], model["text"]
    full_fn, from_crf_fn = model["full_fn"], model["from_crf_fn"]
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
    want_full = full_steps(n_steps, 5)
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


def _eb_rates(bank, state):
    """Per lane: (rate_low, rate_high, n_valid) for freqca_eb lanes of a
    bank's pre-decide state, None for the other lanes."""
    from repro_torch.core.policies import registry
    if isinstance(bank, registry.MixedBank):
        return [(st.rate_low.item(), st.rate_high.item(), st.n_valid.item())
                if pol.uses_error_feedback else None
                for pol, st in zip(bank.policies, state, strict=True)]
    if not bank.uses_error_feedback:
        return [None] * bank.batch
    return list(zip(state.rate_low.tolist(), state.rate_high.tolist(),
                    state.n_valid.tolist(), strict=True))


def _calibrated_rates(steps, n_valid: int):
    """(rate_low, rate_high) of every eb lane's decision in ``steps``
    whose lane had ``n_valid`` or more full steps behind it."""
    return [(r[0], r[1]) for _, _, rates in steps for r in rates
            if r is not None and r[2] >= n_valid]


def _rates_text(rates) -> str:
    if not rates:
        return "no eb band rates"
    lo, hi = zip(*rates)
    return (f"eb band rates after calibration (rate_low, rate_high) min "
            f"{min(lo):.4f} / {min(hi):.4f}, max {max(lo):.4f} / "
            f"{max(hi):.4f}, smallest sum "
            f"{min(a + b for a, b in rates):.4f} over {len(rates)} "
            "decisions")


def slo_launches(steps, cfg) -> dict:
    """The launches the recorded decide steps imply: per step, whether
    the batch ran its full forward (flash in every joint-attention
    layer), which lanes split their CRF (the band split: every FreqCa
    lane of a MixedBank on a full step, one batched split of a
    UniformBank, and one more for measure_error where the lane reads
    error feedback) and which predicted (the fused cached step: every
    step of a lane-varying bank, cached steps of a scalar one)."""
    from repro_torch.core.policies import FreqCaPolicy, registry
    want = {"band_split_spectral": 0, "freqca_predict_fused_spectral": 0,
            "flash_attention": 0}
    for bank, mask, _ in steps:
        pols = (bank.policies if isinstance(bank, registry.MixedBank)
                else (bank.policy,))
        full = bank.always_full or (mask[0] if bank.scalar_decision
                                    else any(mask))
        for pol in pols:
            if not isinstance(pol, FreqCaPolicy):
                continue
            if full:
                want["band_split_spectral"] += \
                    1 + int(pol.uses_error_feedback)
            if not full or not bank.scalar_decision:
                want["freqca_predict_fused_spectral"] += 1
        if full:
            want["flash_attention"] += cfg.n_double + cfg.n_layers
    return want


def slo_phase(model: dict, n_steps: int) -> dict:
    """Per-request quality SLOs at the model's width: an
    ``AsyncDiffusionEngine`` over a ``DiffusionEngine`` that cuts
    mixed-policy batches (``group_policies=False``, ``max_batch=2``)
    serves four requests: r0 under FreqCa(interval=5, dct), r1-r3 under
    ``freqca_eb`` with a ``max_error`` tier.  [r0, r1] must run as a
    ``MixedBank`` and [r2, r3] as a per-lane ``UniformBank``; r1 and r2
    are then served again alone, and each must match its lane (masks,
    full steps and budget events exactly; realized error and latents
    within ``SLO_REL_TOL``) with its realized error within its budget.
    The metrics' wire format must round-trip and merge.  The banks'
    ``decide`` is spied on to record each step's mask, and the launch
    counters must equal the launches those masks imply.  The tier is
    chosen from the band rates the warmup measures: the strictest tier
    its smallest rate stays ``SLO_TIER_MARGIN`` below (so a cached step
    is possible), else 1.0."""
    import torch

    from repro_torch.core.policies import (ERROR_TIERS,
                                           FreqCaErrorBudgetPolicy,
                                           FreqCaPolicy, registry)
    from repro_torch.kernels import ops
    from repro_torch.serving.async_engine import AsyncDiffusionEngine
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    from repro_torch.serving.metrics import ServeMetrics
    cfg, side, device = model["cfg"], model["side"], model["device"]
    on_card = torch.device(device).type == "cuda"
    freqca = FreqCaPolicy(interval=5, method="dct")
    eb_base = FreqCaErrorBudgetPolicy(method="dct")
    eb_warm = eb_base.with_budget(1.0)
    # one prompt for every lane, so a lane's result cannot depend on
    # its position in a batch
    text = model["text"][:1].expand(2, -1, -1)
    full_fn, from_crf_fn = make_fns(model["params"], cfg, side, text)
    eng = DiffusionEngine(full_fn, from_crf_fn,
                          (side, side, 16), model["crf_shape"], freqca,
                          n_steps=n_steps, max_batch=2,
                          group_policies=False, device=device)
    aeng = AsyncDiffusionEngine(eng)
    steps, plans = [], []
    real = {cls: cls.decide for cls in (registry.UniformBank,
                                        registry.MixedBank)}

    def spy(cls):
        def decide(self, state, ctx):
            rates = _eb_rates(self, state)
            new, mask = real[cls](self, state, ctx)
            steps.append((self, [bool(m) for m in mask.tolist()], rates))
            return new, mask
        return decide
    real_execute = eng.execute_plan

    def execute_spy(plan):
        plans.append([r.request_id for r in plan.requests])
        return real_execute(plan)
    eng.execute_plan = execute_spy
    for cls in real:
        cls.decide = spy(cls)
    try:
        t0 = time.perf_counter()
        aeng.warmup(policies=[eb_warm],
                    lane_policy_sets=[(freqca, eb_warm)])
        warm_s = time.perf_counter() - t0
        post = _calibrated_rates(steps, eb_base.needed_history + 1)
        if not post:
            raise AssertionError("slo: the warmup measured no band rate")
        r_min = min(a + b for a, b in post)
        tier = next((t for t in ERROR_TIERS
                     if r_min <= t * (1 - SLO_TIER_MARGIN)), 1.0)
        eb = eb_base.with_budget(tier)   # what the scheduler stamps
        log(f"slo: warmup {warm_s:.1f} s, {eng.compiled_buckets()} "
            f"signatures; {_rates_text(post)}; tier {tier}")

        steps.clear()
        ops.reset_launch_counts()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        first = eng.metrics.n_batches
        reqs = [DiffusionRequest(request_id=0, seed=300, policy=freqca)]
        reqs += [DiffusionRequest(request_id=i, seed=300 + i, policy=eb_base,
                                  max_error=tier) for i in (1, 2, 3)]
        t0 = time.perf_counter()
        with aeng.scheduler.cv:        # all four queued before any cut
            futs = [aeng.submit(r) for r in reqs]
        res = {f.result(timeout=900).request_id: f.result() for f in futs}
        snap_a = aeng.metrics_dict()
        for rid, seed in ((11, 301), (12, 302)):
            fut = aeng.submit(DiffusionRequest(request_id=rid, seed=seed,
                                               policy=eb_base,
                                               max_error=tier))
            res[rid] = fut.result(timeout=900)
        aeng.shutdown(drain=True, timeout=900)
        wall = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        for cls, fn in real.items():
            cls.decide = fn
        aeng.shutdown(drain=False, timeout=900)
    walls = eng.metrics.batch_walls[first:]
    log(f"slo: cuts {plans}, batch walls (s) "
        f"{[round(w, 3) for w in walls]}, phase wall {wall:.1f} s, peak "
        f"memory {peak / 2**30:.2f} GiB; served requests' "
        + _rates_text(_calibrated_rates(steps, eb.needed_history + 1)))
    for rid in sorted(res):
        r = res[rid]
        log(f"slo: request {rid} bucket {r.bucket} n_full_steps "
            f"{r.n_full_steps} budget_events {r.budget_events} "
            f"realized_error {r.realized_error}")

    # the cuts, and the bank each ran under
    banks = []
    for bank, _, _ in steps:
        if not banks or banks[-1] is not bank:
            banks.append(bank)
    if plans != [[0, 1], [2, 3], [11], [12]] or len(banks) != 4:
        raise AssertionError(f"slo: cuts {plans}, {len(banks)} banks")
    kinds = [(type(b).__name__, getattr(b, "policies", None)
              or (b.policy,) * b.batch) for b in banks]
    want_kinds = [("MixedBank", (freqca, eb)), ("UniformBank", (eb, eb)),
                  ("UniformBank", (eb,)), ("UniformBank", (eb,))]
    if kinds != want_kinds:
        raise AssertionError(f"slo: banks {kinds}, expected {want_kinds}")
    masks = [[m for bk, m, _ in steps if bk is b] for b in banks]
    lane_masks = {rid: [m[lane] for m in masks[k]] for rid, k, lane in
                  ((0, 0, 0), (1, 0, 1), (2, 1, 0), (11, 2, 0), (12, 3, 0))}
    log("slo: per-step masks (1 = full) " + "; ".join(
        f"r{k} {''.join(str(int(v)) for v in m)}"
        for k, m in lane_masks.items()))

    # each eb lane against its solo run
    want_r0 = full_steps(n_steps, 5)
    if res[0].n_full_steps != want_r0 or res[0].realized_error != 0.0:
        raise AssertionError(f"slo: the freqca lane ran "
                             f"{res[0].n_full_steps} full steps (want "
                             f"{want_r0}), realized {res[0].realized_error}")
    for lane, solo in ((1, 11), (2, 12)):
        a, b = res[lane], res[solo]
        err_rel = (abs(a.realized_error - b.realized_error)
                   / max(abs(b.realized_error), 1e-12))
        lat_rel = rel_l2(a.latents, b.latents)
        log(f"slo: r{lane} in its batch vs alone: n_full_steps "
            f"{a.n_full_steps}/{b.n_full_steps}, budget_events "
            f"{a.budget_events}/{b.budget_events}, realized_error rel diff "
            f"{err_rel:.3e}, latents rel L2 {lat_rel:.3e} (tol "
            f"{SLO_REL_TOL:.0e})")
        if (lane_masks[lane] != lane_masks[solo]
                or a.n_full_steps != b.n_full_steps
                or a.budget_events != b.budget_events
                or err_rel > SLO_REL_TOL or not lat_rel <= SLO_REL_TOL):
            raise AssertionError(f"slo: r{lane} differs from its solo run")
    for rid in (1, 2, 3, 11, 12):
        if not res[rid].realized_error <= tier + 1e-6:
            raise AssertionError(f"slo: r{rid} realized "
                                 f"{res[rid].realized_error} > {tier}")
    for r in res.values():
        if tuple(r.latents.shape) != (side, side, 16) or \
                not torch.isfinite(r.latents).all():
            raise AssertionError("slo: latents of wrong shape or "
                                 "non-finite")

    # the metrics' wire format
    snap_b = aeng.metrics_dict()
    if ServeMetrics.from_dict(snap_b).to_dict() != snap_b:
        raise AssertionError("slo: to_dict . from_dict is not the identity")
    merged = ServeMetrics.merge([snap_a, snap_b])
    sums = {k: (getattr(merged, k), snap_a[k] + snap_b[k])
            for k in ("compile_hits", "compile_misses", "full_steps",
                      "budget_events_total")}
    if any(got != want for got, want in sums.values()) or \
            merged.n_requests != (len(snap_a["request_latencies"])
                                  + len(snap_b["request_latencies"])):
        raise AssertionError(f"slo: merge {sums}")
    summary = eng.metrics.summary()
    log(f"slo: metrics requests {summary['requests']}, batches "
        f"{summary['batches']}, budget_events {summary['budget_events']}, "
        f"realized_error p95 {summary['realized_error_p95']}, compile "
        f"hits/misses {summary['compile_hits']}/{summary['compile_misses']}"
        f", signatures {summary['compiled_signatures']}; merge of two "
        f"snapshots {merged.n_requests} requests")

    want = slo_launches(steps, cfg)
    log(f"slo: launch counts {counts}; implied by the masks {want}")
    if on_card and any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"slo: launches {counts}, the masks imply "
                             f"{want}")
    return counts


def backbone_phase(n_steps: int, cfg=None, side: int = 128,
                   device: str = "cuda") -> dict:
    """FreqCa on an assigned architecture at full width: mamba2-370m (48
    SSD layers, d 1024) in bf16 as the denoiser over 128x128x4 latents (S
    4096, CRF [4096, 1024]), served by the ``DiffusionEngine`` under
    ``FreqCaPolicy(interval=5, dct, rho=1/16)`` with float32 rings,
    ``max_batch=2``, four requests.  Each full forward runs the SSD
    kernel once per layer.  (``cfg``, ``side`` and ``device`` let the
    phase be rehearsed small on the CPU, with the CUDA memory and sync
    calls stubbed.)"""
    import torch

    from repro_torch import configs
    from repro_torch.core.policies import FreqCaPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import common, dit
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    cfg, dev = cfg or configs.get_config("mamba2-370m"), device
    dtype = getattr(torch, cfg.dtype)
    t0 = time.perf_counter()
    params = common.init_params(dit.backbone_denoiser_specs(cfg), seed=20,
                                device=dev, dtype=dtype)
    redraw_zero_leaves(params, seed=21)
    log(f"backbone: {cfg.arch_id} denoiser params "
        f"{sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M in "
        f"{time.perf_counter() - t0:.1f} s")

    def full_fn(x, t):
        out = dit.backbone_denoiser_forward(params, x, t.expand(x.shape[0]),
                                            cfg)
        return out.velocity, out.crf

    def from_crf_fn(crf, t):
        return dit.backbone_denoiser_from_crf(params, crf, cfg, side, side)
    latent, crf_shape = (side, side, 4), ((side // 2) ** 2, cfg.d_model)
    eng = DiffusionEngine(full_fn, from_crf_fn, latent, crf_shape,
                          FreqCaPolicy(interval=5, method="dct", rho=1 / 16),
                          n_steps=n_steps, max_batch=2, device=dev)
    log(f"backbone: warmup {eng.warmup():.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(4):
        eng.submit(DiffusionRequest(request_id=i, seed=200 + i))
    results = eng.serve_until_drained()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = eng.metrics.n_batches
    fulls = [r.n_full_steps for r in results]
    want_full = full_steps(n_steps, 5)
    log(f"backbone: {len(results)} requests in {n_batches} batches, "
        f"n_full_steps per request {fulls}, batch walls (s) "
        f"{[round(w, 3) for w in eng.metrics.batch_walls]}, peak memory "
        f"{peak / 2**30:.2f} GiB; launch counts {counts}")
    if len(results) != 4 or fulls != [want_full] * 4:
        raise AssertionError(f"backbone: expected 4 requests with "
                             f"{want_full} full steps, got {fulls}")
    per_batch = {"ssd_chunk_scan": want_full * cfg.n_layers,
                 "band_split_spectral": want_full,
                 "freqca_predict_fused_spectral": n_steps - want_full}
    on_card = torch.device(dev).type == "cuda"   # the CPU launches none
    for name, n in per_batch.items():
        if on_card and counts[name] != n * n_batches:
            raise AssertionError(f"backbone {name}: {counts[name]} launches, "
                                 f"expected {n} per batch x {n_batches}")
    if not all(torch.isfinite(r.latents).all() and
               tuple(r.latents.shape) == latent for r in results):
        raise AssertionError("backbone: latents of wrong shape or "
                             "non-finite")
    x2 = torch.randn((2,) + latent, device=dev)
    t = torch.tensor(0.75, device=dev)
    log(f"backbone: one full forward, 2 lanes: "
        f"{time_ms(lambda: full_fn(x2, t), reps=3):.2f} ms "
        f"({cfg.n_layers} SSD launches)")
    return counts


def flash_check(label: str, cfg, s: int, dev, seed: int) -> None:
    """The forward's attention launch at ``cfg``'s own shape (bf16 [1, S,
    H/Hkv, hd], causal GQA, drawn from ``seed``), held against the plain
    version on the first and the last ``n_q`` queries with every key
    they see (1024 at 32 heads, fewer at more heads, so that the plain
    version's [H, n_q, S] float32 logits stay ~4 GB); then, on the card,
    that launch alone beside its bound and SDPA."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention, blocks
    hd, hkv, g = cfg.head_dim, cfg.n_kv_heads, cfg.q_per_kv
    _, ng, plan = blocks._layer_plan(cfg)
    n_attn = ng * sum(kind == "attn" for kind, _ in plan)
    shape = f"[1, {s}, {cfg.n_heads}/{hkv}, {hd}]"
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, s, cfg.n_heads, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, s, hkv, hd), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in "kv")
    got = ops.flash(q, k, v, g, causal=True)
    n_q = min(max(128, 1024 * 32 // cfg.n_heads), s)
    for q0 in (0, s - n_q):
        want = ref.sdpa_ref(q[:, q0:q0 + n_q], k[:, :q0 + n_q],
                            v[:, :q0 + n_q],
                            attention.causal_mask(n_q, offset=q0, device=dev),
                            g)
        err, rel = compare(f"flash_attention[{label}]", "bfloat16",
                           got[:, q0:q0 + n_q].contiguous(), want)
        log(f"{label}: causal GQA flash {shape} bf16, queries "
            f"{q0}:{q0 + n_q} vs plain: max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (tol {TOLERANCE['bfloat16']:.0e})")
        del want
    del got
    if torch.device(dev).type == "cuda":
        work, nb = fa.fwd_work(1, s, s, cfg.n_heads, hkv, hd, "bfloat16",
                               True)
        flops = work["bfloat16"]
        b_ms, b_by = bound_ms(nb, flops, "bfloat16")
        import torch.nn.functional as F
        t_k = time_ms(lambda: ops.flash(q, k, v, g, causal=True), reps=2)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=2)
        log(f"{label}: breakdown: causal GQA flash {shape} {t_k:.3f} ms per "
            f"layer x {n_attn} = {t_k * n_attn / 1e3:.3f} s of "
            f"the forward; bound {b_ms:.4f} ms ({b_by}); library (SDPA) "
            f"{t_l:.3f} ms; {rate(flops, t_k, b_ms)}")
        del qt, kt, vt
    del q, k, v


def lm_phase(cfg=None, s: int = 32768, device: str = "cuda",
             params=None) -> dict:
    """yi-9b at full width and depth (48 layers, d 4096, 32 query heads
    on 4 kv heads of 128, d_ff 11008, vocabulary 64000), bf16 from a
    seed, through ``transformer.forward`` on one sequence of 32768 tokens
    (the assigned prefill length): every layer's attention runs the
    causal GQA flash kernel, which is then held against its plain
    version at that shape.  ``params`` (default: drawn here from seed
    30) lets the decode phase reuse them.  (``cfg``, ``s`` and
    ``device`` let the phase be rehearsed small on the CPU, with the
    CUDA memory and sync calls stubbed.)"""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cfg, dev = cfg or configs.get_config("yi-9b"), device
    t0 = time.perf_counter()
    if params is None:
        params = lm_params(cfg, cfg.n_layers, seed=30, device=dev)
    log(f"lm: {cfg.arch_id} params "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(31))
    forms, real_flash = [], ops.flash

    def flash_spy(q, k, v, q_per_kv=1, causal=False, window=0):
        forms.append((q_per_kv, causal, window))
        return real_flash(q, k, v, q_per_kv, causal, window)
    walls = []
    ops.flash = flash_spy
    try:
        for rep in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            forms.clear()
            t0 = time.perf_counter()
            out = transformer.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            finite = bool(torch.isfinite(out.logits).all())
            shape = tuple(out.logits.shape)
            last = out.logits[:, -1].float()
            del out
    finally:
        ops.flash = real_flash
    peak = torch.cuda.max_memory_allocated()
    log(f"lm: forward [1, {s}] walls (s) {[round(w, 3) for w in walls]}, "
        f"flash launches {counts['flash_attention']} (forms q_per_kv, "
        f"causal, window: {sorted(set(forms))}), logits {shape} finite "
        f"{finite}, peak memory {peak / 2**30:.2f} GiB")
    on_card = torch.device(dev).type == "cuda"   # the CPU launches none
    if on_card and (counts["flash_attention"] != cfg.n_layers or
                    set(forms) != {(cfg.q_per_kv, True, 0)}):
        raise AssertionError(f"lm: flash launches {counts}, forms {forms}")
    if not finite or shape != (1, s, cfg.vocab_size):
        raise AssertionError(f"lm: logits {shape}, finite {finite}")
    # the prefill step on the same parameters and tokens: the last
    # token's logits only, equal to the forward's last row
    from repro_torch.launch import steps
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pre = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    pre_counts = ops.launch_counts()
    pre_rel = ((pre.float() - last).abs().max()
               / last.abs().max()).item()
    log(f"lm: make_prefill_step [1, {s}] -> {tuple(pre.shape)} in "
        f"{pre_wall:.3f} s, {pre_counts['flash_attention']} flash launches; "
        f"against the forward's last row: max_rel_err {pre_rel:.3e} (tol "
        f"{TOLERANCE['bfloat16']:.0e}), bitwise "
        f"{torch.equal(pre.float(), last)}")
    if tuple(pre.shape) != (1, cfg.vocab_size) or not (
            pre_rel <= TOLERANCE["bfloat16"]) or (
            on_card and (pre_counts["flash_attention"] != cfg.n_layers
                         or sum(pre_counts.values()) != cfg.n_layers)):
        raise AssertionError(f"lm: prefill {tuple(pre.shape)}, rel err "
                             f"{pre_rel:.3e}, launches {pre_counts}")
    del pre, last
    flash_check("lm", cfg, s, dev, seed=32)
    return {"lm": counts, "lm_prefill": pre_counts}


# the decode phase: (label, arch, input shape, batch).  decode_32k's
# global batch of 128 is cut to 16 for yi-9b (17.66 GB of weights and a
# 51.5 GB cache of 32768 slots fill the card); mamba2-370m keeps it
DECODE_RUNS = (("yi_decode_32k", "yi-9b", "decode_32k", 16),
               ("yi_long_500k", "yi-9b", "long_500k", 1),
               ("mamba_decode_32k", "mamba2-370m", "decode_32k", 128),
               ("mamba_long_500k", "mamba2-370m", "long_500k", 1))
DECODE_TIMED = 8          # timed steps after one warm step
# the decode-against-forward checks: yi-9b cut to 4 layers on a prompt
# long enough for the forward's flash route, mamba2-370m at full depth
# (cut to 8 layers for the float32 check: its prefill is host-bound,
# ~1 ms of eager ops a layer and token)
DECODE_YI_LAYERS, DECODE_YI_PROMPT = 4, 2048
DECODE_MAMBA_PROMPT = 512
DECODE_MAMBA_F32_LAYERS = 8
DECODE_NEW = 16
# card against CPU, relative L2 of the logits and of the updated cache:
# float32 sums in other orders (TF32 off); bf16 one rounding of each
# output in places.  The RoPE frequencies are the host's bits on both
# (``common.rope_frequencies``), so positions near 524288 take the same
# tolerance
DECODE_CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# decode against forward: the prefill's last logits against the
# forward's last row, relative L2; bf16 takes the same 2e-2 over yi's 4
# layers and 5e-2 over mamba2's 48, whose chunk scan (bf16 inputs) and
# float32 recurrence round the residual stream in other places in
# every layer; float32 1e-3 (a sharper check of the same wiring)
DECODE_FWD_TOL = {("yi-9b", "bfloat16"): 2e-2,
                  ("mamba2-370m", "bfloat16"): 5e-2,
                  ("yi-9b", "float32"): 1e-3,
                  ("mamba2-370m", "float32"): 1e-3,
                  ("granite-moe-3b-a800m", "float32"): 1e-3}


def fill_cache(cache, pos: int, seed: int):
    """Draw every buffer of a decode cache in place from a seed (K, V,
    the conv history and the SSM state ~ N(0, 1)) and set every KV
    cache's next position to ``pos``."""
    import torch
    gen = None
    for group in cache:
        for c in group.values():
            for t in vars(c).values():
                if isinstance(t, torch.Tensor):
                    if gen is None:
                        gen = torch.Generator(device=t.device).manual_seed(
                            seed)
                    t.normal_(generator=gen)
            if hasattr(c, "index"):
                c.index = pos
    return cache


def set_position(cache, pos: int) -> None:
    for group in cache:
        for c in group.values():
            if hasattr(c, "index"):
                c.index = pos


def decode_run(label: str, cfg, params, batch: int, cache_len: int,
               pos: int, window: int, device: str) -> None:
    """One decode run: a seeded cache at position ``pos``, one warm step
    and DECODE_TIMED timed greedy steps through ``make_decode_step``
    (CUDA events around each), then one step with events around every
    attention / SSM mixer and MoE FFN for the split; bound, peak memory,
    no kernel launched."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import attention, blocks, moe, ssm
    from repro_torch.roofline import op_analysis
    on_card = torch.device(device).type == "cuda"
    dtype = getattr(torch, cfg.dtype)
    before = torch.cuda.memory_allocated() if on_card else 0
    cache = fill_cache(blocks.stack_cache_zeros(cfg, batch, cache_len, dtype,
                                                device), pos, seed=40)
    step = steps.make_decode_step(cfg, window=window)
    gen = torch.Generator(device=device).manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), device=device,
                           generator=gen)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def event():
        if not on_card:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def elapsed(a, b) -> float:
        return a.elapsed_time(b) if on_card else (b - a) * 1e3
    logits, _ = step(params, tokens, cache)                  # warm
    marks = []
    t0 = time.perf_counter()
    for _ in range(DECODE_TIMED):
        tokens = torch.argmax(logits[:, -1:], dim=-1)
        start = event()
        logits, _ = step(params, tokens, cache)
        marks.append((start, event()))
    if on_card:
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / DECODE_TIMED
    walls = [elapsed(a, b) for a, b in marks]
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    finite = bool(torch.isfinite(logits).all())
    kv = [c for g in cache for c in g.values() if hasattr(c, "index")]
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) or not finite or \
            any(c.index != pos + 1 + DECODE_TIMED for c in kv) or \
            any(counts.values()):
        raise AssertionError(f"decode {label}: logits {tuple(logits.shape)}"
                             f" finite {finite}, positions "
                             f"{sorted({c.index for c in kv})}, launches "
                             f"{counts}")
    # the split: the last position again, events around every mixer and
    # every MoE FFN
    set_position(cache, pos + DECODE_TIMED)
    mixers, ffns = [], []
    real = (attention.decode_self_attention, ssm.ssm_decode_step,
            moe.moe_ffn, moe.moe_ffn_gather)

    def timed(fn, into):
        def wrapper(*args, **kw):
            a = event()
            out = fn(*args, **kw)
            into.append((a, event()))
            return out
        return wrapper
    attention.decode_self_attention = timed(real[0], mixers)
    ssm.ssm_decode_step = timed(real[1], mixers)
    moe.moe_ffn, moe.moe_ffn_gather = (timed(f, ffns) for f in real[2:])
    try:
        start = event()
        step(params, tokens, cache)
        end = event()
    finally:
        (attention.decode_self_attention, ssm.ssm_decode_step, moe.moe_ffn,
         moe.moe_ffn_gather) = real
    if on_card:
        torch.cuda.synchronize()
    split_ms = elapsed(start, end)
    mixer_ms = sum(elapsed(a, b) for a, b in mixers)
    ffn_ms = sum(elapsed(a, b) for a, b in ffns)
    nbytes = op_analysis.decode_step_bytes(cfg, params, cache, batch)
    flops = op_analysis.decode_step_flops(cfg, params, cache, batch)
    b_ms, b_by = bound_ms(nbytes, flops, cfg.dtype)
    mean = sum(walls) / len(walls)
    kind = "attention" if kv else "SSM"
    cache_gb = sum(t.nbytes for g in cache for c in g.values()
                   for t in vars(c).values()
                   if isinstance(t, torch.Tensor)) / 1e9
    where = (f"KV cache {cache_len} slots, window {window}, position {pos}"
             if kv else "SSM state and conv history")
    log(f"decode {label}: {cfg.arch_id} {cfg.n_layers} layers {cfg.dtype}, "
        f"batch {batch}, {where} ({cache_gb:.2f} GB): step walls (ms, CUDA "
        f"events) {[round(w, 3) for w in walls]}, mean {mean:.3f} (host "
        f"clock {host_ms:.3f}), {batch / mean * 1e3:.1f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB, of it {before / 2**30:.2f} held "
        f"before the cache; bound {b_ms:.3f} ms ({b_by}: "
        f"{nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP), mean/bound "
        f"{mean / b_ms:.2f}; split (one more step, {split_ms:.3f} ms): "
        f"{kind} {len(mixers)} x {mixer_ms / max(len(mixers), 1):.3f} = "
        f"{mixer_ms:.3f} ms ({mixer_ms / split_ms:.1%})" + (
            f", MoE FFN {len(ffns)} x {ffn_ms / max(len(ffns), 1):.3f} = "
            f"{ffn_ms:.3f} ms ({ffn_ms / split_ms:.1%})" if ffns else "")
        + f", the rest {split_ms - mixer_ms - ffn_ms:.3f} ms; 0 kernel "
        "launches")


def decode_params(cfg, n_layers: int, seed: int, device: str):
    """``lm_params`` with an attention model's projections, and the
    experts of an MoE layer, redrawn at std 1/sqrt(fan-in) (as
    ``lm_train_reference`` draws yi: the reference's rule for the
    stacked 4-D leaves gives std 1/sqrt(n_layers), which puts random
    yi-9b logits near 426 and makes a bf16 comparison meaningless; an
    expert ``[e, d_in, d_out]`` draws with 1/sqrt(d_in) in place of
    granite's 1/sqrt(32))."""
    params = lm_params(cfg, n_layers, seed, device)
    fan_in_redraw(params, seed + 1, experts=True)
    return params


def fan_in_redraw(params, seed: int, experts: bool = False) -> None:
    """Redraw in place, in the tree's order, every attention projection
    (under ``attn``, ``self_attn`` or ``cross_attn``) at std 1/sqrt(its
    fan-in, dim 0) and, with ``experts``, every expert leaf ``[e, d_in,
    d_out]`` of an ``ffn`` at 1/sqrt(d_in)."""
    import torch
    gen = None

    def draw(w, fan_in):
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(seed)
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                / fan_in ** 0.5)

    def walk(node):
        for key, sub in (node.items() if isinstance(node, dict)
                         else enumerate(node)):
            if key in ("attn", "self_attn", "cross_attn"):
                for w in sub.values():
                    draw(w, w.shape[0])
            elif key == "ffn" and experts:
                for w in sub.values():
                    if w.dim() == 3:
                        draw(w, w.shape[1])
            elif isinstance(sub, (dict, list)):
                walk(sub)
    walk(params)


def decode_reference(devices=("cpu", "cuda"), cfgs=None,
                     yi_len: int = 32768) -> None:
    """One decode step card against CPU, at full width cut to 2 layers,
    in float32 and bf16, from one seeded non-empty cache: yi-9b without
    a window (batch 1, 32768 slots, the last one free), yi-9b on
    long_500k's 8192-slot ring at position 524279, mamba2-370m at batch
    2.  The logits and every buffer the step writes (the new K / V slot;
    the SSM state and conv history) are held to DECODE_CARD_TOL."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import blocks, common
    get = cfgs or configs.get_config
    yi, mamba = get("yi-9b"), get("mamba2-370m")
    ring = configs.for_shape(yi, "long_500k")
    w = ring.sliding_window
    cases = (("yi-9b", yi, 1, yi_len, yi_len - 1, 0),
             ("yi-9b ring", ring, 1, w, 524288 - 9, w),
             ("mamba2-370m", mamba, 2, 1, 0, 0))
    # why ``rope_frequencies`` computes on the host: the card's own pow
    own = {dev: (1.0 / yi.rope_theta ** (torch.arange(
        0, yi.head_dim, 2, dtype=torch.float32, device=dev) / yi.head_dim))
        .cpu() for dev in devices}
    used = common.rope_frequencies(yi.head_dim, yi.rope_theta, devices[1])
    n_own = int((own[devices[0]] != own[devices[1]]).sum())
    n_used = int((used.cpu() != own[devices[0]]).sum())
    log(f"decode reference: yi-9b RoPE frequencies computed on the card "
        f"differ from the CPU's in {n_own} of {own[devices[0]].numel()}; "
        f"those the port uses there in {n_used}")
    for seed, (name, full, batch, cache_len, pos, window) in enumerate(
            cases, start=80):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(full, n_layers=2, dtype=dtype)
            params_cpu = decode_params(cfg, 2, seed, "cpu")
            cache_cpu = fill_cache(blocks.stack_cache_zeros(
                cfg, batch, cache_len, getattr(torch, dtype), "cpu"), pos,
                seed=seed)
            tokens = torch.randint(0, cfg.vocab_size, (batch, 1),
                                   generator=torch.Generator().manual_seed(
                                       seed))
            outs = {}
            for dev in devices:
                cache = [{k: type(c)(**{f: (t.to(dev, copy=True)
                                            if isinstance(t, torch.Tensor)
                                            else t)
                                        for f, t in vars(c).items()})
                          for k, c in g.items()} for g in cache_cpu]
                logits, cache = steps.make_decode_step(cfg, window)(
                    _to(params_cpu, dev), tokens.to(dev), cache)
                written = []
                for g in cache:
                    for c in g.values():
                        if hasattr(c, "index"):
                            slot = pos % cache_len
                            written += [c.k[:, slot], c.v[:, slot]]
                        else:
                            written += [c.state, c.conv]
                outs[dev] = [logits] + written
            tol = DECODE_CARD_TOL[dtype]
            rels = [rel_l2(g, w_) for g, w_ in zip(outs[devices[1]],
                                                   outs[devices[0]],
                                                   strict=True)]
            finite = all(bool(torch.isfinite(t).all())
                         for t in outs[devices[1]])
            log(f"decode reference {name} x2 {dtype} batch {batch}, cache "
                f"{cache_len}, position {pos}: card vs CPU rel L2 logits "
                f"{rels[0]:.3e}, written cache max {max(rels[1:]):.3e} "
                f"(tol {tol:.0e})")
            if not finite or max(rels) > tol:
                raise AssertionError(f"decode reference {name} {dtype}: "
                                     f"rel L2 {rels}")
            del outs, cache_cpu, params_cpu


def decode_forward_check(label: str, cfg, params, prompt_len: int,
                         device: str) -> None:
    """``LMEngine`` at full width against ``transformer.forward``: the
    prefill's last logits against the forward's last row (relative L2,
    DECODE_FWD_TOL), then DECODE_NEW greedy tokens, each equal to the
    forward's argmax over the generated sequence (teacher-forced, so
    each row sees the prefix the decode saw; padded to a multiple of 256
    for the SSD kernel, which changes no compared row of a causal model)
    wherever that row's top-2 margin exceeds the tolerance times its
    largest |logit| (bf16 logits tie often).  A bf16 check also holds
    the prefill's distance from the float32 forward of the same weights
    to twice the bf16 forward's.

    With experts, decode routes each token alone and the forward groups
    of up to 2048: the two agree only where neither drops.  The check
    reads both drop fractions and states them; where the forward's is
    non-zero at the config's capacity factor it runs at ``n_experts /
    top_k`` (the forward's capacity its whole group: nothing drops).
    Every prompt token's routing in every layer is then held between
    the two (``route_check``, not strict: the forward's float32 sums
    and one token's differ by more than the card's and the CPU's, so
    near-ties may route apart, and only they may)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer
    from repro_torch.serving.engine import LMEngine
    gen = torch.Generator(device=device).manual_seed(90)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), device=device,
                           generator=gen)
    tol = DECODE_FWD_TOL[(cfg.arch_id, cfg.dtype)]
    moe_note, fwd_spy = "", MoESpy()
    if cfg.moe is not None:
        with torch.no_grad(), MoESpy() as spy:
            transformer.forward(params, prompt, cfg)
        drop = max(float(a.drop_fraction) for a in spy.aux)
        moe_note = (f"; the forward's drop fraction at capacity factor "
                    f"{cfg.moe.capacity_factor}: {drop:.4e}")
        del spy
        if drop > 0:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            moe_note += (f", so compared at {cfg.moe.capacity_factor}, "
                         "where nothing drops")
    engine = LMEngine(params, cfg, prompt_len + DECODE_NEW, device=device)
    t0 = time.perf_counter()
    with MoESpy() as dec_spy:
        last, _ = engine.prefill(prompt)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    with torch.no_grad(), fwd_spy:
        want = transformer.forward(params, prompt, cfg).logits[:, -1:]
    if cfg.moe is not None:
        n_moe = len(fwd_spy.routes)
        dec_routes = [tuple(torch.cat([dec_spy.routes[t * n_moe + i][j]
                                       for t in range(prompt_len)], 1)
                            for j in range(2)) + dec_spy.routes[i][2:]
                      for i in range(n_moe)]
        route_check(f"decode {label} prefill vs forward", dec_routes,
                    fwd_spy.routes, strict=False)
        drops = [float(a.drop_fraction) for a in fwd_spy.aux + dec_spy.aux]
        moe_note += (f"; drop fractions: the forward "
                     f"{max(drops[:n_moe]):.4e}, the decode "
                     f"{max(drops[n_moe:]):.4e}")
        if any(drops):
            raise AssertionError(f"decode {label}: drops {drops}")
    del dec_spy, fwd_spy
    rel = rel_l2(last, want)
    control = ""
    if cfg.dtype == "bfloat16":
        # a control: both bf16 paths' distance from the float32 forward
        # of the same weights; the decode may lie at most twice as far
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with torch.no_grad():
            exact = transformer.forward(
                _to(params, torch.float32), prompt, cfg32).logits[:, -1:]
        d_fwd, d_dec = rel_l2(want, exact), rel_l2(last, exact)
        control = (f"; from the float32 forward: the bf16 forward "
                   f"{d_fwd:.3e}, the bf16 prefill {d_dec:.3e} (at most "
                   f"2x the forward's)")
        if not d_dec <= 2 * d_fwd:
            raise AssertionError(f"decode {label}: the prefill lies "
                                 f"{d_dec:.3e} from the float32 forward, "
                                 f"the forward {d_fwd:.3e}")
    t0 = time.perf_counter()
    out = engine.generate(prompt, DECODE_NEW)
    gen_s = time.perf_counter() - t0
    seq = out[:, :-1]
    pad = -seq.shape[1] % 256
    with torch.no_grad():
        tf = transformer.forward(
            params, torch.cat([seq, torch.zeros((1, pad), dtype=seq.dtype,
                                                device=device)], 1),
            cfg).logits[0, prompt_len - 1:prompt_len - 1 + DECODE_NEW]
    top2 = torch.topk(tf.float(), 2, dim=-1)
    margin = (top2.values[:, 0] - top2.values[:, 1]) / tf.float().abs().amax(
        dim=-1)
    clear = margin > tol
    wrong = clear & (out[0, prompt_len:] != top2.indices[:, 0])
    log(f"decode {label}: LMEngine prefill of {prompt_len} tokens "
        f"{pre_s:.2f} s, last logits vs forward rel L2 {rel:.3e} (tol "
        f"{tol:.0e}){control}{moe_note}; generate {DECODE_NEW} tokens "
        f"{gen_s:.2f} s; "
        f"{int(clear.sum())} of {DECODE_NEW} rows with a margin past the "
        f"tolerance, {int(wrong.sum())} of them not the teacher-forced "
        f"forward's argmax (smallest margin {margin.min().item():.3e})")
    if wrong.any():
        raise AssertionError(f"decode {label}: tokens {wrong.tolist()} "
                             "differ from the forward's argmax")
    if not bool(torch.isfinite(last).all()) or rel > tol or \
            tuple(out.shape) != (1, prompt_len + DECODE_NEW):
        raise AssertionError(f"decode {label}: rel {rel:.3e}, out "
                             f"{tuple(out.shape)}")


def decode_phase(yi_params=None, yi_cfg=None, mamba_cfg=None,
                 seq: int = 0, prompts=(DECODE_YI_PROMPT,
                                        DECODE_MAMBA_PROMPT),
                 device: str = "cuda") -> dict:
    """The LM decode path at full width: the four DECODE_RUNS (yi-9b on
    ``yi_params``, the lm phase's, at decode_32k and, through
    ``for_shape``, long_500k's 8192-slot ring at position 524279;
    mamba2-370m at full depth), each from a seeded cache positioned so
    that its nine steps end at the shape's length; then the card against
    the CPU (``decode_reference``) and ``LMEngine`` against the forward
    (``decode_forward_check``).  Returns the launch counts of the
    checks' forwards (flash and the SSD scan) under ``decode``.
    (``yi_cfg``, ``mamba_cfg``, ``seq`` and ``prompts`` let the phase be
    rehearsed small on the CPU.)"""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    cfgs = {"yi-9b": yi_cfg or configs.get_config("yi-9b"),
            "mamba2-370m": mamba_cfg or configs.get_config("mamba2-370m")}
    on_card = torch.device(device).type == "cuda"
    if yi_params is None:
        yi_params = lm_params(cfgs["yi-9b"], cfgs["yi-9b"].n_layers, seed=30,
                              device=device)
    m_cfg = cfgs["mamba2-370m"]
    params = {"yi-9b": yi_params,
              "mamba2-370m": lm_params(m_cfg, m_cfg.n_layers, seed=42,
                                       device=device)}
    for label, arch, shape, batch in DECODE_RUNS:
        cfg = configs.for_shape(cfgs[arch], shape)
        length = seq or configs.INPUT_SHAPES[shape]["seq_len"]
        window = cfg.sliding_window
        decode_run(label, cfg, params[arch], batch,
                   window or length, length - 1 - DECODE_TIMED, window,
                   device)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    del params, yi_params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    decode_reference(devices=("cpu", device),
                     cfgs=None if yi_cfg is None else cfgs.get,
                     yi_len=seq or 32768)
    ops.reset_launch_counts()
    yi = dataclasses.replace(cfgs["yi-9b"], n_layers=DECODE_YI_LAYERS)
    m32 = min(DECODE_MAMBA_F32_LAYERS, m_cfg.n_layers)
    checks = ((yi, "bfloat16", prompts[0]), (yi, "float32", prompts[0]),
              (m_cfg, "bfloat16", prompts[1]),
              (dataclasses.replace(m_cfg, n_layers=m32), "float32",
               prompts[1]))
    for seed, (full, dtype, prompt) in enumerate(checks, start=91):
        cfg = dataclasses.replace(full, dtype=dtype)
        decode_forward_check(f"{cfg.arch_id} x{cfg.n_layers} {dtype}", cfg,
                             decode_params(cfg, cfg.n_layers, seed, device),
                             prompt, device)
    counts = ops.launch_counts()
    # two forwards a check, three in bf16 (the float32 control)
    want = {"flash_attention": 5 * yi.n_layers,
            "ssd_chunk_scan": 3 * m_cfg.n_layers + 2 * m32}
    if on_card and any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"decode: launches {counts}, expected {want}")
    log(f"decode: the checks' forwards launched "
        f"{ {k: counts[k] for k in want} } (expected {want} on the card)")
    return {"decode": counts}


TRAIN_LAYERS = 16     # single blocks of the train phase's flux1-dev cut
TRAIN_STEPS = 4


def train_config():
    """flux1-dev at full width for training: d 3072, 24 heads of 128,
    d_ff 12288, patch 2, 16 latent channels, text_dim 4096, bf16.  The
    reference's ``train_dit`` passes no text, so its double blocks never
    run: ``n_double=0``; the 38 single blocks are cut to 16 so that the
    parameters (bf16), their gradients and AdamW's float32 moments (12
    bytes a parameter in all) fit one 80 GB card beside the
    activations."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_config("flux1-dev"), n_double=0,
                               n_layers=TRAIN_LAYERS)


def train_phase(cfg=None, size: int = 128, batch: int = 2,
                steps: int = TRAIN_STEPS, n_steps: int = N_STEPS,
                device: str = "cuda") -> dict:
    """``launch.train.train_dit`` at full flux1-dev width (``train_config``)
    on shapes batches of two 1024² latents (128x128x16, S 4096): every
    step runs 16 flash forward launches, each with its backward kernel.
    Logs per step the loss, grad norm, lr, the forward, backward and
    AdamW times (CUDA events) and the step wall, tokens/s and peak
    memory; checks the losses are finite and that on step 1 every leaf
    the forward uses has a finite non-zero gradient while ``text_proj``
    (no text in training) has none.  Then the saved checkpoint is loaded
    through ``bridge.params_from_checkpoint`` into a ``DiffusionEngine``
    under ``FreqCaPolicy(interval=5)`` and serves one request of 20 steps
    with random text embeddings (512x4096): 6 full steps, kernels 1-3 on
    the trained weights.  Returns the launch counts of the training
    (``train``) and of the request (``train_serve``).  (``cfg``,
    ``size``, ``steps`` and ``device`` let the phase be rehearsed small
    on the CPU.)"""
    import shutil

    import torch

    from repro_torch.checkpointing import bridge, checkpoint
    from repro_torch.core.policies import FreqCaPolicy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import dit
    from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
    cfg, dev = cfg or train_config(), torch.device(device)
    on_card = dev.type == "cuda"
    s_img = (size // cfg.patch_size) ** 2
    params = dit.init_params(cfg, seed=40, device=dev)
    redraw_zero_leaves(params, seed=41)
    n_params = sum(p.numel() for p in _leaves(params))
    paths = checkpoint._flatten_with_paths(params)
    log(f"train: {cfg.arch_id} cut to n_double {cfg.n_double}, n_layers "
        f"{cfg.n_layers} (d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.dtype}): params "
        f"{n_params / 1e9:.3f} B; batch {batch} x {size}² latents (S "
        f"{s_img}), {steps} steps")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    records, bad = [], []

    def on_step(i, metrics, grads):
        records.append(metrics)
        if i:
            return
        for path, g in checkpoint._flatten_with_paths(grads).items():
            used = not path.startswith("text_proj/")
            if used != (g is not None) or (used and not (
                    bool(torch.isfinite(g).all()) and bool(g.any()))):
                bad.append(path)
        if sorted(checkpoint._flatten_with_paths(grads)) != sorted(paths):
            bad.append("tree")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train.train_dit(cfg, steps, batch, str(ckpt_dir), seed=40,
                              log_every=1, size=size, device=dev,
                              params=params, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for i, m in enumerate(records):
        log(f"train: step {i} loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.4e} lr {m['lr']:.3e}" + (
                f"; forward {m['forward_ms']:.1f} ms, backward "
                f"{m['backward_ms']:.1f} ms, AdamW {m['adamw_ms']:.1f} ms, "
                f"step wall {m['step_ms']:.1f} ms, "
                f"{batch * s_img / m['step_ms'] * 1e3:.0f} tokens/s"
                if on_card else ""))
    log(f"train: {steps} steps and the save in {wall:.1f} s (the save "
        f"{wall - sum(m.get('step_ms', 0) for m in records) / 1e3:.1f} s); "
        f"peak memory {peak / 2**30:.2f} GiB; launch counts {counts}; step "
        f"1 gradients: {len(paths)} leaves, off {bad}")
    if len(records) != steps or bad or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in records):
        raise AssertionError(f"train: losses {records}, gradient leaves "
                             f"off {bad}")
    want = {"flash_attention": steps * cfg.n_layers,
            "flash_attention_bwd": steps * cfg.n_layers}
    if on_card and (any(counts[k] != n for k, n in want.items())
                    or sum(counts.values()) != sum(want.values())):
        raise AssertionError(f"train: launches {counts}, expected {want}")
    del trained, params
    gc.collect()
    if on_card:
        # where a step's attention time goes: the two kernels alone at
        # the step's shape, times the layers
        qkv = torch.randn((batch, s_img, cfg.n_heads, cfg.head_dim),
                          device=dev).to(torch.bfloat16)
        o, lse = fa.flash_attention(qkv, qkv, qkv, return_lse=True)
        f_ms = time_ms(lambda: fa.flash_attention(qkv, qkv, qkv,
                                                  return_lse=True), 5)
        b_ms = time_ms(lambda: fa.flash_attention_bwd(qkv, qkv, qkv, o, lse,
                                                      qkv), 5)
        last = records[-1]
        log(f"train: breakdown of the last step ({last['step_ms']:.1f} ms): "
            f"forward {last['forward_ms']:.1f} ms, of it flash "
            f"{cfg.n_layers} x {f_ms:.3f} = {cfg.n_layers * f_ms:.1f} ms; "
            f"backward {last['backward_ms']:.1f} ms, of it flash backward "
            f"{cfg.n_layers} x {b_ms:.3f} = {cfg.n_layers * b_ms:.1f} ms; "
            f"AdamW {last['adamw_ms']:.1f} ms")
        del qkv, o, lse
        torch.cuda.empty_cache()

    # serve one request from the checkpoint
    t0 = time.perf_counter()
    served = bridge.params_from_checkpoint(str(ckpt_dir), steps, cfg,
                                           device=dev)
    load_s = time.perf_counter() - t0
    text = torch.randn((1, cfg.n_text_tokens, cfg.text_dim), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(42)
                       ).to(dit.torch_dtype(cfg.dtype))
    full_fn, from_crf_fn = make_fns(served, cfg, size, text)
    eng = DiffusionEngine(full_fn, from_crf_fn, (size, size, cfg.in_channels),
                          (s_img, cfg.d_model), FreqCaPolicy(interval=5),
                          n_steps=n_steps, max_batch=1, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (res,) = eng.run_batch([DiffusionRequest(request_id=0, seed=43)])
    serve_s = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    want_full = full_steps(n_steps, 5)
    log(f"train: checkpoint loaded in {load_s:.1f} s; one FreqCa request "
        f"served from it in {serve_s:.2f} s, {res.n_full_steps} full steps "
        f"of {n_steps}; launch counts {serve_counts}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if res.n_full_steps != want_full or not bool(
            torch.isfinite(res.latents).all()) or tuple(
            res.latents.shape) != (size, size, cfg.in_channels):
        raise AssertionError(f"train: the served request: {res.n_full_steps} "
                             f"full steps, latents {tuple(res.latents.shape)}")
    want = {"band_split_spectral": want_full,
            "freqca_predict_fused_spectral": n_steps - want_full,
            "flash_attention": want_full * cfg.n_layers}
    if on_card and (any(serve_counts[k] != n for k, n in want.items())
                    or sum(serve_counts.values()) != sum(want.values())):
        raise AssertionError(f"train: served launches {serve_counts}, "
                             f"expected {want}")
    return {"train": counts, "train_serve": serve_counts}


LM_TRAIN_STEPS = 4
LM_TRAIN_SEQ = 4096
LM_TRAIN_MAMBA_BATCH = 8     # train_4k's global batch of 256, cut
LM_TRAIN_YI_LAYERS = 16      # yi-9b's 48 layers, cut
LM_TRAIN_YI_BATCH = 2


def lm_train_run(label: str, cfg, params, batch: int, seq: int, steps: int,
                 kernels, dev, ckpt_dir: str = "", n_launching: int = 0
                 ) -> dict:
    """``launch.train.train_lm`` from ``params`` for ``steps`` steps; logs
    each step's loss, grad norm, lr, forward / backward / AdamW ms, step
    wall and tokens/s (of ``seq`` tokens a sequence), and the peak
    memory; checks finite losses, that on step 0 every leaf has a finite
    non-zero gradient, and that the launches are the plan's: under remat
    two forward launches of the layer's kernel (``kernels[0]``) and one
    backward (``kernels[1]``) per launching layer (``n_launching``,
    default ``cfg.n_layers``) and step, and nothing else.  Returns the
    launch counts, the last step's metrics and the first loss."""
    import torch

    from repro_torch.checkpointing import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    on_card = dev.type == "cuda"
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"{label}: {cfg.arch_id} {cfg.n_layers} layers (d {cfg.d_model}, "
        f"{cfg.dtype}, remat {cfg.remat}): params {n_params / 1e9:.3f} B; "
        f"batch {batch} x {seq} tokens, {steps} steps")
    records, bad = [], []

    def on_step(i, metrics, grads):
        records.append(metrics)
        if i == 0:
            bad.extend(path for path, g in
                       checkpoint._flatten_with_paths(grads).items()
                       if g is None or not (bool(torch.isfinite(g).all())
                                            and bool(g.any())))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trained, losses = train.train_lm(cfg, steps, batch, seq, ckpt_dir,
                                     seed=80, log_every=1, device=dev,
                                     params=params, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for i, m in enumerate(records):
        log(f"{label}: step {i} loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.4e} lr {m['lr']:.3e}" + (
                f" lb_loss {m['lb_loss']:.6f} drop_fraction "
                f"{m['drop_fraction']:.4e}" if "lb_loss" in m else "") + (
                f"; forward {m['forward_ms']:.1f} ms, backward "
                f"{m['backward_ms']:.1f} ms, AdamW {m['adamw_ms']:.1f} ms, "
                f"step wall {m['step_ms']:.1f} ms, "
                f"{batch * seq / m['step_ms'] * 1e3:.0f} tokens/s"
                if on_card else ""))
    log(f"{label}: {steps} steps" + (" and the save" if ckpt_dir else "")
        + f" in {wall:.1f} s; peak memory {peak / 2**30:.2f} GiB; launch "
        f"counts {counts}; step 0 gradients off: {bad}")
    if len(records) != steps or bad or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in records):
        raise AssertionError(f"{label}: losses {losses}, gradient leaves "
                             f"off {bad}")
    n = n_launching or cfg.n_layers
    want = {kernels[0]: steps * 2 * n, kernels[1]: steps * n}
    if on_card and (any(counts[k] != n for k, n in want.items())
                    or sum(counts.values()) != sum(want.values())):
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return {"counts": counts, "last": records[-1], "params": trained,
            "first_loss": losses[0]}


def lm_train_phase(mamba_cfg=None, yi_cfg=None, yi_draw=None,
                   seq: int = LM_TRAIN_SEQ, steps: int = LM_TRAIN_STEPS,
                   device: str = "cuda") -> dict:
    """LM training at full width through ``launch.train.train_lm``
    (AdamW, lr 1e-3 with 10 warmup steps, the stack rematerialised,
    synthetic Markov tokens), ``steps`` steps at ``seq`` tokens, bf16:

    - mamba2-370m at full depth (48 SSD layers, d 1024, 32 heads of 64,
      d_state 128, chunk 256), batch 8 (``train_4k``'s global batch of
      256 cut to what one card holds): per step 96 forward and 48
      backward SSD launches;
    - yi-9b at full width (d 4096, 32/4 heads of 128, d_ff 11008) cut to
      16 of its 48 layers, drawn as the 48-layer model's (3.3 B
      parameters: bf16 weights and gradients and float32 moments,
      ~40 GB), batch 2: per step 32 causal GQA flash forward and 16
      backward launches.  Its checkpoint (~6.6 GB, under
      ``build/lm_train_ckpt/``, removed after) reloads through
      ``bridge`` and runs one ``make_prefill_step`` call, equal to the
      trained parameters' own.

    Logs where each step's backward goes: the backward kernel alone at
    the step's shape, times the layers.  (The configs and ``device``
    let the phase be rehearsed small on the CPU.)"""
    import dataclasses
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch.checkpointing import bridge, checkpoint
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref, ssd_scan
    from repro_torch.launch import steps as step_lib
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}
    # mamba2-370m, full depth
    cfg = mamba_cfg or configs.get_config("mamba2-370m")
    run = lm_train_run("lm_train_mamba2", cfg,
                       lm_params(cfg, cfg.n_layers, seed=70, device=dev),
                       LM_TRAIN_MAMBA_BATCH, seq, steps,
                       ("ssd_chunk_scan", "ssd_chunk_scan_bwd"), dev)
    out["lm_train_mamba2"] = run["counts"]
    last = run["last"]
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        # the two SSD kernels alone at the step's shape (bf16 x [8, 4096,
        # 32, 64] and B, C as column slices), times the launches a step;
        # kernel 8 held against its plain version at this shape first
        ssm = cfg.ssm
        x, dts, a, bm, cm, dy = ssd_bwd_inputs(
            LM_TRAIN_MAMBA_BATCH, torch.bfloat16, seq,
            cfg.d_model * ssm.expand // ssm.head_dim, ssm.d_state)

        def kern():
            return ssd_scan.ssd_chunk_scan_bwd(x, dts, a, bm, cm, dy,
                                               ssm.chunk)
        ssd_bwd_check(f"ssd_chunk_scan_bwd {list(x.shape)}", "bfloat16",
                      kern(), kern(), ref.ssd_chunk_scan_bwd_ref(
                          x, dts, a, bm, cm, dy, ssm.chunk))
        torch.cuda.empty_cache()
        f_ms = time_ms(lambda: ssd_scan.ssd_chunk_scan(x, dts, a, bm, cm,
                                                       ssm.chunk), 3)
        b_ms = time_ms(kern, 3)
        ssd_bwd_split(f"lm_train_mamba2: the SSD backward {list(x.shape)} "
                      "bf16", kern, 3)
        log(f"lm_train_mamba2: breakdown of the last step "
            f"({last['step_ms']:.1f} ms): forward {last['forward_ms']:.1f} "
            f"ms; backward {last['backward_ms']:.1f} ms, of it the SSD "
            f"backward {cfg.n_layers} x {b_ms:.3f} = "
            f"{cfg.n_layers * b_ms:.1f} ms "
            f"({cfg.n_layers * b_ms / last['backward_ms']:.1%}) and the "
            f"remat's SSD forward {cfg.n_layers} x {f_ms:.3f} = "
            f"{cfg.n_layers * f_ms:.1f} ms; the forward's SSD "
            f"{cfg.n_layers * f_ms:.1f} ms; AdamW {last['adamw_ms']:.1f} ms")
        del x, bm, cm, dts, dy
        torch.cuda.empty_cache()

    # yi-9b, 16 of 48 layers
    full = yi_draw or configs.get_config("yi-9b")
    cfg = yi_cfg or dataclasses.replace(full, n_layers=LM_TRAIN_YI_LAYERS)
    ckpt_dir = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run = lm_train_run("lm_train_yi", cfg,
                       lm_params(full, cfg.n_layers, seed=71, device=dev),
                       LM_TRAIN_YI_BATCH, seq, steps,
                       ("flash_attention", "flash_attention_bwd"), dev,
                       ckpt_dir=str(ckpt_dir))
    out["lm_train_yi"] = run["counts"]
    trained, last = run["params"], run["last"]
    del run
    if on_card:
        # the two flash kernels alone at the step's shape (bf16 [2, 4096,
        # 32/4, 128], causal), times the launches a step
        g = torch.Generator(device=dev).manual_seed(72)
        q = torch.randn((LM_TRAIN_YI_BATCH, seq, cfg.n_heads, cfg.head_dim),
                        generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((LM_TRAIN_YI_BATCH, seq, cfg.n_kv_heads,
                             cfg.head_dim), generator=g, device=dev).to(
            torch.bfloat16) for _ in "kv")
        o, lse = fa.flash_attention(q, k, v, cfg.q_per_kv, True,
                                    return_lse=True)
        f_ms = time_ms(lambda: fa.flash_attention(
            q, k, v, cfg.q_per_kv, True, return_lse=True), 3)
        b_ms = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, q, cfg.q_per_kv, True), 3)
        log(f"lm_train_yi: breakdown of the last step "
            f"({last['step_ms']:.1f} ms): forward {last['forward_ms']:.1f} "
            f"ms, of it flash {cfg.n_layers} x {f_ms:.3f} = "
            f"{cfg.n_layers * f_ms:.1f} ms; backward "
            f"{last['backward_ms']:.1f} ms, of it flash backward "
            f"{cfg.n_layers} x {b_ms:.3f} = {cfg.n_layers * b_ms:.1f} ms and "
            f"the remat's flash forward {cfg.n_layers * f_ms:.1f} ms; AdamW "
            f"{last['adamw_ms']:.1f} ms")
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    # the checkpoint, reloaded through bridge, serves one prefill
    t0 = time.perf_counter()
    tree = checkpoint.unflatten(checkpoint.load_flat(str(ckpt_dir), steps,
                                                     cfg.arch_id))
    reloaded = bridge.lm_params_from_jax_numpy(tree, cfg, device=dev)
    load_s = time.perf_counter() - t0
    del tree
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    flat = checkpoint._flatten_with_paths
    mine, back = flat(trained), flat(reloaded)
    same = sorted(mine) == sorted(back) and all(
        torch.equal(mine[k], back[k]) for k in mine)
    del mine, back
    tokens = synthetic.lm_batch(torch.Generator(device=dev).manual_seed(73),
                                1, seq, cfg.vocab_size, device=dev)["tokens"]
    prefill = step_lib.make_prefill_step(cfg)
    want = prefill(trained, {"tokens": tokens}).float()
    ops.reset_launch_counts()
    got = prefill(reloaded, {"tokens": tokens}).float()
    counts = ops.launch_counts()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"lm_train_yi: checkpoint reloaded through bridge in {load_s:.1f} "
        f"s (every leaf equal to the trained one: {same}); "
        f"make_prefill_step [1, {seq}] -> {tuple(got.shape)}, finite "
        f"{bool(torch.isfinite(got).all())}, against the trained "
        f"parameters' max_rel_err {rel:.3e} (tol "
        f"{TOLERANCE['bfloat16']:.0e}); launches {counts}")
    if not same or tuple(got.shape) != (1, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()) or not rel <= TOLERANCE["bfloat16"]:
        raise AssertionError("lm_train_yi: the reloaded checkpoint's "
                             "prefill")
    if on_card and (counts["flash_attention"] != cfg.n_layers
                    or sum(counts.values()) != cfg.n_layers):
        raise AssertionError(f"lm_train_yi: prefill launches {counts}")
    out["lm_train_prefill"] = counts
    del trained, reloaded
    return out


# the moe and lm_configs phases: granite-moe-3b-a800m at full depth
# (32 layers, 3.3 B parameters, 6.6 GB in bf16); phi3.5-moe-42b-a6.6b
# cut to 16 of its 32 layers for prefill and decode (41.6 GB of 83.8)
# and to 2 for training (2.9 B parameters: bf16 weights and gradients
# and float32 moments, ~35 GB); the dense configs cut as LM_CONFIG_LAYERS
MOE_SEQ = 32768               # prefill_32k's length, its batch of 32 cut to 1
MOE_TRAIN_STEPS = 4
MOE_TRAIN_BATCH = 8           # train_4k's global batch of 256, cut
GRANITE_DECODE_BATCH = 16     # decode_32k's 128, cut: a 34.4 GB KV cache
PHI_LAYERS = 16
PHI_TRAIN_LAYERS = 2
PHI_TRAIN_STEPS = 2
PHI_DECODE_BATCH = 8          # decode_32k at 16 layers: a 17.2 GB KV cache
# granite cut to 4 layers for LMEngine against the forward, float32, on
# a 256-token prompt (below the flash threshold: the check is routing's)
MOE_DECODE_LAYERS, MOE_DECODE_PROMPT = 4, 256
# one prefill at 32768 tokens each: deepseek-coder-33b at full depth
# (66.7 GB of weights), llama3-405b cut to 8 of 126 layers (6.4 GB a
# layer + 8.4 GB of embedding and head: 59.7 GB), command-r-plus-104b to
# 16 of 64 (3.15 GB a layer + 12.6 GB: 63.0 GB)
LM_CONFIG_LAYERS = (("deepseek-coder-33b", 62), ("llama3-405b", 8),
                    ("command-r-plus-104b", 16))
# the card-vs-CPU checks of this slice: float32, relative L2 (TF32 off)
MOE_CARD_TOL = {"logits": 1e-4, "loss": 1e-5, "grad": 1e-3}
MOE_REF_SEQ = 512
DENSE_CARD_TOL = 1e-4


class MoESpy:
    """While active, records every ``moe._route`` call's (probs, mask,
    top_k, n_real) and every MoE FFN's aux (``moe_ffn`` /
    ``moe_ffn_gather``, as ``blocks._ffn`` looks them up)."""

    def __init__(self):
        self.routes, self.aux = [], []

    def __enter__(self):
        from repro_torch.models import moe
        self._real = real = (moe._route, moe.moe_ffn, moe.moe_ffn_gather)

        def route(logits, top_k, n_real=0):
            out = real[0](logits, top_k, n_real)
            self.routes.append((out[2].detach(), out[1].detach(), top_k,
                                n_real or logits.shape[-1]))
            return out

        def ffn(fn):
            def wrapper(*args, **kw):
                y, aux = fn(*args, **kw)
                self.aux.append(aux)
                return y, aux
            return wrapper
        moe._route, moe.moe_ffn, moe.moe_ffn_gather = (route, ffn(real[1]),
                                                       ffn(real[2]))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route, moe.moe_ffn, moe.moe_ffn_gather = self._real


def route_gaps(probs, top_k: int, n_real: int):
    """Each token's k-th minus (k+1)-th router probability over the real
    experts."""
    import torch
    top = torch.topk(probs[..., :n_real].float(), top_k + 1, dim=-1).values
    return top[..., top_k - 1] - top[..., top_k]


def route_check(label: str, got, want, strict: bool = True) -> None:
    """Two runs routed the same tokens alike.  ``got`` and ``want`` are
    aligned lists of (probs, mask, top_k, n_real) of the same shapes.  δ
    is the largest difference of any router probability between them.
    ``strict`` (the card-vs-CPU rule): every token's k-th minus (k+1)-th
    probability (``want``'s) must exceed 4δ, so that no selection can
    flip, and then the masks must be equal; a draw that fails the margin
    fails the check.  Otherwise (decode against the forward, whose
    float32 sums differ by more than the card's and the CPU's): every
    token routed apart must lie within 4δ of a tie."""
    delta = max((pg.float().cpu() - pw.float().cpu()).abs().max().item()
                for (pg, *_), (pw, *_) in zip(got, want, strict=True))
    gap, n, differ, clear_apart = float("inf"), 0, 0, 0
    for (pg, mg, k, n_real), (pw, mw, _, _) in zip(got, want, strict=True):
        if pg.shape != pw.shape:
            raise AssertionError(f"{label}: routes {pg.shape} vs "
                                 f"{pw.shape}")
        gaps = route_gaps(pw.cpu(), k, n_real)
        apart = (mg.cpu() != mw.cpu()).any(-1)
        gap = min(gap, gaps.min().item())
        n += gaps.numel()
        differ += int(apart.sum())
        clear_apart += int((apart & (gaps > 4 * delta)).sum())
    near = sum(int((route_gaps(pw.cpu(), k, nr) <= 4 * delta).sum())
               for pw, _, k, nr in want)
    log(f"{label}: {n} routings in {len(want)} MoE calls; largest router "
        f"probability difference δ {delta:.3e}; smallest k-th minus "
        f"(k+1)-th gap {gap:.3e} ({near} within 4δ {4 * delta:.3e}"
        f"{', which the strict rule refuses' if strict else ''}); tokens "
        f"whose experts differ: {differ}, {clear_apart} of them clear of "
        "4δ")
    if strict and not gap > 4 * delta:
        raise AssertionError(f"{label}: a routing within 4δ of a tie")
    if clear_apart or (strict and differ):
        raise AssertionError(f"{label}: {differ} tokens routed apart")


def drop_text(aux) -> str:
    """Each MoE layer's drop fraction, as a short text."""
    drops = [float(a.drop_fraction) for a in aux]
    if not drops:
        return ""
    return (f"drop fractions over {len(drops)} MoE layers: mean "
            f"{sum(drops) / len(drops):.4e}, max {max(drops):.4e}, "
            f"{sum(d > 0 for d in drops)} layers dropping")


def prefill_run(label: str, cfg, params, s: int, dev, reps: int,
                seed: int) -> dict:
    """``make_prefill_step`` on one sequence of ``s`` random tokens,
    ``reps`` times: walls (synchronised host clock), tokens/s, peak
    memory, the flash launches (one a layer on the card, nothing else)
    and, with experts, each layer's drop fraction.  Returns {"counts",
    "logits" (float32, of the last call), "walls", "aux"}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    on_card = torch.device(dev).type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
    step = steps.make_prefill_step(cfg)
    walls = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with MoESpy() as spy:
            t0 = time.perf_counter()
            logits = step(params, {"tokens": tokens})
            if on_card:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    finite = bool(torch.isfinite(logits).all())
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"{label}: {cfg.arch_id} {cfg.n_layers} layers ({n_params / 1e9:.3f}"
        f" B parameters, {cfg.dtype}"
        f"{', impl ' + cfg.moe.impl if cfg.moe else ''}"
        f") make_prefill_step [1, {s}] -> {tuple(logits.shape)} finite "
        f"{finite}: walls (s) {[round(w, 3) for w in walls]}, "
        f"{s / min(walls):.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB,"
        f" launches {counts['flash_attention']} flash; {drop_text(spy.aux)}")
    if tuple(logits.shape) != (1, cfg.vocab_size) or not finite:
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if on_card and (counts["flash_attention"] != cfg.n_layers
                    or sum(counts.values()) != cfg.n_layers):
        raise AssertionError(f"{label}: launches {counts}")
    return {"counts": counts, "logits": logits.float(), "walls": walls,
            "aux": spy.aux}


def moe_layer_rows(label: str, cfg, layer, s: int, dev) -> None:
    """One MoE layer at the prefill's shape (bf16 x [1, s, d], layer 0's
    weights): the einsum dispatch against the gather dispatch (the same
    routing, so their outputs differ by bf16 sums only: 2e-2 of the
    largest; the load-balance and z-losses bitwise; the drop fractions
    to the einsum form's bf16 rounding, since it sums the bf16 dispatch
    tensor, as the reference does), each one's time, and the expert
    products alone (the dispatch share is the rest of the einsum
    form's time)."""
    import torch

    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(120)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=dev).to(
        getattr(torch, cfg.dtype))
    ye, ae = moe.moe_ffn(layer, x, cfg)
    yg, ag = moe.moe_ffn_gather(layer, x, cfg)
    err, rel = compare(f"{label} moe_ffn gather vs einsum", "bfloat16", yg,
                       ye)
    same = all(torch.equal(a, b) for a, b in zip(ae[:2], ag[:2],
                                                 strict=True))
    de, dg = float(ae.drop_fraction), float(ag.drop_fraction)
    log(f"{label}: one MoE layer [1, {s}, {cfg.d_model}] bf16, gather vs "
        f"einsum: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol "
        f"{TOLERANCE['bfloat16']:.0e}); load-balance and z-loss bitwise: "
        f"{same}; drop fraction einsum {de:.4e} (its bf16 sum), gather "
        f"{dg:.4e}")
    if not same or abs(de - dg) > 2.0 ** -8 * max(1.0 - dg, 2.0 ** -8):
        raise AssertionError(f"{label}: gather and einsum aux differ")
    del ye, yg
    if torch.device(dev).type != "cuda":
        return
    g, n, cap = moe._capacity(cfg, s, 2048)
    e = cfg.moe.e_total
    xin = torch.randn((n, e, cap, cfg.d_model), generator=gen,
                      device=dev).to(x.dtype)
    t_e = time_ms(lambda: moe.moe_ffn(layer, x, cfg), 3)
    t_g = time_ms(lambda: moe.moe_ffn_gather(layer, x, cfg), 3)
    t_x = time_ms(lambda: moe._experts(layer, xin), 3)
    ex_flops = 3 * 2 * n * e * cap * cfg.d_model * cfg.d_ff
    disp_flops = 2 * 2 * n * g * e * cap * cfg.d_model
    log(f"{label}: one MoE layer at {s} tokens ({n} groups of {g}, "
        f"capacity {cap}): einsum form {t_e:.3f} ms, gather form {t_g:.3f} "
        f"ms; the expert products alone {t_x:.3f} ms "
        f"({ex_flops / t_x / 1e9:.1f} TFLOP/s), so routing, dispatch and "
        f"combine take {t_e - t_x:.3f} ms of the einsum form "
        f"({(t_e - t_x) / t_e:.1%}; its dispatch and combine products "
        f"{disp_flops / 1e12:.2f} TFLOP against the experts' "
        f"{ex_flops / 1e12:.2f}) and {t_g - t_x:.3f} ms of the gather form")
    del x, xin


def flash_bwd_check(label: str, cfg, batch: int, seq: int, dev,
                    causal: bool = True, form: bool = False) -> None:
    """The flash backward at a training step's shape (``cfg``'s heads,
    causal or not): held against its plain version at batch 1 ([1, seq,
    H/Hkv, hd], dQ, dK, dV each to the bf16 tolerance, two launches
    bitwise) and timed there beside its bound and the plain version;
    then, at the step's batch, the forward (with its log-sum-exp) and
    the backward timed beside the backward's bound and SDPA's backward
    (``torch.autograd.grad`` through SDPA less its forward).  With
    ``form``, the step's numbers (the plain version's at batch 1) are
    recorded as ``flash_attention_bwd[label]`` for the kernels line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(121)
    g, hd, h = cfg.q_per_kv, cfg.head_dim, cfg.n_heads

    def draw(b):
        q = torch.randn((b, seq, h, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, seq, cfg.n_kv_heads, hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in "kv")
        return q, k, v, torch.randn_like(q)

    def bound(q, k):
        work, nb = fa.bwd_work(q.shape[0], seq, seq, h, k.shape[2], hd,
                               causal)
        flops = work["bfloat16"]
        return (flops, *bound_ms(nb, flops, "bfloat16"))
    q, k, v, do = draw(1)
    o, lse = fa.flash_attention(q, k, v, g, causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal)
    err, rels = 0.0, []
    for x, a, a2, w in zip("qkv", got, again, want, strict=True):
        e, r = compare(f"flash_attention_bwd[{label}] d{x}", "bfloat16", a, w)
        if not torch.equal(a, a2):
            raise AssertionError(f"flash_attention_bwd[{label}] d{x}: two "
                                 "launches differ")
        err, rels = max(err, e), rels + [r]
    shape = f"[{batch}, {seq}, {h}/{cfg.n_kv_heads}, {hd}], causal {causal}"
    del got, again, want
    t_k = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, g,
                                                 causal), 3)
    t_p = time_ms(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, g,
                                                causal), 3)
    _, b1_ms, b1_by = bound(q, k)
    log(f"{label}: flash backward [1, {seq}, {h}/{cfg.n_kv_heads}, {hd}], "
        f"causal {causal} vs plain: max_rel_err dq={rels[0]:.3e} "
        f"dk={rels[1]:.3e} dv={rels[2]:.3e} (tol "
        f"{TOLERANCE['bfloat16']:.0e}), two launches bitwise; kernel "
        f"{t_k:.4f} ms, bound {b1_ms:.4f} ms ({b1_by}), plain {t_p:.4f} ms")
    del q, k, v, do, o, lse
    q, k, v, do = draw(batch)
    o, lse = fa.flash_attention(q, k, v, g, causal, return_lse=True)
    f_ms = time_ms(lambda: fa.flash_attention(q, k, v, g, causal,
                                              return_lse=True), 3)
    b_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, g,
                                                  causal), 3)
    leaves = [a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=g > 1)
    t_l = time_ms(lambda: torch.autograd.grad(sdpa(), leaves,
                                              do.transpose(1, 2)), 3) - \
        time_ms(sdpa, 3)
    flops, bb_ms, bb_by = bound(q, k)
    log(f"{label}: flash at the step's shape {shape}: forward with lse "
        f"{f_ms:.3f} ms, backward {b_ms:.3f} ms (bound {bb_ms:.4f} ms, "
        f"{bb_by}; {rate(flops, b_ms, bb_ms)}), library (SDPA backward) "
        f"{t_l:.4f} ms; a step's {cfg.n_layers} layers: forward twice "
        f"(remat) {2 * cfg.n_layers * f_ms:.1f} ms, backward "
        f"{cfg.n_layers * b_ms:.1f} ms")
    if form:
        FORM_ROWS.setdefault(f"flash_attention_bwd[{label}]", {})[
            "bfloat16"] = {"max_abs_err": err, "ms": b_ms, "plain_ms": t_p,
                           "bound_ms": bb_ms, "bound_by": bb_by,
                           "library_ms": t_l, "plain_at_batch": 1}
    del q, k, v, do, o, lse, leaves


def moe_reference(devices=("cpu", "cuda"), cfg=None,
                  seq: int = MOE_REF_SEQ, cache_len: int = 2048) -> None:
    """granite-moe-3b-a800m at full width cut to 2 layers (d 1536, 24
    query heads on 8 kv heads of 64, 40 experts top-8 of width 512;
    vocabulary cut to 8192), float32, on the card against the CPU, with
    the attention projections and the experts drawn at std
    1/sqrt(fan-in) (``decode_params``):

    - ``transformer.forward`` and ``loss_fn`` with every gradient leaf
      (the stack rematerialised, as granite trains) on one Markov
      sequence of ``seq`` tokens (below the flash threshold: the flash
      backward takes bf16 only, and this check is the router's);
    - one ``make_decode_step`` at batch 4 from a seeded cache of
      ``cache_len`` slots at position ``cache_len − 8``.

    Each run's routing is held to the CPU's (``route_check``: every
    routing clear of 4δ, then equal masks), the drop fractions equal.
    Tolerances (MOE_CARD_TOL, relative L2): logits and CRF 1e-4, the
    loss 1e-5 (relative), each gradient leaf 1e-3, the decode step's
    logits and written K / V slot DECODE_CARD_TOL's 1e-4."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.checkpointing import checkpoint
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import blocks, transformer
    from repro_torch.optim import adamw
    full = cfg or configs.get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(full, n_layers=2, vocab_size=8192,
                              dtype="float32")
    params_cpu = decode_params(cfg, 2, seed=110, device="cpu")
    gen = torch.Generator().manual_seed(111)
    data = synthetic.lm_batch(gen, 1, seq, cfg.vocab_size)
    flat = checkpoint._flatten_with_paths
    out = {}
    for dev in devices:
        params = adamw.tree_map(
            lambda p: p.to(dev, copy=True).requires_grad_(True), params_cpu)
        ops.reset_launch_counts()
        with MoESpy() as spy:
            loss, metrics = transformer.loss_fn(
                params, {k: v.to(dev) for k, v in data.items()}, cfg)
        loss.backward()
        with torch.no_grad():
            fwd = transformer.forward(params, data["tokens"].to(dev), cfg)
        out[dev] = {"loss": loss.item(), "spy": spy,
                    "grads": {k: p.grad.cpu()
                              for k, p in flat(params).items()},
                    "logits": fwd.logits.cpu(), "crf": fwd.crf.cpu(),
                    "drop": float(metrics["drop_fraction"]),
                    "launches": sum(ops.launch_counts().values())}
        del params, loss, fwd
    want, got = (out[d] for d in devices)
    route_check(f"reference granite x2 forward ({seq} tokens)",
                got["spy"].routes, want["spy"].routes)
    rels = {k: rel_l2(got[k], want[k]) for k in ("logits", "crf")}
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    g_rels = {k: rel_l2(got["grads"][k], want["grads"][k])
              for k in want["grads"]}
    worst = max(g_rels, key=g_rels.get)
    log(f"reference granite x2 (d {cfg.d_model}, {cfg.moe.n_experts} experts"
        f" top-{cfg.moe.top_k}, float32, S {seq}) card vs CPU: logits rel L2 "
        f"{rels['logits']:.3e}, CRF {rels['crf']:.3e} (tol "
        f"{MOE_CARD_TOL['logits']:.0e}); loss {got['loss']:.6f} / "
        f"{want['loss']:.6f} (rel {loss_rel:.2e}, tol "
        f"{MOE_CARD_TOL['loss']:.0e}); worst gradient leaf rel L2 "
        f"{g_rels[worst]:.2e} ({worst}; tol {MOE_CARD_TOL['grad']:.0e}) over "
        f"{len(g_rels)} leaves; drop fractions {got['drop']:.4e} / "
        f"{want['drop']:.4e}; kernel launches on the card {got['launches']}")
    if (max(rels.values()) > MOE_CARD_TOL["logits"]
            or loss_rel > MOE_CARD_TOL["loss"]
            or g_rels[worst] > MOE_CARD_TOL["grad"]
            or got["drop"] != want["drop"]
            or not all(bool(torch.isfinite(g).all())
                       for g in got["grads"].values())):
        raise AssertionError("reference granite x2: card and CPU disagree")
    del out
    # one decode step from a seeded cache
    pos, batch = cache_len - 8, 4
    cache_cpu = fill_cache(blocks.stack_cache_zeros(
        cfg, batch, cache_len, torch.float32, "cpu"), pos, seed=112)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1),
                           generator=torch.Generator().manual_seed(113))
    outs = {}
    for dev in devices:
        cache = [{k: type(c)(**{f: (t.to(dev, copy=True)
                                    if isinstance(t, torch.Tensor) else t)
                                for f, t in vars(c).items()})
                  for k, c in g.items()} for g in cache_cpu]
        with MoESpy() as spy:
            logits, cache = steps.make_decode_step(cfg)(
                _to(params_cpu, dev), tokens.to(dev), cache)
        written = [t for g in cache for c in g.values()
                   for t in (c.k[:, pos], c.v[:, pos])]
        outs[dev] = ([logits] + written, spy)
    route_check("reference granite x2 decode step", outs[devices[1]][1].routes,
                outs[devices[0]][1].routes)
    rels = [rel_l2(g, w) for g, w in zip(outs[devices[1]][0],
                                         outs[devices[0]][0], strict=True)]
    tol = DECODE_CARD_TOL["float32"]
    log(f"reference granite x2 decode step, batch {batch}, cache {cache_len}"
        f", position {pos}: card vs CPU rel L2 logits {rels[0]:.3e}, "
        f"written cache max {max(rels[1:]):.3e} (tol {tol:.0e})")
    if max(rels) > tol or not bool(torch.isfinite(
            outs[devices[1]][0][0]).all()):
        raise AssertionError(f"reference granite decode: rel L2 {rels}")


def moe_phase(granite_cfg=None, phi_cfg=None, s: int = MOE_SEQ,
              train_seq: int = LM_TRAIN_SEQ, decode_len: int = 0,
              device: str = "cuda") -> dict:
    """The two MoE configs at full width, bf16 from seeds:

    - granite-moe-3b-a800m at full depth (32 layers, 40 experts top-8,
      d 1536, 24/8 heads of 64): ``make_prefill_step`` on 32768 tokens
      with its own dispatch (``einsum``) twice, then once with
      ``gather`` (and both once more on the model drawn at std
      1/sqrt(fan-in), a control for how far the reference's draw
      carries a bf16 difference); one MoE layer's two dispatches held
      against each other and timed (``moe_layer_rows``); the causal GQA
      flash launch (group 3 at hd 64) against its plain version
      (``flash_check``); decode at
      decode_32k (batch 16, 32768 slots) and, through ``for_shape``, at
      long_500k (an 8192-slot ring at position 524279); ``train_lm`` for
      4 steps at S 4096 on batch 8 (remat: 64 flash forward and 32
      backward launches a step), the flash backward at that shape;
      ``moe_reference`` (card against CPU); ``LMEngine`` against the
      forward at 4 layers in float32 (``decode_forward_check``);
    - phi3.5-moe-42b-a6.6b (16 experts top-2, d 4096, d_ff 6400, 32/8
      heads of 128) cut to 16 layers: ``make_prefill_step`` on 32768
      tokens, its flash launch against its plain version, decode at
      decode_32k on batch 8; cut to 2 layers, ``train_lm`` for 2 steps
      at S 4096 on batch 8, the flash backward at that shape.

    Returns the launch counts of each run.  (The configs, lengths and
    ``device`` let the phase be rehearsed small on the CPU.)"""
    import dataclasses

    import torch

    from repro_torch import configs
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    # granite, full depth
    cfg = granite_cfg or configs.get_config("granite-moe-3b-a800m")
    t0 = time.perf_counter()
    params = lm_params(cfg, cfg.n_layers, seed=100, device=dev)
    log(f"moe: {cfg.arch_id} params "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    run = prefill_run("moe granite prefill", cfg, params, s, dev, reps=2,
                      seed=101)
    out["moe_prefill"], einsum_logits = run["counts"], run["logits"]
    gather = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              impl="gather"))
    run = prefill_run("moe granite prefill (gather)", gather, params, s, dev,
                      reps=1, seed=101)
    out["moe_prefill_gather"] = run["counts"]
    rel = rel_l2(run["logits"], einsum_logits)
    del run, einsum_logits
    free()
    # the same comparison on the same architecture drawn at std
    # 1/sqrt(fan-in) (``decode_params``), a control for how far the
    # reference's draw (experts and attention at 1/sqrt(32): sharp
    # softmaxes, each layer's FFN output ~190) carries a bf16 difference
    control = decode_params(cfg, cfg.n_layers, seed=108, device=dev)
    ctrl = rel_l2(*(prefill_run(f"moe granite prefill control ({c.moe.impl}"
                                ", fan-in draw)", c, control, s, dev,
                                reps=1, seed=101)["logits"]
                    for c in (gather, cfg)))
    del control
    free()
    log(f"moe granite prefill: the gather dispatch's last-token logits "
        f"against the einsum dispatch's: rel L2 {rel:.3e}; drawn at std "
        f"1/sqrt(fan-in): {ctrl:.3e} (bf16 sums differ after the first "
        "layer, a later layer may route a near-tie apart, and the "
        "reference's draw amplifies any difference; the layer-level check "
        "below is exact in routing)")
    moe_layer_rows("moe granite", cfg, params["stack"][0]["l0"]["ffn"], s,
                   dev)
    free()
    flash_check("moe granite", cfg, s, dev, seed=102)
    free()
    for label, shape, batch in (("granite_decode_32k", "decode_32k",
                                 GRANITE_DECODE_BATCH),
                                ("granite_long_500k", "long_500k", 1)):
        c = configs.for_shape(cfg, shape)
        length = decode_len or configs.INPUT_SHAPES[shape]["seq_len"]
        window = c.sliding_window
        decode_run(label, c, params, batch, window or length,
                   length - 1 - DECODE_TIMED, window, device)
        free()
    run = lm_train_run("moe_train_granite", cfg, params, MOE_TRAIN_BATCH,
                       train_seq, MOE_TRAIN_STEPS,
                       ("flash_attention", "flash_attention_bwd"), dev)
    out["moe_train_granite"] = run["counts"]
    del run, params
    free()
    if on_card:
        flash_bwd_check("moe_train_granite", cfg, MOE_TRAIN_BATCH,
                        train_seq, dev)
        free()
    moe_reference(devices=("cpu", device), cfg=cfg)
    free()
    small = dataclasses.replace(cfg, n_layers=MOE_DECODE_LAYERS,
                                dtype="float32")
    decode_forward_check(f"{cfg.arch_id} x{small.n_layers} float32", small,
                         decode_params(small, small.n_layers, 103, device),
                         MOE_DECODE_PROMPT, device)
    free()
    out.update(moe_phi(phi_cfg, s, train_seq, decode_len, device))
    return out


def moe_phi(phi_cfg=None, s: int = MOE_SEQ, train_seq: int = LM_TRAIN_SEQ,
            decode_len: int = 0, device: str = "cuda") -> dict:
    """phi3.5-moe-42b-a6.6b cut to PHI_LAYERS for prefill and decode, to
    PHI_TRAIN_LAYERS for training (``moe_phase``'s second half)."""
    import dataclasses

    import torch

    from repro_torch import configs
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    full = phi_cfg or configs.get_config("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(full, n_layers=min(PHI_LAYERS, full.n_layers))
    params = lm_params(full, cfg.n_layers, seed=104, device=dev)
    run = prefill_run("moe phi prefill", cfg, params, s, dev, reps=1,
                      seed=105)
    out["moe_prefill_phi"] = run["counts"]
    del run
    free()
    flash_check("moe phi", cfg, s, dev, seed=106)
    free()
    c = configs.for_shape(cfg, "decode_32k")
    length = decode_len or configs.INPUT_SHAPES["decode_32k"]["seq_len"]
    decode_run("phi_decode_32k", c, params, PHI_DECODE_BATCH, length,
               length - 1 - DECODE_TIMED, 0, device)
    del params
    free()
    cfg = dataclasses.replace(full, n_layers=min(PHI_TRAIN_LAYERS,
                                                 full.n_layers))
    run = lm_train_run("moe_train_phi", cfg,
                       lm_params(full, cfg.n_layers, seed=107, device=dev),
                       MOE_TRAIN_BATCH, train_seq, PHI_TRAIN_STEPS,
                       ("flash_attention", "flash_attention_bwd"), dev)
    out["moe_train_phi"] = run["counts"]
    del run
    free()
    if on_card:
        flash_bwd_check("moe_train_phi", cfg, MOE_TRAIN_BATCH, train_seq,
                        dev)
        free()
    return out


def dense_reference(devices=("cpu", "cuda"), cfgs=None) -> None:
    """Each dense config of this slice at full width (d_model, heads and
    kv heads; d_ff cut to 2048 and the vocabulary to 8192, so that the
    CPU side stays short) cut to 2 layers, float32, attention projections
    at std 1/sqrt(fan-in) (``decode_params``), through
    ``transformer.forward`` at 2048 tokens: the causal GQA flash kernel
    on the card (groups of 7, 16 and 12), the blockwise plain version on
    the CPU; logits and CRF rel L2 DENSE_CARD_TOL (1e-4).  A control,
    the card's forward with TF32 matmuls, must fail that limit."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    for seed, (arch, _) in enumerate(LM_CONFIG_LAYERS, start=130):
        full = (cfgs or configs.get_config)(arch)
        cfg = dataclasses.replace(full, n_layers=2, d_ff=min(full.d_ff, 2048),
                                  vocab_size=min(full.vocab_size, 8192),
                                  dtype="float32")
        params_cpu = decode_params(cfg, 2, seed, "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048),
                               generator=torch.Generator().manual_seed(seed))
        outs, control = {}, None
        for dev in devices:
            ops.reset_launch_counts()
            params = _to(params_cpu, dev)
            with torch.no_grad():
                outs[dev] = transformer.forward(params, tokens.to(dev), cfg)
                n = ops.launch_counts()["flash_attention"]
                if torch.device(dev).type == "cuda":
                    if n != cfg.n_layers:
                        raise AssertionError(f"dense reference {arch}: {n} "
                                             "flash launches")
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        control = transformer.forward(params, tokens.to(dev),
                                                      cfg)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
            del params
        want, got = (outs[d] for d in devices)
        for name in ("logits", "crf"):
            rel = rel_l2(getattr(got, name), getattr(want, name))
            ctrl = (None if control is None else
                    rel_l2(getattr(control, name), getattr(want, name)))
            log(f"reference {arch} x2 (d {cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}) forward at S 2048 "
                f"[{name}] card vs CPU: rel L2 {rel:.3e} (tol "
                f"{DENSE_CARD_TOL:.0e})" + ("" if ctrl is None else
                                            f", the TF32 control {ctrl:.3e}"))
            if not bool(torch.isfinite(getattr(got, name)).all()) or \
                    rel > DENSE_CARD_TOL:
                raise AssertionError(f"dense reference {arch} [{name}]: "
                                     f"{rel:.3e}")
            if ctrl is not None and not ctrl > DENSE_CARD_TOL:
                raise AssertionError(f"dense reference {arch} [{name}]: the "
                                     f"TF32 control {ctrl:.3e} passes")
        del outs, control, params_cpu
        gc.collect()


def lm_configs_phase(cfgs=None, s: int = MOE_SEQ,
                     device: str = "cuda") -> dict:
    """The three dense configs of this slice at full width, bf16 from
    seeds, cut as LM_CONFIG_LAYERS: one ``make_prefill_step`` each on
    32768 tokens (one causal GQA flash launch a layer: groups of 7, 16
    and 12 at hd 128), each model freed before the next is drawn, then
    the flash launch at that config's shape held against its plain
    version and timed (``flash_check``); last, ``dense_reference``.
    Returns each prefill's launch counts."""
    import dataclasses

    import torch

    from repro_torch import configs
    dev = torch.device(device)
    out = {}
    for seed, (arch, n_layers) in enumerate(LM_CONFIG_LAYERS, start=140):
        full = (cfgs or configs.get_config)(arch)
        cfg = dataclasses.replace(full, n_layers=min(n_layers,
                                                     full.n_layers))
        t0 = time.perf_counter()
        params = lm_params(full, cfg.n_layers, seed=seed, device=dev)
        log(f"lm_configs: {arch} cut to {cfg.n_layers} of {full.n_layers} "
            f"layers, params drawn in {time.perf_counter() - t0:.1f} s")
        run = prefill_run(f"lm_configs {arch}", cfg, params, s, dev, reps=1,
                          seed=seed)
        out[f"lm_configs_{arch}"] = run["counts"]
        del run, params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        flash_check(f"lm_configs {arch}", cfg, s, dev, seed=seed)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dense_reference(devices=("cpu", device), cfgs=cfgs)
    return out


# ---------------------------------------------------------------------------
# the last three configs: jamba (hybrid, SSD heads of 128), seamless
# (enc-dec), llava (modality prefix)
# ---------------------------------------------------------------------------

JAMBA_SEQ = 32768            # prefill_32k's length, its batch of 32 cut to 1
JAMBA_BWD_SEQ = 4096
# card against CPU: l0 (mamba2 + dense SwiGLU) at full SSM width, d_ff
# cut to 2048 so that the CPU side stays short, float32, relative L2 of
# the output and of the worst gradient (the SSD backward's float32 sums
# over 256-token chunks and its dA, a sum whose terms cancel, read
# 2.7e-5); the forward and the backward with TF32 matmuls must fail each
JAMBA_REF_SEQ, JAMBA_REF_DFF = 1024, 2048
JAMBA_CARD_TOL = {"out": 1e-4, "grad": 2e-4}
SEAMLESS_SEQ = 32768          # frames and tokens of one prefill
SEAMLESS_CROSS_Q = 4096       # the cross form's queries on a long memory
SEAMLESS_TRAIN_BATCH, SEAMLESS_TRAIN_SEQ = 8, 4096
SEAMLESS_TRAIN_STEPS = 3
SEAMLESS_DECODE_BATCH = 16    # decode_32k's 128, cut: 12 x 2.1 GB of cache
# card against CPU: 2 + 2 layers at full width, vocabulary cut to 8192,
# S = T = 2048 (every attention on the flash kernel), float32, rel L2
SEAMLESS_REF = dict(n_layers=2, n_enc_layers=2, vocab_size=8192)
SEAMLESS_REF_SEQ = 2048
ENCDEC_CARD_TOL = 1e-4
LLAVA_TRAIN_LAYERS = 4        # of 60: ~6.7 GB a layer trained
LLAVA_TRAIN_BATCH, LLAVA_TRAIN_STEPS = 8, 2
LLAVA_TRAIN_SEQ = 4096        # 2880 prefix + 1216 text
LLAVA_REF = dict(n_layers=2, d_ff=2048, vocab_size=8192, n_prefix_tokens=1024)
LLAVA_REF_TEXT = 1024


def _on_card(dev) -> bool:
    import torch
    return torch.device(dev).type == "cuda"


def _sync(dev) -> None:
    import torch
    if _on_card(dev):
        torch.cuda.synchronize()


def _free(dev) -> None:
    import torch
    gc.collect()
    if _on_card(dev):
        torch.cuda.empty_cache()


def _peak_gib(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30 if _on_card(dev) else 0.0


def _reset_peak(dev) -> None:
    import torch
    if _on_card(dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _event(dev):
    """A CUDA event recorded now on the card, the host clock elsewhere."""
    import torch
    if not _on_card(dev):
        return time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _ms(a, b) -> float:
    return a.elapsed_time(b) if not isinstance(a, float) else (b - a) * 1e3


def _timed(fn, into: list, dev):
    """``fn`` wrapped to append each call's (start, end) ``_event`` pair
    to ``into``."""
    def wrapper(*args, **kw):
        a = _event(dev)
        y = fn(*args, **kw)
        into.append((a, _event(dev)))
        return y
    return wrapper


def _recorded(fn, into: list):
    """``fn`` wrapped to append each call's (args, result) to ``into``."""
    def wrapper(*args):
        y = fn(*args)
        into.append((args, y))
        return y
    return wrapper


def flash_form_row(label: str, s: int, t: int, hq: int, hkv: int, hd: int,
                   causal: bool, dev, seed: int) -> None:
    """One flash launch at a new form, bf16 [1, S, hq/hkv, hd] queries on T
    keys: held against the plain version on the first and the last
    ``n_q`` queries with every key they see, then timed beside its bound
    and SDPA; recorded as ``flash_attention[label]`` (the plain version
    at this size is not timed: its [H, S, T] float32 logits)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention
    g = hq // hkv
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, s, hq, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, t, hkv, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in "kv")
    got = ops.flash(q, k, v, g, causal=causal)
    n_q = min(max(128, 1024 * 32 // hq), s)
    err = rel = 0.0
    for q0 in (0, s - n_q):
        end = q0 + n_q if causal else t
        mask = (attention.causal_mask(n_q, offset=q0, device=dev) if causal
                else None)
        want = ref.sdpa_ref(q[:, q0:q0 + n_q], k[:, :end], v[:, :end], mask,
                            g)
        e, r = compare(f"flash_attention[{label}]", "bfloat16",
                       got[:, q0:q0 + n_q].contiguous(), want)
        err, rel = max(err, e), max(rel, r)
        del want
    del got
    shape = f"[1, {s}, {hq}/{hkv}, {hd}] on T {t}, causal {causal}"
    if not _on_card(dev):
        log(f"{label}: flash {shape} vs plain: max_rel_err {rel:.3e}")
        return
    work, nb = fa.fwd_work(1, s, t, hq, hkv, hd, "bfloat16", causal)
    flops = work["bfloat16"]
    b_ms, b_by = bound_ms(nb, flops, "bfloat16")
    t_k = time_ms(lambda: ops.flash(q, k, v, g, causal=causal), reps=3)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    t_l = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=g > 1), reps=3)
    log(f"kernel flash_attention[{label}] [bfloat16] {shape}: queries "
        f"0:{n_q} and {s - n_q}:{s} vs plain max_abs_err={err:.3e} "
        f"max_rel_err={rel:.3e} (tol {TOLERANCE['bfloat16']:.0e}) "
        f"kernel_ms={t_k:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms="
        f"{t_l:.4f} (SDPA) {rate(flops, t_k, b_ms)}")
    FORM_ROWS.setdefault(f"flash_attention[{label}]", {})["bfloat16"] = {
        "max_abs_err": err, "ms": t_k, "plain_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": t_l}
    del q, k, v, qt, kt, vt


def ssd_launch_check(label: str, args, got) -> None:
    """One ``ops.ssd`` call of a main-path run (its inputs and output as
    ``_recorded`` kept them) held against the plain version on the same
    inputs, at ``TOLERANCE`` for x's type."""
    import torch

    from repro_torch.kernels import ref
    x, dt, a, bm, cm, chunk = args
    dtype = str(x.dtype).removeprefix("torch.")
    with torch.no_grad():
        want = ref.ssd_chunk_scan_ref(x, dt.float(), a.float(), bm, cm,
                                      chunk)
    err, rel = compare(f"ssd_chunk_scan[{label}]", dtype, got, want)
    log(f"{label}: its SSD launch {list(x.shape)} (N {bm.shape[-1]}, Q "
        f"{chunk}, {x.shape[1] // chunk} chunks) vs plain on the same "
        f"inputs: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol "
        f"{TOLERANCE[dtype]:.0e})")


def jamba_group(cfg, s: int, dev) -> dict:
    """One full-width jamba group (l0–l7: seven mamba2 layers and one
    attention layer, the MoE FFN on l1, l3, l5, l7), bf16, layer at a
    time at batch 1 over ``s`` tokens: the embedding, then each layer's
    parameters drawn from its own seed with the model's specs (the
    reference's rule) and ``blocks.block_full`` run, the same code
    ``stack_full`` runs, each layer freed before the next is drawn (the
    88 GB group cannot be held at once); last the final norm and the
    last token's logits.  Logs each layer's ms (CUDA events), each MoE
    layer's drop fraction, the peak; 7 SSD and 1 flash launches.  l0's
    SSD launch is held against the plain version on its own inputs
    (``ssd_launch_check``).  Returns the launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import blocks, common, transformer
    specs = transformer.lm_specs(cfg)
    dtype = getattr(torch, cfg.dtype)
    _, _, plan = blocks._layer_plan(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(160))
    _reset_peak(dev)
    ops.reset_launch_counts()
    rows, t_all = [], time.perf_counter()
    with torch.no_grad():
        emb = common.init_params(specs["embed"], seed=161, device=dev,
                                 dtype=dtype)
        h = common.embed(emb, tokens).to(dtype)
        del emb
        for i, (kind, is_moe) in enumerate(plan):
            t0 = time.perf_counter()
            layer = common.init_params(specs["stack"][0][f"l{i}"],
                                       seed=162 + i, device=dev, dtype=dtype)
            _sync(dev)
            draw_s = time.perf_counter() - t0
            n = sum(p.numel() for p in _leaves(layer))
            ssd_calls, real_ssd = [], ops.ssd
            if i == 0:
                ops.ssd = _recorded(real_ssd, ssd_calls)
            try:
                with MoESpy() as spy:
                    a = _event(dev)
                    h, _ = blocks.block_full(layer, h, cfg, kind, is_moe)
                    b = _event(dev)
            finally:
                ops.ssd = real_ssd
            _sync(dev)
            rows.append((i, kind, is_moe, n, _ms(a, b), draw_s,
                         drop_text(spy.aux)))
            del layer
            if ssd_calls:
                ssd_launch_check(f"jamba group l{i}", *ssd_calls[0])
            del ssd_calls
            _free(dev)
        tail = common.init_params({"final_norm": specs["final_norm"],
                                   "head": specs["head"]}, seed=170,
                                  device=dev, dtype=dtype)
        hn = common.rmsnorm(tail["final_norm"], h[:, -1:], cfg.norm_eps)
        logits = (hn @ tail["head"]["kernel"].to(hn.dtype))[:, 0]
        _sync(dev)
    wall = time.perf_counter() - t_all
    counts = ops.launch_counts()
    for i, kind, is_moe, n, ms, draw_s, drops in rows:
        log(f"jamba group l{i}: {kind}{' + MoE FFN' if is_moe else ''} "
            f"({n / 1e9:.3f} B parameters, drawn in {draw_s:.2f} s): "
            f"{ms:.3f} ms over [1, {s}]" + (f"; {drops}" if drops else ""))
    finite = bool(torch.isfinite(logits).all())
    total = sum(r[4] for r in rows)
    log(f"jamba group: {cfg.arch_id} one group of {len(plan)} layers at "
        f"full width, layer at a time: layers {total:.1f} ms "
        f"({s / total * 1e3:.0f} tokens/s), wall with the draws "
        f"{wall:.1f} s; logits {tuple(logits.shape)} finite {finite}; peak "
        f"memory {_peak_gib(dev):.2f} GiB; launches {counts}")
    want = {"ssd_chunk_scan": sum(k == "ssm" for k, _ in plan),
            "flash_attention": sum(k == "attn" for k, _ in plan)}
    if _on_card(dev) and (any(counts[k] != n for k, n in want.items())
                          or sum(counts.values()) != sum(want.values())):
        raise AssertionError(f"jamba group: launches {counts}, expected "
                             f"{want}")
    if not finite or tuple(logits.shape) != (1, cfg.vocab_size):
        raise AssertionError(f"jamba group: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    return counts


def jamba_l0_backward(cfg, s: int, dev) -> dict:
    """The backward of l0 (mamba2 + dense SwiGLU) at full width, bf16,
    batch 1 over ``s`` tokens: ``blocks.block_full`` under autograd, a
    random output gradient; one SSD forward and one SSD backward launch
    (kernel 8 on heads of 128), every parameter's and the input's
    gradient finite and non-zero.  Returns the launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import blocks, common, transformer
    dtype = getattr(torch, cfg.dtype)
    layer = common.init_params(transformer.lm_specs(cfg)["stack"][0]["l0"],
                               seed=171, device=dev, dtype=dtype)
    leaves = [p.requires_grad_() for p in _leaves(layer)]
    gen = torch.Generator(device=dev).manual_seed(172)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=dev).to(
        dtype).requires_grad_()
    dy = torch.randn((1, s, cfg.d_model), generator=gen, device=dev).to(
        dtype)
    _reset_peak(dev)
    ops.reset_launch_counts()
    a = _event(dev)
    out, _ = blocks.block_full(layer, x, cfg, "ssm", False)
    b = _event(dev)
    out.backward(dy)
    c = _event(dev)
    _sync(dev)
    counts = ops.launch_counts()
    bad = [tuple(p.shape) for p in leaves + [x] if p.grad is None or not (
        bool(torch.isfinite(p.grad).all()) and bool(p.grad.any()))]
    log(f"jamba l0 backward [1, {s}, {cfg.d_model}] bf16: forward "
        f"{_ms(a, b):.3f} ms, backward {_ms(b, c):.3f} ms; peak "
        f"{_peak_gib(dev):.2f} GiB; launches {counts}; gradients off: "
        f"{bad}")
    if bad or (_on_card(dev) and (
            counts["ssd_chunk_scan"] != 1 or counts["ssd_chunk_scan_bwd"] != 1
            or sum(counts.values()) != 2)):
        raise AssertionError(f"jamba l0 backward: launches {counts}, "
                             f"gradients off {bad}")
    return counts


def jamba_reference(devices=("cpu", "cuda"), cfg=None,
                    seq: int = JAMBA_REF_SEQ) -> None:
    """jamba's l0 (mamba2 at full SSM width: d 8192, 128 heads of 128,
    state 128, chunk 256; the dense SwiGLU cut to d_ff 2048) in float32
    over ``seq`` tokens, on the card (kernels 6 and 8) against the CPU
    (the plain versions): the output and the gradient of every parameter
    and of the input for a random output gradient, relative L2
    (``JAMBA_CARD_TOL``); a control, the card's forward and backward with
    TF32 matmuls, must fail both limits."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import blocks, common
    full = cfg or configs.get_config("jamba-1.5-large-398b")
    c = dataclasses.replace(full, d_ff=min(full.d_ff, JAMBA_REF_DFF),
                            dtype="float32")
    _, ng, _ = blocks._layer_plan(c)
    params_cpu = common.init_params(blocks.block_specs(c, "ssm", False, ng),
                                    seed=175, device="cpu")
    gen = torch.Generator().manual_seed(176)
    x = torch.randn((1, seq, c.d_model), generator=gen)
    dy = torch.randn((1, seq, c.d_model), generator=gen)
    def run(dev):
        params = _to(params_cpu, dev, copy=True)
        leaves = [p.requires_grad_() for p in _leaves(params)]
        xl = x.to(dev, copy=True).requires_grad_()
        out, _ = blocks.block_full(params, xl, c, "ssm", False)
        out.backward(dy.to(dev))
        return (out.detach().cpu(),
                [p.grad.cpu() for p in leaves] + [xl.grad.cpu()])

    def errors(got):
        return (rel_l2(got[0], want[0]),
                max(rel_l2(a, b) for a, b in zip(got[1], want[1],
                                                 strict=True)))
    want, got = run(devices[0]), run(devices[1])
    _free(devices[1])
    rel, worst = errors(got)
    ctrl = None
    if _on_card(devices[1]):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctrl = errors(run(devices[1]))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        _free(devices[1])
    log(f"jamba reference l0 (d {c.d_model}, {c.n_ssm_heads} SSD heads of "
        f"{c.ssm.head_dim}, d_ff {c.d_ff}) float32 over {seq} tokens, card "
        f"vs CPU: output rel L2 {rel:.3e} (tol {JAMBA_CARD_TOL['out']:.0e}), "
        f"worst of {len(got[1])} gradients {worst:.3e} (tol "
        f"{JAMBA_CARD_TOL['grad']:.0e})" + (
            "" if ctrl is None else f"; the TF32 control: output "
            f"{ctrl[0]:.3e}, worst gradient {ctrl[1]:.3e}"))
    if not bool(torch.isfinite(got[0]).all()) or \
            rel > JAMBA_CARD_TOL["out"] or worst > JAMBA_CARD_TOL["grad"]:
        raise AssertionError(f"jamba reference: output {rel:.3e}, "
                             f"gradients {worst:.3e}")
    if ctrl is not None and not (ctrl[0] > JAMBA_CARD_TOL["out"]
                                 and ctrl[1] > JAMBA_CARD_TOL["grad"]):
        raise AssertionError(f"jamba reference: the TF32 control {ctrl} "
                             "passes")


def jamba_phase(cfg=None, s: int = JAMBA_SEQ, bwd_seq: int = JAMBA_BWD_SEQ,
                ref_seq: int = JAMBA_REF_SEQ, device: str = "cuda") -> dict:
    """jamba-1.5-large-398b: one full-width group layer at a time at
    ``s`` tokens (``jamba_group``), its attention launch at that shape
    (causal GQA 64/8, hd 128) against the plain version and SDPA
    (``flash_check``), l0's backward at ``bwd_seq``
    (``jamba_l0_backward``), l0 card against CPU (``jamba_reference``).
    (Kernels 6 and 8 at a jamba layer's shape are rows of the kernel
    phase.)  Returns each run's launch counts."""
    from repro_torch import configs
    cfg = cfg or configs.get_config("jamba-1.5-large-398b")
    out = {"jamba_group": jamba_group(cfg, s, device)}
    _free(device)
    flash_check("jamba", cfg, s, device, seed=163)
    _free(device)
    out["jamba_l0_backward"] = jamba_l0_backward(cfg, bwd_seq, device)
    _free(device)
    jamba_reference(("cpu", device), cfg, ref_seq)
    _free(device)
    return out


def encdec_params(cfg, seed: int, device, fan_in: bool = False):
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import common
    params = common.init_params(steps.model_specs(cfg), seed=seed,
                                device=device,
                                dtype=getattr(torch, cfg.dtype))
    if fan_in:
        fan_in_redraw(params, seed + 1)
    return params


def grad_norm_at_draw(label: str, cfg, params, batch: int, seq: int,
                      dev) -> None:
    """One ``train_lm`` step from ``params``: logs its grad_norm (the
    float32 sum of squares, the reference's ``global_norm``) beside the
    same gradients' norm summed in float64 and their largest entry;
    every gradient leaf must be finite."""
    import torch

    from repro_torch.launch import train
    from repro_torch.optim import adamw
    seen = {}

    def on_step(i, metrics, grads):
        g = [x for x in adamw.leaves(grads) if x is not None]
        seen.update(metrics, finite=all(bool(torch.isfinite(x).all())
                                        for x in g),
                    norm64=math.sqrt(sum(float(torch.linalg.vector_norm(
                        x, dtype=torch.float64)) ** 2 for x in g)),
                    amax=max(float(x.abs().max()) for x in g))
    train.train_lm(cfg, 1, batch, seq, "", seed=80, log_every=1, device=dev,
                   params=params, on_step=on_step)
    log(f"{label}: batch {batch} x {seq}: loss {seen['loss']:.4f}, "
        f"grad_norm {seen['grad_norm']:.4e} (float32); the same gradients' "
        f"norm in float64 {seen['norm64']:.4e} (float32's largest "
        f"{torch.finfo(torch.float32).max:.4e}), largest entry "
        f"{seen['amax']:.4e}, every leaf finite {seen['finite']}")
    if not seen["finite"]:
        raise AssertionError(f"{label}: a gradient leaf is not finite")


def encdec_prefill(label: str, cfg, params, s: int, dev, reps: int) -> dict:
    """``make_prefill_step`` on frames [1, s, d] (N(0, 0.1²)) and ``s``
    tokens, ``reps`` times: walls, tokens/s, peak, the flash launches by
    form (non-causal S = T: the encoder's and the cross-attention's;
    causal: the decoder's self-attention; nothing else); then one more
    run with events around the encoder and every self- and
    cross-attention for the split.  Returns the launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import attention, encdec
    gen = torch.Generator(device=dev).manual_seed(151)
    batch = {"frames": torch.randn((1, s, cfg.d_model), generator=gen,
                                   device=dev) * 0.1,
             "tokens": torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                                     generator=gen)}
    step = steps.make_prefill_step(cfg)
    forms, walls, real = [], [], ops.flash

    def flash_spy(q, k, v, q_per_kv=1, causal=False, window=0):
        forms.append((q_per_kv, causal, window, q.shape[1], k.shape[1]))
        return real(q, k, v, q_per_kv, causal, window)
    ops.flash = flash_spy
    try:
        for _ in range(reps):
            _reset_peak(dev)
            ops.reset_launch_counts()
            forms.clear()
            t0 = time.perf_counter()
            logits = step(params, batch)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
    finally:
        ops.flash = real
    peak = _peak_gib(dev)
    finite = bool(torch.isfinite(logits).all())
    by_form = {}
    for f in forms:
        by_form[f] = by_form.get(f, 0) + 1
    # the split: the encoder, and every attention of the decoder
    marks = {"self": [], "cross": []}
    saved = (encdec.encode, attention.self_attention,
             attention.cross_attention)

    enc = []
    encdec.encode = _timed(saved[0], enc, dev)
    attention.self_attention = _timed(saved[1], marks["self"], dev)
    attention.cross_attention = _timed(saved[2], marks["cross"], dev)
    try:
        a = _event(dev)
        step(params, batch)
        b = _event(dev)
        _sync(dev)
    finally:
        encdec.encode, attention.self_attention, attention.cross_attention = \
            saved
    total, enc_ms = _ms(a, b), _ms(*enc[0])
    self_ms = [_ms(x, y) for x, y in marks["self"]]
    cross_ms = sum(_ms(x, y) for x, y in marks["cross"])
    dec_self = sum(self_ms[cfg.n_enc_layers:])
    log(f"{label}: {cfg.arch_id} ({cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
        f"parameters, {cfg.dtype}) make_prefill_step on frames [1, {s}, "
        f"{cfg.d_model}] and {s} tokens -> {tuple(logits.shape)} finite "
        f"{finite}: walls (s) {[round(w, 3) for w in walls]}, "
        f"{s / min(walls):.0f} tokens/s, peak {peak:.2f} GiB; flash "
        f"launches {counts['flash_attention']} by (q_per_kv, causal, window,"
        f" S, T): {by_form}")
    log(f"{label}: split of one more prefill ({total:.1f} ms):"
        f" the encoder {enc_ms:.1f} ms ({enc_ms / total:.1%}; its "
        f"self-attention {sum(self_ms[:cfg.n_enc_layers]):.1f} ms), the "
        f"decoder {total - enc_ms:.1f} ms: self-attention {dec_self:.1f} "
        f"ms, cross-attention {cross_ms:.1f} ms ({cross_ms / total:.1%}), "
        f"the rest (FFNs, norms, head) "
        f"{total - enc_ms - dec_self - cross_ms:.1f} ms")
    n_nc, n_c = cfg.n_enc_layers + cfg.n_layers, cfg.n_layers
    want = {(1, False, 0, s, s): n_nc, (1, True, 0, s, s): n_c}
    if tuple(logits.shape) != (1, cfg.vocab_size) or not finite:
        raise AssertionError(f"{label}: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if _on_card(dev) and (by_form != want or counts["flash_attention"]
                          != n_nc + n_c or sum(counts.values()) != n_nc + n_c):
        raise AssertionError(f"{label}: launches {counts}, forms {by_form}")
    return counts


def encdec_decode(label: str, cfg, params, batch: int, cache_len: int,
                  dev) -> None:
    """``make_decode_step`` against a memory of ``cache_len`` frames (the
    reference's decode input: memory [B, seq, d]) from seeded KV caches
    of ``cache_len`` slots at position ``cache_len`` − 1 − DECODE_TIMED:
    one warm and DECODE_TIMED timed greedy steps (CUDA events), then one
    with events around every self- and cross-attention for the split;
    bound, peak, no kernel launched (decode attends through
    ``ref.sdpa_ref`` and the cross-attention recomputes the memory's K
    and V every step, as the reference does)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import attention, encdec
    dtype = getattr(torch, cfg.dtype)
    pos = cache_len - 1 - DECODE_TIMED
    gen = torch.Generator(device=dev).manual_seed(152)
    cache = encdec.decode_cache_zeros(cfg, batch, cache_len, dtype, dev)
    for c in cache:
        c.k.normal_(generator=gen)
        c.v.normal_(generator=gen)
        c.index = pos
    memory = torch.randn((batch, cache_len, cfg.d_model), generator=gen,
                         device=dev).to(dtype)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), device=dev,
                           generator=gen)
    step = steps.make_decode_step(cfg)
    _reset_peak(dev)
    ops.reset_launch_counts()
    logits, _ = step(params, tokens, cache, memory)          # warm
    walls = []
    for _ in range(DECODE_TIMED):
        tokens = torch.argmax(logits[:, -1:], dim=-1)
        a = _event(dev)
        logits, _ = step(params, tokens, cache, memory)
        walls.append((a, _event(dev)))
    _sync(dev)
    walls = [_ms(a, b) for a, b in walls]
    counts = ops.launch_counts()
    peak = _peak_gib(dev)
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) or not finite or \
            any(c.index != pos + 1 + DECODE_TIMED for c in cache) or \
            any(counts.values()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} finite "
                             f"{finite}, positions "
                             f"{sorted({c.index for c in cache})}, launches "
                             f"{counts}")
    for c in cache:
        c.index = pos + DECODE_TIMED
    marks = {"self": [], "cross": []}
    saved = (attention.decode_self_attention, attention.cross_attention)

    attention.decode_self_attention = _timed(saved[0], marks["self"], dev)
    attention.cross_attention = _timed(saved[1], marks["cross"], dev)
    try:
        a = _event(dev)
        step(params, tokens, cache, memory)
        b = _event(dev)
        _sync(dev)
    finally:
        attention.decode_self_attention, attention.cross_attention = saved
    split = _ms(a, b)
    self_ms = sum(_ms(x, y) for x, y in marks["self"])
    cross_ms = sum(_ms(x, y) for x, y in marks["cross"])
    d, n_l = cfg.d_model, cfg.n_layers
    # the decoder's weights (the encoder's and the embedding table's
    # stay unread; of the table only the batch's rows)
    weights = [p for k, v in params.items() if k not in (
        "encoder", "enc_proj", "enc_norm", "embed") for p in _leaves(v)]
    # every weight once, each cache read and one slot written, the memory
    # read once a layer (its K and V projections), the logits written
    nbytes = (sum(p.nbytes for p in weights)
              + sum(c.k.nbytes + c.v.nbytes for c in cache)
              + n_l * memory.nbytes + batch * cfg.vocab_size * 2)
    # 2 a weight and token, the memory's K and V projections, attention
    # 4·hd a head and key over the cache and the memory
    flops = (2.0 * batch * sum(p.numel() for p in weights)
             + n_l * 2 * 2.0 * batch * cache_len * d * d
             + n_l * 4.0 * cfg.head_dim * cfg.n_heads * batch * 2 * cache_len)
    b_ms, b_by = bound_ms(nbytes, flops, cfg.dtype)
    mean = sum(walls) / len(walls)
    log(f"decode {label}: {cfg.arch_id} {n_l} decoder layers, batch {batch},"
        f" KV caches of {cache_len} slots at {pos}, memory [{batch}, "
        f"{cache_len}, {d}]: step walls (ms, CUDA events) "
        f"{[round(w, 3) for w in walls]}, mean {mean:.3f}, "
        f"{batch / mean * 1e3:.1f} tokens/s; peak {peak:.2f} GiB; bound "
        f"{b_ms:.3f} ms ({b_by}: {nbytes / 1e9:.2f} GB, {flops / 1e12:.2f} "
        f"TFLOP), mean/bound {mean / b_ms:.2f}; split (one more step, "
        f"{split:.3f} ms): self-attention {n_l} x {self_ms / n_l:.3f} = "
        f"{self_ms:.3f} ms ({self_ms / split:.1%}), cross-attention {n_l} x "
        f"{cross_ms / n_l:.3f} = {cross_ms:.3f} ms ({cross_ms / split:.1%}),"
        f" the rest {split - self_ms - cross_ms:.3f} ms; 0 kernel launches")
    del cache, memory


def encdec_reference(devices=("cpu", "cuda"), cfg=None,
                     seq: int = SEAMLESS_REF_SEQ) -> None:
    """seamless at full width cut to 2 + 2 layers (vocabulary 8192),
    float32, attention projections at std 1/sqrt(fan-in), through
    ``encdec.forward`` on ``seq`` frames and tokens: on the card every
    attention on the flash kernel (2 non-causal, 2 causal, 2 cross at S
    = T), on the CPU the blockwise plain version; the memory, CRF and
    logits relative L2 ENCDEC_CARD_TOL; a control, the card's forward
    with TF32 matmuls, must fail the logits' limit."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    full = cfg or configs.get_config("seamless-m4t-medium")
    c = dataclasses.replace(full, dtype="float32", **{
        k: min(v, getattr(full, k)) for k, v in SEAMLESS_REF.items()})
    params_cpu = encdec_params(c, 155, "cpu", fan_in=True)
    gen = torch.Generator().manual_seed(156)
    frames = torch.randn((1, seq, c.d_model), generator=gen) * 0.1
    tokens = torch.randint(0, c.vocab_size, (1, seq), generator=gen)
    outs, control = {}, None
    for dev in devices:
        params = _to(params_cpu, dev)
        ops.reset_launch_counts()
        with torch.no_grad():
            outs[dev] = encdec.forward(params, frames.to(dev),
                                       tokens.to(dev), c)
            n = ops.launch_counts()["flash_attention"]
            if _on_card(dev):
                want_n = c.n_enc_layers + 2 * c.n_layers
                if seq >= 2048 and n != want_n:
                    raise AssertionError(f"encdec reference: {n} flash "
                                         f"launches, expected {want_n}")
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    control = encdec.forward(params, frames.to(dev),
                                             tokens.to(dev), c)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
        del params
    want, got = (outs[d] for d in devices)
    for name in ("memory", "crf", "logits"):
        rel = rel_l2(getattr(got, name), getattr(want, name))
        ctrl = (None if control is None else
                rel_l2(getattr(control, name), getattr(want, name)))
        log(f"encdec reference {c.n_enc_layers} + {c.n_layers} layers (d "
            f"{c.d_model}, {c.n_heads} heads of {c.head_dim}, vocabulary "
            f"{c.vocab_size}) at S = T = {seq} [{name}] card vs CPU: rel L2 "
            f"{rel:.3e} (tol {ENCDEC_CARD_TOL:.0e})" + (
                "" if ctrl is None else f", the TF32 control {ctrl:.3e}"))
        if not bool(torch.isfinite(getattr(got, name)).all()) or \
                rel > ENCDEC_CARD_TOL:
            raise AssertionError(f"encdec reference [{name}]: {rel:.3e}")
        if name == "logits" and ctrl is not None and \
                not ctrl > ENCDEC_CARD_TOL:
            raise AssertionError(f"encdec reference: the TF32 control "
                                 f"{ctrl:.3e} passes")
    del outs, control, params_cpu
    gc.collect()


def encdec_phase(cfg=None, s: int = SEAMLESS_SEQ,
                 cross_q: int = SEAMLESS_CROSS_Q,
                 train_batch: int = SEAMLESS_TRAIN_BATCH,
                 train_seq: int = SEAMLESS_TRAIN_SEQ,
                 train_steps: int = SEAMLESS_TRAIN_STEPS,
                 decode_batch: int = SEAMLESS_DECODE_BATCH,
                 decode_len: int = 0, ref_seq: int = SEAMLESS_REF_SEQ,
                 device: str = "cuda") -> dict:
    """seamless-m4t-medium at full width and depth (12 + 12 layers, d
    1024, 16 heads of 64, vocabulary 256206), bf16 from seeds:
    ``make_prefill_step`` on ``s`` frames and tokens (36 flash launches:
    12 non-causal, 12 causal, 12 cross), twice, at the reference's
    draw; kernel 3 at the
    encoder's non-causal form and the cross form (``cross_q`` queries on
    ``s`` frames) and the decoder's causal MHA form against its plain
    version and SDPA (``flash_form_row``); ``make_decode_step`` at
    decode_32k's length (``decode_len``, default 32768) on
    ``decode_batch``; ``train_lm`` for ``train_steps`` steps on
    ``train_batch`` x ``train_seq`` from a fresh draw with attention at
    std 1/sqrt(fan-in) (remat: 72 flash forward and 36 backward launches
    a step; the first loss near ln 256206); kernel 7
    at the train shape's forms (``flash_bwd_check``); last
    ``encdec_reference``.  Returns each run's launch counts."""
    import torch

    from repro_torch import configs
    dev = device
    cfg = cfg or configs.get_config("seamless-m4t-medium")
    out = {}
    params = encdec_params(cfg, 150, dev)
    out["encdec_prefill"] = encdec_prefill("encdec prefill", cfg, params, s,
                                           dev, reps=2)
    _free(dev)
    hd, h = cfg.head_dim, cfg.n_heads
    for label, sq, t, causal in (("seamless encoder", s, s, False),
                                 ("seamless cross", cross_q, s, False),
                                 ("seamless decoder", s, s, True)):
        flash_form_row(label, sq, t, h, cfg.n_kv_heads, hd, causal, dev,
                       seed=157)
        _free(dev)
    length = decode_len or configs.INPUT_SHAPES["decode_32k"]["seq_len"]
    encdec_decode("seamless_decode_32k", cfg, params, decode_batch, length,
                  dev)
    _free(dev)
    del params
    _free(dev)
    # trained from attention drawn at std 1/sqrt(fan-in): under the
    # reference's rule (1/sqrt(12) on [1024, 1024] projections) the
    # softmaxes are near one-hot through 24 layers and the gradient's
    # float32 sum of squares passes float32's range (grad_norm inf), so
    # that clipping scales every update to 0; one step from that draw
    # shows it
    params = encdec_params(cfg, 153, dev)
    grad_norm_at_draw("encdec_train at the reference's draw", cfg, params,
                      train_batch, train_seq, dev)
    del params
    _free(dev)
    params = encdec_params(cfg, 153, dev, fan_in=True)
    run = lm_train_run("encdec_train", cfg, params, train_batch, train_seq,
                       train_steps, ("flash_attention", "flash_attention_bwd"),
                       torch.device(dev),
                       n_launching=cfg.n_enc_layers + 2 * cfg.n_layers)
    out["encdec_train"] = run["counts"]
    ln_v = math.log(cfg.vocab_size)
    log(f"encdec_train: first loss {run['first_loss']:.4f} against ln "
        f"{cfg.vocab_size} = {ln_v:.4f}")
    if abs(run["first_loss"] - ln_v) > 1.0:
        raise AssertionError(f"encdec_train: first loss {run['first_loss']}")
    del run, params
    _free(dev)
    if _on_card(dev):
        # at training S = T, so the cross-attention's form is the
        # encoder's (non-causal MHA)
        for label, causal in (("seamless train encoder", False),
                              ("seamless train decoder", True)):
            flash_bwd_check(label, cfg, train_batch, train_seq, dev, causal,
                            form=True)
            _free(dev)
    encdec_reference(("cpu", dev), cfg, ref_seq)
    _free(dev)
    return out


def vlm_reference(devices=("cpu", "cuda"), cfg=None,
                  text: int = LLAVA_REF_TEXT) -> None:
    """llava at full width cut to 2 layers (d_ff 2048, vocabulary 8192,
    the prefix to 1024 embeddings before ``text`` tokens), float32,
    attention projections at std 1/sqrt(fan-in) (``decode_params``),
    through ``transformer.forward`` with the prefix: the causal GQA flash
    kernel on the card (group 7), the blockwise plain version on the
    CPU; logits and CRF rel L2 DENSE_CARD_TOL; the TF32 control must
    fail it."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    full = cfg or configs.get_config("llava-next-34b")
    c = dataclasses.replace(full, dtype="float32", **{
        k: min(v, getattr(full, k)) for k, v in LLAVA_REF.items()})
    params_cpu = decode_params(c, c.n_layers, 195, "cpu")
    gen = torch.Generator().manual_seed(196)
    prefix = torch.randn((1, c.n_prefix_tokens, c.d_model), generator=gen) \
        * 0.1
    tokens = torch.randint(0, c.vocab_size, (1, text), generator=gen)
    outs, control = {}, None
    for dev in devices:
        params = _to(params_cpu, dev)
        ops.reset_launch_counts()
        with torch.no_grad():
            outs[dev] = transformer.forward(params, tokens.to(dev), c,
                                            prefix_embeds=prefix.to(dev))
            n = ops.launch_counts()["flash_attention"]
            if _on_card(dev):
                if c.n_prefix_tokens + text >= 2048 and n != c.n_layers:
                    raise AssertionError(f"vlm reference: {n} flash "
                                         "launches")
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    control = transformer.forward(
                        params, tokens.to(dev), c,
                        prefix_embeds=prefix.to(dev))
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
        del params
    want, got = (outs[d] for d in devices)
    for name in ("logits", "crf"):
        rel = rel_l2(getattr(got, name), getattr(want, name))
        ctrl = (None if control is None else
                rel_l2(getattr(control, name), getattr(want, name)))
        log(f"vlm reference x{c.n_layers} (d {c.d_model}, {c.n_heads}/"
            f"{c.n_kv_heads} heads, d_ff {c.d_ff}) forward on "
            f"{c.n_prefix_tokens} prefix + {text} text positions [{name}] "
            f"card vs CPU: rel L2 {rel:.3e} (tol {DENSE_CARD_TOL:.0e})" + (
                "" if ctrl is None else f", the TF32 control {ctrl:.3e}"))
        if not bool(torch.isfinite(getattr(got, name)).all()) or \
                rel > DENSE_CARD_TOL:
            raise AssertionError(f"vlm reference [{name}]: {rel:.3e}")
        if ctrl is not None and not ctrl > DENSE_CARD_TOL:
            raise AssertionError(f"vlm reference [{name}]: the TF32 control "
                                 f"{ctrl:.3e} passes")
    del outs, control, params_cpu
    gc.collect()


def vlm_phase(cfg=None, s: int = MOE_SEQ, train_layers: int =
              LLAVA_TRAIN_LAYERS, train_batch: int = LLAVA_TRAIN_BATCH,
              train_seq: int = LLAVA_TRAIN_SEQ,
              train_steps: int = LLAVA_TRAIN_STEPS,
              ref_text: int = LLAVA_REF_TEXT, device: str = "cuda") -> dict:
    """llava-next-34b, bf16 from seeds: ``make_prefill_step`` at full
    depth (60 layers, 34.4 B parameters) on ``s`` positions, its 2880
    prefix embeddings (N(0, 0.1²)) before ``s`` − 2880 text tokens (one
    causal GQA flash launch a layer, group 7 at hd 128), with events
    around the prefix projection; ``train_lm`` at ``train_layers``
    layers for ``train_steps`` steps on ``train_batch`` sequences of
    ``train_seq`` positions (the prefix and ``train_seq`` − 2880 text
    tokens), the flash backward at that shape; ``vlm_reference``.
    Returns each run's launch counts."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import common
    dev = torch.device(device)
    full = cfg or configs.get_config("llava-next-34b")
    n_pre = full.n_prefix_tokens
    out = {}
    t0 = time.perf_counter()
    params = lm_params(full, full.n_layers, seed=190, device=dev)
    log(f"vlm: {full.arch_id} params "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(191)
    batch = {"prefix_embeds": torch.randn((1, n_pre, full.d_model),
                                          generator=gen, device=dev) * 0.1,
             "tokens": torch.randint(0, full.vocab_size, (1, s - n_pre),
                                     device=dev, generator=gen)}
    step = steps.make_prefill_step(full)
    walls = []
    proj = []
    real = common.dense

    def dense_spy(p, x):
        a = _event(dev)
        y = real(p, x)
        proj.append((a, _event(dev)))
        return y
    for rep in range(2):
        _reset_peak(dev)
        ops.reset_launch_counts()
        if rep:
            common.dense = dense_spy
        try:
            t1 = time.perf_counter()
            logits = step(params, batch)
            _sync(dev)
            walls.append(time.perf_counter() - t1)
        finally:
            common.dense = real
        counts = ops.launch_counts()
    peak = _peak_gib(dev)
    finite = bool(torch.isfinite(logits).all())
    log(f"vlm prefill: {full.arch_id} {full.n_layers} layers "
        f"make_prefill_step on {n_pre} prefix embeddings + {s - n_pre} text "
        f"tokens -> {tuple(logits.shape)} finite {finite}: walls (s) "
        f"{[round(w, 3) for w in walls]}, {s / min(walls):.0f} positions/s, "
        f"peak {peak:.2f} GiB, flash launches {counts['flash_attention']}; "
        f"the prefix projection {_ms(*proj[0]):.3f} ms")
    if tuple(logits.shape) != (1, full.vocab_size) or not finite or (
            _on_card(dev) and (counts["flash_attention"] != full.n_layers
                               or sum(counts.values()) != full.n_layers)):
        raise AssertionError(f"vlm prefill: logits {tuple(logits.shape)} "
                             f"finite {finite}, launches {counts}")
    out["vlm_prefill"] = counts
    del params, logits, batch
    _free(dev)
    cut = dataclasses.replace(full, n_layers=min(train_layers,
                                                 full.n_layers))
    run = lm_train_run("vlm_train", cut,
                       lm_params(full, cut.n_layers, seed=192, device=dev),
                       train_batch, train_seq - n_pre, train_steps,
                       ("flash_attention", "flash_attention_bwd"), dev)
    out["vlm_train"] = run["counts"]
    del run
    _free(dev)
    if _on_card(dev):
        flash_bwd_check("vlm_train", cut, train_batch, train_seq, dev)
        _free(dev)
    vlm_reference(("cpu", device), full, ref_text)
    _free(dev)
    return out


LAUNCHER_ARGS = ["--requests", "10", "--steps", "10", "--train-steps", "10",
                 "--batch", "4"]
# dB: every launcher request against its uncached twin.  Measured 39.75
# min on the H100 and 40.67 on the CPU, in every mode; the control (the
# next request's uncached output) at most 5.34 and 5.36 dB.  It catches
# a wrong lane, not a stale cache, whose output on this barely trained
# model need not fall far from FreqCa's; the cache kernels' own checks
# at the launcher's shape guard that path.
LAUNCHER_PSNR_FLOOR = 30.0
LAUNCHER_MODES = {"burst": [],
                  "poisson": ["--arrival", "poisson", "--clients", "2"],
                  "replicas": ["--replicas", "2"]}


def cache_kernel_checks(b: int, s: int, d: int, device: str,
                        label: str = "launcher") -> None:
    """Kernels 1 and 2 against their plain versions at the float32 CRF
    of a dit-small batch (``[b, s, d]``, rings of 3), the shapes the
    launcher's engines give them; not timed, not counted."""
    import torch

    from repro_torch.core import frequency
    from repro_torch.kernels import dct, freqca_fused, ops, ref
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((b, s, d), generator=gen, device=device)
    errs = [compare("band_split_spectral[dit-small]", "float32",
                    dct.band_split_spectral(x, 0.0625, "dct"),
                    ref.band_split_spectral_ref(x, 0.0625, "dct"))]
    m = frequency.spectral_kept_bins(s, 0.0625, "dct")
    low = torch.randn((b, m, d), generator=gen, device=device)
    hist = torch.randn((b, 3, s, d), generator=gen, device=device)
    synth = frequency.low_band_basis(s, 0.0625, "dct", device=device).T
    ts = torch.tensor([[0.9, 0.85, 0.75]], device=device).expand(b, 3)
    w = ops.hermite_weights(ts, torch.tensor(0.7, device=device), 2)
    errs.append(compare(
        "freqca_predict_fused_spectral[dit-small]", "float32",
        freqca_fused.freqca_predict_fused_spectral(low, synth, hist, w),
        ref.freqca_predict_spectral_ref(low, synth, hist, w)))
    log(f"{label}: kernels 1 and 2 at [{b}, {s}, {d}] float32 against "
        f"their plain versions: max rel err {errs[0][1]:.3e} / "
        f"{errs[1][1]:.3e} (tol {TOLERANCE['float32']:.0e})")


def launcher_phase(device: str = "cuda") -> dict:
    """``repro_torch.launch.serve.main`` in this process, three times, at
    dit-small (8 blocks, d 128, S 256, float32; 10 training steps, 10
    requests of 10 steps, FreqCa interval 5, max batch 4, every fifth an
    edit): closed-loop bursts, the threaded open loop (Poisson arrivals,
    two clients) and two replica processes (``--replicas 2``).  Each run
    must give every request 4 full steps (steps 0, 1, 2, 5), a PSNR
    against the uncached run (for the fleet, an uncached engine in this
    process on the weights the launcher trained) of at least
    ``LAUNCHER_PSNR_FLOOR`` and 0 steady-state first runs.  The control,
    each request's output against the uncached output of the next
    request (a cache that serves another lane's history), must fall
    below the floor.  Returns the launch counts of the in-process runs
    (the replicas' launches happen in their own processes and are not
    read here; the fleet phase reads its replicas'): S 256 is below the
    flash threshold, so kernels 1 and 2 only, one band split per full
    step and one fused step per cached step of each batch, warmup
    included."""
    import torch

    from repro_torch import configs
    from repro_torch.core.policies import NoCachePolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DiffusionEngine
    cfg_args = ["--device", device] if device != "cuda" else []
    args = serve.build_parser().parse_args(LAUNCHER_ARGS)
    want_full = full_steps(args.steps, args.interval)
    if device == "cuda":
        cache_kernel_checks(args.batch, 256, 128, device)
    ops.reset_launch_counts()
    n_runs = 0
    for mode, extra in LAUNCHER_MODES.items():
        t0 = time.perf_counter()
        res = serve.main(LAUNCHER_ARGS + extra + cfg_args)
        wall = time.perf_counter() - t0
        if mode == "replicas":
            outs = res["outs"]
            steady = [pr["steady_recompiles"]
                      for pr in res["summary"]["per_replica"].values()]
            # the uncached run of the fleet's stream, on the weights the
            # launcher trained and shipped
            full_fn, from_crf_fn = serve.dit_fns(
                res["params"], configs.get_config("dit-small"))
            eng = DiffusionEngine(full_fn, from_crf_fn, (32, 32, 4),
                                  (256, 128), NoCachePolicy(),
                                  n_steps=args.steps, max_batch=args.batch,
                                  device=device)
            bursts = serve.mixed_stream(args.requests, 32, 4,
                                        edit_every=args.edit_every)
            uncached, _ = serve.serve_stream(eng, bursts)
            uncached.sort(key=lambda o: o.request_id)
            routing = res["summary"]["routing"]
            detail = (f"routing {routing['submitted']} submitted, "
                      f"{routing['resolved']} resolved; steady recompiles "
                      f"per replica {steady}")
        else:
            outs, uncached = res["freqca"]["outs"], res["full"]["outs"]
            steady = [res["freqca"]["steady_recompiles"],
                      res["full"]["steady_recompiles"]]
            n_runs += (res["freqca"]["warmup_compiles"]
                       + res["freqca"]["summary"]["batches"])
            detail = (f"freqca {res['freqca']['wall']:.2f} s, uncached "
                      f"{res['full']['wall']:.2f} s; steady recompiles "
                      f"{steady}")
        n = len(uncached)
        ps = [serve.psnr(f.latents, u.latents)
              for f, u in zip(outs, uncached, strict=True)]
        control = [serve.psnr(f.latents, uncached[(i + 1) % n].latents)
                   for i, f in enumerate(outs)]
        fulls = [o.n_full_steps for o in outs]
        log(f"launcher: {mode}: {len(outs)} requests, full steps {fulls}; "
            f"PSNR vs uncached min {min(ps):.2f} / mean "
            f"{sum(ps) / len(ps):.2f} dB (floor {LAUNCHER_PSNR_FLOOR}; the "
            f"next request's uncached output: max {max(control):.2f} dB); "
            f"{detail}; wall {wall:.1f} s (training included)")
        if (sorted(o.request_id for o in outs) != list(range(args.requests))
                or fulls != [want_full] * args.requests
                or not min(ps) >= LAUNCHER_PSNR_FLOOR
                or not max(control) < LAUNCHER_PSNR_FLOOR
                or any(s != 0 for s in steady)
                or not all(bool(torch.isfinite(torch.as_tensor(o.latents))
                                .all()) for o in outs)):
            raise AssertionError(f"launcher: {mode} run failed its checks")
    counts = ops.launch_counts()
    want = {"band_split_spectral": want_full * n_runs,
            "freqca_predict_fused_spectral": (args.steps - want_full)
            * n_runs}
    log(f"launcher: launch counts {counts} (in-process runs: {n_runs} "
        f"sampler runs of FreqCa, warmup included)")
    if device == "cuda" and (any(counts[k] != n for k, n in want.items())
                             or sum(counts.values()) != sum(want.values())):
        raise AssertionError(f"launcher: launches {counts}, expected {want}")
    return counts


FLEET_REQUESTS = 6
# a fleet lane served at another bucket than its in-process twin (a
# batch of 1 against 2 in bf16) may differ by more than the last bit;
# the tolerance of the slo phase's batch-of-2 against solo lanes
FLEET_REL_TOL = SLO_REL_TOL


def fleet_factory(*args, **kw):
    """The port's ``launch.serve.fleet_engine_factory``, with two additions
    in whichever process builds the engine, neither of them on the
    fleet's wire protocol:

    - a check that the engine is on the device asked for (the card,
      unless a rehearsal asks for the CPU) and, on the card, that the
      memory allocated there once it is built holds at least the bytes of
      the weights it was sent (``args[0]``, the wire tree): the
      parameters sit on the card;
    - the process's own launch counts: the counters are set to 0 once
      the engine's warmup is done, and ``metrics_dict`` (the snapshot a
      replica answers ``("metrics",)`` with) carries them as
      ``launch_counts``.  ``ServeMetrics.merge`` reads the fields it
      knows, so the fleet's own accounting leaves the key alone."""
    import os

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    eng = serve.fleet_engine_factory(*args, **kw)
    want = torch.device(kw.get("device") or "cuda").type
    wire_bytes = sum(a.nbytes for a in _leaves(args[0]))
    on_card = want == "cuda"
    held = torch.cuda.memory_allocated() if on_card else None
    if eng.device.type != want or (on_card and held < wire_bytes):
        raise AssertionError(f"fleet: engine on {eng.device} holding {held} "
                             f"bytes on the card for {wire_bytes} bytes of "
                             f"weights; asked for {want}")
    log(f"fleet: pid {os.getpid()} built its engine on {eng.device}: "
        f"{wire_bytes / 2**30:.2f} GiB of weights"
        + (f"; {held / 2**30:.2f} GiB allocated on the card" if on_card
           else ""))
    warmup, metrics_dict = eng.warmup, eng.metrics_dict

    def warmup_then_reset(*a, **k):
        secs = warmup(*a, **k)
        ops.reset_launch_counts()
        return secs

    def metrics_with_launches():
        return dict(metrics_dict(), launch_counts=ops.launch_counts())
    eng.warmup, eng.metrics_dict = warmup_then_reset, metrics_with_launches
    return eng


def free_g() -> str:
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return " | ".join(" ".join(line.split()) for line in out[:2])


def fleet_request(rid: int, size: int, channels: int, policy=None):
    """Request ``rid`` of the fleet phase: seed 200 + rid; request 2 an
    edit of a shapes latent (``torch.Generator`` seed 1000 + rid,
    strength 0.5)."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.serving.engine import DiffusionRequest
    if rid == 2:
        ref = synthetic.shapes_batch(
            torch.Generator().manual_seed(1000 + rid), 1, size=size,
            channels=channels, device="cpu")[0]
        return DiffusionRequest(request_id=rid, seed=200 + rid,
                                init_latents=ref, edit_strength=0.5,
                                policy=policy)
    return DiffusionRequest(request_id=rid, seed=200 + rid, policy=policy)


def _wait(pred, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"fleet: timed out waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def fleet_phase(cfg=None, size: int = 128, n_steps: int = N_STEPS,
                device: str = "cuda") -> dict:
    """Two replica processes on the one card behind a ``FleetRouter``,
    each holding its own copy of flux1-dev at full width cut as the train
    phase cuts it (``train_config``: 16 single blocks, ``n_double=0`` —
    ``fleet_engine_factory`` passes no text, so double blocks would never
    run), shipped through its pipe as a numpy tree (bf16 as raw bits).
    ``FreqCaPolicy(interval=5, dct)``, 20 steps, ``max_batch=2``,
    ``max_restarts=1``.

    Wave 1: six 1024² requests (latent 128x128x16, S 4096), the third an
    edit; the replica with the most in-flight work (the lower index on a
    tie) is SIGKILLed at once, mid-batch.  Every future resolves exactly
    once; the counters read submitted == resolved == 6, failed == 0,
    duplicate_results == 0, replicas_lost == 1 and, once the supervisor
    has restarted the slot, restarts == 1.  Wave 2: two requests naming
    the default policy explicitly, a new affinity group, which the router
    places on one replica (the least-loaded).  Wave 3: six more requests
    across both replicas, timed.  The restarted replica must have served
    at least two requests by then (its own metrics).

    Launches (``fleet``): each replica counts its own from the end of its
    warmup (``fleet_factory``); after wave 3 the router reads both
    replicas' counts (the survivor of the kill and the restarted one),
    each of which must be its batches times one batch's launches: kernels
    1, 2 and 3, 16 flash launches a full forward.  The killed
    incarnation's launches die with it and are not read.

    Oracle (``fleet_oracle``): after ``shutdown``, this process builds
    the same engine from the same factory and weights and serves all 14
    requests (wave 3 timed apart): per request ``n_full_steps == 6``,
    latents bitwise equal where the fleet served the lane at the same
    bucket, else within ``FLEET_REL_TOL`` (relative L2); its launches
    again its batches times one batch's.  Logs each replica's boot
    (spawn -> ready), the restart, and requests/s of wave 3 in the fleet
    against in this process, on the same card.  Returns both phases'
    launch counts.  (``cfg``, ``size`` and ``device`` let the phase be
    rehearsed small on the CPU.)"""
    import functools

    import torch

    from repro_torch.checkpointing import bridge
    from repro_torch.core.policies import FreqCaPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import dit
    from repro_torch.serving.fleet import FleetRouter
    cfg, on_card = cfg or train_config(), device == "cuda"
    interval, max_batch = 5, 2
    want_full = full_steps(n_steps, interval)
    per_batch = {"band_split_spectral": want_full,
                 "freqca_predict_fused_spectral": n_steps - want_full,
                 "flash_attention": want_full * (cfg.n_double + cfg.n_layers)}

    def launches_ok(counts, n_batches) -> bool:
        return (all(counts[k] == n * n_batches for k, n in per_batch.items())
                and sum(counts.values())
                == sum(per_batch.values()) * n_batches)
    t0 = time.perf_counter()
    params = dit.init_params(cfg, seed=50, device=device)
    redraw_zero_leaves(params, seed=51)
    n_params = sum(p.numel() for p in _leaves(params))
    wire = bridge.params_to_wire(params, cfg)
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f"fleet: {cfg.arch_id} cut to n_double {cfg.n_double}, n_layers "
        f"{cfg.n_layers} (d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.dtype}): {n_params / 1e9:.3f}"
        f" B parameters, built and turned into the wire tree in "
        f"{time.perf_counter() - t0:.1f} s; {size}² latents (S "
        f"{(size // cfg.patch_size) ** 2}); host memory (free -g): "
        f"{free_g()}")
    factory = functools.partial(
        fleet_factory, wire, cfg, size, n_steps, max_batch, 0.05, "dct",
        interval, None, True, None, 4.0, device=device)
    router = FleetRouter(factory, n_replicas=2, max_restarts=1,
                         health_interval_s=0.1, boot_timeout_s=600.0)
    channels = cfg.in_channels
    reqs = [fleet_request(i, size, channels) for i in range(FLEET_REQUESTS)]
    explicit = FreqCaPolicy(interval=interval, method="dct")
    wave2 = [fleet_request(FLEET_REQUESTS + i, size, channels,
                           policy=explicit) for i in range(2)]
    wave3 = [fleet_request(FLEET_REQUESTS + 2 + i, size, channels)
             for i in range(FLEET_REQUESTS)]
    outs = {}
    try:
        t0 = time.perf_counter()
        router.start()
        log(f"fleet: both replicas ready {time.perf_counter() - t0:.1f} s "
            f"after the first spawn; host memory (free -g): {free_g()}")
        boots = [round(r.boot_s, 1) for r in router.replicas]
        for r in router.replicas:
            log(f"fleet: replica {r.idx} pid {r.meta['pid']}: spawn -> "
                f"ready {r.boot_s:.1f} s, of it warmup {r.meta['warmup_s']:.1f}"
                f" s ({r.meta['warmup_compiles']} signatures run once, the "
                f"port's count of first runs)")
        # wave 1, and the crash
        futs = [router.submit(r) for r in reqs]
        with router._lock:
            inflight = [len(r.inflight) for r in router.replicas]
            victim = max(router.replicas,
                         key=lambda r: (len(r.inflight), -r.idx))
        victim.proc.kill()
        t_kill = time.perf_counter()
        log(f"fleet: in flight per replica {inflight}; SIGKILL replica "
            f"{victim.idx} (pid {victim.meta['pid']})")
        for f in futs:
            res = f.result(timeout=600)
            outs[res.request_id] = res
        wave1_s = time.perf_counter() - t_kill
        # the supervisor adopts the newcomer, then counts the restart:
        # wait for both, or the accounting below can read the slot back
        # before its count
        restart_s = _wait(lambda: router.replicas[victim.idx] is not victim
                          and router.replicas[victim.idx].healthy
                          and router.status()["supervisor"]["restarts"]
                          >= 1, 600, "the restart")
        restart_s += wave1_s
        st = router.status()
        c, sup = st["counters"], st["supervisor"]
        newcomer = router.replicas[victim.idx]
        log(f"fleet: wave 1 resolved {wave1_s:.1f} s after the kill; the "
            f"slot rejoined {restart_s:.1f} s after it (spawn -> ready "
            f"{newcomer.boot_s:.1f} s, backoff {sup['restart_backoff_s']} "
            f"s); counters {c}; supervisor {sup}")
        if (sorted(outs) != list(range(FLEET_REQUESTS))
                or c["submitted"] != FLEET_REQUESTS
                or c["resolved"] != FLEET_REQUESTS or c["failed"] != 0
                or c["duplicate_results"] != 0 or c["replicas_lost"] != 1
                or sup["restarts"] != 1 or st["healthy_replicas"] != 2):
            raise AssertionError(f"fleet: crash accounting {st}")
        # wave 2: a new group starts on the restarted replica
        futs = [router.submit(r) for r in wave2]
        with router._lock:
            placed = [len(r.inflight) for r in router.replicas]
        for f in futs:
            res = f.result(timeout=600)
            outs[res.request_id] = res
        # wave 3: both replicas, timed
        t0 = time.perf_counter()
        futs = [router.submit(r) for r in wave3]
        for f in futs:
            res = f.result(timeout=600)
            outs[res.request_id] = res
        fleet_s = time.perf_counter() - t0
        fleet_m = router.fleet_metrics()
        fm = dict(fleet_m.summary(), per_replica_launches={
            i: snap["launch_counts"]
            for i, snap in fleet_m.per_replica.items()})
    finally:
        router.shutdown(drain=True)
    per = fm["per_replica"]
    served = {i: (p["requests"], p["batches"], p["steady_recompiles"])
              for i, p in per.items()}
    replica_counts = {i: fm["per_replica_launches"][i] for i in per}
    fleet_counts = {k: sum(c[k] for c in replica_counts.values())
                    for k in ops.launch_counts()}
    log(f"fleet: wave 2 placed {placed} per replica; wave 3 "
        f"{len(wave3)} requests in {fleet_s:.2f} s = "
        f"{len(wave3) / fleet_s:.3f} req/s across 2 replicas; per replica "
        f"(requests, batches, steady first runs) {served}; routing "
        f"{fm['routing']}")
    log(f"fleet: launches read from the replicas after wave 3 (each from "
        f"the end of its warmup; the killed incarnation's not read): "
        f"{replica_counts}; together {fleet_counts}")
    if (sorted(placed) != [0, 2] or per[victim.idx]["requests"] < 2
            or any(p["steady_recompiles"] != 0 for p in per.values())
            or sorted(outs) != list(range(FLEET_REQUESTS + 8))):
        raise AssertionError(f"fleet: after the restart {placed}, {per}")
    if on_card and not all(launches_ok(replica_counts[i], per[i]["batches"])
                           for i in per):
        raise AssertionError(f"fleet: replica launches {replica_counts}, "
                             f"expected {per_batch} per batch x "
                             f"{ {i: p['batches'] for i, p in per.items()} }")

    # the oracle: the same engine in this process
    t0 = time.perf_counter()
    eng = factory()
    warm_s = eng.warmup()
    log(f"fleet: in-process engine built in {time.perf_counter() - t0:.1f}"
        f" s (warmup {warm_s:.1f} s)")
    ops.reset_launch_counts()
    for r in reqs + wave2:
        eng.submit(r)
    want = {o.request_id: o for o in eng.serve_until_drained()}
    t0 = time.perf_counter()
    for r in wave3:
        eng.submit(r)
    want.update({o.request_id: o for o in eng.serve_until_drained()})
    local_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_batches = eng.metrics.n_batches
    same = diff = 0
    worst = 0.0
    for rid, o in sorted(outs.items()):
        w = want[rid]
        got = torch.as_tensor(o.latents)
        ref = w.latents.cpu()
        if o.n_full_steps != want_full or w.n_full_steps != want_full \
                or not bool(torch.isfinite(got).all()) \
                or tuple(got.shape) != (size, size, channels):
            raise AssertionError(f"fleet: request {rid}: full steps "
                                 f"{o.n_full_steps} / {w.n_full_steps}")
        if o.bucket == w.bucket:
            same += 1
            if not torch.equal(got, ref):
                raise AssertionError(f"fleet: request {rid} differs from the"
                                     f" in-process engine at bucket "
                                     f"{o.bucket}")
        else:
            diff += 1
            rel = rel_l2(got, ref)
            worst = max(worst, rel)
            if not rel <= FLEET_REL_TOL:
                raise AssertionError(f"fleet: request {rid}: rel L2 {rel:.3e}"
                                     f" > {FLEET_REL_TOL}")
    log(f"fleet: oracle: {len(outs)} requests, every one {want_full} full "
        f"steps; {same} at the fleet's bucket, bitwise equal; {diff} at "
        f"another, worst rel L2 {worst:.3e} (tol {FLEET_REL_TOL}); wave 3 "
        f"in this process {local_s:.2f} s = {len(wave3) / local_s:.3f} "
        f"req/s; launch counts {counts} over {n_batches} batches")
    if on_card:
        log(f"fleet: on {nvidia_smi()}: spawn -> ready {boots} s, restart "
            f"(kill -> rejoined) {restart_s:.1f} s; wave 3 "
            f"{len(wave3) / fleet_s:.3f} req/s across two replica "
            f"processes against {len(wave3) / local_s:.3f} req/s in this "
            f"process")
    if on_card and not launches_ok(counts, n_batches):
        raise AssertionError(f"fleet: oracle launches {counts}, expected "
                             f"{per_batch} per batch x {n_batches}")
    del eng, want, wire
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"fleet": fleet_counts, "fleet_oracle": counts}


# the dry run's card rows: (label, arch, shape, per-card batch); the DiT
# steps at the serve phase's two 1024² lanes, the LMs at the batches the
# lm, lm_train and moe phases run
DRYRUN_ROWS = (("flux_denoise_step", "flux1-dev", "denoise_step", 2),
               ("flux_cached_step", "flux1-dev", "cached_step", 2),
               ("yi_prefill_32k", "yi-9b", "prefill_32k", 1),
               ("mamba2_train_4k", "mamba2-370m", "train_4k",
                LM_TRAIN_MAMBA_BATCH),
               ("granite_prefill_32k", "granite-moe-3b-a800m", "prefill_32k",
                1))
DRYRUN_TIMED = 3              # timed calls of a card row, after two warm


def dryrun_sweep() -> None:
    """``launch.dryrun``'s ``--all`` sweep on the 16 x 16 mesh, in this
    process (the CPU's work: meta tensors, nothing on the card): one
    ``dryrun_row {...}`` line per combo; fails on any failed combo."""
    from repro_torch.launch import dryrun, mesh
    m = mesh.make_production_mesh()
    t0 = time.perf_counter()
    combos = dryrun.all_combos()
    for arch, shape in combos:
        rec = dryrun.run_one(arch, shape, m, out_dir=None, verbose=False)
        row = {k: rec[k] for k in ("arch", "shape", "mesh", "n_devices",
                                   "memory", "flops", "bytes_accessed")}
        row["by_kind_flops"] = {k: v["flops"] for k, v in
                                rec["by_kind"].items() if v["flops"]}
        row["compute_s"] = rec["roofline"]["compute_s"]
        row["memory_s"] = rec["roofline"]["memory_s"]
        row["bottleneck"] = rec["roofline"]["bottleneck"]
        row["collectives"] = rec["collectives"]["note"]
        print("dryrun_row " + json.dumps(row), flush=True)
    log(f"dryrun: {len(combos)} combos on {m.name}, 0 failed, "
        f"{time.perf_counter() - t0:.1f} s")


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    from repro_torch.roofline import op_analysis
    seen = {}
    for t in op_analysis._tensors(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def dryrun_card_row(label: str, spec, args, smi: str) -> dict:
    """One step of the dry run's on the card: the counter's prediction
    (``op_analysis.analyze`` on the spec's meta arguments) beside the
    card's figures for the same step on ``args`` (materialised from
    them): argument bytes (must be equal), the peak (the step's
    ``max_memory_allocated`` above what was held before it, plus the
    arguments), the wall (CUDA events, DRYRUN_TIMED calls after two
    warm), the step's share of the bf16 peak and the bound (bytes over
    the memory rate, or each type's FLOPs over its peak, the larger).
    Returns the launch counts of the warm and timed calls."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.roofline import analysis, op_analysis
    counted = op_analysis.analyze(spec.fn, *spec.args)
    measured_args = _storage_bytes(args)
    if measured_args != counted["argument_bytes"]:
        raise AssertionError(f"dryrun {label}: argument bytes predicted "
                             f"{counted['argument_bytes']}, on the card "
                             f"{measured_args}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = spec.fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held + measured_args
    outs = [t for t in op_analysis._tensors(out) if t.is_floating_point()]
    if not outs or not all(bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError(f"dryrun {label}: non-finite or no output")
    del out, outs
    wall_ms = time_ms(lambda: spec.fn(*args), DRYRUN_TIMED)
    counts = ops.launch_counts()
    flops = counted["flops"]
    t_ops = analysis.compute_seconds(counted["flops_by_type"])
    t_bytes = counted["bytes_accessed"] / analysis.HBM_BW
    row = {
        "label": label, "step": spec.name,
        "argument_bytes": {"predicted": counted["argument_bytes"],
                           "measured": measured_args},
        "peak_bytes": {"predicted": counted["peak_bytes"],
                       "measured": peak,
                       "measured_over_predicted": peak
                       / counted["peak_bytes"]},
        "flops": flops,
        "flops_by_kind": {k: v["flops"] for k, v in
                          counted["by_kind"].items() if v["flops"]},
        "bytes_accessed": counted["bytes_accessed"],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "wall_ms": wall_ms,
        "bf16_peak_share": flops / (wall_ms * 1e-3 * PEAK_FLOPS["bfloat16"]),
        "launches": {k: v for k, v in counts.items() if v},
        "card": smi}
    print("dryrun_card " + json.dumps(row), flush=True)
    return counts


def _fill(gen, vocab: int = 0):
    """A meta tensor -> the card's: integers uniform below ``vocab``,
    floats ~ N(0, 1) in their type."""
    import torch

    def fill(t):
        if not t.is_floating_point():
            return torch.randint(0, vocab, t.shape, dtype=t.dtype,
                                 device="cuda", generator=gen)
        return torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)
    return fill


def dryrun_flux(model: dict, smi: str) -> dict:
    """The dry run's flux1-dev rows on the serve phase's parameters: the
    full step (kernel 3) at two 1024² lanes, then the FreqCa cached step
    (kernel 2) from float32 rings that three cache updates filled
    (kernel 1, as the served full steps fill them)."""
    import torch

    from repro_torch.core.policies import base as policy_base
    from repro_torch.core.policies.freqca import FreqCaPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, mesh, steps
    by_phase = {}
    gen = torch.Generator(device="cuda").manual_seed(70)
    one = mesh.one_card_mesh()
    for label, arch, shape, batch in DRYRUN_ROWS[:2]:
        spec = steps.build_dit(arch, one, batch=batch,
                               latent=dryrun.DIT_LATENT[arch],
                               cached_step=shape == "cached_step")
        ops.reset_launch_counts()
        params = model["params"]
        if shape == "denoise_step":
            lat, _, text = spec.args[1:]
            args = (params, _fill(gen)(lat),
                    torch.full((batch,), 0.7, device="cuda"),
                    _fill(gen)(text))
        else:
            pol = FreqCaPolicy(interval=5, method="dct", rho=0.0625,
                               high_order=2)
            feat = model["crf_shape"]
            state = pol.init(batch, feat, torch.float32, device="cuda")
            for t in (0.9, 0.85, 0.75):
                ctx = policy_base.StepContext(
                    step_idx=0, t_now=torch.tensor(t, device="cuda"), x=None,
                    batch=batch, feat_shape=feat, crf_dtype=torch.float32)
                crf = torch.randn((batch,) + feat, generator=gen,
                                  device="cuda")
                state = pol.update(state, crf, ctx)
            args = (params, state, torch.full((batch,), 0.7, device="cuda"))
        fill_counts = ops.launch_counts()
        counts = dryrun_card_row(label, spec, args, smi)
        by_phase[f"dryrun_{label}"] = {k: counts[k] + fill_counts[k]
                                       for k in counts}
        del args
        _free("cuda")
    return by_phase


def dryrun_lm(label: str, params=None, smi: str = "") -> dict:
    """One dry-run LM row of ``DRYRUN_ROWS`` on the card: its parameters
    ``params`` (the lm phase's yi-9b) or drawn here from a seed, its
    inputs drawn from a seed (a train step's moments zero, as
    ``adamw.init`` makes them)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import mesh, steps
    from repro_torch.models import common
    from repro_torch.optim import adamw
    _, arch, shape, batch = next(r for r in DRYRUN_ROWS if r[0] == label)
    spec = steps.build(arch, shape, mesh.one_card_mesh(), {"batch": batch})
    cfg = configs.get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(71)
    if params is None:
        params = common.init_params(steps.model_specs(cfg), seed=72,
                                    dtype=getattr(torch, cfg.dtype),
                                    device="cuda")
    fill = _fill(gen, cfg.vocab_size)
    batch_args = {k: fill(v) for k, v in spec.args[-1].items()}
    if spec.name.endswith(":train"):
        opt_cfg = steps.make_train_step(cfg)[1]
        args = (params, adamw.init(opt_cfg, params), batch_args)
    else:
        args = (params, batch_args)
    counts = dryrun_card_row(label, spec, args, smi)
    del args, batch_args
    return {f"dryrun_{label}": counts}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# the float32 hd-16 flash rows (kernels 3 and 7 at dit-small's joint
# attention, 8 heads of 16): (label, B, S) at latent 128 (S 4096, the
# kernels line's rows), latent 64 at batch 16 and latent 80 (S 1600,
# off every tile of 128 rows)
F32_HD16_ROWS = (("", 2, 4096), (" 16x1024", 16, 1024),
                 (" 2x1600", 2, 1600))
# the kernels line's entries of the float32 hd-16 library: (counter,
# source, the TPU kernel or autodiff replaced); the forward is the 3xTF32
# template, built in flash_attention_f32.cu
F32_HD16_KERNELS = {
    "flash_attention[f32_hd16]": (
        "flash_attention_f32",
        "src/repro_torch/kernels/csrc/flash_fwd_tf32.cuh",
        "src/repro/kernels/flash_attention.py:79"),
    "flash_attention_bwd[f32_hd16]": (
        "flash_attention_f32_bwd",
        "src/repro_torch/kernels/csrc/flash_attention_f32.cu",
        "none: XLA autodiff of repro/models/dit.py:_joint_attention"),
}


def f32_build_checks() -> None:
    """flash_attention_f32, kernel by kernel: its two forward kernels (the
    3xTF32 template at hd 16, with and without the LSE) hold TF32 HMMA;
    its three backward kernels compute on the FMA units, FFMA and no HMMA
    or HGMMA; ptxas reports no spills in any of them.  The forward's
    float32 accuracy rests on its tolerances and on their TF32 controls
    that must fail (``f32_hd16_rows``, the dit_small serve check)."""
    funcs = sass_functions("flash_attention_f32")
    counts = {n: {"TF32 HMMA": tf32_hmma(c),
                  **{op: c.count(op) for op in ("FFMA", "HMMA", "HGMMA")}}
              for n, c in funcs.items()}
    fwd = {n: c for n, c in counts.items() if "tf32_fwd_kernel" in n}
    bwd = {n: c for n, c in counts.items() if "bwd" in n}
    spills = ptxas_spills("flash_attention_f32")
    log(f"flash_attention_f32 SASS by kernel: {counts}; spill bytes "
        f"{sorted(set(spills.values()))} over {len(spills)} kernels")
    if len(fwd) != 2 or len(bwd) != 3 or len(counts) != 5 \
            or any(c["TF32 HMMA"] == 0 for c in fwd.values()) \
            or any(c["FFMA"] == 0 or c["HMMA"] or c["HGMMA"]
                   for c in bwd.values()) \
            or len(spills) != 5 or any(spills.values()):
        raise AssertionError(f"flash_attention_f32 build: SASS {counts}, "
                             f"spills {spills}")


@contextlib.contextmanager
def tf32_on():
    """Float32 matrix products on the TF32 tensor cores inside the block
    (a control: the stated float32 tolerances must catch it)."""
    import torch
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def max_rel(got, want) -> float:
    """max |got − want| / max |want|, in float64."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def f32_hd16_rows(row) -> None:
    """Kernels 3 and 7 in float32 at head width 16 (``flash_attention_f32``;
    non-causal MHA, 8 heads, at ``F32_HD16_ROWS``): the forward without
    and with its log-sum-exp against ``ref.attention_ref`` /
    ``attention_lse_ref`` (float32, TF32 off) at ``TOLERANCE``; the
    backward against ``ref.attention_bwd_ref`` run in float64 from the
    kernel's o and lse (the oracle), each gradient at ``TOLERANCE``, and
    two backward launches bitwise equal.  The control: the plain version
    with TF32 on must miss each of those tolerances (the forward's output,
    each gradient against the oracle).  Bounds from ``fwd_work`` at the
    TF32 peak (the forward runs on the TF32 cores; the FMA peak's and the
    design's 3 products logged beside) and ``bwd_work`` at the float32
    FMA peak; library: SDPA's float32
    forward, and its backward (grad through SDPA less its forward), timed
    only; each backward launch timed apart (``torch.profiler``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    tol = TOLERANCE["float32"]
    h, hd = 8, 16
    for label, b, s in F32_HD16_ROWS:
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                       for _ in range(4))
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves)
        t_sf = time_ms(sdpa, 5)
        t_sb = time_ms(lambda: torch.autograd.grad(
            sdpa(), leaves, do.transpose(1, 2)), 5) - t_sf
        for lse in (False, True):
            work, nb = fa.fwd_work(b, s, s, h, h, hd, "float32", lse=lse)
            plain = ((lambda: ref.attention_lse_ref(q, k, v)) if lse
                     else (lambda: ref.attention_ref(q, k, v)))
            name = f"flash_attention[f32_hd16{' lse' if lse else ''}{label}]"
            row(name, "float32",
                lambda lse=lse: fa.flash_attention(q, k, v, return_lse=lse),
                plain, nb, work["tf32"], library_ms=t_sf, op_dtype="tf32")
            log_f32_fwd_bounds(f"{name} [float32]", nb, work["tf32"])
        want = ref.attention_ref(q, k, v)
        with tf32_on():
            control = [max_rel(ref.attention_ref(q, k, v), want)]
        o, lse = fa.flash_attention(q, k, v, return_lse=True)

        def kern():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)
        got, again = kern(), kern()
        same = all(torch.equal(a, c) for a, c in zip(got, again,
                                                     strict=True))
        # float64 inputs: the plain version computes in float64
        oracle = ref.attention_bwd_ref(
            *(x.double() for x in (q, k, v, o, lse, do)))
        rels = [max_rel(a, w) for a, w in zip(got, oracle, strict=True)]
        err = max((a.double() - w).abs().max().item()
                  for a, w in zip(got, oracle, strict=True))
        with tf32_on():
            control += [max_rel(a, w) for a, w in zip(
                ref.attention_bwd_ref(q, k, v, o, lse, do), oracle,
                strict=True)]
        log(f"kernel flash_attention_bwd[f32_hd16{label}] [float32] "
            f"against the float64 oracle: max_rel_err dq={rels[0]:.3e} "
            f"dk={rels[1]:.3e} dv={rels[2]:.3e} (tol {tol:.0e}); two "
            f"launches bitwise equal: {same}; the TF32 control's max rel "
            f"err (out; dq, dk, dv) "
            + ", ".join(f"{c:.3e}" for c in control)
            + f" (each must exceed {tol:.0e}); SDPA forward {t_sf:.4f} ms, "
              f"backward {t_sb:.4f} ms")
        if not same or max(rels) > tol or min(control) <= tol \
                or not all(bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"flash_attention_bwd[f32_hd16{label}]: "
                                 f"rel errs {rels}, bitwise {same}, TF32 "
                                 f"control {control}")
        del got, again, oracle, want
        work, nb = fa.bwd_work(b, s, s, h, h, hd, dtype_name="float32")
        row(f"flash_attention_bwd[f32_hd16{label}]", "float32", kern,
            lambda: ref.attention_bwd_ref(q, k, v, o, lse, do), nb,
            work["float32"], library_ms=t_sb, checked=(err, max(rels)))
        parts = sorted(device_ms(kern, 5).items())
        log(f"kernel flash_attention_bwd[f32_hd16{label}] per launch "
            "(torch.profiler, 5 calls): "
            + "; ".join(f"{n} {ms:.4f} ms" for n, (ms, _) in parts))
        del q, k, v, do, o, lse, leaves
        torch.cuda.empty_cache()


# the dit_small phase: dit-small at its full width (8 layers, d 128, 8
# heads of 16, float32) at the sizes whose joint attention reaches
# flash (latent 64: S 1024; 128: S 4096), beside the served 32 (S 256)
DIT_SMALL_SERVE_ARGS = ["--requests", "6", "--steps", "6", "--train-steps",
                        "4", "--batch", "2", "--sizes", "32,64,128"]
DIT_SMALL_TRAIN_STEPS = 3
DIT_SMALL_TRAIN_BATCH = 16
# the served stream's first five requests (every size and kind in it:
# generations at 32, 64 and 128, an edit at 64) are served again on the
# CPU and by the two controls on the card; its sixth, a second
# generation at 128, would add ~16 s of CPU
DIT_SMALL_ORACLE_REQUESTS = 5
# card against CPU, and the kernel route against the plain route on the
# card: float32 on both sides with TF32 off, so they differ by the order
# of float32 sums (and the kernels' ex2.approx, 2^-22 relative) through
# 8 layers, forward and back: ~1e-6 relative per attention call; the
# served latents over 6 steps on redrawn weights read 7.9e-7 to 1.9e-6
# relative L2 (the edit the most), and the limit is 2.7x the worst
DIT_SMALL_TOL = {"loss": 1e-5, "grad": 1e-4, "latents": 5e-6}
# the serve check's attention control: q scaled by 1 + this before the
# kernel, a softmax temperature off by 1e-3 (a wrong kernel), which the
# latents' limit must catch at every size that reaches flash (1e-4 read
# 5.3e-6 to 7.1e-6: too near the card-vs-CPU reading to tell apart)
DIT_SMALL_PERTURB = 1e-3


def _by_size(tokens: list, patch: int = 2) -> dict:
    """{latent size: calls} from the token counts of op-layer calls."""
    out = {}
    for s in tokens:
        size = int(math.isqrt(s)) * patch
        out[size] = out.get(size, 0) + 1
    return out


def dit_small_serve(params, argv, device: str, n_requests: int) -> list:
    """The FreqCa engine of ``launch.serve.main(argv)`` on ``device`` with
    ``params``, serving the first ``n_requests`` of its stream (a request
    is drawn from its id alone): the same policy, ladder and engine
    settings, no warmup and no uncached run; returns the outputs by
    request id."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DiffusionEngine
    args = serve.build_parser().parse_args(argv)
    cfg = configs.get_config("dit-small")
    size = 32
    shapes = serve.shape_ladder(cfg, serve._parse_sizes(args, size))
    full_fn, from_crf_fn = serve.dit_fns(params, cfg)
    pol = serve._default_policy(args)
    eng = DiffusionEngine(full_fn, from_crf_fn, (size, size, cfg.in_channels),
                          ((size // cfg.patch_size) ** 2, cfg.d_model), pol,
                          n_steps=args.steps, max_batch=args.batch,
                          max_wait_s=args.max_wait, shapes=shapes,
                          device=device)
    bursts = serve.mixed_stream(n_requests, size, cfg.in_channels,
                                edit_every=args.edit_every, shapes=shapes)
    outs, _ = serve.serve_stream(eng, bursts)
    return sorted(outs, key=lambda o: o.request_id)


def dit_small_step(params, cfg, latents, t, noise):
    """One ``rf_loss`` gradient of dit-small: ``(loss, {path: grad})``."""
    from repro_torch.checkpointing import checkpoint
    from repro_torch.diffusion import training
    from repro_torch.models import dit
    from repro_torch.optim import adamw
    loss, _ = training.rf_loss(
        lambda p, x, tt: dit.dit_forward(p, x, tt, cfg).velocity, params,
        {"latents": latents}, t=t, noise=noise)
    loss.backward()
    grads = adamw.tree_map(lambda p: p.grad, params)
    return loss.item(), {k: g.detach().cpu() for k, g in
                         checkpoint._flatten_with_paths(grads).items()}


def dit_small_reference(devices=("cpu", "cuda"), size: int = 64,
                        oracle_size: int = 128, batch: int = 2) -> dict:
    """One dit-small training step (``rf_loss`` gradient) at latent
    ``size`` on ``devices[1]`` (the flash kernels in every layer) against
    the same step on ``devices[0]`` (the plain attention), then at latent
    ``oracle_size`` on ``devices[1]`` against the same step there through
    the plain route (``dit._attention`` patched to ``ref.attention_ref``,
    a test-side oracle: the CPU's [B, 8, S, S] logits would take minutes
    at S 4096): the loss and every gradient leaf at ``DIT_SMALL_TOL``.
    The zero-initialised leaves are redrawn (``redraw_zero_leaves``), so
    every leaf has a gradient.  The first comparison runs again with TF32
    on as a control: its worst gradient leaf must miss the tolerance (its
    loss is logged: TF32 moved it 7e-6 in my run, inside 1e-5).  Returns
    the launch counts of the kernel runs by size."""
    from unittest import mock

    import torch

    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dit
    from repro_torch.optim import adamw
    cfg = configs.get_config("dit-small")
    params0 = dit.init_params(cfg, seed=80, device="cpu")
    redraw_zero_leaves(params0, seed=81)
    gen = torch.Generator().manual_seed(82)

    def inputs(side):
        lat = synthetic.shapes_batch(gen, batch, size=side,
                                     channels=cfg.in_channels)
        return (lat, torch.sigmoid(torch.randn((batch,), generator=gen)),
                torch.randn(lat.shape, generator=gen))

    def run(dev, drawn, plain=False):
        params = adamw.tree_map(
            lambda p: p.to(dev, copy=True).requires_grad_(True), params0)
        ops.reset_launch_counts()
        with (mock.patch.object(dit, "_attention", ref.attention_ref)
              if plain else contextlib.nullcontext()):
            out = dit_small_step(params, cfg, *(x.to(dev) for x in drawn))
        return out, ops.launch_counts()

    def held(label, got, want):
        (l_got, g_got), (l_want, g_want) = got, want
        loss_rel = abs(l_got - l_want) / abs(l_want)
        rels = {k: rel_l2(g_got[k], g_want[k]) for k in g_want}
        worst = max(rels, key=rels.get)
        zero = [k for k, g in g_got.items() if not bool(g.any())]
        log(f"dit_small reference {label}: loss {l_got:.7f} / {l_want:.7f} "
            f"(rel {loss_rel:.2e}, tol {DIT_SMALL_TOL['loss']:.0e}); worst "
            f"gradient leaf rel L2 {rels[worst]:.2e} ({worst}; tol "
            f"{DIT_SMALL_TOL['grad']:.0e}) over {len(rels)} leaves; zero "
            f"leaves {zero}")
        return (loss_rel <= DIT_SMALL_TOL["loss"]
                and rels[worst] <= DIT_SMALL_TOL["grad"] and not zero
                and sorted(g_got) == sorted(g_want)
                and all(bool(torch.isfinite(g).all())
                        for g in g_got.values()))
    n_s = (size // cfg.patch_size) ** 2
    drawn = inputs(size)
    want, _ = run(devices[0], drawn)
    got, counts = run(devices[1], drawn)
    ok = held(f"S {n_s} {devices[1]} vs {devices[0]}", got, want)
    by_size = {f"dit_small_reference_{size}": counts}
    on_card = torch.device(devices[1]).type == "cuda"
    control_rel = None
    if on_card:
        with tf32_on():
            control, _ = run(devices[1], drawn)
        held("TF32 control", control, want)
        control_rel = max(rel_l2(control[1][k], want[1][k]) for k in want[1])
    n_o = (oracle_size // cfg.patch_size) ** 2
    drawn = inputs(oracle_size)
    want, plain_counts = run(devices[1], drawn, plain=True)
    got, counts = run(devices[1], drawn)
    ok_o = held(f"S {n_o} {devices[1]} kernels vs plain route", got, want)
    by_size[f"dit_small_reference_{oracle_size}"] = counts
    want_counts = {"flash_attention_f32": cfg.n_layers,
                   "flash_attention_f32_bwd": cfg.n_layers}
    if (on_card and any(c != {k: want_counts.get(k, 0) for k in c}
                        for c in by_size.values())) \
            or any(plain_counts.values()):
        raise AssertionError(f"dit_small reference: launches {by_size}, "
                             f"the plain route's {plain_counts}")
    if not (ok and ok_o) or (control_rel is not None
                             and control_rel <= DIT_SMALL_TOL["grad"]):
        raise AssertionError(f"dit_small reference: the steps disagree, or "
                             f"the TF32 control ({control_rel}) does not")
    return by_size


def dit_small_phase(device: str = "cuda", serve_args=None,
                    train_sizes=(64, 128), steps: int = DIT_SMALL_TRAIN_STEPS,
                    batch: int = DIT_SMALL_TRAIN_BATCH) -> dict:
    """dit-small at full width where its joint attention reaches the
    float32 hd-16 flash kernels (``flash_attention_f32``):
    - kernels 1 and 2 against their plain versions at the float32 CRF of
      a batch at each ladder size (``cache_kernel_checks``);
    - serve: ``launch.serve.main(DIT_SMALL_SERVE_ARGS)`` on the card (a
      shape ladder of latent 32, 64 and 128, six requests in turn, every
      fifth an edit, FreqCa interval 5 and the uncached engine), its
      trained weights' AdaLN-zero leaves redrawn (``redraw_zero_leaves``:
      four AdamW steps leave them ~1e-4, and the velocity would barely
      read the attention): every request answered once with finite
      latents of its size; the first ``DIT_SMALL_ORACLE_REQUESTS``
      served again through the same FreqCa engine on the CPU on the same
      weights (``dit_small_serve``, in a thread beside the card's work
      below): full steps equal and latents within ``DIT_SMALL_TOL``
      relative L2; two controls on the card, the same requests with TF32
      on and with the kernel's q scaled by ``1 + DIT_SMALL_PERTURB``,
      must each miss that tolerance on every request they change; the
      op layer's calls of the new forward and of kernels 1 and 2 (spied
      by token count) are > 0 at latent 64 and 128 and add up to each
      kernel's launches, and flash is not called at 32;
    - train: ``launch.train.train_dit`` for ``steps`` steps on batch
      ``batch`` at latent 64 and at 128: finite losses, every leaf's
      gradient finite and non-zero on step 0 (zero leaves redrawn), one
      forward and one backward launch of the new kernels a layer a step;
    - ``dit_small_reference``: a step at latent 64 card against CPU, and
      at 128 kernels against the plain route on the card;
    - the dry run's dit-small full step at latent 128
      (``dryrun.DIT_LATENT``) on the one-card mesh, batch 2, against the
      card (``dryrun_card_row``).
    Returns the launch counts by run.  (``device``, ``serve_args`` and
    ``train_sizes`` let it be rehearsed small on the CPU: the launch and
    dry-run checks then are skipped.)"""
    import threading
    from unittest import mock

    import torch

    from repro_torch import configs
    from repro_torch.checkpointing import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, mesh, serve, train
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import dit
    from repro_torch.optim import adamw
    on_card = torch.device(device).type == "cuda"
    cfg = configs.get_config("dit-small")
    serve_args = list(serve_args or DIT_SMALL_SERVE_ARGS)
    args = serve.build_parser().parse_args(serve_args)
    sizes = serve._parse_sizes(args, 32)
    by_phase = {}

    if on_card:
        for s_img in sorted({(sz // cfg.patch_size) ** 2 for sz in sizes}):
            cache_kernel_checks(args.batch, s_img, cfg.d_model, device,
                                "dit_small")
    # serve on the card, the op layer's calls of the three kernels spied
    # by token count: {op: (the kernel's counter, the token axis's arg)}
    spied = {"flash": ("flash_attention_f32", lambda a: a[0].shape[1]),
             "band_split_spectral": ("band_split_spectral",
                                     lambda a: a[0].shape[1]),
             "freqca_predict_spectral": ("freqca_predict_fused_spectral",
                                         lambda a: a[2].shape[-2])}
    seen = {op: [] for op in spied}

    def spy(op, real):
        def call(*a, **kw):
            seen[op].append(spied[op][1](a))
            return real(*a, **kw)
        return call
    real_train = serve.train_dit

    def train_redrawn(*a, **kw):
        params = real_train(*a, **kw)
        with torch.no_grad():
            redraw_zero_leaves(params, seed=89)
        return params
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for op in spied:
            stack.enter_context(mock.patch.object(
                ops, op, spy(op, getattr(ops, op))))
        stack.enter_context(mock.patch.object(serve, "train_dit",
                                              train_redrawn))
        res = serve.main(serve_args + ["--device", device])
    wall = time.perf_counter() - t0
    counts = by_phase["dit_small_serve"] = ops.launch_counts()
    at = {op: _by_size(v, cfg.patch_size) for op, v in seen.items()}
    outs = res["freqca"]["outs"]
    log(f"dit_small: serve {serve_args} in {wall:.1f} s (training "
        f"included): {len(outs)} FreqCa requests, full steps "
        f"{[o.n_full_steps for o in outs]}, uncached "
        f"{[o.n_full_steps for o in res['full']['outs']]}; op-layer calls "
        f"by latent size {at}; launch counts {counts}")

    # the stream's first requests through its FreqCa engine on the CPU,
    # beside the controls and the training
    n_oracle = min(DIT_SMALL_ORACLE_REQUESTS, args.requests)
    params_cpu = adamw.tree_map(lambda p: p.detach().to("cpu"),
                                res["params"])
    cpu = {}

    def cpu_serve():
        try:
            cpu["outs"] = dit_small_serve(params_cpu, serve_args, "cpu",
                                          n_oracle)
        except Exception as e:    # re-raised after the join
            cpu["error"] = e
    t_cpu = time.perf_counter()
    worker = threading.Thread(target=cpu_serve, name="dit_small_cpu_serve")
    worker.start()
    controls = {}
    if on_card:
        real_flash = ops.flash

        def flash_off(q, k, v, *a, **kw):
            # the card's calls only: the CPU's run goes on beside this
            if q.is_cuda:
                q = q * (1 + DIT_SMALL_PERTURB)
            return real_flash(q, k, v, *a, **kw)
        with tf32_on():
            controls["TF32"] = dit_small_serve(res["params"], serve_args,
                                               device, n_oracle)
        with mock.patch.object(ops, "flash", flash_off):
            controls[f"q x (1 + {DIT_SMALL_PERTURB:.0e})"] = \
                dit_small_serve(res["params"], serve_args, device, n_oracle)

    # train at the sizes that reach the kernels
    for size in train_sizes:
        params = dit.init_params(cfg, seed=83, device=device)
        redraw_zero_leaves(params, seed=84)
        records, bad = [], []

        def on_step(i, metrics, grads):
            records.append(metrics)
            if i == 0:
                bad.extend(k for k, g in checkpoint._flatten_with_paths(
                    grads).items() if g is None or not (
                    bool(torch.isfinite(g).all()) and bool(g.any())))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        train.train_dit(cfg, steps, batch, "", seed=85, log_every=steps,
                        size=size, device=device, params=params,
                        on_step=on_step)
        wall = time.perf_counter() - t0
        counts = by_phase[f"dit_small_train_{size}"] = ops.launch_counts()
        s_img = (size // cfg.patch_size) ** 2
        log(f"dit_small: train_dit at latent {size} (S {s_img}), batch "
            f"{batch}, {steps} steps in {wall:.2f} s: losses "
            f"{[round(m['loss'], 6) for m in records]}"
            + ("; step walls (ms) "
               + str([round(m['step_ms'], 1) for m in records])
               + ", forward / backward / AdamW of the last "
               f"{records[-1]['forward_ms']:.1f} / "
               f"{records[-1]['backward_ms']:.1f} / "
               f"{records[-1]['adamw_ms']:.1f} ms"
               if on_card else "")
            + f"; step-0 gradient leaves off {bad}; launch counts {counts}")
        want = {"flash_attention_f32": steps * cfg.n_layers,
                "flash_attention_f32_bwd": steps * cfg.n_layers}
        if len(records) != steps or bad or not all(
                math.isfinite(m["loss"]) for m in records) or (
                on_card and counts != {k: want.get(k, 0) for k in counts}):
            raise AssertionError(f"dit_small: train at {size}: losses "
                                 f"{records}, leaves off {bad}, launches "
                                 f"{counts}, expected {want}")
        del params
        _free(device)

    worker.join(timeout=600)
    if worker.is_alive():
        raise AssertionError("dit_small: the CPU's run of the stream took "
                             "over 600 s")
    if "error" in cpu:
        raise cpu["error"]
    cpu_outs = cpu["outs"]
    tol = DIT_SMALL_TOL["latents"]
    n_req = args.requests
    ids = [o.request_id for o in outs]
    card_full = [o.n_full_steps for o in outs[:n_oracle]]
    cpu_full = [o.n_full_steps for o in cpu_outs]
    lat_rel = [rel_l2(a.latents, b.latents)
               for a, b in zip(outs[:n_oracle], cpu_outs, strict=True)]
    size_of = [sizes[i % len(sizes)] for i in ids]
    shapes_ok = all(
        tuple(o.latents.shape) == (sz, sz, cfg.in_channels)
        and bool(torch.isfinite(torch.as_tensor(o.latents)).all())
        for o, sz in zip(outs, size_of, strict=True))
    # each control against the CPU, on the requests it changes: TF32 all
    # of them, the attention's every one that reaches flash (latent > 32)
    missed = {}
    for name, c_outs in controls.items():
        changed = [i for i in range(n_oracle)
                   if name == "TF32" or size_of[i] > 32]
        missed[name] = [rel_l2(c_outs[i].latents, cpu_outs[i].latents)
                        for i in changed]
    log(f"dit_small: the CPU's FreqCa run of the stream's first {n_oracle} "
        f"requests in {time.perf_counter() - t_cpu:.1f} s: full steps "
        f"{cpu_full} (card {card_full}); latents card vs CPU rel L2 by "
        "request " + ", ".join(f"{r:.3e}" for r in lat_rel)
        + f" (tol {tol:.0e}); the controls' rel L2 (each must exceed it) "
        + "; ".join(f"{n} " + ", ".join(f"{r:.3e}" for r in v)
                    for n, v in missed.items()))
    served = by_phase["dit_small_serve"]
    reached = on_card and all(
        all(at[op].get(sz, 0) > 0 for sz in sizes if sz > 32)
        and sum(at[op].values()) == served[counter]
        for op, (counter, _) in spied.items()) and at["flash"].get(32) is None
    if (ids != list(range(n_req)) or card_full != cpu_full or not shapes_ok
            or max(lat_rel) > tol
            or any(min(v) <= tol for v in missed.values())
            or (on_card and not reached)):
        raise AssertionError(f"dit_small: serve: ids {ids}, full steps "
                             f"{card_full} vs CPU {cpu_full}, latents rel "
                             f"{lat_rel}, controls {missed}, op-layer calls "
                             f"{at}, launches {served}")
    del res, params_cpu, cpu, controls
    _free(device)

    if on_card:
        by_phase.update(dit_small_reference())
        one = mesh.one_card_mesh()
        latent = dryrun.DIT_LATENT["dit-small"]
        spec = steps_lib.build_dit("dit-small", one, batch=2, latent=latent)
        gen = torch.Generator(device="cuda").manual_seed(86)
        params = dit.init_params(cfg, seed=87, device="cuda")
        redraw_zero_leaves(params, seed=88)
        args_card = (params, _fill(gen)(spec.args[1]),
                     torch.full((2,), 0.7, device="cuda"))
        log(f"dit_small: the dry run's full step at latent {latent} (S "
            f"{(latent // cfg.patch_size) ** 2}), batch 2, one card:")
        by_phase["dryrun_dit_small_denoise_step"] = dryrun_card_row(
            "dit_small_denoise_step", spec, args_card, nvidia_smi())
        del args_card, params
        _free("cuda")
    return by_phase


# the phases after the build and kernel phases, in the order they run
PHASES = ("dryrun", "reference", "analysis", "serve", "slo", "backbone",
          "lm", "decode", "train", "lm_train", "moe", "lm_configs", "jamba",
          "encdec", "vlm", "dit_small", "launcher", "fleet")


def run_phases(phases) -> dict:
    """Run the selected phases in ``PHASES`` order, each model freed
    before the next is drawn; returns the launch counts of every run,
    by run."""
    from repro_torch import configs

    def free():
        _free("cuda")
    by_phase = {}
    t_last = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - t_last[0]:.1f} s")
        t_last[0] = now
    dry = "dryrun" in phases
    smi = nvidia_smi()
    if dry:
        dryrun_sweep()
        done("dryrun (the 16 x 16 sweep)")
    if "reference" in phases:
        reference_phase()
        done("reference")
    if {"analysis", "serve", "slo", "dryrun"} & set(phases):
        model = flux_model()
        for name, fn in (("analysis", analysis_phase), ("serve", serve_phase),
                         ("slo", slo_phase)):
            if name in phases:
                by_phase[name] = fn(model, N_STEPS)
                done(name)
        if dry:
            by_phase.update(dryrun_flux(model, smi))
            done("dryrun (flux1-dev rows)")
        del model       # free flux1-dev (~26 GB) before the next models
        free()
    if "backbone" in phases:
        by_phase["backbone"] = backbone_phase(N_STEPS)
        free()
        done("backbone")
    if {"lm", "decode", "dryrun"} & set(phases):
        yi = configs.get_config("yi-9b")
        yi_params = lm_params(yi, yi.n_layers, seed=30, device="cuda")
        if "lm" in phases:
            by_phase.update(lm_phase(params=yi_params))
            free()     # the lm phase's 32768-token activations
            done("lm")
        if dry:
            by_phase.update(dryrun_lm("yi_prefill_32k", yi_params, smi))
            free()
            done("dryrun (yi-9b row)")
        if "decode" in phases:
            by_phase.update(decode_phase(yi_params))
            done("decode")
        del yi_params
        free()
    for name, fn in (("train", train_phase), ("lm_train", lm_train_phase),
                     ("moe", moe_phase), ("lm_configs", lm_configs_phase),
                     ("jamba", jamba_phase), ("encdec", encdec_phase),
                     ("vlm", vlm_phase), ("dit_small", dit_small_phase)):
        if name in phases:
            by_phase.update(fn())
            free()
            done(name)
    if dry:
        for label in ("mamba2_train_4k", "granite_prefill_32k"):
            by_phase.update(dryrun_lm(label, smi=smi))
            free()
        done("dryrun (mamba2-370m and granite rows)")
    if "launcher" in phases:
        by_phase["launcher"] = launcher_phase()
        done("launcher")
    if "fleet" in phases:
        by_phase.update(fleet_phase())
        done("fleet")
    return by_phase


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build and "
                         "kernel phases, which always run (default: all: "
                         + ", ".join(PHASES) + ")")
    args = ap.parse_args(argv)
    phases = tuple(p for p in args.phases.split(",") if p)
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {smi}; capability {cap}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; phases {list(phases)}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability (9, 0), "
                         f"got {cap}")

    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {secs} (wall {time.perf_counter() - t0:.1f} s)")
    for name in build.KERNELS:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    flash_build_checks()
    mma_build_checks()
    f32_build_checks()

    # each kernel's row is the type its path runs it in: the served CRF
    # is bf16 with float32 rings, and the legacy cache state float32
    main_dtype = {"band_split_spectral": "bfloat16",
                  "freqca_predict_fused_spectral": "float32",
                  "flash_attention": "bfloat16",
                  "token_basis_matmul": "bfloat16",
                  "freqca_predict_fused": "float32",
                  "ssd_chunk_scan": "bfloat16",
                  "flash_attention_bwd": "bfloat16",
                  "ssd_chunk_scan_bwd": "bfloat16"}
    rows = kernel_phase(main_dtype)
    log(f"build and kernel phases: {time.perf_counter() - t_start:.1f} s")
    # launches are read from the counters of the phases that run each
    # kernel's paths (reset just before each, read just after) and
    # summed; without those phases nothing was counted and the line
    # says null
    by_phase = run_phases(phases)
    paths = {name: [ph for ph in by_phase if by_phase[ph][name] > 0]
             for name in main_dtype}

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
        "token_basis_matmul": ("src/repro_torch/kernels/csrc/"
                               "token_basis_matmul.cu",
                               "src/repro/kernels/dct.py:40"),
        "freqca_predict_fused": ("src/repro_torch/kernels/csrc/"
                                 "freqca_fused.cu",
                                 "src/repro/kernels/freqca_fused.py:42"),
        "ssd_chunk_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:68"),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "none: XLA autodiff of repro/models/dit.py:_joint_attention"),
        "ssd_chunk_scan_bwd": (
            "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "none: XLA autodiff of src/repro/models/ssm.py:93 ssd_chunked, "
            "through ssm_block :156-172"),
    }
    kernels = []
    for name, (src, rep) in replaces.items():
        k = dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=(sum(by_phase[ph][name] for ph in paths[name])
                           if by_phase else None), **rows[name])
        if by_phase:
            k["launches_by_phase"] = {ph: by_phase[ph][name]
                                      for ph in paths[name]}
        if name == "flash_attention":
            k["forms"] = ("all: non-causal MHA (this row's times: the DiT "
                          "joint attention, bf16 [2, 4608, 24, 128]); "
                          "causal GQA, sliding-window and non-causal GQA "
                          "(rows flash_attention[... gqa 32/4] of the "
                          "kernel phase; the lm, moe, lm_configs, jamba "
                          "and vlm phases' launches are causal GQA, groups "
                          "3 at hd 64 and 4, 7, 8, 12, 16 at hd 128, each "
                          "timed at 32768 tokens in its phase's log); the "
                          "encdec phase's are MHA at hd 64: non-causal "
                          "(encoder, and cross-attention with T != S) and "
                          "causal (decoder), rows flash_attention[seamless "
                          "...] in form_rows")
        if name == "flash_attention_bwd":
            k["forms"] = ("all four, bf16 (this row's times: the DiT joint "
                          "attention [2, 4608, 24, 128]; rows "
                          "flash_attention_bwd[train 2x4096] and [causal "
                          "gqa 32/4] of the kernel phase); the train "
                          "phase's launches are non-causal MHA, the "
                          "lm_train_yi, moe_train and vlm_train phases' "
                          "causal GQA (groups 8; 3 at hd 64 and 4; 7, "
                          "timed at batch 8 in their phases' logs), the "
                          "encdec_train phase's MHA at hd 64, non-causal "
                          "and causal (rows flash_attention_bwd[seamless "
                          "train ...] in form_rows)")
        if name == "ssd_chunk_scan":
            k["forms"] = ("heads of 64 (this row: one mamba2-370m layer, "
                          "bf16 [2, 4096, 32, 64], N 128, chunk 256) and of "
                          "128, run as two of 64 (row "
                          "ssd_chunk_scan[jamba] in form_rows: one jamba "
                          "layer [1, 4096, 128, 128]; the jamba phase's "
                          "launches at [1, 32768, 128, 128])")
        if name == "ssd_chunk_scan_bwd":
            k["forms"] = ("bf16 and float32 x, B, C (this row: bf16, one "
                          "mamba2-370m layer [2, 4096, 32, 64], N 128, "
                          "chunk 256); the lm_train_mamba2 phase's "
                          "launches are bf16 at batch 8; heads of 128 "
                          "(row ssd_chunk_scan_bwd[jamba] in form_rows; "
                          "the jamba phase's launch at [1, 4096, 128, "
                          "128])")
        form_rows = {label: v for label, v in FORM_ROWS.items()
                     if label.startswith(name + "[")
                     and "f32_hd16" not in label}
        if form_rows:
            k["form_rows"] = form_rows
        kernels.append(k)
    # the float32 hd-16 library (dit-small from latent 64): its rows
    # carry the [2, 4096, 8, 16] numbers, the other shapes in form_rows
    for name, (counter, src, rep) in F32_HD16_KERNELS.items():
        k = dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=(sum(c[counter] for c in by_phase.values())
                           if by_phase else None),
                 **FORM_ROWS[name]["float32"])
        if by_phase:
            k["launches_by_phase"] = {ph: c[counter]
                                      for ph, c in by_phase.items()
                                      if c[counter]}
        k["forms"] = ("float32, head width 16, non-causal MHA (dit-small's "
                      "joint attention, 8 heads): this row [2, 4096, 8, "
                      "16]; [16, 1024] and the ragged [2, 1600] in "
                      "form_rows" + (", and the forward writing its "
                                     "log-sum-exp" if "bwd" not in name
                                     else ""))
        k["form_rows"] = {label: v for label, v in FORM_ROWS.items()
                          if label.startswith(name[:-1]) and label != name}
        kernels.append(k)
    log(f"chip_smoke: phases {list(phases)} done in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

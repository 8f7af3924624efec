"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into its own shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, named by a hash of its sources and flags so an edited
source is rebuilt and an unchanged one is not.  Nothing is compiled at
import: ``load`` builds a missing library at first use, and ``build``
compiles several at once (one ``nvcc`` process per source, all started
together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("band_split_spectral", "freqca_fused_spectral", "flash_attention",
           "token_basis_matmul", "freqca_fused", "ssd_scan",
           "flash_attention_bwd", "ssd_scan_bwd", "flash_attention_f32")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """nvcc's output for the library of ``name`` (ptxas' registers,
    shared memory, spills and warnings per kernel), kept beside it."""
    return lib_path(name).with_suffix(".ptxas").read_text()


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library of ``names`` (default: all) in
    parallel; returns ``{name: seconds}`` for those built.  Raises with
    nvcc's output if any build fails."""
    names = [n for n in (names or KERNELS)
             if not (lib_path(n).exists()
                     and lib_path(n).with_suffix(".ptxas").exists())]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    seconds, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n} (exit {proc.returncode}):\n{out}")
            continue
        lib_path(n).with_suffix(".ptxas").write_text(out)
        os.replace(tmp, lib_path(n))   # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
        return lib


_fns: Dict[tuple, object] = {}


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """Library ``name``'s C function ``symbol`` with its argument and
    result types set, configured once (setting ``argtypes`` costs a few
    microseconds of host time a call, which the small kernels feel)."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _fns[key] = fn
    return fn


def dtype_code(t) -> int:
    """The kernels' element-type code (``rt::DType`` in common.cuh)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on one device (what the C entry points assume)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected contiguous, 16-byte "
                             "aligned tensors")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def require_no_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward the kernel lacks: its
    output is written through a pointer and has no ``grad_fn``, so a
    graph through it would stop there without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward yet; call it under "
            "torch.no_grad() or on tensors that need no gradient")


def check(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise if a C entry point reported a launch error."""
    if status != 0:
        msg = lib.rt_error_string(status).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({status})")

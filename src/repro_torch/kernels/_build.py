"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel source (``kernels/<name>/csrc/<lib>.cu``) becomes one shared
library with a plain C interface, compiled for Hopper (``sm_90a``) on
first use into ``build/repro_torch/`` at the repository root, under a
name keyed by a hash of its sources and flags.  A second use in the same
or a later process loads the cached library.  Nothing here includes
PyTorch's headers or needs the network; ``build_all`` starts one
``nvcc`` per source at once, so a cold build costs the slowest file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: the per-PE energy terms then round
              # exactly as the plain PyTorch version's separate ops do
              "-fmad=false"]

# library name -> its .cu source; headers are found next to it and in
# the shared cgra_step/csrc
SOURCES: Dict[str, Path] = {
    "cgra_alu": _PKG / "cgra_step" / "csrc" / "cgra_alu.cu",
    "cgra_sweep": _PKG / "cgra_sweep" / "csrc" / "cgra_sweep.cu",
}
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [SOURCES[name], *sorted(_PKG.glob("*/csrc/*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is cached; returns
    (final path, temp path, process or None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(_PKG / "cgra_step" / "csrc"),
           "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent builder is harmless
    return out


def build_all() -> List[Path]:
    """Compile every kernel library not yet cached, all in parallel."""
    started = {n: _start(n) for n in SOURCES}
    return [_finish(n, *started[n]) for n in SOURCES]


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_finish(name, *_start(name))))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")

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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# no FMA contraction in the CGRA libraries: the per-PE energy terms then
# round exactly as the plain PyTorch version's separate ops do
_NO_FMAD = ["-fmad=false"]

# library name -> its .cu source; headers are found next to it
SOURCES: Dict[str, Path] = {
    "cgra_alu": _PKG / "cgra_step" / "csrc" / "cgra_alu.cu",
    "cgra_sweep": _PKG / "cgra_sweep" / "csrc" / "cgra_sweep.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "ssd_intra_chunk": _PKG / "mamba2_scan" / "csrc" / "ssd_intra_chunk.cu",
    "flash_attention_bwd": _PKG / "flash_attention" / "csrc"
    / "flash_attention_bwd.cu",
    "ssd_intra_chunk_bwd": _PKG / "mamba2_scan" / "csrc"
    / "ssd_intra_chunk_bwd.cu",
    "smem_poison": _PKG / "common" / "csrc" / "smem_poison.cu",
}
# ptxas reports each kernel's registers, shared memory and spills; the
# report is kept beside the library (``build_log``)
_PTXAS_V = ["-Xptxas", "-v"]
# library name -> its flags beyond NVCC_FLAGS (the sweep kernel also
# includes the ALU header of cgra_step/csrc; the flash and SSD libraries,
# forward and backward, link libcuda, against the toolkit's stub, for
# cuTensorMapEncodeTiled)
EXTRA_FLAGS: Dict[str, List[str]] = {
    "cgra_alu": _NO_FMAD,
    "cgra_sweep": _NO_FMAD + _PTXAS_V
    + ["-I", str(_PKG / "cgra_step" / "csrc")],
    "flash_attention": _PTXAS_V + ["-lcuda"],
    "ssd_intra_chunk": _PTXAS_V + ["-lcuda"],
    "flash_attention_bwd": _PTXAS_V + ["-lcuda"],
    "ssd_intra_chunk_bwd": _PTXAS_V + ["-lcuda"],
    "smem_poison": [],
}
_loaded: Dict[str, ctypes.CDLL] = {}
_typed: Dict[tuple, tuple] = {}     # (library, entry) -> (CDLL, function)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS[name]


def _link_dirs() -> List[str]:
    """-L for the toolkit's libcuda stub, where the toolkit has one."""
    root = Path(nvcc()).resolve().parents[1]
    return [arg for d in (root / "lib64" / "stubs",
                          root / "targets" / "x86_64-linux" / "lib" / "stubs")
            if d.is_dir() for arg in ("-L", str(d))]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
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
    flags = _flags(name)
    libs = [f for f in flags if f.startswith("-l")]   # after the source
    cmd = [nvcc(), *(f for f in flags if f not in libs), *_link_dirs(),
           "-o", str(tmp), str(SOURCES[name]), *libs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent builder is harmless
    return out


def build_all() -> List[Path]:
    """Compile every kernel library not yet cached, all in parallel."""
    started = {n: _start(n) for n in SOURCES}
    return [_finish(n, *started[n]) for n in SOURCES]


def build_log(name: str) -> str:
    """nvcc's output for library ``name`` (with ``-Xptxas -v`` the
    registers, shared memory and spills of each kernel); "" if none."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_finish(name, *_start(name))))
        _loaded[name] = lib
    return lib


def function(name: str, entry: str, argtypes):
    """The C function ``entry`` of library ``name``, returning int, its
    argument types set once per loaded library (not on every call)."""
    lib = library(name)
    got = _typed.get((name, entry))
    if got is None or got[0] is not lib:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        got = _typed[(name, entry)] = (lib, fn)
    return got[1]


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")

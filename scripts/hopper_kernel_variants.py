#!/usr/bin/env python3
"""Time the design alternatives of the two redesigned Hopper kernels
against the kernels as committed, on one GPU.

    PYTHONPATH=src python3 scripts/hopper_kernel_variants.py

Each variant is a copy of ``src/repro_torch/kernels`` with a few source
lines replaced, built with the library's own nvcc flags into
``build/variants/<name>/`` (one nvcc per variant, all at once) and
loaded in place of the committed library for its measurements:

- flash attention (bf16, the serving path's prefill shape B=1, S=2048,
  H=32, hd=80, causal): three and four consumer warpgroups a block, two
  blocks an SM (96 registers a thread), the probability as a branch per
  element (``live ? exp2f : 0``), and P.V on one bf16 term of P (the
  split's cost; its error fails the two-bf16-steps check, shown);
- the sweep kernel (the 40,960-point conv campaign of chip_smoke.py,
  three buckets, ``max_steps=13000``): lanes per block and chunk sizes
  of ``dse.sweep``, and each lane's memory image copied into shared
  memory for the chunk (``blk_b`` <= 14 at 16 KB an image).

Every variant's results are compared with the committed kernel's:
attention against the plain version (max error, elements off by more
than two bf16 steps), the sweep's integers bit for bit and its energy.
Prints one line a measurement and the ptxas summary (registers, spills,
wgmma serialization notes) of each variant.  Measurements alternate
committed, variants, committed.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "variants"
FH = "flash_attention/csrc/flash_hopper.cuh"
FT = "flash_attention/csrc/flash_tile.cuh"
SW = "cgra_sweep/csrc/cgra_sweep.cu"

FLASH = {
    "three consumer warpgroups": [
        (FH, "constexpr int CONSUMERS = 2; ", "constexpr int CONSUMERS = 3; ")],
    "four consumer warpgroups": [
        (FH, "constexpr int CONSUMERS = 2; ", "constexpr int CONSUMERS = 4; ")],
    "two blocks an SM": [
        (FH, "__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
    "branch per probability": [
        (FT, "  const float p = exp2f(fmaf(s, c, -m));\n  return live ? p : 0.0f;",
         "  return live ? exp2f(fmaf(s, c, -m)) : 0.0f;")],
    "P in one bf16 term": [
        (FH, "      mma_rs<HDP>(acc, p_lo + 4 * kk, dv);\n", "")],
}
_LAUNCH = "sweep_kernel<{p}><<<blocks, s.blk_b * P, 0, stream>>>(s);"
_LAUNCH_SMEM = ("{{ const int smem = 4 * s.mem_size * s.blk_b; "
                "cudaFuncSetAttribute(sweep_kernel<{p}>, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, smem); "
                "sweep_kernel<{p}><<<blocks, s.blk_b * P, smem, stream>>>(s); }}")
SWEEP = {
    "images in shared memory": [
        (SW, "  const int P = kP > 0 ? kP : s.rows * s.cols;\n",
         "  const int P = kP > 0 ? kP : s.rows * s.cols;\n"
         "  extern __shared__ int32_t images[];\n"),
        (SW, "  int32_t* mem = s.mem + lane * s.mem_size;\n",
         "  int32_t* const image = s.mem + lane * s.mem_size;\n"
         "  int32_t* mem = images + static_cast<int64_t>(slot_in_block) *"
         " s.mem_size;\n"
         "  for (int i = pe; i < s.mem_size; i += P) mem[i] = image[i];\n"
         "  __syncwarp(gmask);\n"),
        (SW, "  regs[0] = r0;\n",
         "  for (int i = pe; i < s.mem_size; i += P) image[i] = mem[i];\n"
         "  regs[0] = r0;\n"),
        (SW, _LAUNCH.format(p=16), _LAUNCH_SMEM.format(p=16)),
        (SW, _LAUNCH.format(p=0), _LAUNCH_SMEM.format(p=0))],
}


def start_build(name: str, lib: str, edits):
    """Copy the kernel sources, apply ``edits``, start nvcc."""
    d = OUT / name.replace(" ", "_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(KERNELS, d, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    for rel, old, new in edits:
        p = d / rel
        text = p.read_text()
        if old not in text:
            raise SystemExit(f"variant {name!r}: {rel} no longer holds "
                             f"{old[:60]!r}")
        p.write_text(text.replace(old, new))
    flags = [f.replace(str(KERNELS), str(d)) for f in _build._flags(lib)]
    libs = [f for f in flags if f.startswith("-l")]
    so = d / f"lib{lib}.so"
    src = d / _build.SOURCES[lib].relative_to(KERNELS)
    cmd = [_build.nvcc(), *(f for f in flags if f not in libs),
           *_build._link_dirs(), "-o", str(so), str(src), *libs]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def ptxas_summary(log: str, kernel: str) -> str:
    lines = log.splitlines()
    notes = sorted({ln.split("(C")[1][:4] for ln in lines if "(C75" in ln})
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "stack frame" in x or "Used" in x]
            return "; ".join(info) + f"; ptxas notes C{notes}"
    return f"ptxas notes C{notes}"


def cuda_ms(fn, reps: int = 1) -> float:
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def flash(libs, committed) -> None:
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 2048, 32, 80, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    want = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                         causal=True).transpose(1, 2).float()
    order = ["committed", *libs, "committed"]
    for name in order:
        _build._loaded["flash_attention"] = libs.get(name, committed)
        got = attention(q, k, v).float()
        err = float((got - want).abs().max())
        off = int((~torch.isclose(got, want, rtol=2.0 ** -6,
                                  atol=1e-5)).sum())
        attention(q, k, v)
        ms = cuda_ms(lambda: attention(q, k, v), reps=50)
        print(f"[flash] {name}: {ms:.4f} ms, max abs err {err:.3g}, "
              f"{off} elements off by more than two bf16 steps")


def sweep(libs, committed) -> None:
    from repro_torch.apps import conv
    from repro_torch.core import dse, hwconfig
    from repro_torch.core.characterization import characterize
    from repro_torch.core.program import bucket_programs
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine
    from repro_torch.kernels.cgra_sweep.ref import init_lanes
    dev = torch.device("cuda")
    prof = characterize(device=dev)
    progs = [m.program for m in conv.all_mappings()]
    images = np.stack([conv.conv_wp(seed).mem_init for seed in range(256)])
    hws = [hwconfig.TOPOLOGIES[t]().replace(smul_lat=s, n_banks=nb)
           for t in sorted(hwconfig.TOPOLOGIES) for s in (1, 3)
           for nb in (2, 4, 8, 16)]
    inputs = []
    for batch in bucket_programs(progs, 4).batches:
        plan = dse.plan_grid(batch, hws, images, device=dev)
        mem = plan.images[torch.as_tensor(plan.img_idx, device=dev).long()]
        inputs.append((dse.sweep_tables(plan.batch, prof, dev), plan.hw_grid,
                       torch.as_tensor(plan.prog_idx, device=dev), mem))

    def campaign(blk_b, chunk_steps):
        total, states = [], []
        for tables, hw, gidx, mem in inputs:
            st = init_lanes(mem.clone(), 16)
            total.append(cuda_ms(lambda: sweep_engine(
                tables, hw, gidx, st, rows=4, cols=4, max_steps=13000,
                chunk_steps=chunk_steps, blk_b=blk_b)))
            states.append(st)
        return total, states

    _build._loaded["cgra_sweep"] = committed
    _, ref = campaign(32, 64)
    runs = [("committed", 32, 64), ("committed", 16, 64),
            ("committed", 8, 64), ("committed", 32, 256),
            ("committed", 32, None)]
    runs += [(n, b, 64) for n in libs for b in (13, 7)]
    runs += [("committed", 32, 64)]
    for name, blk_b, chunk_steps in runs:
        _build._loaded["cgra_sweep"] = libs.get(name, committed)
        ms, states = campaign(blk_b, chunk_steps)
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for a, b in zip(states, ref) for f in a._fields)
        print(f"[sweep] {name}, blk_b {blk_b}, chunk_steps {chunk_steps}: "
              f"{sum(ms):.2f} ms over the buckets "
              f"{[round(x, 2) for x in ms]}; equal to the committed "
              f"kernel's results: {same}")


def main() -> int:
    if not torch.cuda.is_available():
        print("hopper_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build_all()
    committed_flash = _build.library("flash_attention")
    committed_sweep = _build.library("cgra_sweep")
    flash_log = _build.build_log("flash_attention")
    print(f"[build] committed flash: "
          f"{ptxas_summary(flash_log, 'flash_fwd_hopperILi80')}")
    started = {("flash_attention", n): start_build(n, "flash_attention", e)
               for n, e in FLASH.items()}
    started.update({("cgra_sweep", n): start_build(n, "cgra_sweep", e)
                    for n, e in SWEEP.items()})
    libs = {"flash_attention": {}, "cgra_sweep": {}}
    for (lib, name), (so, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[build] {name}: nvcc failed\n{log[-2000:]}")
            return 1
        kernel = "flash_fwd_hopperILi80" if lib == "flash_attention" \
            else "sweep_kernelILi16"
        print(f"[build] {name}: {ptxas_summary(log, kernel)}")
        libs[lib][name] = ctypes.CDLL(str(so))
    flash(libs["flash_attention"], committed_flash)
    sweep(libs["cgra_sweep"], committed_sweep)
    return 0

if __name__ == "__main__":
    sys.exit(main())

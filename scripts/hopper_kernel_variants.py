#!/usr/bin/env python3
"""Time the design alternatives of the redesigned Hopper kernels
against the kernels as committed, on one GPU.

    PYTHONPATH=src python3 scripts/hopper_kernel_variants.py \
        [--only flash|sweep|ssd|flash_bwd|ssd_bwd]

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
  memory for the chunk (``blk_b`` <= 14 at 16 KB an image);
- the intra-chunk SSD kernel (the serving path's shapes, L=64, H=80,
  P=64, N=64, at G=32 and G=5 chunks): both products as f32 FMAs on the
  CUDA cores or in 3xTF32 on the tensor cores (each written out below
  in place of the kernel's product functions), instead of f64 on the
  tensor cores; a ring of three x tiles
  instead of two; grids of at least 1 or 4 (chunk, head) items a block
  instead of at least 2; and three diagnostics
  that leave out the products, C.B^T, or everything but the loads and
  stores (their results are wrong by design; they show where the time
  goes).  Times are device times (the launches queue behind a sleep on
  the stream, so the host's time per call does not show) and CUDA
  events around 20 back-to-back calls, as chip_smoke.py's `ms`;
- the flash backward's tensor-core route (the training shape B=2,
  S=4096, H=32, hd=80, bf16, causal): a ring of three K/V tiles in the
  dQ kernel instead of two, both kernels without setmaxnreg (168
  registers a thread), and P and dS in one bf16 term each (the split's
  cost; its error fails the two-bf16-steps check, shown);
- the SSD backward (the training shape G=128, L=64, H=80, P=N=64): a
  ring of three x/dy slots instead of two, 8 warps a block instead of
  16, 256-byte L2 promotion of the TMA boxes, and three diagnostics that
  leave out the double exp, the ds and C.B^T products, or the dx
  products (wrong results by design).  Backward variants are timed by
  CUDA events around back-to-back calls and held to the float64 plain
  backward (elements off by more than the card checks' tolerance).

Every variant's results are compared with the committed kernel's:
attention against the plain version (max error, elements off by more
than two bf16 steps), the sweep's integers bit for bit and its energy,
the SSD against the plain version on the host (max error, elements off
by more than 2e-5) and against the float64 rounding bound of
scripts/stress_lm_kernels.py (worst error over the bound).
Prints one line a measurement and the ptxas summary (registers, spills,
wgmma serialization notes) of each variant.  Measurements alternate
committed, variants, committed.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "variants"
FH = "flash_attention/csrc/flash_hopper.cuh"
FT = "flash_attention/csrc/flash_tile.cuh"
SW = "cgra_sweep/csrc/cgra_sweep.cu"
SSD_CU = "mamba2_scan/csrc/ssd_intra_chunk.cu"
FB = "flash_attention/csrc/flash_bwd_hopper.cuh"
SSD_BWD_CU = "mamba2_scan/csrc/ssd_intra_chunk_bwd.cu"
SSD_BWD_TILE = "mamba2_scan/csrc/ssd_bwd_tile.cuh"

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


# The committed kernel's products (f64 mma.sync), as regions of its source
_SSD_MMA = ("// The products run on the tensor cores in f64",
            "__device__ __forceinline__ float2 ld2(")
_SSD_PRODUCTS = ("// One warp's C.B^T tile:", "struct Args {")
_SSD_3XTF32 = r"""// 3xTF32: each f32 operand split into two TF32 terms (hi rounded to
// nearest, ties away, as cvt.rna.tf32.f32 does; lo the rest, rounded the
// same way), hi * hi + hi * lo + lo * hi in f32 accumulators, the small
// terms first; lo * lo (about 2^-22 relative) is dropped.
using Acc = float;

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// d += a * b over one m16n8k8 tile, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    const float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float h, l;
      split_tf32(a[k], h, l);
      hi[k] = __float_as_uint(h);
      lo[k] = __float_as_uint(l);
    }
  }
};

__device__ __forceinline__ void mma_step(Acc (&d)[4], const FragA& a,
                                         float b0, float b1) {
  float bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

"""
_SSD_FMA = r"""__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// C.B^T by f32 FMAs: lane (rq, cc) owns rows i0 + 4 rq .. + 3 of column
// j0 + cc; 16-byte reads along the state dimension, one partial sum per
// row and lane of the read.
__device__ __forceinline__ void cb_tile_product(const float* cs,
                                                const float* bs, float* cb,
                                                int i0, int j0, int N,
                                                int lane) {
  const int rq = lane / 8, cc = lane % 8;
  float d[4][4] = {};
#pragma unroll 4
  for (int n = 0; n < N; n += 4) {
    const float4 bv = ld4(bs + ssd::swz(j0 + cc, n));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 cv = ld4(cs + ssd::swz(i0 + 4 * rq + k, n));
      d[k][0] = fmaf(cv.x, bv.x, d[k][0]);
      d[k][1] = fmaf(cv.y, bv.y, d[k][1]);
      d[k][2] = fmaf(cv.z, bv.z, d[k][2]);
      d[k][3] = fmaf(cv.w, bv.w, d[k][3]);
    }
  }
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    e[k] = (d[k][0] + d[k][1]) + (d[k][2] + d[k][3]);
  *reinterpret_cast<float4*>(cb + (j0 + cc) * CB_LD + i0 + 4 * rq) =
      make_float4(e[0], e[1], e[2], e[3]);
}

// scores.x by f32 FMAs: lane (rp, cg) owns rows i0 + 2 rp, + 1 of each of
// its strips and the 4-column groups quarter * 2 NBX + cg + 4 q: 8- and
// 16-byte reads of scores and x, 8 FMAs a pair of reads.
template <int NBX, bool kVec>
__device__ __forceinline__ void item_product(const float* sc,
                                             const float* xs, float* y,
                                             int64_t ld, int L, int P,
                                             int warp, int lane) {
  constexpr int NQ = (NBX + 1) / 2;
  const int quarter = warp >> 1, rp = lane / 4, cg = lane % 4;
  float acc[2][NQ][2][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[w][q][r][c] = 0.0f;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int i0 = ssd::STRIP * ssd::warp_strip(warp, which);
    const int r0 = i0 + 2 * rp;
    // columns in fours: the rows past L of x and of the scores are 0
    const int jn = i0 < L ? min(i0 + ssd::STRIP, (L + 3) & ~3) : 0;
    for (int j0 = 0; j0 < jn; j0 += 4) {
      float2 s2[4];
      float4 x4[4][NQ];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s2[u] = ld2(sc + (j0 + u) * SC_LD + r0);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (cg + 4 * q < 2 * NBX)
            x4[u][q] = ld4(xs + ssd::swz(
                j0 + u, 4 * (quarter * 2 * NBX + cg + 4 * q)));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (cg + 4 * q >= 2 * NBX) continue;
          const float sv[2] = {s2[u].x, s2[u].y};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* o = acc[which][q][r];
            o[0] = fmaf(sv[r], x4[u][q].x, o[0]);
            o[1] = fmaf(sv[r], x4[u][q].y, o[1]);
            o[2] = fmaf(sv[r], x4[u][q].z, o[2]);
            o[3] = fmaf(sv[r], x4[u][q].w, o[3]);
          }
        }
    }
  }
  // y: 16-byte stores when kVec
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int r0 = ssd::STRIP * ssd::warp_strip(warp, which) + 2 * rp;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = 4 * (quarter * 2 * NBX + cg + 4 * q);
      if (cg + 4 * q >= 2 * NBX || col >= P) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + r >= L) continue;
        float* yr = y + (r0 + r) * ld + col;
        const float* v = acc[which][q][r];
        if constexpr (kVec) {
          *reinterpret_cast<float4*>(yr) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < P) yr[c] = v[c];
        }
      }
    }
  }
}

"""
_SSD_NO_PRODUCT = (SSD_CU, "  for (int ks = 0; ks < nk; ++ks) {",
                   "  for (int ks = 0; ks < 0 * nk; ++ks) {")
_SSD_NO_CB = (SSD_CU, "      chunk_cb();\n",
              "      if (a.G < 0) chunk_cb();\n")
_SSD_NO_SCORES = (SSD_CU,
                  "        at[u] = i < L && j < L ? j * SC_LD + i : -1;",
                  "        at[u] = -1;")
SSD = {
    "f32 FMAs on the CUDA cores": [(SSD_CU, _SSD_PRODUCTS, _SSD_FMA)],
    "3xTF32 on the tensor cores": [(SSD_CU, _SSD_MMA, _SSD_3XTF32)],
    "ring depth 3": [
        (SSD_CU, "constexpr int STAGES = 2; ", "constexpr int STAGES = 3; ")],
    "at least 1 item a block": [
        (SSD_CU, "constexpr int MIN_ITEMS = 2; ",
         "constexpr int MIN_ITEMS = 1; ")],
    "at least 4 items a block": [
        (SSD_CU, "constexpr int MIN_ITEMS = 2; ",
         "constexpr int MIN_ITEMS = 4; ")],
    # diagnostics, wrong results by design: where the time goes
    "diagnostic: no products": [_SSD_NO_PRODUCT],
    "diagnostic: no C.B^T": [_SSD_NO_CB],
    "diagnostic: loads and stores only": [_SSD_NO_PRODUCT, _SSD_NO_CB,
                                          _SSD_NO_SCORES],
}
FLASH_BWD = {
    "backward dQ ring depth 3": [
        (FB, "constexpr int STAGES = 2;                 // ring depth",
         "constexpr int STAGES = 3;                 // ring depth"),
        (FB, "return hdp <= 80 ? STAGES : 1;", "return hdp <= 80 ? 2 : 1;")],
    "backward without setmaxnreg": [
        (FB, "    regs_release<PRODUCER_REGS>();\n", ""),
        (FB, "  regs_take<CONSUMER_REGS>();\n", ""),
        (FB, "if (dq_attr.numRegs < LAUNCH_REGS || kv_attr.numRegs < LAUNCH_REGS)",
         "if (false)")],
    "backward P and dS in one bf16 term": [
        (FB, "    mma_rs<HDP>(acc, lo + 4 * kk, dt);\n", "")],
}
SSD_BWD = {
    "backward ring depth 3": [
        (SSD_BWD_CU, "return nbx <= 2 ? 2 : 1;", "return nbx <= 2 ? 3 : 1;")],
    "backward 8 warps": [
        (SSD_BWD_CU, "constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
    "backward L2 promotion 256B": [
        (SSD_BWD_CU, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
         "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    # diagnostics, wrong results by design: where the time goes
    "backward diagnostic: no exp": [
        (SSD_BWD_TILE, "const T e = exp(cum_i - cum_j);",
         "const T e = T(1) + (cum_i - cum_j);")],
    "backward diagnostic: no ds or C.B^T products": [
        (SSD_BWD_CU, "mma_f64(ks % 2 ? odd[t] : d[t], a_lo.x, a_hi.x, a_lo.y, "
         "a_hi.y, bb.x,\n              bb.y);",
         "d[t][0] += a_lo.x * bb.x + a_hi.y * bb.y;")],
    "backward diagnostic: no dx products": [
        (SSD_BWD_CU, "mma_f64(acc[w][t], lo.x, hi.x, lo.y, hi.y, b0[t], b1[t]);",
         "acc[w][t][0] += lo.x * b0[t] + hi.y * b1[t];")],
}
KERNEL_NAME = {"flash_attention": "flash_fwd_hopperILi80",
               "cgra_sweep": "sweep_kernelILi16",
               "ssd_intra_chunk": "ssd_kernelILi2ELb1E",
               "flash_attention_bwd": "flash_bwd_dkdv_hopperILi80",
               "ssd_intra_chunk_bwd": "ssd_bwd_kernelILi2ELb1E"}


def start_build(name: str, lib: str, edits):
    """Copy the kernel sources, apply ``edits`` ((file, old, new): ``old``
    a string, or a pair of strings that bound the region replaced), start
    nvcc."""
    d = OUT / name.replace(" ", "_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(KERNELS, d, ignore=shutil.ignore_patterns(
        "*.py", "__pycache__"))
    for rel, old, new in edits:
        p = d / rel
        text = p.read_text()
        if isinstance(old, tuple):    # the region from old[0] up to old[1]
            i = text.find(old[0])
            j = text.find(old[1], i) if i >= 0 else -1
            old = text[i:j] if j >= 0 else old[0]
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


def ssd(libs, committed) -> None:
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref
    spec = importlib.util.spec_from_file_location(
        "stress_lm_kernels", ROOT / "scripts" / "stress_lm_kernels.py")
    stress = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stress)
    dev = torch.device("cuda")
    cases = {}
    for G in (32, 5):
        gen = torch.Generator(device=dev).manual_seed(G)
        args = stress.ssd_inputs(gen, dev, G, 64, 80, 64, 64)
        want, err = stress.ssd_error_bound(*args)
        cases[G] = (args, intra_chunk_ref(*(t.cpu() for t in args)), want,
                    err)
    for name in ["committed", *libs, "committed"]:
        _build._loaded["ssd_intra_chunk"] = libs.get(name, committed)
        line = []
        for G, (args, host, want, err) in cases.items():
            y = ssd_intra_chunk(*args)
            off = int((~torch.isclose(y.cpu(), host, rtol=2e-5,
                                      atol=2e-5)).sum())
            e = float((y.cpu() - host).abs().max())
            ev = cuda_ms(lambda: ssd_intra_chunk(*args), reps=20)
            ms = device_ms(lambda: ssd_intra_chunk(*args))
            line.append(f"G={G} {ms:.4f} ms device, {ev:.4f} ms events "
                        f"back to back, max abs err {e:.3g} "
                        f"({off} elements off by more than 2e-5), worst "
                        f"error {stress.ratio(y, want, err):.3g} of the "
                        f"bound")
        print(f"[ssd] {name}: " + "; ".join(line))


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


def flash_bwd(libs, committed) -> None:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(2, 4096, 32, 80, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    _, lse, out32 = ops._launch(q, k, v, True, None, lse=True)
    want = [w.float() for w in attention_bwd_ref(q, k, v, do)]

    def run():
        return ops._launch_bwd(q, k, v, do, lse, True, None, out32=out32)
    for name in ["committed", *libs, "committed"]:
        _build._loaded["flash_attention_bwd"] = libs.get(name, committed)
        try:
            got = [g.float() for g in run()]
        except RuntimeError as e:       # a launch the library refused
            print(f"[flash_bwd] {name}: {e}")
            continue
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        off = sum(int((~torch.isclose(g, w, rtol=2.0 ** -6, atol=1e-5))
                      .sum()) for g, w in zip(got, want))
        ms = cuda_ms(run, reps=10)
        print(f"[flash_bwd] {name}: {ms:.4f} ms, route "
              f"{ops.last_bwd_route()}, max abs err {err:.3g}, {off} "
              f"elements off by more than two bf16 steps")


def ssd_bwd(libs, committed) -> None:
    from repro_torch.kernels.mamba2_scan import ops
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref
    spec = importlib.util.spec_from_file_location(
        "stress_lm_kernels", ROOT / "scripts" / "stress_lm_kernels.py")
    stress = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stress)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(128)
    args = stress.ssd_inputs(gen, dev, 128, 64, 80, 64, 64)
    dy = torch.randn(128, 64, 80, 64, device=dev, generator=gen)
    want = intra_chunk_bwd_ref(*(t.double() for t in (*args, dy)))

    def run():
        return ops._launch_bwd(*args, dy)
    for name in ["committed", *libs, "committed"]:
        _build._loaded["ssd_intra_chunk_bwd"] = libs.get(name, committed)
        try:
            got = run()
        except RuntimeError as e:       # a launch the library refused
            print(f"[ssd_bwd] {name}: {e}")
            continue
        err = max(float((g.double() - w).abs().max())
                  for g, w in zip(got, want))
        off = sum(int((~torch.isclose(g.double(), w, rtol=1e-4, atol=1e-4))
                      .sum()) for g, w in zip(got, want))
        ms = cuda_ms(run, reps=20)
        print(f"[ssd_bwd] {name}: {ms:.4f} ms, max abs err {err:.3g} "
              f"against the float64 plain backward ({off} elements off by "
              f"more than 1e-4)")


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
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", choices=["flash", "sweep", "ssd",
                                           "flash_bwd", "ssd_bwd"])
    only = parser.parse_args().only
    if not torch.cuda.is_available():
        print("hopper_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.build_all()
    groups = {"flash": ("flash_attention", FLASH, flash),
              "sweep": ("cgra_sweep", SWEEP, sweep),
              "ssd": ("ssd_intra_chunk", SSD, ssd),
              "flash_bwd": ("flash_attention_bwd", FLASH_BWD, flash_bwd),
              "ssd_bwd": ("ssd_intra_chunk_bwd", SSD_BWD, ssd_bwd)}
    if only:
        groups = {only: groups[only]}
    started = {}
    for lib, variants, _ in groups.values():
        print(f"[build] committed {lib}: "
              f"{ptxas_summary(_build.build_log(lib), KERNEL_NAME[lib])}")
        started.update({(lib, n): start_build(n, lib, e)
                        for n, e in variants.items()})
    libs = {lib: {} for lib, _, _ in groups.values()}
    for (lib, name), (so, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[build] {name}: nvcc failed\n{log[-2000:]}")
            return 1
        print(f"[build] {name}: {ptxas_summary(log, KERNEL_NAME[lib])}")
        libs[lib][name] = ctypes.CDLL(str(so))
    for lib, _, run in groups.values():
        run(libs[lib], _build.library(lib))
    return 0


if __name__ == "__main__":
    sys.exit(main())

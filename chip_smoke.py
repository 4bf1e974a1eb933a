#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the CGRA estimator's
DSE sweep, zamba2-2.7b serving and training, serving the decoder-only
transformer families (dense, MoE, VLM), the encoder-decoder whisper-small
and the xLSTM xlstm-350m, training all of them, and llama3.2-1b's trunk
pipelined over a stage mesh.

    python3 chip_smoke.py            # from the repository root

Needs one CUDA device and nvcc; builds the kernels from the sources in
src/repro_torch on first use.  Every phase fails loudly (non-zero exit):

1. device: the card's name and power limit, then the build of all
   kernel libraries, one nvcc each, in parallel; a [build] line per
   redesigned kernel (the sweep kernel, the tensor-core flash kernel and
   its two backward kernels at hd 80, the SSD kernel and its backward at
   P = N = 64) with registers, shared memory and spills from ptxas,
   whether ptxas serialized any wgmma, and whether the flash libraries'
   SASS holds HGMMA (cuobjdump);
2. the alu_dispatch kernel against its plain version on (1048576, 16)
   seeded int32 planes, bit for bit, timed there and at the main path's
   shape (one step of 16 PEs): the host's time per call, and the device
   time per launch with the launches queued behind a sleep;
3. the cgra_sweep kernel against its plain version on the card: 5
   MiBench kernels x 5 topologies x their 5 images, and Im2col-OP x 5
   topologies; integer state bit for bit, energy at rtol=1e-5;
4. the sweep's main path at a size users run: the characterization
   profile computed on the card, then dse.sweep over 4 conv mappings x
   40 hardware configs x 256 seeded layers (40,960 design points),
   counted kernel launches, results checked against the conv oracle
   through the simulator and, for every lane, against the plain engine
   on the card;
4b. the paper's analysis surface on the phase-4 campaign, with counted
   kernel launches: sweep(reduce=) with TopK("edp", 8), a
   (latency, energy) and a (latency, power) Pareto front, with and
   without observed_steps, bit for bit against reduce_oracle over phase
   4's lanes, none clipped, with each front's distinct points;
   search_mappings (k=8, keep=2, 2 rounds) over 2 DAGs x the 40 configs
   x 64 seeded images (40,960 design points a round), its winners held
   to DAG.evaluate on the card, its front to fold_segments of the
   unfolded sweep and to reduce_oracle over the last round's lanes run
   by the plain engine (held to the kernel as in phase 3); the estimator, cases (i)-(vi), on the 5 MiBench
   kernels traced on the card (against the same kernels traced on the
   host) and the 4 conv traces of phase 4 (case (vi) against their sweep
   lanes), with the paper's Fig. 2 error table;
4c. the crash-safe sweep service on the phase-4 campaign, with counted
   kernel launches, every answer bit for bit phase 4's lanes (or
   reduce_oracle over them): a ResumableSweepRunner of 10 units of 4096
   lanes stopped after 4 and resumed by a second runner; a TopK("edp",
   8) runner; a persistent fault on the stage "cuda" raising
   SweepUnitError; `python -m repro_torch.service` killed by SIGKILL at
   unit 2 and resumed (2 units resumed, its .npz equal to an
   uninterrupted run's); a SweepTransport over a SweepService (2 slots,
   units of 2,560 lanes) answering 4 requests (one conv mapping x the 40
   configs x the first 64 layers, one of them TopK("edp", 8)) through
   SweepClient, a replayed key, a drain once the first campaign is
   complete and a new transport on the same port and checkpoint root,
   then each request alone, and again on a third transport, where every
   unit resumes; tune_sweep over the campaign (27 candidates, each
   one's ms) into a temporary cache, then an AUTO sweep from the cache;
4d. the sweep split across devices on the phase-4 campaign, with
   kernel launches counted by device and by shard, every answer bit for
   bit phase 4's lanes (or reduce_oracle over them): dse.sweep on
   make_debug_mesh() (every visible card), on 4 shards of cuda:0
   (unreduced, TopK("edp", 8), a (latency, energy) front of up to H*D
   points) and on 3
   (unreduced and TopK: 2 pad lanes), each mesh's wall beside the
   unsharded sweep's in turns, the device time of one unsharded and one
   4-shard sweep; a ResumableSweepRunner on the 4-shard mesh, 10 units
   of 4096 lanes, losing 2 of its 4 nodes after unit 1 and re-planning
   to 2 shards; one of its unit checkpoints restored onto cuda:0 by
   restore_resharded;
5. the flash-attention kernel against its plain version on the card at
   the serving path's prefill shape (B=1, S=2048, H=32, hd=80, bf16,
   causal) and at f32 hd 16 and 128, a ragged S=1000, causal=False,
   window=512 and GQA 32/8 (2e-5 in f32, 2e-2 in bf16, TF32 off; bf16
   also within two bf16 steps of each element), timed beside its
   plain version and scaled_dot_product_attention: the bf16 route (the
   tensor-core kernel) and the f32 route (the FMA kernel) at the main
   shape; every case prints the route that ran; then the transformer
   families' bf16 causal prefill shapes on the tensor-core route (held
   as above, timed beside scaled_dot_product_attention and the bound of
   their live pairs at 989 TFLOP/s): llama3.2-1b (1, 2048, 32, 64) kv 8,
   qwen2-vl-7b (1, 2048, 28, 128) kv 4, starcoder2-15b (1, 4608, 48,
   128) kv 4 with its 4,096-token window; and whisper-small's, 12 heads
   of 64, kv 12: the encoder (1, 1500) non-causal, cross-attention of
   224 and of 4 queries against 1,500 keys, the decoder's causal 224;
6. the intra-chunk SSD kernel against its plain version at
   (G, L=64, H=80, P=64, N=64) f32 for G = 32, 14 and 5 (a 2048-token
   prompt, the serving run's mean, its smallest), rtol = atol = 2e-5,
   each timed (device time) beside its bound, with the route it took;
7. the serving main path: zamba2-2.7b at full width (54 layers,
   d_model 2560, seeded weights on the card), a Server with 4 slots and
   context 4096 answering 8 requests of seeded prompt lengths in
   256-2048 with 32 greedy tokens each; counted kernel launches
   (9 x 8 = 72 flash, 54 x 8 = 432 SSD), prefill tokens/s, decode ms per
   step and tokens/s, peak device memory;
8. the card's path against the plain path on the host: full width cut
   to 6 layers (one group), f32, the same weights on both; prompts of
   256 and 200 tokens spliced into two slots, then 8 teacher-forced
   decode steps; logits at every step at rtol = atol = 1e-3;
9. training zamba2-2.7b: (a) both backward kernels against their plain
   backward on the card, gradient for gradient (flash at the training
   shape B=2, S=4096, H=32, hd=80 bf16 causal within 2e-2 and two bf16
   steps; f32 hd 16 and 128, ragged S=1000, causal=False, window=512 and
   GQA 32/8 at 1e-4, TF32 off; SSD at (128, 64, 80, 64, 64) and the
   card tests' ragged shapes at 1e-4; every case's route: bf16 with hd
   a multiple of 8 on the tensor cores, f32 on the FMA kernels), timed
   beside their bounds, scaled_dot_product_attention's backward and the
   FMA kernels on f32 copies of the main shape; (b) the main path:
   launch.train.main at full width and depth (54 layers, d_model 2560,
   seeded weights, bf16 activations, f32 parameters and moments,
   remat "full"), 4 AdamW steps of 2 x 4096 tokens: finite loss, nll
   and grad_norm, every parameter changed, ms a step, tokens/s, peak
   memory, and counted launches a step (flash forward 9 x 2, its
   backward 9 x 2 kernels, SSD forward 54 x 2, its backward 54 x 1);
   (c) 2 steps of full width cut to 6 layers, f32, card against host
   with the same weights: loss, grad_norm, every parameter at 1e-3;
   (d) the smoke trainer killed at step 4 (exit 42) and resumed on the
   card: steps 5-8 equal an uninterrupted run at 1e-5;
10. the transformer families' main path: llama3.2-1b at full width and
   depth (16 layers, d_model 2048, 32 heads of 64, kv 8, vocab 128,256,
   tied embeddings; seeded weights, bf16 activations), a Server with 4
   slots and context 4096 answering 8 requests of seeded prompt lengths
   in 256-2048 with 32 greedy tokens; exact launch counts (16 x 8 = 128
   flash, 0 SSD), finite logits, prefill tokens/s, decode ms per step
   and tokens/s, peak memory;
10b. the other six configs at full width, each a Server with 2 slots
   answering 2 requests of 16 greedy tokens: granite-moe-1b-a400m,
   olmo-1b and smollm-360m on 512-token prompts, qwen2-vl-7b on 512
   with 256 seeded patch embeds a request through admit(extras=),
   starcoder2-15b (40 layers) and mixtral-8x22b (2 of its 56 layers: 524
   GiB of f32 weights at full depth) on 4,608-token prompts past their
   4,096-token window, context 8192; the same checks and numbers each;
10c. card against host as phase 8: llama3.2-1b, granite-moe-1b-a400m
   and qwen2-vl-7b (with patch embeds) at full width cut to 2 layers,
   f32, prompts of 256 and 200 tokens, 8 teacher-forced decode steps, at
   1e-3, the MoE's chosen experts compared first (a mismatch names the
   layer, the token and the probability gap); then all seven smoke
   configs at 1e-4;
11. the last two families' main path: whisper-small at full width and
   depth (12 encoder + 12 decoder layers, d_model 768, 12 heads of 64,
   vocab 51,865, tied embeddings; seeded weights, bf16 activations), a
   Server with 4 slots and context 448 answering 8 requests, each 1,500
   seeded frames through admit(extras=) and a seeded prompt of 4-224
   tokens, 32 greedy tokens; exact launch counts (36 x 8 = 288 flash: 12
   encoder, 12 decoder self- and 12 cross-attention a request; 0 SSD),
   finite logits, the encoder's frames/s, the decoder's prompt tokens/s,
   decode ms per step and tokens/s, peak memory, kernels a decode step;
11b. xlstm-350m at full width and depth (24 layers, d_model 1024, 4
   heads of 256, vocab 50,304), a Server with 2 slots answering 2
   requests of 512 seeded tokens with 16 greedy tokens; the same numbers,
   no flash or SSD launch, and the device kernels of a decode step;
11c. card against host as phase 8: whisper-small (2 + 2 layers, with
   seeded frames) and xlstm-350m (2 layers) at full width, f32, prompts
   of 200 and 64 tokens, 8 teacher-forced decode steps, at 1e-3; then
   both smoke configs at 1e-4;
13. training every non-hybrid family, this slice's main path:
   launch.train.main on llama3.2-1b at full width and depth (16 layers,
   d_model 2048, 32 heads of 64, kv 8, vocab 128,256, tied; seeded
   weights, bf16 activations, f32 parameters and moments, remat "dots"),
   4 AdamW steps of 2 x 4096 tokens: finite loss, nll and grad_norm,
   every parameter changed, exact launches a step (flash 16 x 2: the
   forward and the "dots" recomputation; its backward 16 x 2 kernels;
   SSD 0), ms a step (median of steps 2-4), tokens/s, peak memory;
   phase 9a holds the families' bf16 backward shapes on the tensor
   cores (llama's (2, 4096, 32, 64) kv 8 timed beside SDPA's backward
   and its bound, with its training forward); phase 1 prints ptxas's
   report for both backward kernels at hd 64, 80 and 128;
13b. 2 steps each, the same checks and numbers: whisper-small (2 x 448
   tokens, 1,500 seeded frames each; 36 x 2 flash and 36 x 2 backward
   launches a step), granite-moe-1b-a400m (1 x 2,048), olmo-1b and
   smollm-360m (2 x 2,048) at full width and depth; qwen2-vl-7b (seeded
   patch embeds, M-RoPE positions), starcoder2-15b and mixtral-8x22b at
   full width cut to the depth whose 16 bytes a parameter fit
   TRAIN_STATE_GIB (1 x 2,048; the cut is printed); xlstm-350m cut to 2
   layers on 1 x 128 tokens (its per-token loop is host-bound);
13c. card against host, as phase 9c: llama3.2-1b, granite-moe-1b-a400m,
   qwen2-vl-7b, whisper-small (2 + 2 layers) and xlstm-350m at full
   width cut to 2 layers, f32, TF32 off, the same weights; 2 AdamW steps
   of 64 tokens, the MoE's chosen experts compared first (every router
   call, forward and recomputation), then loss, grad_norm and every
   parameter at 1e-3; "dots" against "none" on llama's cut on the card
   at 1e-5; 2 steps of each of the nine smoke configs at 1e-4;
13d. llama3.2-1b's smoke trainer killed at step 4 (exit 42) and resumed
   on the card: steps 5-8 equal an uninterrupted run at 1e-5;
14. the LM's multi-device pieces, this slice's main path: llama3.2-1b's
   16 decoder layers at full width (seeded weights, bf16 activations)
   split into 4 stages of 4 on a "stage" mesh (the first 4 cards, or
   cuda:0 repeated 4 times on a machine with fewer), 8 microbatches of
   (1, 2048) tokens' embeddings through parallel.pipeline_apply (a
   stream a stage) against the same trunk run microbatch by microbatch
   (bit for bit, else within the bf16 tolerance 2e-2, said so); exactly
   128 flash launches on the tensor cores, the pipelined and sequential
   walls after a warm-up, the GPipe bubble (S-1)/(M+S-1) = 3/11, peak
   memory; the flash kernel held to its plain version at that shape and
   timed beside it, scaled_dot_product_attention and its bound; then
   train.compression.compressed_psum over the mesh's 4 shards, a seeded
   f32 tensor a shard in each of llama3.2-1b's 146 gradient shapes (1.24
   G elements a shard), equal bit for bit to the same run on the host,
   with the bytes on the wire against an f32 all-reduce's;
15. one {"kernels": [...]} line with times, bounds and launch counts
   (flash: this slice's main path, phase 14, at its shape; its
   backward: phase 13 at its shape; SSD: phase 7; SSD backward: phase
   9b);
16. the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA H100 data
# sheet): HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (an FMA counted as 2).  The int32 rate is not in the data
# sheet: an SM has 64 INT32 lanes beside its 128 FP32 lanes, so at the
# same 1.98 GHz the int32 peak is 67e12 / 4 operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = 67e12 / 4
# dense bf16 tensor-core rate (NVIDIA H100 data sheet)
BF16_OPS_PER_S = 989e12

# Operations one PE does per executed instruction, counted from the plain
# version's arithmetic (kernels/cgra_sweep/ref.py): int32 -- operand
# select 2, address 4, store dedup 8 (half the PEs compared), ALU 2,
# writeback 2, contention 6, latency 2, control 5; float32 -- the energy
# term's 13 multiplies and adds plus its share of the sum over PEs.
SWEEP_I32_OPS_PER_PE_STEP = 31
SWEEP_F32_OPS_PER_PE_STEP = 14
# One ALU element: the 11 candidate ops and 11 selects of the branchless
# reference form.
ALU_I32_OPS_PER_ELEMENT = 22

MAIN_MAX_STEPS = 13000
# the analysis phase: the largest Pareto front it may keep (a clipped
# front fails the phase), and the mapping search's grid
PARETO_POINTS = 256
SEARCH_IMAGES, SEARCH_MAX_STEPS = 64, 256
# the service phase: runner units of 4096 lanes (10 for the campaign);
# HTTP requests of one mapping x the 40 configs x the first 64 layers
SERVICE_UNIT, SERVICE_LAYERS = 4096, 64

ARCH = "zamba2-2.7b"
SERVE_SLOTS, SERVE_CONTEXT, SERVE_REQUESTS, SERVE_GEN = 4, 4096, 8, 32
FLASH_TILE = 64            # q and k tile of csrc/flash_attention.cu


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``reps``)."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one ``fn()`` in ms: the launches queue behind a
    sleep on the stream, so the host runs ahead and its time per call
    does not show."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t) / 3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e9 * (1.5 * host_s * reps + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 200) -> float:
    """The host's time per ``fn()`` in ms, the device left to finish."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def _profiled_kernels(fn) -> list:
    """torch.profiler's rows of the device kernels of one ``fn()`` (after
    one call that warms it up).  The program's own ranges (``repro_torch.``
    spans) also show on the card's timeline; they are not kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.spans import PREFIX

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if _device_us(e) > 0
            and "cuda" in str(e.device_type).lower()
            and not e.key.startswith(PREFIX)]


def kernel_launches(fn) -> int:
    """The device kernels one ``fn()`` launches (torch.profiler); fails
    where the profiler sees none."""
    n = sum(e.count for e in _profiled_kernels(fn))
    check(n > 0, "the profiler recorded no device kernel")
    return n


def profile_kernels(fn, top: int = 6) -> str:
    """The ``top`` kernels of one ``fn()`` by device time (torch.profiler),
    as "name ms xcount" items."""
    rows = _profiled_kernels(fn)
    if not rows:
        return "the profiler recorded no device time"
    rows.sort(key=lambda e: -_device_us(e))
    total = sum(_device_us(e) for e in rows) / 1e3
    return f"{total:.4f} ms in {sum(e.count for e in rows)} kernels; " + \
        "; ".join(f"{e.key[:70]} {_device_us(e) / 1e3:.4f} ms x{e.count}"
                  for e in rows[:top])


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least ms the card could take, what sets it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(log: str, kernel: str) -> str:
    """ptxas -v's registers, shared memory and spills of the first kernel
    whose mangled name contains ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rest = []
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "stack frame" in nxt or "Used" in nxt:
                    rest.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(rest)
    return "not in the build log (library built earlier)"


def build_report(_build) -> None:
    """Phase 1's [build] lines for the five redesigned kernels."""
    import shutil
    from repro_torch.kernels.flash_attention.ops import hopper_shared_memory
    from repro_torch.kernels.mamba2_scan.ops import shared_memory
    sweep = ptxas_report(_build.build_log("cgra_sweep"), "sweep_kernelILi16")
    flash = ptxas_report(_build.build_log("flash_attention"),
                         "flash_fwd_hopperILi80")
    ssd = ptxas_report(_build.build_log("ssd_intra_chunk"),
                       "ssd_kernelILi2ELb1E")
    print(f"[build] cgra_sweep sweep_kernel<16>: {sweep}; no shared memory")
    print(f"[build] flash_attention flash_fwd_hopper<80>: {flash}; dynamic "
          f"shared memory {hopper_shared_memory(80)} bytes a block")
    print(f"[build] ssd_intra_chunk ssd_kernel<2, TMA>: {ssd};"
          f" dynamic shared memory {shared_memory(64, 64)} bytes a block")
    bwd_log = _build.build_log("flash_attention_bwd")
    # hd 80 (zamba2), 64 (llama, whisper) and 128 (qwen2-vl, olmo,
    # starcoder2, mixtral): the widths the families train at
    for hd in (80, 64, 128):
        for kernel in ("flash_bwd_dq_hopper", "flash_bwd_dkdv_hopper"):
            print(f"[build] flash_attention_bwd {kernel}<{hd}>: "
                  f"{ptxas_report(bwd_log, f'{kernel}ILi{hd}E')}")
    print(f"[build] ssd_intra_chunk_bwd ssd_bwd_kernel<2, TMA>: "
          f"{ptxas_report(_build.build_log('ssd_intra_chunk_bwd'), 'ssd_bwd_kernelILi2ELb1E')}")
    for name in ("flash_attention", "flash_attention_bwd"):
        slow = [ln for ln in _build.build_log(name).splitlines()
                if "Potential Performance Loss" in ln]
        print(f"[build] {name}: {len(slow)} ptxas warnings of serialized "
              f"wgmma" + "".join(f"\n[build]   {ln.strip()}"
                                 for ln in slow[:4]))
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent
                                            / "cuobjdump")
    for name in ("flash_attention", "flash_attention_bwd"):
        lib = _build.library(name)._name
        try:
            sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                                  text=True, check=True).stdout
            print(f"[build] {name} SASS: {sass.count('HGMMA')} HGMMA "
                  f"instructions, {sass.count('UTMALDG')} UTMALDG (TMA "
                  f"loads)")
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"[build] {name} SASS: cuobjdump unavailable ({e})")


def axpy_shift(DAG, n_lanes, shift):
    """y[j] = (a[j] * w + b[j]) >> shift (examples/map_search.py)."""
    d = DAG()
    w = d.load(16)
    for j in range(n_lanes):
        m = d.alu("SMUL", d.load(j), w)
        s = d.alu("SADD", m, d.load(32 + j))
        d.store(64 + j, d.alu("SRA", s, d.const(shift)))
    return d


def sad_tree(DAG, n):
    """sum |a[j] - b[j]| via SLT-based abs and an add tree
    (examples/map_search.py)."""
    d = DAG()
    terms = []
    for j in range(n):
        a, b = d.load(j), d.load(32 + j)
        diff = d.alu("SSUB", a, b)
        neg = d.alu("SSUB", d.const(0), diff)
        is_neg = d.alu("SLT", diff, d.const(0))
        keep = d.alu("SMUL", diff, d.alu("LXOR", is_neg, d.const(1)))
        flip = d.alu("SMUL", neg, is_neg)
        terms.append(d.alu("SADD", keep, flip))
    while len(terms) > 1:
        terms = [d.alu("SADD", terms[i], terms[i + 1])
                 for i in range(0, len(terms) - 1, 2)] + \
                (terms[-1:] if len(terms) % 2 else [])
    d.store(100, terms[0])
    return d


def analysis_phase(dev, prof, progs, hws, hw_names, images, res,
                   sweep_wall, conv_traces, compare_lanes) -> dict:
    """Phase 4b: reduction, mapping search and the estimator on the
    phase-4 campaign; returns the launch counts of the phase.

    compare_lanes(programs, images, max_steps, what): phase 3's check of
    the sweep kernel against its plain version on the grid of those
    programs x the phase's configs x those images; returns the plain
    version's lane state last.  Its launches do not count."""
    import numpy as np
    import torch
    from repro_torch.analysis.pareto import (REDUCED_FIELDS, ParetoFront,
                                             TopK, fold_segments,
                                             make_device_reducer,
                                             reduce_oracle, reduced_nbytes)
    from repro_torch.apps import mibench
    from repro_torch.core import detailed, dse, estimator, hwconfig
    from repro_torch.core.cgra import run_program
    from repro_torch.core.mapper import DAG
    from repro_torch.kernels.cgra_step.ops import alu_dispatch
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine

    def same_bits(got, want, what):
        for f in REDUCED_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            check(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                  f"{what}: field {f} differs")

    G, H, D = len(progs), len(hws), images.shape[0]
    B = G * H * D
    alu_dispatch.launches = 0
    sweep_engine.launches = 0

    def distinct_points(spec, red):
        """Distinct (axis 0, axis 1) pairs of each program's front."""
        a0, a1 = (getattr(red, f) for f in spec.axes)
        return [len(set(zip(a0[g, :n].tolist(), a1[g, :n].tolist())))
                for g, n in enumerate(red.count.tolist())]

    # ---- reduction on the device, against the oracle over phase 4 ----
    fields = [x.cpu().numpy() for x in res]
    full_bytes = sum(x.numel() * x.element_size() for x in res)
    prog_idx = np.repeat(np.arange(G), H * D)
    observed = [int(x) for x in res.steps_executed.view(G, -1).max(1).values]
    print(f"[reduce] observed steps per program (phase 4): {observed}")
    # latency here depends on the config alone, and the config best on
    # latency is best on energy, so each (latency, energy) front is one
    # point held by every layer (ties kept by the flat-index rule); the
    # (latency, power) front trades the two across configs.  H * D, a
    # program's every lane, is the most it can hold
    specs = (TopK("edp", 8),
             ParetoFront(("latency_cc", "energy_pj"), PARETO_POINTS),
             ParetoFront(("latency_cc", "power_mw"), H * D))
    wants = {}
    for spec in specs:
        t = time.perf_counter()
        wants[spec] = reduce_oracle(spec, fields, prog_idx, np.arange(B), G)
        print(f"[reduce] reduce_oracle({spec}) over phase 4's {B} lanes on "
              f"the host: {time.perf_counter() - t:.3f} s")

    def timed_sweep(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dse.sweep(programs=progs, profile=prof, hw_configs=hws,
                        mem_images=images, max_steps=MAIN_MAX_STEPS,
                        device=dev, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # two rounds, the unreduced sweep first in each, so each wall has a
    # neighbour of its own kind in the same call
    walls = {"unreduced": []}
    for _ in range(2):
        walls["unreduced"].append(timed_sweep()[1])
        for spec in specs:
            for obs in (None, observed):
                got, wall = timed_sweep(reduce=spec, observed_steps=obs)
                what = (f"sweep(reduce={spec}, observed_steps="
                        f"{'observed' if obs else None})")
                same_bits(got, wants[spec], what)
                check(int(got.clipped.sum()) == 0,
                      f"{what}: {got.clipped.tolist()} front points "
                      f"clipped; raise PARETO_POINTS")
                walls.setdefault(what, []).append(wall)
                last = got
            distinct = (f", distinct points {distinct_points(spec, last)}"
                        if isinstance(spec, ParetoFront) else "")
            print(f"[reduce] {spec}: bit-identical to reduce_oracle with "
                  f"static and observed bucketing; candidates per program "
                  f"{last.count.tolist()}{distinct}, clipped "
                  f"{last.clipped.tolist()}; {reduced_nbytes(G, spec)} bytes "
                  f"shipped against {full_bytes} for the five (B,) fields")
    for what, ws in walls.items():
        print(f"[reduce] wall {what}: {[round(w, 4) for w in ws]} s "
              f"(phase 4's unreduced {sweep_wall:.4f} s)")
    gi = torch.as_tensor(prog_idx, dtype=torch.int32, device=dev)
    lane = torch.arange(B, dtype=torch.int32, device=dev)
    for spec in specs:
        red = make_device_reducer(spec, G)
        ms = cuda_ms(lambda: red(tuple(res), gi, lane), reps=20)
        dev_ms = device_ms(lambda: red(tuple(res), gi, lane), reps=20)
        print(f"[reduce] make_device_reducer({spec}) alone on phase 4's "
              f"{B} lanes: {ms:.4f} ms a call back to back (events), "
              f"{dev_ms:.4f} ms device time")
        print(f"[reduce]   device time by kernel, one call: "
              f"{profile_kernels(lambda: red(tuple(res), gi, lane))}")

    # ---- mapping search over the 40 configs x 64 seeded images -------
    dags = [axpy_shift(DAG, 6, 2), sad_tree(DAG, 4)]
    mems = np.random.default_rng(0).integers(
        -100, 100, (SEARCH_IMAGES, images.shape[1])).astype(np.int32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sr = dse.search_mappings(dags, prof, hws, mems, k=8, keep=2, rounds=2,
                             seed=0, objective="edp",
                             names=["axpy_shift", "sad_tree"],
                             max_steps=SEARCH_MAX_STEPS, device=dev)
    search_s = time.perf_counter() - t
    for row in sr.history:
        n = sum(row["n_candidates"]) * H * SEARCH_IMAGES
        check(row["n_candidates"] == [8, 8],
              f"search round {row['round']}: {row['n_candidates']} "
              f"candidates, expected 8 per kernel")
        print(f"[search] round {row['round']}: {row['n_candidates']} "
              f"candidates x {H} configs x {SEARCH_IMAGES} images = {n} "
              f"design points; best EDP {row['best']}, worst "
              f"{row['worst']}")
    for g, dag in enumerate(dags):
        prog = sr.best[g]
        final, _ = run_program(prog, mems[0], max_steps=prog.n_instrs + 2,
                               device=dev)
        check(np.array_equal(final.mem.cpu().numpy(), dag.evaluate(mems[0])),
              f"search winner {prog.name} differs from DAG.evaluate")
    spec = TopK("edp", 2)
    unfolded = dse.sweep(mappings=sr.mappings, profile=prof, hw_configs=hws,
                         mem_images=mems, max_steps=SEARCH_MAX_STEPS,
                         reduce=spec, fold_mappings=False, device=dev)
    same_bits(fold_segments(spec, unfolded, sr.mappings.kernel_of,
                            sr.mappings.n_kernels), sr.front,
              "search front against fold_segments of the unfolded sweep")
    # the last round's candidate lanes through the sweep kernel and its
    # plain version, and the front against the oracle over the plain
    # version's lanes, segmented by kernel
    n_sweep = sweep_engine.launches
    r = compare_lanes(list(sr.mappings.programs), mems, SEARCH_MAX_STEPS,
                      "search candidates")
    sweep_engine.launches = n_sweep
    plain = [x.cpu().numpy() for x in dse.lane_results(r[-1], prof)]
    n_lanes = plain[0].shape[0]
    kernel_seg = np.repeat(np.asarray(sr.mappings.kernel_of),
                           n_lanes // len(sr.mappings.kernel_of))
    same_bits(sr.front, reduce_oracle(spec, plain, kernel_seg,
                                      np.arange(n_lanes),
                                      sr.mappings.n_kernels),
              "search front against reduce_oracle over the plain engine")
    print(f"[search] the last round's {n_lanes} candidate lanes: kernel == "
          f"plain, energy max rel err {r[1]:.3g} (kernel {r[2]:.3f} ms, plain"
          f" {r[3]:.3f} ms); the front equals reduce_oracle over the plain "
          f"version's lanes")
    held = dse.make_bucketed_sweep_fn(
        list(sr.mappings.programs), prof, hws, mems,
        max_steps=SEARCH_MAX_STEPS, reduce=TopK("edp", 1), device=dev)
    held()
    torch.cuda.synchronize()
    t = time.perf_counter()
    held()
    round_sweep_s = time.perf_counter() - t
    print(f"[search] winners {[p.name for p in sr.best]} reproduce "
          f"DAG.evaluate on the card; the front equals fold_segments of the "
          f"unfolded sweep; best EDP {sr.best_score.tolist()}; search wall "
          f"{search_s:.3f} s for {len(sr.history)} rounds "
          f"({search_s / len(sr.history):.3f} s a round, candidate "
          f"generation and verification included); one round's held sweep "
          f"{round_sweep_s:.3f} s")

    # ---- the estimator, cases (i)-(vi): paper Fig. 2 ------------------
    hw = hwconfig.baseline()
    errs = {c: [] for c in estimator.CASES}
    rows = []
    for k in mibench.all_kernels():
        torch.cuda.synchronize()
        t = time.perf_counter()
        final, trace = k.run(hw, device=dev)
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t
        check(k.check(final.mem.cpu().numpy()), f"{k.name}: wrong output")
        t = time.perf_counter()
        ests = estimator.estimate_all_cases(k.program, trace, prof, hw)
        est_s = time.perf_counter() - t
        host = estimator.estimate_all_cases(
            k.program, k.run(hw, device="cpu")[1], prof, hw)
        for c in estimator.CASES:
            e, w = ests[c], host[c]
            check(e.latency_cc == w.latency_cc
                  and np.allclose(e.energy_pj, w.energy_pj, rtol=1e-5,
                                  atol=0)
                  and np.allclose(e.power_mw, w.power_mw, rtol=1e-5, atol=0),
                  f"{k.name} case {c}: the card's trace and the host's "
                  f"give different estimates")
        rows.append((k.name, k.program, trace, ests, trace_s, est_s))
    lane_of = {}
    h_base = hw_names.index("baseline/smul3/banks4")
    for g, (case, trace) in enumerate(conv_traces):
        t = time.perf_counter()
        ests = estimator.estimate_all_cases(case.program, trace, prof, hw)
        rows.append((case.name, case.program, trace, ests, None,
                     time.perf_counter() - t))
        lane_of[case.name] = (g * H + h_base) * D + 7
    for name, program, trace, ests, trace_s, est_s in rows:
        host = type(trace)(*(x.cpu().numpy() for x in trace))
        rep = detailed.report(program, host, hw.to("cpu"))
        for c in ("iii", "iv", "v", "vi"):
            check(ests[c].latency_cc == rep.latency_cc,
                  f"{name} case {c}: latency {ests[c].latency_cc} != the "
                  f"detailed model's {rep.latency_cc}")
        for c in estimator.CASES:
            errs[c].append(estimator.errors_vs_detailed(ests[c], rep))
        if name in lane_of:
            lane = lane_of[name]
            e_lane = float(res.energy_pj[lane])
            check(int(res.latency_cc[lane]) == ests["vi"].latency_cc
                  and abs(ests["vi"].energy_pj - e_lane)
                  <= 1e-4 * abs(e_lane),
                  f"{name}: case (vi) differs from its sweep lane")
        print(f"[estimator] {name}: {int(trace.valid.sum())} steps"
              + (f", traced on the card in {trace_s:.3f} s" if trace_s
                 else " (phase 4's trace)")
              + f"; estimate_all_cases {est_s:.4f} s on the host; case (vi) "
              f"{ests['vi'].latency_cc} cc, {ests['vi'].energy_pj:.6g} pJ, "
              f"{ests['vi'].power_mw:.6g} mW")
    print("[estimator] cases (iii)-(vi) latency equals the detailed model "
          "on all 9 kernels; MiBench estimates from the card's traces equal "
          "the host's; conv case (vi) equals its sweep lanes")
    print("[estimator] Fig. 2, error against the detailed model over "
          f"{len(rows)} kernels (5 MiBench, 4 conv), baseline hardware:")
    for c in estimator.CASES:
        lat = [e["latency_err"] for e in errs[c]]
        pw = [e["power_err"] for e in errs[c]]
        print(f"[estimator]   case ({c}): latency mean {np.mean(lat):.4f} "
              f"max {np.max(lat):.4f}; power mean {np.mean(pw):.4f} max "
              f"{np.max(pw):.4f}")

    launches = {"alu_dispatch": alu_dispatch.launches,
                "cgra_sweep": sweep_engine.launches}
    print(f"[analysis] launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"the analysis phase never launched the {name} kernel")
    return launches


def _file_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def service_phase(dev, prof, progs, hws, images, res, sweep_wall,
                  work: Path) -> dict:
    """Phase 4c: the crash-safe sweep service on the phase-4 campaign;
    every answer is held to phase 4's lanes bit for bit (or to the
    oracle over them).  Returns the phase's sweep launches and times.

    ``work`` is an empty directory for checkpoints and outputs."""
    import os
    import threading
    import numpy as np
    import torch
    from repro_torch.analysis.pareto import REDUCED_FIELDS, TopK, \
        reduce_oracle
    from repro_torch.core import dse
    from repro_torch.core.autotune import tune_sweep
    from repro_torch.core.characterization import default_profile
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine
    from repro_torch.runtime.faults import (FAULT_PLAN_ENV, FaultInjector,
                                            FaultPlan)
    from repro_torch.service import (ClientRetry, ResumableSweepRunner,
                                     SweepClient, SweepService,
                                     SweepTransport, SweepUnitError)
    from repro_torch.service.transport import sweep_to_wire

    G, H, D = len(progs), len(hws), images.shape[0]
    B = G * H * D
    want = [x.cpu() for x in res]
    fields = [x.numpy() for x in want]

    def equal_lanes(got, what, rows=None):
        for f, w in zip(dse.SweepResult._fields, want):
            g = torch.as_tensor(got[f] if isinstance(got, dict)
                                else getattr(got, f)).cpu()
            w = w if rows is None else w[rows]
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"{what}: {f} differs from phase 4")

    def equal_reduced(got, oracle, what):
        for f in REDUCED_FIELDS:
            g = np.asarray(got[f] if isinstance(got, dict)
                           else getattr(got, f))
            w = getattr(oracle, f)
            check(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                  f"{what}: {f} differs from the oracle")

    sweep_engine.launches = 0
    t_phase = time.perf_counter()

    # ---- the runner, stopped after 4 units and resumed ------------------
    plan = dse.plan_grid(programs=progs, hw_configs=hws, mem_images=images,
                         device=dev)
    kw = dict(plan=plan, profile=prof, max_steps=MAIN_MAX_STEPS,
              unit_size=SERVICE_UNIT)
    ck = work / "runner"
    t = time.perf_counter()
    first = ResumableSweepRunner(ckpt_dir=str(ck), **kw)
    check(first.n_units == 10 and first.stage.name == "cuda",
          f"runner: {first.n_units} units on {first.stage.name}")
    for k in first.pending_units()[:4]:
        first.run_unit(k)
    first.mgr.wait()
    wall_a = time.perf_counter() - t
    t = time.perf_counter()
    second = ResumableSweepRunner(ckpt_dir=str(ck), **kw)
    out, rep = second.run()
    wall_b = time.perf_counter() - t
    check(rep.units_resumed == 4 and rep.units_run == 6,
          f"runner resumed {rep.units_resumed}, ran {rep.units_run}")
    equal_lanes(out, "resumed runner")
    unit_s = [r.seconds for r in first.report.records + rep.records
              if not r.resumed]
    ck_bytes = _file_bytes(ck)
    print(f"[service] runner: 10 units of {SERVICE_UNIT} lanes, 4 run, "
          f"then 4 resumed + 6 run by a second runner: equal to phase 4 "
          f"in all five fields")
    print(f"[service] runner wall {wall_a:.4f} + {wall_b:.4f} s "
          f"(fingerprints included) against phase 4's dse.sweep "
          f"{sweep_wall:.4f} s; units {sum(unit_s):.4f} s in all, "
          f"{min(unit_s):.4f}-{max(unit_s):.4f} s a unit")
    print(f"[service] fingerprint {first.fingerprint_s:.4f} / "
          f"{second.fingerprint_s:.4f} s (hashes "
          f"{plan.images.numel() * 4 / 1e6:.0f} MB of images on the host); "
          f"checkpoints {ck_bytes} bytes, {ck_bytes / 10:.0f} a unit")

    spec = TopK("edp", 8)
    prog_idx = np.repeat(np.arange(G), H * D)
    oracle = reduce_oracle(spec, fields, prog_idx, np.arange(B), G)
    red, _ = ResumableSweepRunner(reduce=spec, **kw).run()
    equal_reduced(red, oracle, "TopK runner")
    broken = ResumableSweepRunner(injector=FaultInjector(
        FaultPlan(broken_backends=("cuda",))), **kw)
    try:
        broken.run_unit(0)
        fail("a persistent fault on stage cuda did not raise")
    except SweepUnitError as e:
        check("injected persistent" in str(e), f"wrong error: {e}")
    print("[service] TopK('edp', 8) runner equals reduce_oracle over phase "
          "4's lanes; a persistent fault on stage cuda raises "
          "SweepUnitError")
    del first, second, broken

    # ---- the runner's CLI, killed by SIGKILL and resumed -----------------
    default_profile(device=dev)          # the cache the CLIs read
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop(FAULT_PLAN_ENV, None)
    cli = [sys.executable, "-m", "repro_torch.service",
           "--kernels", "bitcnt,crc32,susan,sha", "--unit-size", "3"]
    ck2 = str(work / "cli")
    t = time.perf_counter()
    killed = subprocess.Popen(
        cli + ["--ckpt-dir", ck2, "--out", str(work / "dead.npz")],
        env=dict(env, **{FAULT_PLAN_ENV: FaultPlan(kill_at_unit=2)
                         .to_json()}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    solo = subprocess.Popen(cli + ["--out", str(work / "solo.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    solo_out = solo.communicate(timeout=300)[0]
    killed_out = killed.communicate(timeout=300)[0]
    check(killed.returncode == -9,
          f"the killed CLI exited {killed.returncode}: {killed_out[-800:]}")
    check(solo.returncode == 0, f"the solo CLI failed: {solo_out[-800:]}")
    resumed = subprocess.run(
        cli + ["--ckpt-dir", ck2, "--out", str(work / "resumed.npz"),
               "--report-out", str(work / "rep.json")],
        env=env, capture_output=True, text=True, timeout=300)
    check(resumed.returncode == 0,
          f"the resumed CLI failed: {resumed.stderr[-800:]}")
    cli_s = time.perf_counter() - t
    cli_rep = json.loads((work / "rep.json").read_text())
    check(cli_rep["units_resumed"] == 2 and cli_rep["units_run"] == 9,
          f"CLI resumed {cli_rep['units_resumed']}, ran "
          f"{cli_rep['units_run']}")
    a, b = np.load(work / "resumed.npz"), np.load(work / "solo.npz")
    check(sorted(a.files) == sorted(dse.SweepResult._fields)
          and all(a[f].tobytes() == b[f].tobytes() for f in a.files),
          "the resumed CLI's .npz differs from the uninterrupted run's")
    print(f"[service] CLI: SIGKILL at unit 2 (exit -9), resumed 2 units and "
          f"ran 9 on the card; its .npz equals an uninterrupted run's "
          f"({cli_s:.2f} s for three processes, two at once); "
          f"{resumed.stdout.strip()}")

    # ---- the service over HTTP -------------------------------------------
    d_req = SERVICE_LAYERS
    reduced_g = G - 1
    rows = [np.asarray([(g * H + h) * D + d for h in range(H)
                        for d in range(d_req)]) for g in range(G)]
    root = str(work / "service")

    def transport(port=0):
        svc = SweepService(prof, device=dev, slots=2,
                           pack_max_lanes=4 * H * d_req,
                           unit_size=H * d_req, max_steps=MAIN_MAX_STEPS,
                           mem_size=images.shape[1], ckpt_root=root)
        tr = SweepTransport(svc, "127.0.0.1", port)
        tr.start()
        return tr

    def answer_ok(g, arrays, what):
        if g == reduced_g:
            equal_reduced(arrays, reduce_oracle(
                spec, [f[rows[g]] for f in fields],
                np.zeros(H * d_req, np.int64), np.arange(H * d_req), 1),
                what)
        else:
            equal_lanes(arrays, what, rows=torch.as_tensor(rows[g]))

    def client(tr, seed):
        return SweepClient(tr.host, tr.port, seed=seed, timeout_s=120.0,
                           retry=ClientRetry(max_attempts=60,
                                             max_resubmits=8,
                                             max_backoff_s=0.5))

    def request(g):
        return ([progs[g]], hws, images[:d_req],
                spec if g == reduced_g else None)

    t1 = transport()
    body = {"v": 1, "idempotency_key": "smoke-0",
            "sweep": sweep_to_wire(*request(0)[:3])}
    s1, o1 = client(t1, 0)._request("POST", "/v1/sweeps", body)
    s2, o2 = client(t1, 0)._request("POST", "/v1/sweeps", body)
    check((s1, o1.get("created"), s2, o2.get("created")) ==
          (201, True, 200, False) and o1["campaign"] == o2["campaign"],
          f"a replayed key did not replay its campaign: {o1} {o2}")
    results, walls, errors = {}, {}, []

    def drive(g, tr):
        t0 = time.perf_counter()
        try:
            progs_g, hws_g, imgs_g, red_g = request(g)
            results[g] = client(tr, g).sweep(
                progs_g, hws_g, imgs_g, reduce=red_g,
                idempotency_key=f"smoke-{g}")
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(f"request {g}: {e!r}")
        walls[g] = time.perf_counter() - t0

    t = time.perf_counter()
    threads = [threading.Thread(target=drive, args=(g, t1))
               for g in range(G)]
    for th in threads:
        th.start()
    # drain once the first campaign is complete; its clients ride the
    # drain to a new transport on the same port and checkpoint root
    deadline = time.monotonic() + 300
    done = False
    while not done and time.monotonic() < deadline and not errors:
        done = any(client(t1, 9)._request("GET", f"/v1/sweeps/c{i}")[1]
                   .get("status") == "complete" for i in range(G))
        time.sleep(0.01)
    check(done, f"no campaign completed within 300 s: {errors}")
    t1.request_drain()
    check(t1.wait(120), "the first transport did not drain")
    t1.close()
    t2 = transport(t1.port)
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads) and not errors,
          f"requests did not complete: {errors}")
    service_wall = time.perf_counter() - t
    for g in range(G):
        answer_ok(g, results[g].arrays, f"service request {g}")
    resubmits = sum(results[g].stats.resubmits for g in range(G))
    print(f"[service] HTTP: {G} requests of {H * d_req} lanes (request "
          f"{reduced_g} TopK('edp', 8)), slots 2, units of {H * d_req}: "
          f"every answer equals phase 4's rows (or the oracle over them); "
          f"a replayed key replays its campaign; drained after the first "
          f"campaign completed, {resubmits} resubmissions to a new "
          f"transport on the same port and checkpoint root")
    print(f"[service] wall per request (from submission, drain and restart "
          f"included): " + ", ".join(f"{walls[g]:.3f} s" for g in range(G))
          + f"; all {G} in {service_wall:.3f} s")
    print("[service] admission after the restart (rids, units resumed "
          "from the checkpoints): " + "; ".join(
              f"{e['rids']} {e['resumed_units']}"
              for e in t2.service.admission_log))
    # each request alone on the new transport (its own campaign), then
    # again on a third transport on the same checkpoint root: there every
    # unit resumes and the kernel never runs
    rounds = []
    for tr in (t2, None):
        if tr is None:
            t2.close()
            tr = transport()
        before = sweep_engine.launches
        t = time.perf_counter()
        for g in range(G):
            progs_g, hws_g, imgs_g, red_g = request(g)
            answer_ok(g, client(tr, 20 + g).sweep(
                progs_g, hws_g, imgs_g, reduce=red_g,
                idempotency_key=f"smoke-{len(rounds)}-{g}").arrays,
                f"request {g} alone")
        rounds.append((time.perf_counter() - t,
                       sweep_engine.launches - before,
                       sum(e["resumed_units"]
                           for e in tr.service.admission_log)))
    tr.close()
    check(rounds[1][1] == 0 and rounds[1][2] == G,
          f"a third transport resumed {rounds[1][2]} of {G} units and "
          f"launched the kernel {rounds[1][1]} times")
    print(f"[service] each request alone: {rounds[0][0]:.3f} s, "
          f"{rounds[0][1]} launches; resubmitted to a third transport on "
          f"the same checkpoint root: {rounds[1][0]:.3f} s, every unit "
          f"resumed, no launch")

    # ---- autotune --------------------------------------------------------
    tuned = []
    t = time.perf_counter()
    cfg = tune_sweep(progs, prof, hws, plan.images, max_steps=MAIN_MAX_STEPS,
                     device=dev, repeats=2,
                     log=lambda c, sec: tuned.append((c, sec * 1e3)))
    tune_s = time.perf_counter() - t
    for c, ms in tuned:
        print(f"[autotune] max_buckets {c['max_buckets']} chunk_steps "
              f"{c['chunk_steps']} blk_b {c['blk_b']}: {ms:.3f} ms")
    static = next(ms for c, ms in tuned if (c["blk_b"], c["chunk_steps"],
                                             c["max_buckets"]) == (32, 64, 4))
    best = min(ms for _, ms in tuned)
    held = dse.make_bucketed_sweep_fn(progs, prof, hws, plan.images,
                                      max_steps=MAIN_MAX_STEPS, device=dev)
    check(held.cfg.source == "cache", f"AUTO knobs came from "
          f"{held.cfg.source}, not the cache")
    print(f"[autotune] {len(tuned)} candidates in {tune_s:.2f} s; winner "
          f"blk_b {cfg.blk_b} chunk_steps {cfg.chunk_steps} max_buckets "
          f"{cfg.max_buckets}: {best:.3f} ms against the static 32/64/4's "
          f"{static:.3f} ms")
    # dse.sweep end to end (plan, buckets, kernel, scatter), the tuned
    # knobs against the static ones in turns: static, AUTO, AUTO, static
    walls = {"static": [], "AUTO": []}
    for which in ("static", "AUTO", "AUTO", "static"):
        knobs = (dict(chunk_steps=64, blk_b=32, max_buckets=4)
                 if which == "static" else {})
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = dse.sweep(programs=progs, profile=prof, hw_configs=hws,
                        mem_images=images, max_steps=MAIN_MAX_STEPS,
                        device=dev, **knobs)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t)
        equal_lanes(got, f"{which} sweep")
    print(f"[autotune] dse.sweep wall, static 32/64/4 "
          + " / ".join(f"{w:.4f}" for w in walls["static"])
          + " s, AUTO (from the cache) "
          + " / ".join(f"{w:.4f}" for w in walls["AUTO"])
          + " s; every run equals phase 4")
    launches = sweep_engine.launches
    print(f"[service] phase {time.perf_counter() - t_phase:.1f} s; sweep "
          f"launches {launches}")
    check(launches > 0, "the service phase never launched the sweep kernel")
    return {"launches": launches, "tuned_ms": best, "static_ms": static,
            "auto_sweep_s": walls["AUTO"], "static_sweep_s": walls["static"]}


def mesh_phase(dev, prof, progs, hws, images, res, sweep_wall,
               work: Path) -> dict:
    """Phase 4d: the sweep split across devices on the phase-4 campaign;
    every answer is held to phase 4's lanes bit for bit (or to the oracle
    over them).  Returns the phase's launches, by device and by shard,
    and each mesh's walls.

    ``work`` is an empty directory for the runner's checkpoints."""
    import numpy as np
    import torch
    from repro_torch.analysis.pareto import (REDUCED_FIELDS, ParetoFront,
                                             TopK, reduce_oracle)
    from repro_torch.checkpoint import restore_resharded
    from repro_torch.core import dse
    from repro_torch.kernels.cgra_sweep.ops import sweep_engine
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.service import FleetMonitor, ResumableSweepRunner

    G, H, D = len(progs), len(hws), images.shape[0]
    B = G * H * D
    want = [x.cpu() for x in res]
    fields = [x.numpy() for x in want]
    prog_idx = np.repeat(np.arange(G), H * D)
    # phase 4's knobs (the static defaults; phase 4c's tuned winner sits
    # in the cache for one entry), so every wall compares the same work
    knobs = dict(chunk_steps=64, blk_b=32, max_buckets=4)
    kw = dict(programs=progs, profile=prof, hw_configs=hws,
              mem_images=images, max_steps=MAIN_MAX_STEPS, **knobs)

    def equal_lanes(got, what, rows=slice(None), on=None):
        for f, w in zip(dse.SweepResult._fields, want):
            g = getattr(got, f) if not isinstance(got, dict) else got[f]
            check(on is None or g.device == on,
                  f"{what}: {f} lies on {g.device}, not {on}")
            g = g.cpu()
            check(g.dtype == w.dtype and torch.equal(g, w[rows]),
                  f"{what}: {f} differs from phase 4")

    def equal_reduced(got, oracle, what):
        for f in REDUCED_FIELDS:
            g, w = np.asarray(getattr(got, f)), getattr(oracle, f)
            check(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                  f"{what}: {f} differs from reduce_oracle over phase 4")
        check(not np.asarray(got.clipped).any(), f"{what}: a clipped front")

    def synchronize():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sweep_engine.launches = 0
    sweep_engine.device_launches.clear()
    t_phase = time.perf_counter()
    meshes = {"all cards": make_debug_mesh(),
              "4 on cuda:0": make_debug_mesh(4, device="cuda:0"),
              "3 on cuda:0": make_debug_mesh(3, device="cuda:0")}
    check(meshes["all cards"].devices.size == torch.cuda.device_count(),
          "make_debug_mesh() does not hold every visible card")
    first = torch.device("cuda", 0)

    # ---- unreduced: each mesh beside the unsharded sweep, in turns -------
    walls = {name: [] for name in ["unsharded", *meshes]}
    shard_launches = {}
    order = ["unsharded", *meshes]
    for name in order + order[::-1]:
        synchronize()
        t = time.perf_counter()
        if name == "unsharded":
            got = dse.sweep(device=dev, **kw)
        else:
            fn = dse.make_bucketed_sweep_fn(mesh=meshes[name], **kw)
            got = fn()
            shard_launches.setdefault(name, [
                sum(grid.shard_launches[i] for grid in fn.grids)
                for i in range(meshes[name].devices.size)])
        synchronize()
        walls[name].append(time.perf_counter() - t)
        equal_lanes(got, f"sweep on {name}", on=first)
    for name, counts in shard_launches.items():
        check(min(counts) > 0, f"a shard of {name} never launched")
    print(f"[mesh] every mesh equals phase 4 in all five fields, gathered "
          f"on {first}: " + "; ".join(
              f"{name} ({meshes[name].devices.size} shards, "
              f"{len(meshes[name].distinct())} distinct device(s))"
              for name in meshes))
    print(f"[mesh] dse.sweep wall, knobs 32/64/4, in turns (phase 4: "
          f"{sweep_wall:.4f} s): " + "; ".join(
              f"{name} " + " / ".join(f"{w:.4f}" for w in ws) + " s"
              for name, ws in walls.items()))
    print("[mesh] chunk launches per shard, first call: " + "; ".join(
        f"{name} {counts}" for name, counts in shard_launches.items()))
    kernel_ms = {}
    for name in ("unsharded", "4 on cuda:0"):
        run = ((lambda: dse.sweep(device=dev, **kw)) if name == "unsharded"
               else (lambda: dse.sweep(mesh=meshes["4 on cuda:0"], **kw)))
        kernel_ms[name] = profile_kernels(run, top=2)
        print(f"[mesh] device time of one sweep, {name}: {kernel_ms[name]}")

    # ---- reduced: each shard reduces on its device -----------------------
    # a front of up to H*D points: a shard's own front of a program (ties
    # kept) may hold more points than the program's whole front, and a
    # shard that clips marks the merged front clipped
    for name, specs in (("4 on cuda:0",
                         (TopK("edp", 8),
                          ParetoFront(("latency_cc", "energy_pj"),
                                      max_points=H * D))),
                        ("3 on cuda:0", (TopK("edp", 8),))):
        for spec in specs:
            oracle = reduce_oracle(spec, fields, prog_idx, np.arange(B), G)
            t = time.perf_counter()
            got = dse.sweep(mesh=meshes[name], reduce=spec, **kw)
            wall = time.perf_counter() - t
            equal_reduced(got, oracle, f"{spec} on {name}")
            print(f"[mesh] {spec} on {name}: bit for bit reduce_oracle over "
                  f"phase 4's lanes, {int(np.asarray(got.count).sum())} "
                  f"candidates, {wall:.4f} s")

    # ---- the runner: 4 shards lose 2 nodes and re-plan to 2 ---------------
    clock = {"now": 0.0}
    monitor = FleetMonitor([f"dev{i}" for i in range(4)],
                           clock=lambda: clock["now"], timeout=5.0)
    dead = ((1, "dev2"), (1, "dev3"))
    runner = ResumableSweepRunner(
        programs=progs, profile=prof, hw_configs=hws, mem_images=images,
        max_steps=MAIN_MAX_STEPS, unit_size=SERVICE_UNIT, chunk_steps=64,
        blk_b=32, mesh=meshes["4 on cuda:0"], monitor=monitor,
        injector=FaultInjector(FaultPlan(dead_nodes=dead)),
        ckpt_dir=str(work / "mesh_runner"))
    check(runner.n_units == 10, f"mesh runner: {runner.n_units} units")
    t = time.perf_counter()
    for k in runner.pending_units():
        runner.run_unit(k)
        clock["now"] += 6.0
    runner.mgr.wait()
    runner_wall = time.perf_counter() - t
    replans = runner.report.replans
    check(len(replans) == 1 and replans[0]["dropped"] == ["dev2", "dev3"]
          and replans[0]["elastic_plan"]["n_devices"] == 2
          and runner.mesh.devices.size == 2,
          f"mesh runner re-planned as {replans}")
    equal_lanes(runner.stitch(), "mesh runner")
    unit = 3
    lo, hi = runner._unit_range(unit)
    like = {f: np.zeros(hi - lo, w.numpy().dtype)
            for f, w in zip(dse.SweepResult._fields, want)}
    back = restore_resharded(like, runner.mgr.path(unit), first)
    equal_lanes(back, f"unit {unit} restored onto {first}",
                rows=slice(lo, hi), on=first)
    print(f"[mesh] runner: 10 units of {SERVICE_UNIT} lanes on 4 shards; "
          f"nodes dev2, dev3 silent from unit 1, re-planned at unit "
          f"{replans[0]['unit']} to {runner.mesh.devices.size} shards "
          f"(elastic_plan {replans[0]['elastic_plan']}); stitched equal to "
          f"phase 4, {runner_wall:.4f} s; unit {unit}'s checkpoint restored "
          f"onto {first} by restore_resharded equals phase 4's rows")

    launches = sweep_engine.launches
    by_device = dict(sweep_engine.device_launches)
    check(launches > 0 and sum(by_device.values()) == launches,
          f"mesh launches {launches} against by device {by_device}")
    mesh_devices = {str(d) for m in meshes.values() for d in m.distinct()}
    check(set(by_device) <= mesh_devices,
          f"launches on {set(by_device)} outside the meshes' devices")
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s; sweep "
          f"launches {launches}, by device {by_device}")
    return {"launches": launches, "by_device": by_device,
            "by_shard": shard_launches,
            "walls": walls, "runner_wall": runner_wall}


def flash_phase(dev) -> dict:
    """Phase 5: the flash-attention kernel against its plain version."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.flash_attention.ops import attention, last_route
    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[flash] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, H, KV, hd, dtype, T=None):
        return [torch.randn(B, n, h, hd, device=dev, generator=gen).to(dtype)
                for n, h in ((S, H), (T or S, KV), (T or S, KV))]

    def plain(q, k, v, causal, window):
        H = q.shape[2]
        return attention_ref(q.transpose(1, 2), expand_kv(k, H),
                             expand_kv(v, H), causal=causal,
                             window=window).transpose(1, 2)

    cases = [  # (name, B, S, H, KV, hd, dtype, causal, window)
        ("main bf16 causal", 1, 2048, 32, 32, 80, torch.bfloat16, True, None),
        ("f32 hd16", 1, 2048, 32, 32, 16, torch.float32, True, None),
        ("f32 hd128", 1, 2048, 32, 32, 128, torch.float32, True, None),
        ("ragged S=1000", 1, 1000, 32, 32, 80, torch.float32, True, None),
        ("causal=False", 1, 2048, 32, 32, 80, torch.float32, False, None),
        ("window=512", 1, 2048, 32, 32, 80, torch.float32, True, 512),
        ("GQA 32/8 bf16", 1, 2048, 32, 8, 80, torch.bfloat16, True, None),
    ]

    def hold(name, q, k, v, causal, window):
        """The kernel against its plain version: (max abs err, the route
        that ran); fails past the tolerance."""
        got = attention(q, k, v, causal=causal, window=window)
        ran = last_route()
        want = plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        dtype = q.dtype
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol)),
              f"flash_attention {name}: max abs err {err:.3g} over {tol}")
        ref_max = float(want.float().abs().max())
        tight = ""
        if dtype == torch.bfloat16:
            # both sides round f32 values that agree to ~1e-6 to bf16 (8
            # significant bits), so each element differs by at most about
            # one bf16 step of itself; 2e-2 alone is half a typical output
            check(bool(torch.allclose(got.float(), want.float(),
                                      rtol=2.0 ** -6, atol=1e-5)),
                  f"flash_attention {name}: an element is off by more "
                  f"than two bf16 steps of itself (rtol 2^-6, atol 1e-5)")
            tight = " and within two bf16 steps of each element"
        (B, S, H, hd), (T, KV) = q.shape, k.shape[1:3]
        print(f"[flash] {name} (B={B}, S={S}, T={T}, H={H}, KV={KV}, hd={hd}, "
              f"{str(dtype)[6:]}, causal={causal}, window={window}), route "
              f"{ran}: max abs err {err:.3g} ({err / ref_max:.3g} of the "
              f"largest |output| {ref_max:.3g}) <= {tol}{tight}")
        return err, ran

    main_err = None
    for name, B, S, H, KV, hd, dtype, causal, window in cases:
        err, _ = hold(name, *inputs(B, S, H, KV, hd, dtype), causal, window)
        main_err = err if main_err is None else main_err

    B, S, H, hd = 1, 2048, 32, 80
    q, k, v = inputs(B, S, H, H, hd, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = cuda_ms(lambda: attention(q, k, v, causal=True), reps=20)
    plain_ms = cuda_ms(lambda: attention_ref(qt, kt, vt, causal=True),
                       reps=5)
    sdpa(qt, kt, vt, is_causal=True)
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=20)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(lambda: attention(qf, kf, vf, causal=True), reps=5)
    pairs = S * (S + 1) // 2                  # the causal band
    b_ms, b_by = bound(4 * B * S * H * hd * 2, 4 * B * H * hd * pairs,
                       BF16_OPS_PER_S)
    print(f"[flash] main shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    print(f"[flash] main shape by route: bf16 (tensor cores) {ms:.4f} ms, "
          f"f32 (FMA kernel) {f32_ms:.4f} ms, scaled_dot_product_attention "
          f"bf16 {lib_ms:.4f} ms")
    families = [family_case(hold, inputs, arch, B, S, S, H, KV, hd, True,
                            window)
                for arch, B, S, H, KV, hd, window in FAMILY_FLASH]
    whisper = [family_case(hold, inputs, *case, None)
               for case in WHISPER_FLASH]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "f32_ms": f32_ms,
            "shape": [B, S, H, hd], "dtype": "bfloat16", "causal": True,
            "family_shapes": families, "whisper_shapes": whisper}


# bf16 causal prefill shapes of the transformer families (phase 5):
# (config, B, S, H, KV, hd, window)
FAMILY_FLASH = [("llama3.2-1b", 1, 2048, 32, 8, 64, None),
                ("qwen2-vl-7b", 1, 2048, 28, 4, 128, None),
                ("starcoder2-15b", 1, 4608, 48, 4, 128, 4096)]
# whisper-small's bf16 prefill shapes (phase 5), 12 heads of 64, kv 12:
# (name, B, S, T, H, KV, hd, causal)
WHISPER_FLASH = [
    ("whisper encoder", 1, 1500, 1500, 12, 12, 64, False),
    ("whisper cross 224", 1, 224, 1500, 12, 12, 64, False),
    ("whisper cross 4", 1, 4, 1500, 12, 12, 64, False),
    ("whisper decoder self 224", 1, 224, 224, 12, 12, 64, True),
]


def family_case(hold, inputs, name, B, S, T, H, KV, hd, causal,
                window) -> dict:
    """One family's prefill shape: held to the plain version on the
    tensor-core route, timed beside scaled_dot_product_attention (on the
    kv heads expanded, with the window as a mask) and the bound of the
    live (query, key) pairs' products at the bf16 tensor-core rate."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import expand_kv

    q, k, v = inputs(B, S, H, KV, hd, torch.bfloat16, T)
    err, ran = hold(f"{name} bf16", q, k, v, causal, window)
    check(ran == "wgmma", f"flash {name} shape took the {ran} route, not "
          f"the tensor cores")
    ms = cuda_ms(lambda: attention(q, k, v, causal=causal, window=window),
                 reps=20)
    # the device's time alone: at the short shapes the wrapper's host
    # time per call may exceed the kernel's
    dev_ms = device_ms(lambda: attention(q, k, v, causal=causal,
                                         window=window))
    qt, kt, vt = q.transpose(1, 2), expand_kv(k, H), expand_kv(v, H)
    if window is None:
        def lib():
            return sdpa(qt, kt, vt, is_causal=causal)
    else:
        i = torch.arange(S, device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def lib():
            return sdpa(qt, kt, vt, attn_mask=band)
    lib()
    lib_ms = cuda_ms(lib, reps=20)
    # keys in band of each query row (causal and windowed calls: S == T)
    pairs = (sum(min(i + 1, window or T) for i in range(S)) if causal
             else S * T)
    n_bytes = 2 * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    n_ops = 4 * B * H * hd * pairs
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    print(f"[flash] {name} shape: kernel {ms:.4f} ms (events, back to "
          f"back), {dev_ms:.4f} ms (device time), "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.4f} "
          f"ms ({b_by}: {pairs} live pairs, {n_ops / 1e9:.2f} GFLOP), "
          f"{ms / b_ms:.2f}x the bound")
    return {"config": name, "shape": [B, S, H, hd], "keys": T,
            "kv_heads": KV, "causal": causal, "window": window,
            "route_taken": ran, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "live_pairs": pairs}


def ssd_phase(dev) -> dict:
    """Phase 6: the intra-chunk SSD kernel against its plain version."""
    import torch
    from torch.nn.functional import softplus
    from repro_torch.kernels.mamba2_scan.ops import last_route, ssd_intra_chunk
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref

    L, H, P, N = 64, 80, 64, 64
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    by_g = []
    for G in (32, 14, 5):
        x = randn(G, L, H, P)
        dt = softplus(randn(G, L, H))
        cum = torch.cumsum(-softplus(randn(G, L, H)), dim=1)
        Bm, Cm = randn(G, L, N), randn(G, L, N)
        got = ssd_intra_chunk(x, dt, cum, Bm, Cm)
        ran = last_route()
        want = intra_chunk_ref(x, dt, cum, Bm, Cm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)),
              f"ssd_intra_chunk G={G}: max abs err {err:.3g} over 2e-5")
        # `ms`: events around back-to-back calls, as for the other
        # kernels; `dev_ms`: the device time alone, the launches queued
        # behind a sleep so that the host's time per call does not show
        ms = cuda_ms(lambda: ssd_intra_chunk(x, dt, cum, Bm, Cm), reps=20)
        dev_ms = device_ms(lambda: ssd_intra_chunk(x, dt, cum, Bm, Cm))
        plain_ms = cuda_ms(lambda: intra_chunk_ref(x, dt, cum, Bm, Cm),
                           reps=5)
        tri = L * (L + 1) // 2              # pairs j <= i of a chunk
        n_bytes = 4 * (2 * G * L * H * P + 2 * G * L * H + 2 * G * L * N)
        # C.B^T over the triangle once a chunk; per head and pair: the
        # difference, exp and two multiplies of the score; the product
        n_ops = 2 * G * tri * N + 4 * G * H * tri + 2 * G * H * tri * P
        b_ms, b_by = bound(n_bytes, n_ops, F32_OPS_PER_S)
        print(f"[ssd] (G={G}, L={L}, H={H}, P={P}, N={N}) f32, route "
              f"{ran}: max abs err {err:.3g}, within rtol = atol = 2e-5; "
              f"kernel {ms:.4f} ms (events, back to back), {dev_ms:.4f} ms "
              f"(device time), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP), "
              f"{ms / b_ms:.2f}x and {dev_ms / b_ms:.2f}x the bound")
        by_g.append({"G": G, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err, "route": ran})
    main = by_g[0]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba2_scan/csrc/"
                      "ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/mamba2_scan/kernel.py:56",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": [32, L, H, P, N], "load_route": main["route"],
            "by_chunks": by_g}


class _Watched:
    """A model whose prefill and decode logits are checked for finite
    values on the device (one flag, read once at the end)."""

    def __init__(self, model):
        import torch
        self._model = model
        self.bad = torch.zeros((), dtype=torch.bool, device=model.device)

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _watch(self, out):
        self.bad |= ~out[0].isfinite().all()
        return out

    def prefill(self, *args, **kw):
        return self._watch(self._model.prefill(*args, **kw))

    def decode(self, *args, **kw):
        return self._watch(self._model.decode(*args, **kw))


def serve_phase(dev, arch=ARCH, *, slots=SERVE_SLOTS, context=SERVE_CONTEXT,
                lengths=None, gen=SERVE_GEN, n_layers=None, tag="serve",
                decode_launches=False) -> dict:
    """Phases 7, 10, 10b, 11 and 11b: ``arch`` at full width (cut to
    ``n_layers`` where given) behind the Server: seeded prompts of
    ``lengths`` tokens (by default SERVE_REQUESTS seeded lengths in
    256-2048), ``gen`` greedy tokens each; the vlm family's requests carry
    seeded patch embeds and the encdec family's seeded frames through
    admit(extras=).  Exact kernel launches, finite logits, prefill
    tokens/s (for encdec also the encoder's frames/s and the decoder's
    prompt tokens/s), decode ms a step, peak memory; with
    ``decode_launches`` also the device kernels of one decode step of
    every slot (torch.profiler, after the kernels' counts are read)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.mamba2_scan.ops import ssd_intra_chunk
    from repro_torch.launch.serve import Server
    from repro_torch.models import make_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = _Watched(make_model(cfg, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    cut = ("" if n_layers is None
           else f" (cut from {get_config(arch).n_layers})")
    enc_layers = (f" + {cfg.n_enc_layers} encoder layers over "
                  f"{cfg.enc_seq} frames" if cfg.family == "encdec" else "")
    print(f"[{tag}] {arch}: {cfg.n_layers} layers{cut}{enc_layers}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} (kv "
          f"{cfg.n_kv_heads}), window {cfg.window}, {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB f32) initialised on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    if lengths is None:
        lengths = rng.integers(256, 2049, SERVE_REQUESTS)
        check(any(n % 64 and n % FLASH_TILE for n in lengths),
              "no prompt length is ragged against the SSD chunk and the tile")
    lengths = np.asarray(lengths)
    requests = []
    for n in lengths:
        extras = None
        if cfg.family == "vlm":
            extras = {"patch_embeds": torch.as_tensor(rng.standard_normal(
                (cfg.n_patches, cfg.d_model)).astype(np.float32))}
        if cfg.family == "encdec":
            extras = {"frames": torch.as_tensor(rng.standard_normal(
                (cfg.enc_seq, cfg.d_model)).astype(np.float32))}
        requests.append((rng.integers(0, cfg.vocab, n), extras))
    print(f"[{tag}] prompt lengths {lengths.tolist()}, context {context}, "
          f"{slots} slots, {gen} greedy tokens each"
          + (f", {cfg.n_patches} patch embeds a request"
             if cfg.family == "vlm" else "")
          + (f", {cfg.enc_seq} frames a request" if cfg.family == "encdec"
             else ""))
    # the encoder's share of each prefill, timed where the model calls it
    enc = {"s": 0.0, "frames": 0}
    if cfg.family == "encdec":
        encode = params.encode

        def timed_encode(frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = encode(frames)
            torch.cuda.synchronize()
            enc["s"] += time.perf_counter() - t
            enc["frames"] += frames.shape[0] * frames.shape[1]
            return out
        params.encode = timed_encode
    srv = Server(model, params, slots=slots, context=context)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    attention.launches = 0
    ssd_intra_chunk.launches = 0
    pending = list(reversed(requests))
    done, prefill_s, decode_s, steps, decode_tokens = [], 0.0, 0.0, 0, 0
    t_all = time.perf_counter()
    while pending or srv.active.any():
        for s in range(srv.slots):
            if not srv.active[s] and pending:
                torch.cuda.synchronize()
                t = time.perf_counter()
                srv.admit(s, *pending.pop())
                torch.cuda.synchronize()
                prefill_s += time.perf_counter() - t
        n_active = int(srv.active.sum())
        t = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t
        steps += 1
        decode_tokens += n_active
        for s in range(srv.slots):
            if srv.active[s] and len(srv.outputs[s]) >= gen:
                done.append(srv.outputs[s])
                srv.active[s] = False
    wall = time.perf_counter() - t_all
    launches = {"flash_attention": attention.launches,
                "ssd_intra_chunk": ssd_intra_chunk.launches}
    print(f"[{tag}] launches: {launches}")
    # per prefill: one flash launch per attention layer (hybrid: per
    # shared-block application; encdec: per encoder layer and twice per
    # decoder layer, self and cross; none for the xLSTM), one SSD launch
    # per Mamba2 layer; decode runs neither kernel
    n_req = len(lengths)
    flash_a_prefill = {
        "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1),
        "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
        "ssm": 0}.get(cfg.family, cfg.n_layers)
    want = {"flash_attention": flash_a_prefill * n_req,
            "ssd_intra_chunk": (cfg.n_layers * n_req
                                if cfg.family == "hybrid" else 0)}
    check(launches == want, f"{arch}: kernel launches {launches} on the "
          f"serving path, expected {want}")
    check(len(done) == n_req and all(len(d) == gen for d in done),
          f"{arch}: served {len(done)} of {n_req} requests")
    check(not bool(model.bad), f"{arch}: non-finite logits")
    check(all(0 <= t < cfg.vocab for d in done for t in d),
          f"{arch}: a generated token is outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    stats = dict(launches, arch=arch, layers=cfg.n_layers,
                 prefill_tok_s=float(lengths.sum()) / prefill_s,
                 decode_ms_per_step=decode_s / steps * 1e3,
                 decode_tok_s=decode_tokens / decode_s,
                 peak_gib=peak / 2**30)
    split = ""
    if cfg.family == "encdec":
        check(enc["frames"] == n_req * cfg.enc_seq,
              f"{arch}: the encoder saw {enc['frames']} frames")
        stats.update(encoder_frames_s=enc["frames"] / enc["s"],
                     decoder_prefill_tok_s=float(lengths.sum())
                     / (prefill_s - enc["s"]))
        split = (f": encoder {enc['s']:.3f} s for {enc['frames']} frames "
                 f"({stats['encoder_frames_s']:.1f} frames/s), decoder "
                 f"{prefill_s - enc['s']:.3f} s "
                 f"({stats['decoder_prefill_tok_s']:.1f} prompt tokens/s)")
    print(f"[{tag}] {arch}: {len(done)} requests, {int(lengths.sum())} "
          f"prompt tokens, {n_req * gen} generated, logits finite, wall "
          f"{wall:.3f} s; prefill {prefill_s:.3f} s "
          f"({stats['prefill_tok_s']:.1f} tokens/s{split}); {steps} decode steps "
          f"in {decode_s:.3f} s ({stats['decode_ms_per_step']:.3f} ms per "
          f"step, {stats['decode_tok_s']:.1f} tokens/s); "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")
    if decode_launches:
        index = int(srv.lengths.max())
        stats["decode_launches"] = kernel_launches(
            lambda: model.decode(params, srv.tokens, srv.caches, index))
        print(f"[{tag}] {arch}: one decode step of {slots} slots launches "
              f"{stats['decode_launches']} device kernels")
    del srv, params, model
    torch.cuda.empty_cache()
    return stats


class _Routes:
    """Records the experts every MoE router call chose, under the name of
    the side running (``side``: "card" or "host"), forward and
    recomputation alike, while open."""

    def __enter__(self):
        from repro_torch.models import moe
        self.log, self._moe, self.side = {}, moe, None
        self._probs = moe.router_probs

        def recorded(p, x):
            probs = self._probs(p, x)
            self.log.setdefault(self.side, []).append(
                (probs.detach().cpu(),
                 moe.topk_experts(probs, p.cfg.top_k).cpu()))
            return probs
        moe.router_probs = recorded
        return self

    def __exit__(self, *exc):
        self._moe.router_probs = self._probs

    def check_equal(self, what: str) -> int:
        card, host = self.log.get("card", []), self.log.get("host", [])
        check(len(card) == len(host), f"{what}: {len(card)} MoE router "
              f"calls on the card, {len(host)} on the host")
        import torch
        for call, ((_, c_card), (probs, c_host)) in enumerate(zip(card,
                                                                  host)):
            if not torch.equal(c_card, c_host):
                b, tok = (c_card != c_host).any(-1).nonzero()[0].tolist()
                top = probs[b, tok].sort(descending=True).values
                k = c_host.shape[-1]
                fail(f"{what}: MoE routing differs at router call {call}, "
                     f"batch row {b}, token {tok}: card "
                     f"{c_card[b, tok].tolist()}, host "
                     f"{c_host[b, tok].tolist()}; gap between the k-th and "
                     f"(k+1)-th probability {float(top[k - 1] - top[k]):.3g}")
        return len(card)


def card_vs_host(dev, cfg, prompts, *, context, steps, tol, what,
                 seed=1) -> list:
    """The card's path against the plain path on the host, the same
    seeded weights on both: ``prompts`` (the vlm family's with seeded
    patch embeds over up to half of each, the encdec family's with seeded
    frames) prefilled and spliced into one slot each, then ``steps`` teacher-forced decode steps at the Server's
    shared index;
    the MoE's chosen experts compared first, call by call (a mismatch
    names the layer, the token and the gap between the k-th and
    (k+1)-th probability), then the logits of every step at rtol = atol
    = ``tol``.  Returns the max abs error of each step."""
    import numpy as np
    import torch
    from repro_torch.models import make_model

    m_dev, m_cpu = make_model(cfg, device=dev), make_model(cfg, device="cpu")
    p_dev = m_dev.init(torch.Generator(device=dev).manual_seed(seed))
    p_cpu = copy.deepcopy(p_dev).to("cpu")
    routes = _Routes()
    rng = np.random.default_rng(seed)
    # a vlm request's image covers at most half its prompt: qwen2-vl's
    # dynamic resolution gives fewer patches than n_patches to a smaller
    # image (the reference writes however many it is given)
    def extra(prompt):
        if cfg.family == "vlm":
            return {"patch_embeds": torch.as_tensor(rng.standard_normal(
                (1, min(cfg.n_patches, len(prompt) // 2), cfg.d_model)
            ).astype(np.float32))}
        if cfg.family == "encdec":
            return {"frames": torch.as_tensor(rng.standard_normal(
                (1, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
        return {}
    extras = [extra(p) for p in prompts]
    index = max(len(p) for p in prompts)     # the Server's shared index

    def run(model, params, forced, side):
        routes.side = side
        caches = model.init_caches(len(prompts), context)
        out = []
        for slot, (prompt, extra) in enumerate(zip(prompts, extras)):
            batch = {"tokens": torch.as_tensor(prompt[None],
                                               device=model.device)}
            batch.update({k: v.to(model.device) for k, v in extra.items()})
            logits, one = model.prefill(params, batch, context=context)
            caches = model.splice_cache(caches, one, slot)
            out.append(logits[:, -1].float().cpu())
        feed = forced or [torch.cat(out).argmax(-1)[:, None]]
        for t in range(steps):
            logits, caches = model.decode(params, feed[t].to(model.device),
                                          caches, index + t)
            out.append(logits[:, -1].float().cpu())
            if not forced:
                feed.append(out[-1].argmax(-1)[:, None])
        return out, feed

    t = time.perf_counter()
    with routes:
        want, feed = run(m_cpu, p_cpu, None, "host")
        t_cpu = time.perf_counter() - t
        got, _ = run(m_dev, p_dev, feed, "card")
    calls = routes.check_equal(what)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    for i, (g, w) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(g).all()) and g.shape == w.shape,
              f"{what} step {i}: non-finite logits or wrong shape")
        check(bool(torch.allclose(g, w, rtol=tol, atol=tol)),
              f"{what} step {i}: card and host logits differ by "
              f"{errs[i]:.3g} (rtol = atol = {tol:g})")
    routed = f"; MoE experts equal in all {calls} calls" if calls else ""
    print(f"[{what}] {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, f32: {len(prompts)} prefills "
          f"({', '.join(str(len(p)) for p in prompts)} tokens) + {steps} "
          f"teacher-forced decode steps, card vs host logits max abs err "
          f"{max(errs):.3g} <= {tol:g} (per step "
          f"{[float(f'{e:.3g}') for e in errs]}){routed}; host run "
          f"{t_cpu:.1f} s")
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    return errs


def depth6_phase(dev) -> None:
    """Phase 8: the card's path against the plain path on the host."""
    import numpy as np
    from repro_torch.configs import get_config

    cfg = get_config(ARCH).replace(n_layers=6, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (256, 200)]
    card_vs_host(dev, cfg, prompts, context=512, steps=8, tol=1e-3,
                 what="depth6")


# the transformer families (phases 10-10c): this slice's main path, then
# the other six configs at full width, 2 slots answering 2 requests of
# 16 greedy tokens; prompts of 512 tokens, 4,608 for the sliding-window
# configs (past their 4,096-token window, context 8,192).  mixtral's 56
# layers take 524 GiB in f32: it runs 2 of them.
LM_ARCH = "llama3.2-1b"
FAMILY_SERVE = [  # (config, prompt tokens, context, layers kept or None)
    ("granite-moe-1b-a400m", 512, 1024, None),
    ("qwen2-vl-7b", 512, 1024, None),
    ("olmo-1b", 512, 1024, None),
    ("smollm-360m", 512, 1024, None),
    ("starcoder2-15b", 4608, 8192, None),
    ("mixtral-8x22b", 4608, 8192, 2),
]
FAMILY_GEN = 16
CARD_HOST_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b")
SMOKE_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b",
               "olmo-1b", "smollm-360m", "starcoder2-15b", "mixtral-8x22b")


def families_phase(dev) -> dict:
    """Phases 10 and 10b: llama3.2-1b at full width and depth behind the
    Server (this slice's main path), then the other six configs."""
    t = time.perf_counter()
    main = serve_phase(dev, LM_ARCH, tag="serve-llama")
    print(f"[serve-llama] phase 10 wall {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    others = [serve_phase(dev, arch, slots=2, context=context,
                          lengths=[n, n], gen=FAMILY_GEN, n_layers=layers,
                          tag="serve-families")
              for arch, n, context, layers in FAMILY_SERVE]
    print(f"[serve-families] phase 10b wall {time.perf_counter() - t:.1f} s")
    return {"main": main, "others": others}


def families_card_vs_host_phase(dev) -> None:
    """Phase 10c: full width cut to 2 layers, f32, card against host at
    1e-3 (as phase 8); then every smoke config at 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    for arch in CARD_HOST_ARCHS:
        cfg = get_config(arch).replace(n_layers=2, dtype="float32")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (256, 200)]
        card_vs_host(dev, cfg, prompts, context=512, steps=8, tol=1e-3,
                     what="card-host")
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (20, 13)]
        card_vs_host(dev, cfg, prompts, context=64, steps=4, tol=1e-4,
                     what="card-host-smoke")
    print(f"[card-host] phase 10c wall {time.perf_counter() - t:.1f} s")


# the last two families (phases 11-11c): whisper-small, this slice's main
# path, a Server of 4 slots at whisper's text context of 448 answering 8
# requests, each 1,500 seeded frames and a seeded prompt of 4-224 tokens
# (whisper's previous-text prompt is capped near half its context), 32
# greedy tokens; then xlstm-350m, 2 slots answering 2 requests of 512
# tokens, 16 greedy tokens
WHISPER_ARCH, XLSTM_ARCH = "whisper-small", "xlstm-350m"
WHISPER_SLOTS, WHISPER_CONTEXT, WHISPER_REQUESTS = 4, 448, 8


def last_families_phase(dev) -> dict:
    """Phases 11 and 11b: whisper-small and xlstm-350m at full width and
    depth behind the Server."""
    import numpy as np

    t = time.perf_counter()
    lengths = np.random.default_rng(11).integers(4, 225, WHISPER_REQUESTS)
    whisper = serve_phase(dev, WHISPER_ARCH, slots=WHISPER_SLOTS,
                          context=WHISPER_CONTEXT, lengths=lengths,
                          tag="serve-whisper", decode_launches=True)
    print(f"[serve-whisper] phase 11 wall {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    xlstm = serve_phase(dev, XLSTM_ARCH, slots=2, context=1024,
                        lengths=[512, 512], gen=FAMILY_GEN,
                        tag="serve-xlstm", decode_launches=True)
    print(f"[serve-xlstm] phase 11b wall {time.perf_counter() - t:.1f} s")
    return {"whisper": whisper, "xlstm": xlstm}


def last_families_card_vs_host_phase(dev) -> None:
    """Phase 11c: whisper-small (2 + 2 layers, with frames) and
    xlstm-350m (2 layers) at full width, f32, card against host at 1e-3;
    then both smoke configs at 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    for arch in (WHISPER_ARCH, XLSTM_ARCH):
        cfg = get_config(arch).replace(n_layers=2, dtype="float32")
        if cfg.family == "encdec":
            cfg = cfg.replace(n_enc_layers=2)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (200, 64)]
        card_vs_host(dev, cfg, prompts, context=WHISPER_CONTEXT, steps=8,
                     tol=1e-3, what="card-host")
    for arch in (WHISPER_ARCH, XLSTM_ARCH):
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (20, 13)]
        card_vs_host(dev, cfg, prompts, context=64, steps=4, tol=1e-4,
                     what="card-host-smoke")
    print(f"[card-host] phase 11c wall {time.perf_counter() - t:.1f} s")


TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 4     # the main training path


def live_pairs(S, T, causal, window) -> int:
    """The (query, key) pairs in band: every one without a mask, the
    causal band (as wide as the window, if any) with one."""
    if not causal:
        return S * T
    return sum(min(i + 1, window or T) for i in range(S))


def flash_bwd_bound(B, S, H, hd, dtype_bytes, ops_per_s, T=None, KV=None,
                    causal=True, window=None):
    """(least ms, what sets it) of the flash backward: q, k, v, dO and lse
    read once, dQ, dK, dV written once; the five products a pair needs
    (S recomputed, dP, dV, dQ, dK), 2 hd operations each, over the live
    pairs (the causal band by default)."""
    T, KV = T or S, KV or H
    n_bytes = (3 * B * S * H + 4 * B * T * KV) * hd * dtype_bytes \
        + 4 * B * H * S
    pairs = live_pairs(S, T, causal, window)
    return bound(n_bytes, 5 * 2 * hd * B * H * pairs, ops_per_s)


def ssd_bwd_bound(G, L, H, P, N):
    """(least ms, what sets it) of the intra-chunk SSD backward: x, dy,
    dt, cum, B, C read once, dx, ddt, dcum, dB, dC written once; over
    the pairs j <= i: C.B^T once a chunk, ds and dx (2P each) and ~9
    elementwise operations a head, dC and dB (2N each) once a chunk."""
    tri = L * (L + 1) // 2
    n_bytes = 4 * (3 * G * L * H * P + 4 * G * L * H + 4 * G * L * N)
    n_ops = G * tri * (2 * N + 4 * N) + G * H * tri * (4 * P + 9)
    return bound(n_bytes, n_ops, F32_OPS_PER_S)


# the families' bf16 backward shapes (phase 9a), every one on the
# tensor cores: (name, B, S, T, H, KV, hd, causal, window)
LLAMA_BWD = "llama3.2-1b training (2, 4096, 32, 64) kv 8"
FAMILY_BWD = [
    (LLAMA_BWD, 2, 4096, 4096, 32, 8, 64, True, None),
    ("qwen2-vl (1, 2048, 28, 128) kv 4", 1, 2048, 2048, 28, 4, 128,
     True, None),
    ("hd 128 (1, 2048, 16, 128) kv 16", 1, 2048, 2048, 16, 16, 128,
     True, None),
    ("hd 128 window 512 (1, 2048, 32, 128) kv 4", 1, 2048, 2048, 32, 4, 128,
     True, 512),
    ("whisper encoder (2, 1500, 12, 64)", 2, 1500, 1500, 12, 12, 64,
     False, None),
    ("whisper cross (2, 448, 12, 64) against 1,500", 2, 448, 1500, 12, 12,
     64, False, None),
    ("whisper decoder (2, 448, 12, 64) causal", 2, 448, 448, 12, 12, 64,
     True, None),
]
FAMILY_NAMES = {c[0] for c in FAMILY_BWD}


def family_bwd_time(name, q, k, v, dout, lse, out32, causal, window,
                    errs) -> dict:
    """A family's backward shape timed beside its plain backward,
    scaled_dot_product_attention's fused backward (on the kv heads
    expanded, as phase 5 times its forward) and the bound."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         expand_kv)

    B, S, H, hd = q.shape
    ms = cuda_ms(lambda: fo._launch_bwd(q, k, v, dout, lse, causal, window,
                                        out32=out32), reps=5)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(
        q, k, v, dout, causal=causal, window=window), reps=2)
    T, KV = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (expand_kv(t, H).contiguous().requires_grad_(True)
              for t in (k, v))
    do_t = dout.transpose(1, 2).contiguous()
    # a window is a mask to SDPA (the memory-efficient backend takes it)
    mask = None
    if window is not None:
        i, j = torch.arange(S, device=q.device), torch.arange(T,
                                                              device=q.device)
        mask = (j[None] <= i[:, None]) & (i[:, None] - j[None] < window)
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def lib(a, b, c):
        with sdpa_kernel(fused):
            if mask is None:
                return sdpa(a, b, c, is_causal=causal)
            return sdpa(a, b, c, attn_mask=mask)
    out = lib(qt, kt, vt)
    torch.autograd.grad(out, (qt, kt, vt), do_t, retain_graph=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do_t, retain_graph=True), reps=5)
    b_ms, b_by = flash_bwd_bound(B, S, H, hd, 2, BF16_OPS_PER_S, T, KV,
                                 causal, window)
    print(f"[train-kernels] flash backward {name}: kernels {ms:.4f} ms (2 "
          f"launches), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"backward {lib_ms:.4f} ms (kv heads expanded), bound {b_ms:.4f} "
          f"ms ({b_by}), {ms / b_ms:.1f}x the bound")
    # the forward as training launches it (lse and the f32 output kept),
    # held to its plain version and timed at the same shape
    got = fo._launch(q, k, v, causal, window, lse=True)[0]
    want = fo.attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    f_err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), rtol=2e-2,
                              atol=2e-2)) and
          bool(torch.allclose(got.float(), want.float(), rtol=2.0 ** -6,
                              atol=1e-5)),
          f"flash forward {name}: max abs err {f_err:.3g}, over 2e-2 or "
          f"two bf16 steps of an element")
    f_ms = cuda_ms(lambda: fo._launch(q, k, v, causal, window, lse=True),
                   reps=10)
    f_plain_ms = cuda_ms(lambda: fo.attention_plain(
        q, k, v, causal=causal, window=window), reps=2)
    qd, kd, vd = qt.detach(), kt.detach(), vt.detach()
    lib(qd, kd, vd)
    f_lib_ms = cuda_ms(lambda: lib(qd, kd, vd), reps=10)
    f_b_ms, f_b_by = bound(2 * (2 * B * S * H * hd + 2 * k.numel()),
                           4 * B * H * hd * live_pairs(S, T, causal, window),
                           BF16_OPS_PER_S)
    print(f"[train-kernels] flash forward {name}, as training launches it: "
          f"max abs err {f_err:.3g} within 2e-2 and two bf16 steps; kernel "
          f"{f_ms:.4f} ms, plain {f_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {f_lib_ms:.4f} ms (kv heads "
          f"expanded), bound {f_b_ms:.4f} ms ({f_b_by})")
    del out, qt, kt, vt, qd, kd, vd, got, want
    return {"config": name, "shape": [B, S, H, hd], "keys": T,
            "kv_heads": KV, "causal": causal, "window": window, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": max(errs),
            "forward": {"ms": f_ms, "plain_ms": f_plain_ms,
                        "library_ms": f_lib_ms, "bound_ms": f_b_ms,
                        "bound_by": f_b_by, "max_abs_err": f_err}}


def train_kernels_phase(dev) -> list:
    """Phase 9a: both backward kernels against their plain backward on
    the card, gradient for gradient, timed beside their bounds (and the
    flash one beside scaled_dot_product_attention's backward and the FMA
    kernels on f32 copies of its main shape); every flash case's route
    checked (bf16 with hd % 8 == 0 on the tensor cores, f32 on the FMA
    kernels)."""
    import torch
    from torch.nn.functional import softplus
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.mamba2_scan import ops as so
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, S, T, H, KV, hd, dtype, causal, window)
        ("main bf16 causal", TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 80, bf16,
         True, None),
        ("bf16 ragged S=1000", 1, 1000, 1000, 32, 32, 80, bf16, True, None),
        ("bf16 GQA 32/8", 1, 2048, 2048, 32, 8, 80, bf16, True, None),
        ("f32 hd16", 1, 2048, 2048, 32, 32, 16, f32, True, None),
        ("f32 hd128", 1, 2048, 2048, 32, 32, 128, f32, True, None),
        ("ragged S=1000", 1, 1000, 1000, 32, 32, 80, f32, True, None),
        ("causal=False", 1, 2048, 2048, 32, 32, 80, f32, False, None),
        ("window=512", 1, 2048, 2048, 32, 32, 80, f32, True, 512),
        ("GQA 32/8", 1, 2048, 2048, 32, 8, 80, f32, True, None),
    ] + [c[:7] + (bf16,) + c[7:] for c in FAMILY_BWD]
    flash_err, family = 0.0, []
    for name, B, S, T, H, KV, hd, dtype, causal, window in cases:
        q, dout = randn(B, S, H, hd, dtype=dtype), randn(B, S, H, hd,
                                                          dtype=dtype)
        k, v = randn(B, T, KV, hd, dtype=dtype), randn(B, T, KV, hd,
                                                       dtype=dtype)
        _, lse, out32 = fo._launch(q, k, v, causal, window, lse=True)
        got = fo.attention_bwd(q, k, v, dout, lse, causal=causal,
                               window=window, out32=out32)
        route = fo.last_bwd_route()
        want_route = "wgmma" if dtype == torch.bfloat16 else "fma"
        check(route == want_route, f"flash backward {name}: took the "
              f"{route} route, expected {want_route}")
        want = attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        errs = []
        for gname, a, w in zip(("dq", "dk", "dv"), got, want):
            err = float((a.float() - w.float()).abs().max())
            errs.append(err)
            check(bool(torch.allclose(a.float(), w.float(), rtol=tol,
                                      atol=tol)),
                  f"flash backward {name} {gname}: max abs err {err:.3g} "
                  f"over {tol}")
            if dtype == torch.bfloat16:
                check(bool(torch.allclose(a.float(), w.float(),
                                          rtol=2.0 ** -6, atol=1e-5)),
                      f"flash backward {name} {gname}: an element is off "
                      f"by more than two bf16 steps of itself")
        print(f"[train-kernels] flash backward {name} (B={B}, S={S}, T={T}, "
              f"H={H}, KV={KV}, hd={hd}, {str(dtype)[6:]}, causal={causal}, "
              f"window={window}), {route} route: max abs err dq/dk/dv "
              f"{[float(f'{e:.3g}') for e in errs]} within {tol}"
              + (" and two bf16 steps" if dtype == torch.bfloat16 else ""))
        flash_err = max(flash_err, *errs)
        if name in FAMILY_NAMES or name.startswith("main"):
            timed = family_bwd_time(name, q, k, v, dout, lse, out32, causal,
                                    window, errs)
            if name in FAMILY_NAMES:
                family.append(timed)
        if name.startswith("main"):
            # the FMA kernels (the f32 route, and before the tensor-core
            # route the bf16 one) on f32 copies of the same inputs, in
            # the same call
            qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
            _, lse_f, _ = fo._launch(qf, kf, vf, causal, window, lse=True)
            fo._launch_bwd(qf, kf, vf, df, lse_f, causal, window)
            check(fo.last_bwd_route() == "fma",
                  "the f32 copies did not take the FMA route")
            fma_ms = cuda_ms(lambda: fo._launch_bwd(qf, kf, vf, df, lse_f,
                                                    causal, window), reps=2)
            del qf, kf, vf, df, lse_f
            main = dict(timed, route=route, fma_f32_ms=fma_ms)
            print(f"[train-kernels] flash backward main shape, {route} route;"
                  f" the FMA kernels on f32 copies of the same inputs "
                  f"{fma_ms:.4f} ms")
        del q, k, v, dout, lse, got, want
        torch.cuda.empty_cache()

    ssd_err, ssd_main = 0.0, None
    for G, L, H, P, N in [(128, 64, 80, 64, 64), (6, 64, 8, 64, 64),
                          (3, 40, 5, 16, 16), (2, 64, 3, 50, 70),
                          (1, 64, 80, 64, 64), (7, 64, 13, 64, 64),
                          (9, 1, 4, 64, 64), (4, 17, 6, 32, 16),
                          (3, 64, 5, 128, 128), (3, 48, 6, 64, 70),
                          (2, 33, 4, 7, 5)]:
        x, dy = randn(G, L, H, P), randn(G, L, H, P)
        dt = softplus(randn(G, L, H))
        cum = torch.cumsum(-softplus(randn(G, L, H)), dim=1)
        Bm, Cm = randn(G, L, N), randn(G, L, N)
        got = so.ssd_intra_chunk_bwd(x, dt, cum, Bm, Cm, dy)
        want = intra_chunk_bwd_ref(x, dt, cum, Bm, Cm, dy)
        torch.cuda.synchronize()
        errs = []
        for gname, a, w in zip(("dx", "ddt", "dcum", "dB", "dC"), got, want):
            err = float((a - w).abs().max())
            errs.append(err)
            check(bool(torch.allclose(a, w, rtol=1e-4, atol=1e-4)),
                  f"SSD backward (G={G}, L={L}, H={H}, P={P}, N={N}) "
                  f"{gname}: max abs err {err:.3g} over 1e-4")
        print(f"[train-kernels] SSD backward (G={G}, L={L}, H={H}, P={P}, "
              f"N={N}): max abs err dx/ddt/dcum/dB/dC "
              f"{[float(f'{e:.3g}') for e in errs]} within rtol = atol = "
              f"1e-4")
        ssd_err = max(ssd_err, *errs)
        if ssd_main is None:
            ms = cuda_ms(lambda: so._launch_bwd(x, dt, cum, Bm, Cm, dy),
                         reps=10)
            plain_ms = cuda_ms(lambda: intra_chunk_bwd_ref(
                x, dt, cum, Bm, Cm, dy), reps=3)
            b_ms, b_by = ssd_bwd_bound(G, L, H, P, N)
            ssd_main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, shape=[G, L, H, P, N])
            print(f"[train-kernels] SSD backward main shape: kernel "
                  f"{ms:.4f} ms (1 launch), plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.1f}x the bound")
        del x, dy, dt, cum, Bm, Cm, got, want
    torch.cuda.empty_cache()
    return [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
         "launches": None, "max_abs_err": flash_err, "ms": main["ms"],
         "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": main["bound_by"], "library_ms": main["library_ms"],
         "shape": main["shape"], "dtype": "bfloat16", "causal": True,
         "kernels_a_call": 2, "route_taken": main["route"],
         "fma_f32_ms": main["fma_f32_ms"], "family_shapes": family},
        {"name": "ssd_intra_chunk_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba2_scan/csrc/"
                   "ssd_intra_chunk_bwd.cu",
         "replaces": "src/repro/kernels/mamba2_scan/kernel.py:56",
         "launches": None, "max_abs_err": ssd_err, "ms": ssd_main["ms"],
         "plain_ms": ssd_main["plain_ms"], "bound_ms": ssd_main["bound_ms"],
         "bound_by": ssd_main["bound_by"], "library_ms": None,
         "shape": ssd_main["shape"], "kernels_a_call": 1},
    ]


def _train_launches():
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.mamba2_scan import ops as so
    return {"flash_attention": fo.attention.launches,
            "flash_attention_bwd": fo.attention_bwd.launches,
            "ssd_intra_chunk": so.ssd_intra_chunk.launches,
            "ssd_intra_chunk_bwd": so.ssd_intra_chunk_bwd.launches}


def _zero_launches():
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.mamba2_scan import ops as so
    fo.attention.launches = fo.attention_bwd.launches = 0
    so.ssd_intra_chunk.launches = so.ssd_intra_chunk_bwd.launches = 0


def train_depth6_phase(dev) -> None:
    """Phase 9c: two training steps on the card against the same on the
    host: full width cut to 6 layers, f32, the same weights, batch 1 x
    256 tokens; loss, grad_norm and every parameter at 1e-3."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH).replace(n_layers=6, dtype="float32")
    train_card_vs_host(dev, cfg, seq=256, tol=1e-3, what="train-depth6",
                       seed=3)


def train_restart_phase(dev, work: Path, arch: str = ARCH,
                        tag: str = "train-restart") -> None:
    """Phases 9d and 13d: the trainer killed at step 4 (exit 42) and
    resumed from its checkpoint on the card replays steps 5-8 of an
    uninterrupted run at 1e-5 (the smoke configuration)."""
    from repro_torch.launch import train

    base = ["--arch", arch, "--smoke", "--device", "cuda", "--steps", "8",
            "--batch", "4", "--seq", "64", "--ckpt-every", "4",
            "--log-every", "100"]
    whole = train.main(base + ["--ckpt-dir", str(work / f"{arch}_a")])
    code = None
    try:
        train.main(base + ["--ckpt-dir", str(work / f"{arch}_b"),
                           "--simulate-failure", "4"])
    except SystemExit as e:
        code = e.code
    check(code == 42, f"--simulate-failure 4 exited {code}, not 42")
    resumed = train.main(base + ["--ckpt-dir", str(work / f"{arch}_b")])
    check([h["step"] for h in resumed] == [5, 6, 7, 8],
          f"the resumed run ran steps {[h['step'] for h in resumed]}")
    by_step = {h["step"]: h["loss"] for h in whole}
    for h in resumed:
        want = by_step[h["step"]]
        check(abs(h["loss"] - want) <= 1e-5 * abs(want),
              f"resumed step {h['step']}: loss {h['loss']!r} against the "
              f"uninterrupted {want!r} (rtol 1e-5)")
    print(f"[{tag}] smoke {arch} on the card: killed after step 4 "
          f"(exit 42), resumed from its checkpoint; steps 5-8 losses "
          f"{[h['loss'] for h in resumed]} equal the uninterrupted run's "
          f"{[by_step[s] for s in (5, 6, 7, 8)]} within rtol 1e-5")


# training every non-hybrid family (phases 13-13d): llama3.2-1b at full
# width and depth, this slice's main path; the other configs at full
# width, cut in depth where their f32 parameters, gradients and two
# moments (16 bytes a parameter) would not leave room for activations on
# the card: (config, batch, tokens, steps, cut)
TRAIN_FAMILY = [
    ("whisper-small", 2, 448, 2, None),
    ("granite-moe-1b-a400m", 1, 2048, 2, None),
    ("olmo-1b", 2, 2048, 2, None),
    ("smollm-360m", 2, 2048, 2, None),
    ("qwen2-vl-7b", 1, 2048, 2, "fit"),
    ("starcoder2-15b", 1, 2048, 2, "fit"),
    ("mixtral-8x22b", 1, 2048, 2, "fit"),
    ("xlstm-350m", 1, 128, 2, 2),     # its per-token loop is host-bound
]
# GiB of f32 parameters, gradients and moments a cut may hold
TRAIN_STATE_GIB = 60
TRAIN_CARD_HOST = ("llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b",
                   "whisper-small", "xlstm-350m")
TRAIN_SMOKE = ("llama3.2-1b", "granite-moe-1b-a400m", "qwen2-vl-7b",
               "olmo-1b", "smollm-360m", "starcoder2-15b", "mixtral-8x22b",
               "whisper-small", "xlstm-350m")


def attention_calls(cfg) -> int:
    """Full-sequence attention calls a forward: a layer's for the
    decoder-only families, the encoder's and each decoder layer's self-
    and cross-attention for the encoder-decoder, the shared block's for
    the hybrid, none for the xLSTM."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def fitting_depth(cfg, gib: float) -> int:
    """The most layers whose f32 parameters, gradients and two moments
    fit in ``gib`` GiB (parameters counted on the meta device)."""
    import torch
    from repro_torch.models import make_model

    def count(n):
        p = make_model(cfg.replace(n_layers=n), device="meta").init(
            torch.Generator())
        return sum(t.numel() for t in p.parameters())
    one, two = count(1), count(2)
    per, base = two - one, 2 * one - two
    return max(1, min(cfg.n_layers,
                      int((gib * 2 ** 30 / 16 - base) // per)))


def train_family(dev, work: Path, arch: str, *, batch: int, seq: int,
                 steps: int, n_layers=None, tag: str) -> dict:
    """Phases 9b, 13 and 13b: ``launch.train.main`` on ``arch`` at full
    width (depth cut to ``n_layers`` if given), seeded weights, bf16
    activations, f32 parameters and moments, the config's remat;
    ``steps`` AdamW steps of ``batch`` x ``seq`` tokens.  Checks finite
    loss, nll and grad_norm, every parameter changed and the exact
    launches a step: flash once a full-sequence attention call, twice
    under remat, and its backward (two kernels) once; the SSD kernel
    likewise once a Mamba2 layer (the hybrid's), its backward once.
    Returns the numbers."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import make_model

    full = get_config(arch)
    cfg = full if n_layers is None else full.replace(n_layers=n_layers)
    check(cfg.dtype == "bfloat16", f"{arch}: dtype {cfg.dtype}")
    argv = ["--arch", arch, "--device", "cuda", "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--ckpt-every", "0",
            "--log-every", "1", "--ckpt-dir", str(work / f"train_{arch}")]
    get = train.get_config
    if n_layers is not None:
        train.get_config = lambda name: get(name).replace(n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        history, state = train.main(argv, return_state=True)
    finally:
        train.get_config = get
    wall = time.perf_counter() - t0
    launches = _train_launches()
    peak = torch.cuda.max_memory_allocated()
    calls = attention_calls(cfg)
    mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    runs = 1 if cfg.remat == "none" else 2
    want = {"flash_attention": calls * runs,
            "flash_attention_bwd": calls * 2,
            "ssd_intra_chunk": mamba * runs, "ssd_intra_chunk_bwd": mamba}
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[{tag}] {arch}: launches in {steps} steps {launches}; a step "
          f"{per_step} (expected {want}: {calls} full-sequence attention "
          f"calls and {mamba} Mamba2 layers, each forward run {runs} "
          f"times under remat {cfg.remat!r}, two flash backward kernels a "
          f"call)")
    check(per_step == want, f"{arch} training launches a step {per_step}, "
          f"expected {want}")
    check(len(history) == steps, f"{arch}: {len(history)} steps recorded")
    for h in history:
        check(all(math.isfinite(h[k]) for k in ("loss", "nll", "grad_norm")),
              f"{arch} step {h['step']}: non-finite loss, nll or grad_norm "
              f"{h}")
    n_params = sum(p.numel() for p in state.params.parameters())
    fresh = make_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    unchanged = [n for (n, a), b in zip(state.params.named_parameters(),
                                        fresh.parameters())
                 if torch.equal(a.detach(), b)]
    check(not unchanged, f"{arch}: parameters unchanged by training: "
          f"{unchanged[:4]}")
    del fresh, state
    torch.cuda.empty_cache()
    steady = sorted(h["time_s"] for h in history[1:])
    step_s = steady[len(steady) // 2]
    tokens = batch * seq
    for h in history:
        print(f"[{tag}] {arch} step {h['step']}: loss {h['loss']:.6f} nll "
              f"{h['nll']:.6f} grad_norm {h['grad_norm']:.6f} lr "
              f"{h['lr']:.3g} {h['time_s'] * 1e3:.1f} ms "
              f"({tokens / h['time_s']:.1f} tokens/s)")
    check(peak < 75 * 2 ** 30, f"{arch}: peak memory {peak / 2**30:.2f} GiB "
          f"over 75 GiB")
    cut = ("" if n_layers is None else
           f", cut from {full.n_layers} layers (16 bytes a parameter: "
           f"{n_params * 16 / 2**30:.1f} GiB of f32 parameters, gradients "
           f"and moments)")
    extra = (f", {cfg.enc_seq} seeded frames a sequence"
             if cfg.family == "encdec" else
             f", {cfg.n_patches} seeded patch embeds and M-RoPE positions a "
             f"sequence" if cfg.family == "vlm" else "")
    print(f"[{tag}] {arch} at full width, {cfg.n_layers} layers{cut}, "
          f"d_model {cfg.d_model}, {n_params} parameters, batch {batch} x "
          f"{seq} tokens{extra}, remat {cfg.remat}, bf16 activations, f32 "
          f"parameters and moments: {steps} steps in {wall:.1f} s, every "
          f"parameter changed; median step (2-{steps}) {step_s * 1e3:.1f} "
          f"ms, {tokens / step_s:.1f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    return {"arch": arch, "layers": cfg.n_layers, "launches": launches,
            "step_ms": step_s * 1e3, "tokens_s": tokens / step_s,
            "peak_gib": peak / 2 ** 30, "remat": cfg.remat}


def train_families_phase(dev, work: Path) -> dict:
    """Phases 13 and 13b: llama3.2-1b at full width and depth (this
    slice's main path), then every other non-hybrid config."""
    from repro_torch.configs import get_config

    t = time.perf_counter()
    cfg = get_config(LM_ARCH)
    check(cfg.remat == "dots", f"{LM_ARCH}: remat {cfg.remat}")
    main = train_family(dev, work, LM_ARCH, batch=TRAIN_B, seq=TRAIN_S,
                        steps=TRAIN_STEPS, tag="train-llama")
    print(f"[train-llama] phase 13 wall {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    others = []
    for arch, batch, seq, steps, cut in TRAIN_FAMILY:
        if cut == "fit":
            cut = fitting_depth(get_config(arch), TRAIN_STATE_GIB)
        others.append(train_family(dev, work, arch, batch=batch, seq=seq,
                                   steps=steps, n_layers=cut,
                                   tag="train-families"))
    print(f"[train-families] phase 13b wall {time.perf_counter() - t:.1f} s")
    return {"main": main, "others": others}


def _train_batch(cfg, seq: int, batch: int, step: int, device):
    """Batch ``step`` of the trainer's seeded stream on ``device``; a vlm
    batch's patch embeds cover at most half its tokens."""
    import torch
    from repro_torch.data import make_stream
    b = make_stream(cfg, seq, batch, seed=0).batch_at(step)
    if "patch_embeds" in b:
        b["patch_embeds"] = b["patch_embeds"][:, :seq // 2]
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def train_card_vs_host(dev, cfg, *, seq: int, tol: float, what: str,
                       steps: int = 2, seed: int = 4) -> float:
    """``steps`` AdamW steps on the card against the same on the host,
    the same seeded weights, batches of 1 x ``seq`` tokens: the MoE's
    chosen experts first (every router call, forward and recomputation),
    then loss and grad_norm each step and every parameter after, at
    rtol = atol = ``tol``.  Returns the largest parameter difference."""
    import torch
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.train_step import TrainState, param_tree

    opt = AdamWConfig(lr=3e-4, warmup_steps=0, schedule="constant")
    p_dev = make_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    runs = []
    for model, params in ((make_model(cfg, device=dev), p_dev),
                          (make_model(cfg, device="cpu"),
                           copy.deepcopy(p_dev).to("cpu"))):
        params.requires_grad_(True)
        runs.append([model, make_train_step(model, opt),
                     TrainState(params, adamw_init(param_tree(params)),
                                None)])
    t_cpu, routed = 0.0, 0
    with _Routes() as routes:
        for step in range(steps):
            mets = []
            for side, run in zip(("card", "host"), runs):
                model, fn, st = run
                routes.side = side
                t = time.perf_counter()
                run[2], met = fn(st, _train_batch(cfg, seq, 1, step,
                                                  model.device))
                mets.append({k: float(v) for k, v in met.items()})
                if side == "host":
                    t_cpu += time.perf_counter() - t
            routed = routes.check_equal(f"{what} {cfg.name} step {step + 1}")
            for k in ("loss", "grad_norm"):
                check(abs(mets[0][k] - mets[1][k]) <= tol + tol * abs(
                    mets[1][k]), f"{what} {cfg.name} step {step + 1}: {k} "
                    f"card {mets[0][k]:.6f} host {mets[1][k]:.6f} (rtol = "
                    f"atol = {tol:g})")
    worst = 0.0
    for (n, a), b in zip(runs[0][2].params.named_parameters(),
                         runs[1][2].params.parameters()):
        a = a.detach().cpu()
        diff = float((a - b.detach()).abs().max())
        worst = max(worst, diff)
        check(bool(torch.allclose(a, b.detach(), rtol=tol, atol=tol)),
              f"{what} {cfg.name}: parameter {n} card and host differ by "
              f"{diff:.3g} (rtol = atol = {tol:g})")
    print(f"[{what}] {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, f32, remat {cfg.remat}: {steps} AdamW steps of "
          f"{seq} tokens, loss {mets[1]['loss']:.6f}, every parameter "
          f"within {tol:g} of the host's (max abs diff {worst:.3g})"
          + (f"; MoE experts equal in all {routed} router calls (forward "
             f"and recomputation)" if routed else "")
          + f"; host steps {t_cpu:.1f} s")
    del runs, p_dev
    torch.cuda.empty_cache()
    return worst


def train_dots_vs_none(dev) -> None:
    """llama3.2-1b at full width cut to 2 layers, f32, on the card: the
    loss and every gradient under remat "dots" against "none" at 1e-5."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.train.train_step import param_tree

    cfg = get_config(LM_ARCH).replace(n_layers=2, dtype="float32")
    state = make_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(5)).state_dict()
    out = {}
    for remat in ("none", "dots"):
        model = make_model(cfg.replace(remat=remat), device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        params.load_state_dict(state)
        params.requires_grad_(True)
        loss, _ = model.loss(params, _train_batch(cfg, 256, 2, 0, dev))
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(param_tree(params).values())))
        del params
    check(bool(torch.allclose(out["dots"][0], out["none"][0], rtol=1e-5,
                              atol=1e-5)),
          f"dots vs none: loss {float(out['dots'][0])} against "
          f"{float(out['none'][0])}")
    worst = 0.0
    for a, b in zip(out["dots"][1], out["none"][1]):
        worst = max(worst, float((a - b).abs().max()))
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
              f"dots vs none: a gradient differs by "
              f"{float((a - b).abs().max()):.3g}")
    print(f"[train-card-host] {LM_ARCH} 2 layers f32 on the card, 2 x 256 "
          f"tokens: remat 'dots' against 'none', loss and every gradient "
          f"within 1e-5 (max abs diff {worst:.3g})")
    del out
    torch.cuda.empty_cache()


def train_card_vs_host_phase(dev) -> None:
    """Phase 13c: full width cut to 2 layers (whisper 2 + 2), f32, TF32
    off, card against host at 1e-3; "dots" against "none" on the card at
    1e-5; then every smoke config at 1e-4."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    for arch in TRAIN_CARD_HOST:
        cfg = get_config(arch).replace(n_layers=2, dtype="float32")
        if cfg.family == "encdec":
            cfg = cfg.replace(n_enc_layers=2)
        train_card_vs_host(dev, cfg, seq=64, tol=1e-3,
                           what="train-card-host")
    train_dots_vs_none(dev)
    for arch in TRAIN_SMOKE:
        train_card_vs_host(dev, get_smoke_config(arch), seq=32, tol=1e-4,
                           what="train-card-host-smoke")
    print(f"[train-card-host] phase 13c wall {time.perf_counter() - t:.1f} s")


# the LM's multi-device pieces (phase 14): llama3.2-1b's full trunk
# pipelined over a 4-stage mesh, M microbatches of one sequence each; and
# compressed_psum over the mesh's 4 shards in llama3.2-1b's gradient shapes
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 2048


def stage_mesh(n: int):
    """A 1-d "stage" mesh of ``n`` entries: the first ``n`` cards where the
    machine has them, else cuda:0 repeated."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh

    if torch.cuda.device_count() >= n:
        return make_mesh((n,), ("stage",))
    return make_debug_mesh(n, ("stage",), device="cuda:0")


def pipeline_flash_case(dev, cfg) -> dict:
    """Phase 14: the flash kernel at the pipeline's shape, (1, PIPE_SEQ) tokens of
    llama3.2-1b bf16 causal, held to its plain version (2e-2 and two bf16
    steps of each element) on the tensor cores and timed beside the plain
    version, scaled_dot_product_attention and the bound."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels.flash_attention.ops import attention, last_route
    from repro_torch.kernels.flash_attention.ref import (attention_plain,
                                                         expand_kv)

    B, S, H, KV, hd = 1, PIPE_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(B, S, h, hd, device=dev, generator=gen
                           ).to(torch.bfloat16) for h in (H, KV, KV))
    got = attention(q, k, v, causal=True)
    ran = last_route()
    want = attention_plain(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(ran == "wgmma", f"pipeline flash shape took the {ran} route")
    check(bool(torch.allclose(got.float(), want.float(), rtol=2e-2,
                              atol=2e-2)
               and torch.allclose(got.float(), want.float(), rtol=2.0 ** -6,
                                  atol=1e-5)),
          f"flash at the pipeline's shape: max abs err {err:.3g}")
    ms = cuda_ms(lambda: attention(q, k, v, causal=True), reps=20)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True), reps=5)
    qt, kt, vt = q.transpose(1, 2), expand_kv(k, H), expand_kv(v, H)
    sdpa(qt, kt, vt, is_causal=True)
    lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=20)
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(2 * (2 * B * S * H * hd + 2 * B * S * KV * hd),
                       4 * B * H * hd * pairs, BF16_OPS_PER_S)
    print(f"[pipeline] flash at the pipeline's shape (B={B}, S={S}, H={H}, "
          f"KV={KV}, hd={hd}, bf16, causal), route {ran}: max abs err "
          f"{err:.3g} <= 2e-2 and within two bf16 steps; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"shape": [B, S, H, hd], "kv_heads": KV, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def pipeline_phase(dev) -> dict:
    """Phase 14, this slice's main path: llama3.2-1b's 16 decoder layers
    at full width (seeded weights, f32 parameters, bf16 activations)
    split into PIPE_STAGES stages of 4 on a "stage" mesh, PIPE_MICRO
    microbatches of (1, PIPE_SEQ) tokens' embeddings through
    ``pipeline_apply`` (each stage on its own stream), against the same
    trunk run microbatch by microbatch; exact flash launches (16 a
    microbatch, all on the tensor cores), both walls after a warm-up,
    the GPipe bubble and peak memory.  Then ``compressed_psum`` over the
    mesh's shards, one seeded f32 tensor a shard in each of llama3.2-1b's
    gradient shapes, held bit for bit to the same on the host, with the
    bytes on the wire against an f32 all-reduce's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.models import layers as L
    from repro_torch.models import make_model
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.train import compression as comp

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    check(cfg.dtype == "bfloat16", f"{LM_ARCH}: dtype {cfg.dtype}")
    S_, M = PIPE_STAGES, PIPE_MICRO
    mesh = stage_mesh(S_)
    devs = mesh.flat()
    params = make_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    per = cfg.n_layers // S_
    stages = [list(params.layers[s * per:(s + 1) * per]) for s in range(S_)]
    for s, layers in enumerate(stages):
        for layer in layers:
            layer.to(devs[s])
    positions = {d: torch.arange(PIPE_SEQ, dtype=torch.int32,
                                 device=d)[None] for d in mesh.distinct()}

    def stage_fn(layers, h):
        pos = positions[h.device]
        for layer in layers:
            h = layer(h, pos)[0]
        return h

    rng = np.random.default_rng(14)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (M, PIPE_SEQ)),
                             device=devs[0])
    run = pipeline_apply(stage_fn, mesh, n_microbatches=M)

    def sequential():
        outs = []
        for m in range(M):
            h = x[m]
            for s in range(S_):
                h = stage_fn(stages[s], h.to(devs[s]))
            outs.append(h.to(devs[0]))
        return torch.stack(outs)

    with torch.no_grad():
        x = L.embed_tokens(params.embed, cfg, tokens)[:, None]
        run(stages, x)
        sequential()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        y = run(stages, x)
        pipe_issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        launches = _train_launches()
        pipe_route = fo.last_route()     # the pipelined run's, not seq's
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        want = sequential()
        seq_issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    calls = cfg.n_layers * M
    print(f"[pipeline] launches in the pipelined run: {launches} (expected "
          f"{calls} flash: {cfg.n_layers} layers x {M} microbatches); flash "
          f"route {pipe_route}")
    check(launches == {"flash_attention": calls, "flash_attention_bwd": 0,
                       "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0},
          f"pipeline launches {launches}, expected {calls} flash")
    check(pipe_route == "wgmma", "the pipeline's attention did not run on "
          "the tensor cores")
    check(tuple(y.shape) == (M, 1, PIPE_SEQ, cfg.d_model)
          and y.device == devs[0] and y.dtype == torch.bfloat16,
          f"pipeline output {tuple(y.shape)} {y.dtype} on {y.device}")
    check(bool(torch.isfinite(y).all()), "non-finite pipeline output")
    bitwise = torch.equal(y, want)
    err = float((y.float() - want.float()).abs().max())
    if not bitwise:
        check(bool(torch.allclose(y.float(), want.float(), rtol=2e-2,
                                  atol=2e-2)),
              f"pipelined trunk against the sequential one: max abs err "
              f"{err:.3g} over the bf16 tolerance 2e-2")
    with torch.no_grad():
        logits = L.logits_from_hidden(params.embed, cfg,
                                      params.ln_f(y[:1, 0].to(dev)))
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "non-finite logits of the pipelined trunk")
    bubble = (S_ - 1) / (M + S_ - 1)
    tokens_n = M * PIPE_SEQ
    print(f"[pipeline] {LM_ARCH} trunk at full width and depth "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.hd}, kv {cfg.n_kv_heads}; seeded weights, bf16 "
          f"activations) over {S_} stages of {per} layers on "
          f"{[str(d) for d in devs]} ({torch.cuda.device_count()} visible "
          f"card(s)), {M} microbatches of (1, {PIPE_SEQ}) tokens: "
          + ("equal to the sequential trunk bit for bit" if bitwise else
             f"NOT bitwise equal to the sequential trunk (max abs err "
             f"{err:.3g}, within the bf16 tolerance 2e-2)")
          + f"; pipelined wall {pipe_s * 1e3:.1f} ms "
          f"({tokens_n / pipe_s:.1f} tokens/s; the host returned after "
          f"{pipe_issue * 1e3:.1f} ms), sequential wall "
          f"{seq_s * 1e3:.1f} ms ({tokens_n / seq_s:.1f} tokens/s; host "
          f"{seq_issue * 1e3:.1f} ms), "
          f"pipelined/sequential {pipe_s / seq_s:.3f}; GPipe bubble "
          f"(S-1)/(M+S-1) = {S_ - 1}/{M + S_ - 1} = {bubble:.4f}; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")
    del x, y, want, logits, stages, positions
    flash = pipeline_flash_case(dev, cfg)

    # compressed_psum: one seeded f32 tensor a shard in each gradient shape
    shapes = [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    del params
    torch.cuda.empty_cache()
    n_el = sum(int(np.prod(s)) for _, s in shapes)
    gens = [torch.Generator(device=d).manual_seed(100 + i)
            for i, d in enumerate(devs)]
    card_s = host_s = 0.0
    wire = f32_wire = 0
    torch.cuda.reset_peak_memory_stats()
    for name, shape in shapes:
        xs = [torch.randn(shape, device=d, generator=g) * 1e-3
              for d, g in zip(devs, gens)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = comp.compressed_psum(xs)
        torch.cuda.synchronize()
        card_s += time.perf_counter() - t0
        host_in = [t.cpu() for t in xs]
        t0 = time.perf_counter()
        host = comp.compressed_psum(host_in)
        host_s += time.perf_counter() - t0
        check(all(g.device == d for g, d in zip(got, devs)),
              f"compressed_psum {name}: a result off its shard's device")
        check(torch.equal(got[0].cpu(), host[0]) and all(
            torch.equal(g, got[0].to(g.device)) for g in got[1:]),
            f"compressed_psum {name} {shape}: the card's result differs "
            f"from the host's")
        n = int(np.prod(shape))
        blocks = -(-n // comp.BLOCK)
        wire += len(xs) * blocks * (comp.BLOCK + 4)
        f32_wire += len(xs) * n * 4
        del xs, got, host_in, host
    psum_peak = torch.cuda.max_memory_allocated()
    print(f"[pipeline] compressed_psum over {len(devs)} shards, "
          f"{len(shapes)} tensors in {LM_ARCH}'s gradient shapes "
          f"({n_el} elements a shard, seeded f32): equal to the host's run "
          f"bit for bit; card {card_s * 1e3:.1f} ms, host "
          f"{host_s * 1e3:.1f} ms; on the wire {wire} bytes (int8 payload "
          f"and an f32 scale a block of {comp.BLOCK}) against {f32_wire} "
          f"for an f32 all-reduce ({f32_wire / wire:.3f}x fewer); "
          f"max_memory_allocated {psum_peak / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    print(f"[pipeline] phase 14 wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "pipe_ms": pipe_s * 1e3,
            "seq_ms": seq_s * 1e3, "pipe_issue_ms": pipe_issue * 1e3,
            "seq_issue_ms": seq_issue * 1e3, "bitwise": bitwise, "max_abs_err": err,
            "bubble": bubble, "peak_gib": peak / 2 ** 30, "flash": flash,
            "psum_card_ms": card_s * 1e3, "psum_host_ms": host_s * 1e3,
            "wire_bytes": wire, "f32_wire_bytes": f32_wire,
            "psum_elements": n_el}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.apps import conv, mibench
    from repro_torch.core import dse, hwconfig, isa
    from repro_torch.core.cgra import run_program
    from repro_torch.core.characterization import characterize
    from repro_torch.core.program import bucket_programs
    from repro_torch.kernels import _build
    from repro_torch.kernels.cgra_step.ops import alu_dispatch
    from repro_torch.kernels.cgra_step.ref import alu_ref
    from repro_torch.kernels.cgra_sweep.ops import (kernel_attributes,
                                                    sweep_engine)
    from repro_torch.kernels.cgra_sweep.ref import init_lanes, sweep_ref

    dev = torch.device("cuda")
    topos = [hwconfig.TOPOLOGIES[t]() for t in sorted(hwconfig.TOPOLOGIES)]
    # checkpoints, outputs and an empty autotune cache of this run's own,
    # inside the checkout: AUTO knobs resolve to the static defaults
    # until phase 4c tunes the campaign
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                       dir=ROOT / "build")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(work.name) / "autotune.json")

    # ---- 1. device and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _build.build_all()
    print(f"[build] all {len(_build.SOURCES)} kernel libraries ready in "
          f"{time.perf_counter() - t:.3f} s; cgra_sweep kernel "
          f"{kernel_attributes()}")
    build_report(_build)

    # ---- 2. alu_dispatch vs alu_ref --------------------------------------
    rng = np.random.default_rng(0)
    shape = (1 << 20, 16)
    ops = rng.integers(0, isa.N_OPS, shape).astype(np.int32)
    a = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    b = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    edge = np.array([-2**31, 2**31 - 1, -1, 0, 1, 31, 32, -33])
    a[:4096] = rng.choice(edge, (4096, 16))
    b[:4096] = rng.choice(edge, (4096, 16))
    ops, a, b = (torch.as_tensor(x.astype(np.int32), device=dev)
                 for x in (ops, a, b))
    got = alu_dispatch(ops, a, b)
    want = alu_ref(ops, a, b)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "alu_dispatch differs from alu_ref")
    alu_err = float((got.long() - want.long()).abs().max())
    alu_ms = cuda_ms(lambda: alu_dispatch(ops, a, b), reps=20)
    alu_plain_ms = cuda_ms(lambda: alu_ref(ops, a, b), reps=5)
    n_el = ops.numel()
    alu_bound = max(4 * 4 * n_el / HBM_BYTES_PER_S,
                    ALU_I32_OPS_PER_ELEMENT * n_el / I32_OPS_PER_S) * 1e3
    print(f"[alu_dispatch] {shape}: bit-identical; kernel {alu_ms:.4f} ms, "
          f"plain {alu_plain_ms:.4f} ms, bound {alu_bound:.4f} ms (bytes)")
    # the main path's shape: core/cgra.py launches it once a simulated
    # step, on the 16 PEs of one instruction
    o1, a1, b1 = (x[:1].contiguous() for x in (ops, a, b))
    check(torch.equal(alu_dispatch(o1, a1, b1), alu_ref(o1, a1, b1)),
          "alu_dispatch differs from alu_ref at (1, 16)")
    alu_step_ms = cuda_ms(lambda: alu_dispatch(o1, a1, b1), reps=200)
    alu_host_ms = host_ms(lambda: alu_dispatch(o1, a1, b1))
    alu_dev_ms = device_ms(lambda: alu_dispatch(o1, a1, b1), reps=200)
    alu_step_bound = max(4 * 4 * 16 / HBM_BYTES_PER_S,
                         ALU_I32_OPS_PER_ELEMENT * 16 / I32_OPS_PER_S) * 1e3
    print(f"[alu_dispatch] (1, 16), the main path's shape: {alu_step_ms:.5f}"
          f" ms a call back to back (events), host {alu_host_ms:.5f} ms a "
          f"call, device {alu_dev_ms:.5f} ms a launch (queued behind a "
          f"sleep), bound {alu_step_bound:.3g} ms (bytes)")

    # ---- 3. cgra_sweep vs sweep_ref on the card --------------------------
    def engine_inputs(batch, prof, hws, images):
        plan = dse.plan_grid(batch, hws, images, device=dev)
        tables = dse.sweep_tables(plan.batch, prof, dev)
        mem = plan.images[torch.as_tensor(plan.img_idx, device=dev).long()]
        gidx = torch.as_tensor(plan.prog_idx, device=dev)
        return tables, plan.hw_grid, gidx, mem

    def compare_engines(inputs, max_steps, what, t_clk):
        """Kernel and plain version on the same inputs; returns (max abs
        energy error in pJ, max relative energy error, kernel ms, plain
        ms, lanes, executed lane-steps, the plain version's state)."""
        tables, hw, gidx, mem = inputs
        states, times = [], []
        for run in (sweep_engine, sweep_ref):
            st = init_lanes(mem.clone(), 16)
            times.append(cuda_ms(lambda: run(
                tables, hw, gidx, st, rows=4, cols=4, max_steps=max_steps,
                chunk_steps=64)))
            states.append(st)
        kern, plain = states
        for f in kern._fields:
            if f != "e_acc":
                check(torch.equal(getattr(kern, f), getattr(plain, f)),
                      f"{what}: kernel {f} differs from the plain version")
        e_k, e_p = kern.e_acc.double(), plain.e_acc.double()
        rel = float(((e_k - e_p).abs() / e_p.abs().clamp(min=1e-30)).max())
        check(rel <= 1e-5, f"{what}: energy rel err {rel:.3g} > 1e-5")
        abs_pj = float((e_k - e_p).abs().max()) * t_clk * 1e-3
        return (abs_pj, rel, times[0], times[1], mem.shape[0],
                int(kern.n_exec.sum()), plain)

    prof_cuda_t = time.perf_counter()
    prof = characterize(device=dev)
    prof_cuda_t = time.perf_counter() - prof_cuda_t
    ks = mibench.all_kernels()
    r = compare_engines(engine_inputs(
        [k.program for k in ks], prof, topos,
        np.stack([k.mem_init for k in ks])), 2048, "mibench grid",
        prof.t_clk_ns)
    print(f"[cgra_sweep] 5 MiBench x 5 topologies x 5 images (B={r[4]}): "
          f"integers bit-identical, energy max rel err {r[1]:.3g}; "
          f"kernel {r[2]:.3f} ms, plain {r[3]:.3f} ms")
    im2col = conv.all_mappings()[2]
    r2 = compare_engines(engine_inputs(
        [im2col.program], prof, topos, im2col.mem_init[None]), 9000,
        "Im2col-OP", prof.t_clk_ns)
    print(f"[cgra_sweep] Im2col-OP x 5 topologies (B={r2[4]}): integers "
          f"bit-identical, energy max rel err {r2[1]:.3g}; kernel "
          f"{r2[2]:.3f} ms, plain {r2[3]:.3f} ms")

    # ---- 4. the main path -------------------------------------------------
    mappings = conv.all_mappings()
    progs = [m.program for m in mappings]
    names = [m.name for m in mappings]
    # every mapping keeps the layer in one memory layout, so
    # all_mappings(seed)[0].mem_init (= conv_wp(seed).mem_init) is the
    # seed's image for all four.  The programs are the default (seed 7)
    # ones; Im2col-IP carries that seed's weights as immediates, so on
    # other layers it runs the same schedule with those weights.
    D = 256
    images = np.stack([conv.conv_wp(seed).mem_init for seed in range(D)])
    hws, hw_names = [], []
    for t in sorted(hwconfig.TOPOLOGIES):
        for smul_lat in (1, 3):
            for n_banks in (2, 4, 8, 16):
                hws.append(hwconfig.TOPOLOGIES[t]().replace(
                    smul_lat=smul_lat, n_banks=n_banks))
                hw_names.append(f"{t}/smul{smul_lat}/banks{n_banks}")
    G, H = len(progs), len(hws)
    B = G * H * D
    print(f"[main] {G} conv mappings x {H} hardware configs x {D} layers "
          f"= {B} design points, {B * images.shape[1] * 4 / 1e6:.0f} MB "
          f"of memory images on the device")

    alu_dispatch.launches = 0
    sweep_engine.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof_main = characterize(device=dev)
    t1 = time.perf_counter()
    res = dse.sweep(programs=progs, profile=prof_main, hw_configs=hws,
                    mem_images=images, max_steps=MAIN_MAX_STEPS, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"alu_dispatch": alu_dispatch.launches,
                "cgra_sweep": sweep_engine.launches}
    print(f"[main] launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")

    lat, energy, power, checksum, steps = res
    for x in res:
        check(tuple(x.shape) == (B,) and x.device.type == "cuda",
              "result shape or device")
    check(bool(torch.isfinite(energy).all() and torch.isfinite(power).all()),
          "non-finite energy or power")
    check(bool((steps > 0).all() and (steps < MAIN_MAX_STEPS).all()),
          "a design point did not run to EXIT")
    check(bool((energy > 0).all() and (lat >= steps).all()),
          "non-positive energy or latency below the step count")
    lane_steps = int(steps.long().sum())
    wall = t2 - t1
    print(f"[main] characterize on the card {t1 - t0:.3f} s; sweep wall "
          f"{wall:.3f} s: {B / wall:.1f} design points/s, "
          f"{lane_steps / wall:.4g} executed lane-steps/s "
          f"({lane_steps} lane-steps)")
    e_mean = energy.view(G, H, D).double().mean(2)
    l_mean = lat.view(G, H, D).double().mean(2)
    for what, grid, unit in (("energy", e_mean, "pJ"),
                             ("latency", l_mean, "cc")):
        g, h = divmod(int(grid.argmin()), H)
        print(f"[main] best by mean {what}: {names[g]} on {hw_names[h]} "
              f"({float(grid[g, h]):.6g} {unit})")

    # the profile on the card equals the host's, field by field
    prof_cpu = characterize(device="cpu")
    for f in type(prof_cpu).__dataclass_fields__:
        check(np.array_equal(np.asarray(getattr(prof_main, f)),
                             np.asarray(getattr(prof_cpu, f))),
              f"profile field {f} differs between the card and the host")

    # right answers on small inputs: each mapping's own layer (seed 7)
    # through the simulator on the card, held to the conv oracle, and the
    # sweep lane of the same design point held to the simulator
    h_base = hw_names.index("baseline/smul3/banks4")
    weights = (torch.arange(images.shape[1], device=dev) | 1).long()
    conv_traces = []
    for g, case in enumerate(mappings):
        final, trace = run_program(case.program, case.mem_init,
                                   hwconfig.baseline(),
                                   max_steps=MAIN_MAX_STEPS, device=dev)
        conv_traces.append((case, trace))
        check(case.check(final.mem.cpu().numpy()),
              f"{case.name}: wrong convolution output")
        lane = (g * H + h_base) * D + 7
        want_sum = int(((final.mem.long() * weights).sum()) & 0xFFFFFFFF)
        check(int(lat[lane]) == int(final.t_cc)
              and (int(checksum[lane]) & 0xFFFFFFFF) == want_sum,
              f"{case.name}: sweep lane differs from the simulator")
    print("[main] conv oracle holds for all 4 mappings on layer 7; their "
          "sweep lanes equal the simulator")

    # every lane of the main path: kernel vs plain version, per bucket
    buckets = bucket_programs(progs, 4)
    main_err = main_rel = kern_ms = plain_ms = 0.0
    for bi, batch in enumerate(buckets.batches):
        r3 = compare_engines(engine_inputs(batch, prof_main, hws, images),
                             MAIN_MAX_STEPS, f"main bucket {bi}",
                             prof_main.t_clk_ns)
        main_err, main_rel = max(main_err, r3[0]), max(main_rel, r3[1])
        kern_ms += r3[2]
        plain_ms += r3[3]
        print(f"[main] bucket {bi} {[names[g] for g in buckets.groups[bi]]}"
              f" (B={r3[4]}): kernel == plain, energy max rel err "
              f"{r3[1]:.3g}; kernel {r3[2]:.3f} ms, plain {r3[3]:.3f} ms")

    # ---- 4b. reduction, mapping search, estimator --------------------------
    def compare_lanes(batch, imgs, max_steps, what):
        return compare_engines(engine_inputs(batch, prof_main, hws, imgs),
                               max_steps, what, prof_main.t_clk_ns)

    analysis = analysis_phase(dev, prof_main, progs, hws, hw_names, images,
                              res, wall, conv_traces, compare_lanes)

    # ---- 4c. the crash-safe sweep service, autotune -----------------------
    service = service_phase(dev, prof_main, progs, hws, images, res, wall,
                            Path(work.name))

    # ---- 4d. the sweep split across devices ---------------------------------
    mesh = mesh_phase(dev, prof_main, progs, hws, images, res, wall,
                      Path(work.name))

    # ---- 5-8. the language-model kernels and the serving path -------------
    flash_entry = flash_phase(dev)
    ssd_entry = ssd_phase(dev)
    serve_stats = serve_phase(dev)
    flash_entry["launches"] = serve_stats["flash_attention"]
    ssd_entry["launches"] = serve_stats["ssd_intra_chunk"]
    depth6_phase(dev)

    # ---- 9. training: the backward kernels, the main path, card vs host,
    # restart ------------------------------------------------------------------
    bwd_entries = train_kernels_phase(dev)
    trained = train_family(dev, Path(work.name), ARCH, batch=TRAIN_B,
                           seq=TRAIN_S, steps=TRAIN_STEPS, tag="train")
    for entry in (flash_entry, ssd_entry, *bwd_entries):
        entry["train_launches"] = trained["launches"][entry["name"]]
    for entry in bwd_entries:
        entry["launches"] = trained["launches"][entry["name"]]
    train_depth6_phase(dev)
    train_restart_phase(dev, Path(work.name))

    # ---- 10. the transformer families: llama3.2-1b (this slice's main
    # path), the other six configs, card against host ----------------------
    served = families_phase(dev)
    flash_entry["zamba2_launches"] = flash_entry["launches"]
    flash_entry["launches"] = served["main"]["flash_attention"]
    flash_entry["family_launches"] = {
        st["arch"]: st["flash_attention"] for st in served["others"]}
    families_card_vs_host_phase(dev)

    # ---- 11. the last two families: whisper-small (this slice's main
    # path), xlstm-350m, card against host -------------------------------
    last = last_families_phase(dev)
    flash_entry["llama_launches"] = flash_entry["launches"]
    flash_entry["launches"] = last["whisper"]["flash_attention"]
    last_families_card_vs_host_phase(dev)

    # ---- 13. training every non-hybrid family: llama3.2-1b (this slice's
    # main path), the other configs, card against host, restart ----------
    trained_families = train_families_phase(dev, Path(work.name))
    llama_train = trained_families["main"]["launches"]
    flash_entry["whisper_launches"] = flash_entry["launches"]
    for entry in (flash_entry, bwd_entries[0]):
        entry["zamba2_train_launches"] = entry.pop("train_launches")
        entry["family_train_launches"] = {
            st["arch"]: st["launches"][entry["name"]]
            for st in trained_families["others"]}
        entry["launches"] = llama_train[entry["name"]]
    # the main path's shape, llama's (2, 4096, 32, 64) kv 8, in the
    # top-level numbers; the earlier main shapes beside them
    llama = bwd_entries[0]["family_shapes"][0]
    for entry, numbers in ((flash_entry, llama["forward"]),
                           (bwd_entries[0], llama)):
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        entry["zamba2_shape"] = {k: entry[k] for k in keys}
        entry.update({k: numbers[k] for k in keys[1:]},
                     shape=llama["shape"], kv_heads=llama["kv_heads"],
                     max_abs_err=max(entry["max_abs_err"],
                                     numbers["max_abs_err"]))
    train_card_vs_host_phase(dev)
    train_restart_phase(dev, Path(work.name), LM_ARCH, "train-restart-llama")

    # ---- 14. the LM's multi-device pieces: llama3.2-1b's trunk through
    # pipeline_apply on a 4-stage mesh (this slice's main path),
    # compressed_psum ------------------------------------------------------
    pipe = pipeline_phase(dev)
    flash_entry["llama_train_launches"] = flash_entry["launches"]
    flash_entry["launches"] = pipe["launches"]["flash_attention"]
    keys = ("shape", "kv_heads", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    flash_entry["llama_train_shape"] = {k: flash_entry[k] for k in keys}
    flash_entry.update({k: pipe["flash"][k] for k in keys},
                       max_abs_err=max(flash_entry["max_abs_err"],
                                       pipe["flash"]["max_abs_err"]))

    # ---- 15. kernels line ---------------------------------------------------
    M = images.shape[1]
    sweep_bytes = 2 * B * M * 4            # images read, final images written
    sweep_bound = max(
        sweep_bytes / HBM_BYTES_PER_S,
        lane_steps * 16 * (SWEEP_I32_OPS_PER_PE_STEP / I32_OPS_PER_S
                           + SWEEP_F32_OPS_PER_PE_STEP / F32_OPS_PER_S)
    ) * 1e3
    sweep_bound_by = ("bytes" if sweep_bytes / HBM_BYTES_PER_S * 1e3
                      >= sweep_bound else "operations")
    kernels = [
        {"name": "cgra_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/cgra_sweep/csrc/cgra_sweep.cu",
         "replaces": "src/repro/kernels/cgra_sweep/ops.py:82",
         "launches": launches["cgra_sweep"], "max_abs_err": main_err,
         "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": sweep_bound,
         "bound_by": sweep_bound_by, "library_ms": None,
         "max_rel_err": main_rel, "lanes": B, "lane_steps": lane_steps,
         "analysis_launches": analysis["cgra_sweep"],
         "service_launches": service["launches"],
         "tuned_sweep_ms": service["tuned_ms"],
         "static_sweep_ms": service["static_ms"],
         "mesh_launches": mesh["launches"],
         "mesh_launches_by_device": mesh["by_device"],
         "mesh_launches_by_shard": mesh["by_shard"]},
        {"name": "alu_dispatch", "route": "cuda",
         "source": "src/repro_torch/kernels/cgra_step/csrc/cgra_alu.cu",
         "replaces": "src/repro/kernels/cgra_step/kernel.py:68",
         "launches": launches["alu_dispatch"], "max_abs_err": alu_err,
         "ms": alu_ms, "plain_ms": alu_plain_ms, "bound_ms": alu_bound,
         "bound_by": "bytes", "library_ms": None, "shape": list(shape),
         "main_path_shape": [1, 16], "main_path_ms": alu_step_ms,
         "main_path_host_ms": alu_host_ms,
         "main_path_device_ms": alu_dev_ms,
         "main_path_bound_ms": alu_step_bound,
         "analysis_launches": analysis["alu_dispatch"]},
        flash_entry, ssd_entry, *bwd_entries,
    ]
    print(f"[summary] profile on the card {prof_cuda_t:.3f} s; main sweep "
          f"{wall:.3f} s for {B} design points; serving "
          f"{serve_stats['prefill_tok_s']:.1f} prefill tokens/s, "
          f"{serve_stats['decode_ms_per_step']:.3f} ms per decode step, "
          f"{serve_stats['decode_tok_s']:.1f} decode tokens/s; training "
          f"{trained['step_ms']:.1f} ms a step, {trained['tokens_s']:.1f} "
          f"tokens/s, peak {trained['peak_gib']:.3f} GiB")
    for st in [served["main"]] + served["others"] + [last["whisper"],
                                                     last["xlstm"]]:
        print(f"[summary] serving {st['arch']} ({st['layers']} layers): "
              f"{st['prefill_tok_s']:.1f} prefill tokens/s, "
              f"{st['decode_ms_per_step']:.3f} ms per decode step, "
              f"{st['decode_tok_s']:.1f} decode tokens/s, peak "
              f"{st['peak_gib']:.3f} GiB, {st['flash_attention']} flash "
              f"launches"
              + (f", encoder {st['encoder_frames_s']:.1f} frames/s, decoder "
                 f"{st['decoder_prefill_tok_s']:.1f} prompt tokens/s"
                 if "encoder_frames_s" in st else "")
              + (f", {st['decode_launches']} kernels a decode step"
                 if "decode_launches" in st else ""))
    for st in [trained_families["main"]] + trained_families["others"]:
        print(f"[summary] training {st['arch']} ({st['layers']} layers, "
              f"remat {st['remat']}): {st['step_ms']:.1f} ms a step, "
              f"{st['tokens_s']:.1f} tokens/s, peak {st['peak_gib']:.3f} "
              f"GiB, {st['launches']['flash_attention']} flash and "
              f"{st['launches']['flash_attention_bwd']} flash backward "
              f"launches")
    print(f"[summary] pipeline {LM_ARCH} ({PIPE_STAGES} stages, "
          f"{PIPE_MICRO} microbatches of {PIPE_SEQ} tokens): "
          f"{pipe['pipe_ms']:.1f} ms pipelined, {pipe['seq_ms']:.1f} ms "
          f"sequential, bubble {pipe['bubble']:.4f}, peak "
          f"{pipe['peak_gib']:.3f} GiB, "
          f"{pipe['launches']['flash_attention']} flash launches, "
          + ("bit for bit" if pipe["bitwise"] else
             f"max abs err {pipe['max_abs_err']:.3g}")
          + f"; compressed_psum {pipe['psum_card_ms']:.1f} ms on the card, "
          f"{pipe['wire_bytes']} bytes on the wire against "
          f"{pipe['f32_wire_bytes']}")
    work.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

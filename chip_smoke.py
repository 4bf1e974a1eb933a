#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the CGRA estimator on one GPU.

    python3 chip_smoke.py            # from the repository root

Needs one CUDA device and nvcc; builds the kernels from the sources in
src/repro_torch on first use.  Every phase fails loudly (non-zero exit):

1. device: the card's name and power limit, then the kernel build;
2. the alu_dispatch kernel against its plain version on (1048576, 16)
   seeded int32 planes, bit for bit;
3. the cgra_sweep kernel against its plain version on the card: 5
   MiBench kernels x 5 topologies x their 5 images, and Im2col-OP x 5
   topologies; integer state bit for bit, energy at rtol=1e-5;
4. the main path at a size users run: the characterization profile
   computed on the card, then dse.sweep over 4 conv mappings x 40
   hardware configs x 256 seeded layers (40,960 design points), counted
   kernel launches, results checked against the conv oracle through the
   simulator and, for every lane, against the plain engine on the card;
5. one {"kernels": [...]} line with times, bounds and launch counts;
6. the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
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

    # ---- 1. device and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _build.build_all()
    print(f"[build] both kernel libraries ready in "
          f"{time.perf_counter() - t:.3f} s; cgra_sweep kernel "
          f"{kernel_attributes()}")

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
        ms, lanes, executed lane-steps)."""
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
                int(kern.n_exec.sum()))

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
    for g, case in enumerate(mappings):
        final, _ = run_program(case.program, case.mem_init,
                               hwconfig.baseline(),
                               max_steps=MAIN_MAX_STEPS, device=dev)
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

    # ---- 5. kernels line ----------------------------------------------------
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
         "max_rel_err": main_rel, "lanes": B, "lane_steps": lane_steps},
        {"name": "alu_dispatch", "route": "cuda",
         "source": "src/repro_torch/kernels/cgra_step/csrc/cgra_alu.cu",
         "replaces": "src/repro/kernels/cgra_step/kernel.py:68",
         "launches": launches["alu_dispatch"], "max_abs_err": alu_err,
         "ms": alu_ms, "plain_ms": alu_plain_ms, "bound_ms": alu_bound,
         "bound_by": "bytes", "library_ms": None, "shape": list(shape)},
    ]
    print(f"[summary] profile on the card {prof_cuda_t:.3f} s; main sweep "
          f"{wall:.3f} s for {B} design points")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

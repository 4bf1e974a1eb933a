"""Design-space exploration: the (program x hardware x data) sweep.

The paper's value proposition is instantaneous comparative analysis of
(kernel mapping x hardware topology) points.  ``sweep`` flattens all
three axes to ``B = G*H*D`` design points ("lanes"), row
``(g*H + h)*D + d`` pairing program g with hardware config h and memory
image d, and runs every lane through the cycle-level simulator with the
fused case-(vi) energy estimate.  The lanes run on the fused sweep
engine (``kernels.cgra_sweep``): its CUDA kernel on the GPU, its plain
PyTorch version on the CPU.

Programs are packed to a common padded shape (``program.pack_programs``)
and each lane fetches its own kernel's rows from the fused row table at
``prog_idx * T_max + pc``.  With ``max_buckets > 1`` the kernels are
first split into length buckets (``program.bucket_programs``) so short
kernels stop running alongside the longest one; results are scattered
back to the canonical row order and equal the unbucketed sweep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, as_int32, resolve_device
from ..kernels.cgra_sweep.ops import sweep_engine
from ..kernels.cgra_sweep.ref import SweepTables, init_lanes
from .characterization import Profile
from .hwconfig import HwConfig, stack_configs
from .memory import (DEFAULT_MAX_BANKS, scoreboard_bound,
                     validate_bank_bound)
from .program import (Program, ProgramBatch, as_program_batch,
                      batch_tables, bucket_programs, fused_rows)

Programs = Union[Program, ProgramBatch, Sequence[Program]]


class SweepResult(NamedTuple):
    latency_cc: torch.Tensor      # (B,) int32
    energy_pj: torch.Tensor       # (B,) float32
    power_mw: torch.Tensor        # (B,) float32
    checksum: torch.Tensor        # (B,) int32 (output-memory hash, validity)
    steps_executed: torch.Tensor  # (B,) int32 instructions actually run


def sweep_tables(batch: ProgramBatch, profile: Profile,
                 device: torch.device) -> SweepTables:
    """Device operands of a packed batch and its profile."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return SweepTables(
        tab=torch.as_tensor(fused_rows(batch_tables(batch)), device=device),
        plen=as_int32(batch.n_instrs, device), t_max=batch.t_max,
        p_dec=f32(profile.p_dec), p_act=f32(profile.p_act),
        e_src=f32(profile.e_src), p_idle=float(profile.p_idle),
        e_sw_op=float(profile.e_sw_op), e_sw_mux=float(profile.e_sw_mux),
        mulzero=float(profile.mulzero))


def _lanes_runner(batch: ProgramBatch, profile: Profile, *, rows: int,
                  cols: int, mem_size: int, max_steps: int,
                  chunk_steps: Optional[int], blk_b: int,
                  device: torch.device):
    """``run(mem (B, M) int32, hw (B,) fields, prog_idx (B,))``.

    ``mem`` is taken over: the engine updates the images in place, so a
    caller that built it (``make_grid_fn``) pays no copy."""
    if batch.n_pes != rows * cols:
        raise ValueError(
            f"program batch {batch.names!r}: n_pes={batch.n_pes} does not "
            f"match the {rows}x{cols} array")
    tables = sweep_tables(batch, profile, device)
    # the clock period comes from the characterization profile, as in
    # the reference (hw.t_clk_ns is not consulted)
    t_clk = float(np.float32(profile.t_clk_ns))

    def run(mem: torch.Tensor, hw: HwConfig, prog_idx) -> SweepResult:
        if mem.dim() != 2 or mem.shape[1] != mem_size:
            raise ValueError(f"memory images must be (B, {mem_size}), got "
                             f"{tuple(mem.shape)}")
        B = mem.shape[0]
        hw = hw.map(lambda v: v.to(device).expand(B).contiguous())
        st = init_lanes(mem, batch.n_pes)
        sweep_engine(tables, hw, as_int32(prog_idx, device), st, rows=rows,
                     cols=cols, max_steps=max_steps, chunk_steps=chunk_steps,
                     blk_b=blk_b)
        lat = st.t_cc
        weights = torch.arange(mem_size, dtype=torch.int64,
                               device=device) | 1
        # int32 wraparound of the reference's sum, made explicit
        checksum = ((st.mem.to(torch.int64) * weights).sum(1)
                    & 0xFFFFFFFF).to(torch.int32)
        return SweepResult(lat, st.e_acc * t_clk * 1e-3,
                           st.e_acc / lat.clamp(min=1) * 1e-3, checksum,
                           st.n_exec)

    return run


def make_sweep_fn(program: Programs, profile: Profile, *, rows: int = 4,
                  cols: int = 4, mem_size: int = 4096, max_steps: int = 2048,
                  chunk_steps: Optional[int] = 64, blk_b: int = 32,
                  max_banks: Optional[int] = None,
                  device: DeviceLike = None):
    """Build the fused simulate+estimate sweep function.

    program: a single ``Program`` -> ``fn(mem_init (B, M), hw) ->
    SweepResult``; a sequence of programs or a ``ProgramBatch`` ->
    ``fn(mem_init, hw, prog_idx (B,))``, each lane running its own
    program.  ``hw`` holds (B,) fields or one configuration for all lanes.
    The memory images are copied before the engine updates them.

    chunk_steps: instructions per engine chunk; the sweep stops issuing
    chunks once every lane is done (``None``: one chunk of max_steps).
    blk_b: lanes per CUDA block.  Neither changes a result.

    max_banks: bank-scoreboard bound (default 16); configs with more
    banks raise, as in the reference.  ``sweep()`` derives it from its
    configs."""
    dev = resolve_device(device)
    max_banks = max_banks or DEFAULT_MAX_BANKS
    run = _lanes_runner(as_program_batch(program), profile, rows=rows,
                        cols=cols, mem_size=mem_size, max_steps=max_steps,
                        chunk_steps=chunk_steps, blk_b=blk_b, device=dev)

    def fn(mem_init, hw: HwConfig, prog_idx=None) -> SweepResult:
        validate_bank_bound(hw.n_banks, max_banks, where="dse.make_sweep_fn")
        mem = torch.as_tensor(mem_init, dtype=torch.int32, device=dev)
        if prog_idx is None:
            prog_idx = torch.zeros(mem.shape[0], dtype=torch.int32)
        return run(mem.clone(), hw, prog_idx)

    if isinstance(program, Program):
        return lambda mem_init, hw: fn(mem_init, hw)
    return lambda mem_init, hw, prog_idx: fn(mem_init, hw, prog_idx)


class GridPlan(NamedTuple):
    """The flattened (program x hardware x data) grid as data: packed
    program batch, the D distinct images on the device, and per-lane
    index / config rows (row ``(g*H + h)*D + d``)."""
    batch: ProgramBatch
    images: torch.Tensor       # (D, M) int32
    img_idx: np.ndarray        # (B,) int32 per-lane image row
    prog_idx: np.ndarray       # (B,) int32 per-lane program row
    hw_grid: HwConfig          # (B,) fields
    max_banks: int             # config-derived scoreboard bound


def plan_grid(program: Optional[Programs] = None,
              hw_configs: Sequence[HwConfig] = None,
              mem_images=None, *, programs: Optional[Sequence[Program]]
              = None, device: DeviceLike = None) -> GridPlan:
    """Flatten the grid to ``B = G*H*D`` index rows without tiling any
    image or table."""
    dev = resolve_device(device)
    if programs is not None:
        if program is not None:
            raise TypeError("plan_grid(): pass either program or "
                            "programs=, not both")
        program = list(programs)
    batch = as_program_batch(program)
    G, H = batch.n_programs, len(hw_configs)
    images = as_int32(mem_images, dev)
    D = images.shape[0]
    n_banks_req = max(int(c.n_banks) for c in hw_configs)
    max_banks = scoreboard_bound(max(n_banks_req, DEFAULT_MAX_BANKS))
    hw_grid = stack_configs(list(hw_configs)).map(
        lambda x: x.to(dev).repeat_interleave(D).repeat(G))
    img_idx = np.tile(np.arange(D, dtype=np.int32), G * H)
    prog_idx = np.repeat(np.arange(G, dtype=np.int32), H * D)
    return GridPlan(batch, images, img_idx, prog_idx, hw_grid, max_banks)


def make_grid_fn(plan: GridPlan, profile: Profile, *, max_steps: int = 2048,
                 mem_size: int = 4096, chunk_steps: Optional[int] = 64,
                 blk_b: int = 32):
    """``fn(img_idx, hw_slice, prog_idx) -> SweepResult`` for any slice
    of the planned grid; lanes are independent, so a lane's result is the
    same in any slice.  Runs where the plan's images are."""
    dev = plan.images.device
    run = _lanes_runner(plan.batch, profile, rows=4, cols=4,
                        mem_size=mem_size, max_steps=max_steps,
                        chunk_steps=chunk_steps, blk_b=blk_b, device=dev)

    def grid_fn(idx, hw: HwConfig, gi) -> SweepResult:
        validate_bank_bound(hw.n_banks, plan.max_banks, where="dse.grid_fn")
        # the gathered images are a fresh tensor the engine may update
        return run(plan.images[as_int32(idx, dev).long()], hw, gi)

    return grid_fn


def sweep(program: Optional[Programs] = None, profile: Profile = None,
          hw_configs: Sequence[HwConfig] = None, mem_images=None, *,
          programs: Optional[Sequence[Program]] = None,
          max_steps: int = 2048, mem_size: int = 4096,
          chunk_steps: Optional[int] = 64, blk_b: int = 32,
          max_buckets: int = 4, device: DeviceLike = None) -> SweepResult:
    """Run the full (program x hw x data) grid.

    program/programs: a single ``Program``, a sequence of programs, or a
    ``ProgramBatch``.  mem_images: (D, mem_size).  Returns (B,) tensors
    on ``device`` in row order ``(g*H + h)*D + d``.

    max_buckets > 1 splits a multi-kernel sweep into up to that many
    length buckets, each packed to its own ``t_max`` and run on its own;
    results are identical to the unbucketed sweep.  Runs on the CUDA
    device unless ``device`` says otherwise."""
    dev = resolve_device(device)
    if programs is not None:
        if program is not None:
            raise TypeError("sweep(): pass either program or programs=, "
                            "not both")
        program = list(programs)
    batch = as_program_batch(program)
    G = batch.n_programs
    kw = dict(profile=profile, hw_configs=hw_configs, mem_images=mem_images,
              max_steps=max_steps, mem_size=mem_size,
              chunk_steps=chunk_steps, blk_b=blk_b, max_buckets=1,
              device=dev)
    if G > 1 and max_buckets > 1:
        buckets = bucket_programs([batch.program(g) for g in range(G)],
                                  max_buckets)
        if buckets.n_buckets > 1:
            parts = [sweep(program=b, **kw) for b in buckets.batches]
            block = len(hw_configs) * len(mem_images)
            out = []
            for field in zip(*parts):
                full = torch.empty((G * block,), dtype=field[0].dtype,
                                   device=dev)
                for group, part in zip(buckets.groups, field):
                    for j, g in enumerate(group):
                        full[g * block:(g + 1) * block] = \
                            part[j * block:(j + 1) * block]
                out.append(full)
            return SweepResult(*out)
    plan = plan_grid(batch, hw_configs, mem_images, device=dev)
    grid_fn = make_grid_fn(plan, profile,
                           max_steps=max_steps, mem_size=mem_size,
                           chunk_steps=chunk_steps, blk_b=blk_b)
    return grid_fn(plan.img_idx, plan.hw_grid, plan.prog_idx)

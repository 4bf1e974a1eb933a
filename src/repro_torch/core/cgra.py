"""Lockstep behavioral simulator of the time-multiplexed CGRA.

Execution model (paper Section 1): all PEs share a program counter; at
each step the CGRA executes one instruction (one operation per PE); the
instruction retires when the slowest PE finishes, and only then does the
PC advance (or branch).  Each PE reads operands from immediates, its own
registers, or its four torus neighbours' output registers, all sampled
at the start of the instruction.

``run_program`` is the single-design-point simulator with a per-step
``StepRecord`` trace; characterization and the tests use it.  The PC
lives on the host (one device-to-host read per step), so each step
fetches its instruction row by a host index and the run stops at EXIT.
The DSE sweep does not run through here: its hot path is the lane-batched
engine in ``kernels.cgra_sweep``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.cgra_step.ops import alu_dispatch
from . import isa
from .hwconfig import HwConfig, baseline
from .memory import mem_completion_times, scoreboard_bound
from .program import Program, fused_rows, program_tables


class SimState(NamedTuple):
    regs: torch.Tensor   # (P, 4) int32
    rout: torch.Tensor   # (P,)  int32
    pc: torch.Tensor     # ()    int32
    done: torch.Tensor   # ()    bool
    mem: torch.Tensor    # (M,)  int32
    t_cc: torch.Tensor   # ()    int32  cumulative true cycles


class StepRecord(NamedTuple):
    """Per-executed-instruction trace row, masked by ``valid``.  Static
    per-instruction fields (op, srcs, dest, imm) are recoverable as
    ``program.X[pc]`` and are not recorded."""
    pc: torch.Tensor        # ()   instruction index executed (-1 if not)
    valid: torch.Tensor     # ()   bool
    a: torch.Tensor         # (P,) operand A values
    b: torch.Tensor         # (P,) operand B values
    result: torch.Tensor    # (P,) ALU/load results
    mem_addr: torch.Tensor  # (P,) word address of mem request (0 if none)
    mem_done: torch.Tensor  # (P,) completion cc of mem request (0 if none)
    busy: torch.Tensor      # (P,) per-PE busy cycles this instruction
    lat: torch.Tensor       # ()   instruction latency in cc
    rout: torch.Tensor      # (P,) output registers AFTER the instruction


class InstrRows(NamedTuple):
    """One decoded instruction: the ``(P,)`` rows of every program table
    at one PC (``program.ROW_FIELDS`` order)."""
    ops: torch.Tensor
    dest: torch.Tensor
    srcA: torch.Tensor
    srcB: torch.Tensor
    imm: torch.Tensor
    is_load: torch.Tensor
    is_store: torch.Tensor
    writes_rout: torch.Tensor
    kindA: torch.Tensor
    kindB: torch.Tensor


def rows_from_fused(fused_row: torch.Tensor) -> InstrRows:
    """``(N_ROW_FIELDS, P)`` fused row -> ``InstrRows``."""
    return InstrRows(*fused_row.unbind(0))


def init_state(mem_init, n_pes: int, device: DeviceLike = None) -> SimState:
    """Fresh state; the memory image is copied, because the simulator
    updates it in place."""
    dev = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    mem = torch.as_tensor(mem_init, dtype=torch.int32, device=dev).clone()
    return SimState(regs=z(n_pes, 4), rout=z(n_pes), pc=z(),
                    done=torch.zeros((), dtype=torch.bool, device=dev),
                    mem=mem, t_cc=z())


def neighbour_tables(rows: int, cols: int, device) -> torch.Tensor:
    """(4, P) torus neighbour indices in RCL, RCR, RCT, RCB order."""
    maps = isa.neighbour_index_maps(rows, cols)
    return torch.as_tensor(np.stack([maps[k] for k in
                                     ("RCL", "RCR", "RCT", "RCB")]),
                           dtype=torch.long, device=device)


def gather_operands(src: torch.Tensor, imm: torch.Tensor,
                    regs: torch.Tensor, rout: torch.Tensor,
                    nbr: torch.Tensor) -> torch.Tensor:
    """(..., P) source selectors -> (..., P) operand values.  ``regs`` is
    (..., 4, P); ``nbr`` the (4, P) neighbour tables."""
    candidates = torch.stack([
        torch.zeros_like(imm), imm,                  # ZERO, IMM
        *regs.unbind(-2),                            # R0..R3
        rout,                                        # ROUT
        *(rout[..., nbr[k]] for k in range(4)),      # RCL RCR RCT RCB
    ], dim=-2)                                       # (..., N_SRCS, P)
    return torch.gather(candidates, -2, src.long().unsqueeze(-2)
                        ).squeeze(-2)


def apply_stores(mem: torch.Tensor, addr: torch.Tensor,
                 is_store: torch.Tensor, store_val: torch.Tensor,
                 old: torch.Tensor) -> None:
    """Ascending-PE store arbitration, written into ``mem`` in place.

    For duplicate addresses only the highest-indexed PE's store lands (it
    is written last).  Masked-off stores must be dropped, and a scatter
    with duplicate indices has no defined order, so each PE writes the
    value its address holds after the step -- the landing store's value,
    or ``old`` (the pre-step word) -- and duplicates all write the same.
    ``mem`` is (..., M); the rest are (..., P)."""
    same = addr.unsqueeze(-1) == addr.unsqueeze(-2)          # (..., P, P)
    P = addr.shape[-1]
    upper = torch.ones(P, P, dtype=torch.bool, device=addr.device).triu(1)
    later = (same & upper & is_store.unsqueeze(-2)).any(-1)  # a q > p too
    landed = is_store & ~later
    hit = same & landed.unsqueeze(-2)                        # (..., P, P)
    win = torch.where(hit, store_val.unsqueeze(-2), 0).sum(
        -1, dtype=torch.int32)
    mem.scatter_(-1, addr.long(), torch.where(hit.any(-1), win, old))


def _branch_target(op_row, a, b, imm_row, pc):
    O = isa.OP
    taken = (((op_row == O["BEQ"]) & (a == b))
             | ((op_row == O["BNE"]) & (a != b))
             | ((op_row == O["BLT"]) & (a < b))
             | ((op_row == O["BGE"]) & (a >= b))
             | (op_row == O["JUMP"]))
    first = torch.argmax(taken.to(torch.int32), dim=-1)  # lowest PE wins
    target = imm_row.gather(-1, first.unsqueeze(-1)).squeeze(-1)
    return torch.where(taken.any(-1), target, pc + 1)


class RowKinds(NamedTuple):
    """Which op classes an instruction holds on any PE (host-side, from
    the program table), so a step skips the data flow it cannot need."""
    alu: bool
    load: bool
    store: bool
    branch: bool
    exit: bool


def row_kinds(program: Program):
    """``RowKinds`` of every instruction of ``program``."""
    has = lambda mask: mask[program.ops].any(axis=1).tolist()
    return [RowKinds(*k) for k in zip(
        has(isa.IS_ALU), has(isa.IS_LOAD), has(isa.IS_STORE),
        has(isa.IS_BRANCH), (program.ops == isa.OP["EXIT"]).any(1).tolist())]


def make_exec_fn(rows: int, cols: int, mem_size: int):
    """Build ``exec_step(instr, kinds, n_instrs, state, hw) -> (SimState,
    StepRecord)``: execute one instruction on a live design point.

    ``kinds`` (``RowKinds``) must describe ``instr``.  ``state.mem`` is
    updated in place, which saves a copy of the image per step; the
    returned state shares it."""
    O = isa.OP
    consts = {}

    def exec_step(instr: InstrRows, kinds: RowKinds, n_instrs: int,
                  state: SimState, hw: HwConfig
                  ) -> Tuple[SimState, StepRecord]:
        dev = state.mem.device
        if dev not in consts:
            consts[dev] = (neighbour_tables(rows, cols, dev),
                           torch.arange(4, device=dev),
                           torch.ones((), dtype=torch.bool, device=dev))
        nbr, reg_ids, valid = consts[dev]
        op_row, imm_row = instr.ops, instr.imm
        regs_t = state.regs.t()                          # (4, P)
        a = gather_operands(instr.srcA, imm_row, regs_t, state.rout, nbr)
        b = gather_operands(instr.srcB, imm_row, regs_t, state.rout, nbr)
        z = torch.zeros_like(a)

        # ---- ALU: the kernels.cgra_step dispatch (its kernel on the GPU) --
        result = alu_dispatch(op_row, a, b) if kinds.alu else z
        busy = torch.where(op_row == O["SMUL"], hw.smul_lat.to(torch.int32),
                           1)

        # ---- memory and its timing ---------------------------------------
        mem_addr = mem_done = z
        if kinds.load or kinds.store:
            is_load = instr.is_load != 0
            is_store = instr.is_store != 0
            is_mem = is_load | is_store
            # LWD/SWD address = imm; LWI/SWI address = a.  Floor modulo:
            # a can be negative.
            direct = (op_row == O["LWD"]) | (op_row == O["SWD"])
            addr = torch.remainder(torch.where(direct, imm_row, a), mem_size)
            load_val = state.mem[addr.long()]
            if kinds.store:
                apply_stores(state.mem, addr, is_store,
                             torch.where(op_row == O["SWD"], a, b), load_val)
            result = torch.where(is_load, load_val, result)
            mem_done = mem_completion_times(is_mem, addr, hw, mem_size, cols)
            mem_addr = torch.where(is_mem, addr, z)
            busy = torch.where(is_mem, mem_done, busy)
        lat = busy.max()

        # ---- writeback -----------------------------------------------------
        writes = instr.writes_rout != 0
        rout_new = torch.where(writes, result, state.rout)
        hit = writes.unsqueeze(-1) & (instr.dest.unsqueeze(-1) == reg_ids)
        regs_new = torch.where(hit, result.unsqueeze(-1), state.regs)

        # ---- control -------------------------------------------------------
        if kinds.branch:
            next_pc = _branch_target(op_row, a, b, imm_row, state.pc)
        else:
            next_pc = state.pc + 1
        next_pc = torch.clamp(next_pc, 0, n_instrs - 1).to(torch.int32)

        new_state = SimState(regs=regs_new, rout=rout_new, pc=next_pc,
                             done=state.done | kinds.exit, mem=state.mem,
                             t_cc=state.t_cc + lat)
        rec = StepRecord(pc=state.pc, valid=valid, a=a, b=b, result=result,
                         mem_addr=mem_addr, mem_done=mem_done, busy=busy,
                         lat=lat, rout=rout_new)
        return new_state, rec

    return exec_step


def _pad_trace(recs, final: SimState, max_steps: int) -> StepRecord:
    """Stack the executed records and append the frozen rows a full
    ``max_steps`` run records after the lane is done."""
    n_pad = max_steps - len(recs)
    stacked = []
    for f in StepRecord._fields:
        x = torch.stack([getattr(r, f) for r in recs])
        if n_pad:
            if f == "rout":
                fill = final.rout.expand(n_pad, -1)
            else:
                fill = torch.full((n_pad,) + x.shape[1:], -1 if f == "pc"
                                  else 0, dtype=x.dtype, device=x.device)
            x = torch.cat([x, fill])
        stacked.append(x)
    return StepRecord(*stacked)


def run_program(program: Program, mem_init, hw: Optional[HwConfig] = None,
                *, rows: int = 4, cols: int = 4, mem_size: int = 4096,
                max_steps: int = 4096, device: DeviceLike = None
                ) -> Tuple[SimState, StepRecord]:
    """Run one program on one memory image -> ``(final_state, trace)``.

    ``trace`` is a StepRecord with a leading ``(max_steps,)`` axis, masked
    by ``valid``, exactly as a full-length run records it; the loop itself
    stops at EXIT.  Runs on the CUDA device unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    if program.n_pes != rows * cols:
        raise ValueError(
            f"program {program.name!r}: n_pes={program.n_pes} does not "
            f"match the {rows}x{cols} array")
    hw = (hw or baseline()).to(dev)
    scoreboard_bound(int(hw.n_banks))        # raises beyond HARD_MAX_BANKS
    fused = torch.as_tensor(fused_rows(program_tables(program)), device=dev)
    kinds = row_kinds(program)
    exec_step = make_exec_fn(rows, cols, mem_size)
    state = init_state(mem_init, program.n_pes, dev)
    recs = []
    pc = 0
    for _ in range(max_steps):
        state, rec = exec_step(rows_from_fused(fused[pc]), kinds[pc],
                               program.n_instrs, state, hw)
        recs.append(rec)
        if kinds[pc].exit:
            break
        # only a branch makes the next PC data-dependent
        pc = (int(state.pc) if kinds[pc].branch
              else min(pc + 1, program.n_instrs - 1))
    return state, _pad_trace(recs, state, max_steps)

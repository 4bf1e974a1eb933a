"""Plain PyTorch version of the fused CGRA sweep engine.

Lane-batched ``(B, P)`` tensor code with the semantics of the TPU
engine's step (``repro/kernels/cgra_sweep/kernel.py``) and the host
chunk loop of its driver (``ops.py``): every chunk advances all lanes by
up to ``chunk_steps`` instructions with live-masking, and the loop stops
once every lane is done or ``max_steps`` is spent.  It is the oracle of
the CUDA kernel (``csrc/cgra_sweep.cu``) and the path the wrapper takes
for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core import isa
from ...core.cgra import apply_stores, gather_operands, neighbour_tables
from ...core.hwconfig import HwConfig
from ...core.memory import mem_completion_times
from ...core.program import ROW_IDX
from ..cgra_step.ref import alu_ref

# Column layout of the packed per-lane integer hardware descriptor.
HW_INT_FIELDS = ("smul_lat", "bus", "interleaved", "n_banks",
                 "dma_per_pe", "t_mem")


class SweepTables(NamedTuple):
    """Read-only operands of one sweep: the fused row table of G programs
    padded to ``t_max``, their true lengths and the profile terms."""
    tab: torch.Tensor        # (G * t_max, N_ROW_FIELDS, P) int32
    plen: torch.Tensor       # (G,) int32
    t_max: int
    p_dec: torch.Tensor      # (N_OPS,) float32
    p_act: torch.Tensor      # (N_OPS,) float32
    e_src: torch.Tensor      # (N_SRC_KINDS,) float32
    p_idle: float
    e_sw_op: float
    e_sw_mux: float
    mulzero: float


class LaneState(NamedTuple):
    """Per-lane architectural state; the engines update it in place."""
    mem: torch.Tensor        # (B, M) int32
    regs: torch.Tensor       # (B, 4, P) int32
    rout: torch.Tensor       # (B, P) int32
    pc: torch.Tensor         # (B,) int32
    done: torch.Tensor       # (B,) int32 0/1
    t_cc: torch.Tensor       # (B,) int32
    e_acc: torch.Tensor      # (B,) float32, uW*cc
    prev_pc: torch.Tensor    # (B,) int32, -1 before the first live step
    n_exec: torch.Tensor     # (B,) int32


def init_lanes(mem: torch.Tensor, n_pes: int) -> LaneState:
    """Fresh state around ``mem`` (B, M), which is taken over, not
    copied."""
    B, dev = mem.shape[0], mem.device
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    return LaneState(
        mem=mem, regs=z(B, 4, n_pes), rout=z(B, n_pes), pc=z(B), done=z(B),
        t_cc=z(B), e_acc=torch.zeros(B, dtype=torch.float32, device=dev),
        prev_pc=torch.full((B,), -1, dtype=torch.int32, device=dev),
        n_exec=z(B))


def chunk_size(chunk_steps: Optional[int], max_steps: int) -> int:
    """Steps per chunk: ``None`` means one chunk of ``max_steps``."""
    return max(1, min(chunk_steps or max_steps, max_steps))


def _chunk(tables: SweepTables, hw: HwConfig, gidx: torch.Tensor,
           st: LaneState, *, rows: int, cols: int, start: int, k_steps: int,
           max_steps: int) -> None:
    """Advance every lane by up to ``k_steps`` instructions."""
    O = isa.OP
    F = ROW_IDX
    dev = st.mem.device
    M = st.mem.shape[1]
    R = tables.tab.shape[0]
    nbr = neighbour_tables(rows, cols, dev)
    reg_ids = torch.arange(4, device=dev)[:, None]
    gi = gidx.long()
    base = gi * tables.t_max
    lane_len = tables.plen[gi.clamp(0, tables.plen.shape[0] - 1)]
    smul_lat = hw.smul_lat[:, None]
    smul_scale = hw.smul_power_scale[:, None]

    def fetch(pc):
        return tables.tab[(base + pc.long()).clamp(0, R - 1)]   # (B, NF, P)

    regs, rout, pc, done = st.regs, st.rout, st.pc, st.done
    t_cc, e_acc, prev_pc, n_exec = st.t_cc, st.e_acc, st.prev_pc, st.n_exec
    # switch-energy reference rows: the previous live instruction's
    has_prev = prev_pc >= 0
    prev_row = fetch(prev_pc.clamp(min=0))
    p_ops, p_srcA, p_srcB = (prev_row[:, F["ops"]], prev_row[:, F["srcA"]],
                             prev_row[:, F["srcB"]])
    for k in range(k_steps):
        live = (done == 0) & (start + k < max_steps)              # (B,)
        lv = live[:, None]
        cur = fetch(pc)
        op = cur[:, F["ops"]]
        imm = cur[:, F["imm"]]
        srcA, srcB = cur[:, F["srcA"]], cur[:, F["srcB"]]
        a = gather_operands(srcA, imm, regs, rout, nbr)
        b = gather_operands(srcB, imm, regs, rout, nbr)

        # ---- memory: loads read the pre-step image -----------------------
        is_load = cur[:, F["is_load"]] > 0
        is_store = cur[:, F["is_store"]] > 0
        direct = (op == O["LWD"]) | (op == O["SWD"])
        addr = torch.remainder(torch.where(direct, imm, a), M)
        load_val = st.mem.gather(1, addr.long())
        apply_stores(st.mem, addr, is_store & lv,
                     torch.where(op == O["SWD"], a, b), load_val)

        # ---- ALU + writeback -----------------------------------------------
        result = torch.where(is_load, load_val, alu_ref(op, a, b))
        writes = cur[:, F["writes_rout"]] > 0
        rout_new = torch.where(writes, result, rout)
        hit = writes[:, None] & (cur[:, None, F["dest"]] == reg_ids)
        regs_new = torch.where(hit, result[:, None], regs)

        # ---- timing ----------------------------------------------------------
        is_mem = is_load | is_store
        mem_done = mem_completion_times(is_mem, addr, hw, M, cols)
        alu_lat = torch.where(op == O["SMUL"], smul_lat, 1)
        busy = torch.where(is_mem, mem_done, alu_lat)
        lat = busy.amax(1)

        # ---- control: the lowest-index PE with a taken branch wins ---------
        taken = (((op == O["BEQ"]) & (a == b)) | ((op == O["BNE"]) & (a != b))
                 | ((op == O["BLT"]) & (a < b))
                 | ((op == O["BGE"]) & (a >= b)) | (op == O["JUMP"]))
        first = torch.argmax(taken.to(torch.int32), dim=1, keepdim=True)
        target = imm.gather(1, first)[:, 0]
        next_pc = torch.where(taken.any(1), target, pc + 1)
        next_pc = torch.minimum(next_pc.clamp(min=0), lane_len - 1)
        exited = (op == O["EXIT"]).any(1)

        # ---- fused case-(vi) energy ----------------------------------------
        smul = op == O["SMUL"]
        scale = torch.where(smul, smul_scale, 1.0)
        wait = (lat[:, None] - busy).clamp(min=0).to(torch.float32)
        active = (busy - 1).clamp(min=0).to(torch.float32)
        gate = torch.where(smul & ((a == 0) | (b == 0)), tables.mulzero, 1.0)
        op_ch = has_prev[:, None] & (op != p_ops)
        a_ch = has_prev[:, None] & (srcA != p_srcA)
        b_ch = has_prev[:, None] & (srcB != p_srcB)
        e_step = (tables.p_dec[op] * scale
                  + tables.p_act[op] * scale * gate * active
                  + tables.p_idle * wait
                  + tables.e_src[cur[:, F["kindA"]]]
                  + tables.e_src[cur[:, F["kindB"]]]
                  + op_ch * tables.e_sw_op
                  + (a_ch.to(torch.float32) + b_ch.to(torch.float32))
                  * tables.e_sw_mux).sum(1)

        # ---- live-masked advance ---------------------------------------------
        regs = torch.where(lv[:, :, None], regs_new, regs)
        rout = torch.where(lv, rout_new, rout)
        prev_pc = torch.where(live, pc, prev_pc)
        pc = torch.where(live, next_pc, pc).to(torch.int32)
        done = torch.where(live & exited, 1, done).to(torch.int32)
        t_cc = torch.where(live, t_cc + lat, t_cc)
        e_acc = e_acc + torch.where(live, e_step, 0.0)
        n_exec = torch.where(live, n_exec + 1, n_exec)
        has_prev = has_prev | live
        p_ops = torch.where(lv, op, p_ops)
        p_srcA = torch.where(lv, srcA, p_srcA)
        p_srcB = torch.where(lv, srcB, p_srcB)
    for dst, src in zip(st[1:], (regs, rout, pc, done, t_cc, e_acc, prev_pc,
                                 n_exec)):
        dst.copy_(src)


def sweep_ref(tables: SweepTables, hw: HwConfig, gidx: torch.Tensor,
              st: LaneState, *, rows: int, cols: int, max_steps: int,
              chunk_steps: Optional[int]) -> None:
    """Run every lane to EXIT or ``max_steps``, updating ``st`` in place.

    ``hw`` holds one configuration per lane ((B,) fields).  Chunks of
    ``chunk_steps`` instructions are issued until every lane is done;
    lanes past their end are frozen, so the chunk size never changes a
    result."""
    K = chunk_size(chunk_steps, max_steps)
    t0 = 0
    while t0 < max_steps and not bool(st.done.all()):
        _chunk(tables, hw, gidx, st, rows=rows, cols=cols, start=t0,
               k_steps=K, max_steps=max_steps)
        t0 += K

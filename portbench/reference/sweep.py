"""The plain reference of the sweep: cycle-level CGRA lanes with the fused
case-(vi) energy estimate, in plain PyTorch.

A frozen copy of the semantics of ``src/repro_torch/kernels/cgra_sweep/
ref.py`` (the step), of ``lane_results`` in ``src/repro_torch/core/dse.py``
(the five result fields), of ``gather_operands``/``apply_stores`` in
``src/repro_torch/core/cgra.py``, of ``src/repro_torch/core/memory.py``
(bus, bank and DMA contention) and of ``src/repro_torch/kernels/
cgra_step/ref.py`` (the ALU).  It imports nothing of the program under
test.

Each lane carries its own program (index into the packed programs), its
own hardware config, its own memory image and its own ``max_steps``, so
the lanes of several sweep calls run in one batch.  The array is a
``rows`` x ``cols`` torus of ``P = rows * cols`` PEs (4x4, the
OpenEdgeCGRA's, unless a configuration names another).  ``energy_dtype``
is float32 as the configuration states; the benchmark's control runs it
in bfloat16.

The control flow and the values a lane computes never depend on its
hardware config: the config only sets instruction latencies and energy.
So ``steps_executed`` of a (program, image) pair is the same under every
config, which the benchmark's work count uses.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import isa
from .hw import BUS_N_TO_M, FIELDS as HW_FIELDS, FLOAT_FIELDS

RESULT_FIELDS = ("latency_cc", "energy_pj", "power_mw", "checksum",
                 "steps_executed")


def pack(programs: Sequence[isa.Program], device, *, rows: int = 4,
         cols: int = 4) -> Dict[str, torch.Tensor]:
    """Programs NOP-padded to a common length, as ``(G, T_max, P)``
    tensors, with their true lengths ``plen`` and the derived masks."""
    t_max = max(p.n_instrs for p in programs)
    out = {}
    for f in isa.FIELDS:
        fill = isa.DEST["ROUT"] if f == "dest" else 0
        arr = np.full((len(programs), t_max, rows * cols), fill, np.int32)
        for g, p in enumerate(programs):
            arr[g, :p.n_instrs] = getattr(p, f)
        out[f] = torch.as_tensor(arr, device=device)
    ops = out["ops"].long()
    for name, table in (("is_load", isa.IS_LOAD), ("is_store", isa.IS_STORE),
                        ("writes_rout", isa.WRITES_ROUT)):
        out[name] = torch.as_tensor(table, device=device)[ops]
    kinds = torch.as_tensor(isa.SRC_KIND, device=device)
    out["kindA"] = kinds[out["srcA"].long()]
    out["kindB"] = kinds[out["srcB"].long()]
    out["plen"] = torch.as_tensor([p.n_instrs for p in programs],
                                  dtype=torch.int32, device=device)
    return out


def alu(op: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 results of the ALU opcodes (0 for the others)."""
    O = isa.OP
    sh = b & 31
    a64 = a.to(torch.int64)
    table = [torch.zeros_like(a)] * isa.N_OPS
    table[O["SADD"]] = (a64 + b).to(torch.int32)
    table[O["SSUB"]] = (a64 - b).to(torch.int32)
    table[O["SMUL"]] = ((a64 * b) & 0xFFFFFFFF).to(torch.int32)
    table[O["SLL"]] = ((a64 << sh) & 0xFFFFFFFF).to(torch.int32)
    table[O["SRL"]] = ((a64 & 0xFFFFFFFF) >> sh).to(torch.int32)
    table[O["SRA"]] = a >> sh
    table[O["LAND"]] = a & b
    table[O["LOR"]] = a | b
    table[O["LXOR"]] = a ^ b
    table[O["SLT"]] = (a < b).to(torch.int32)
    table[O["MV"]] = a
    return torch.gather(torch.stack(table), 0, op.long()[None])[0]


def _operands(src, imm, regs, rout, nbr):
    """(B, P) source selectors -> (B, P) operand values."""
    cand = torch.stack([torch.zeros_like(imm), imm, *regs.unbind(-2), rout,
                        *(rout[..., nbr[k]] for k in range(4))], dim=-2)
    return torch.gather(cand, -2, src.long().unsqueeze(-2)).squeeze(-2)


def _store(mem, addr, is_store, val, old):
    """Ascending-PE store arbitration: of several stores to one address
    the highest-indexed PE's lands."""
    P = addr.shape[-1]
    same = addr.unsqueeze(-1) == addr.unsqueeze(-2)
    upper = torch.ones(P, P, dtype=torch.bool, device=addr.device).triu(1)
    later = (same & upper & is_store.unsqueeze(-2)).any(-1)
    landed = is_store & ~later
    hit = same & landed.unsqueeze(-2)
    win = torch.where(hit, val.unsqueeze(-2), 0).sum(-1, dtype=torch.int32)
    mem.scatter_(-1, addr.long(), torch.where(hit.any(-1), win, old))


def _mem_done(is_mem, addr, hw, M, cols):
    """Per-PE completion cycle of this instruction's memory requests: a
    greedy in-order list scheduler over the bank ports and the DMA
    engines (one a PE, or one a column: PE p's is ``p % cols``), each
    accepting one request a cycle, done ``t_mem`` after the issue slot.
    The slot of request p is the longest chain of earlier requests that
    share its bank or DMA, found by max-plus squaring: a chain spans at
    most P - 1 edges, so ``(P - 2).bit_length()`` squarings reach it."""
    dev = addr.device
    P = addr.shape[-1]
    nb = hw["n_banks"][:, None].clamp(min=1)
    bank_words = (M // nb).clamp(min=1)
    blocked = torch.minimum(
        torch.div(addr, bank_words, rounding_mode="floor").clamp(min=0),
        hw["n_banks"][:, None] - 1)
    bank = torch.where(hw["interleaved"][:, None] > 0,
                       torch.remainder(addr, nb), blocked)
    bank = torch.where(hw["bus"][:, None] == BUS_N_TO_M, bank, 0)
    pe = torch.arange(P, dtype=torch.int32, device=dev)
    dma = torch.where(hw["dma_per_pe"][:, None] > 0, pe, pe % cols)
    shares = ((bank.unsqueeze(-1) == bank.unsqueeze(-2))
              | (dma.unsqueeze(-1) == dma.unsqueeze(-2)))
    earlier = torch.ones(P, P, dtype=torch.bool, device=dev).tril(-1)
    edge = shares & earlier & is_mem.unsqueeze(-1) & is_mem.unsqueeze(-2)
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    chain = torch.where(edge, 1.0, torch.where(eye, 0.0, -torch.inf))
    for _ in range(max(P - 2, 0).bit_length()):
        chain = (chain.unsqueeze(-1) + chain.unsqueeze(-3)).amax(-2)
    slot = chain.amax(-1).to(torch.int32)
    return torch.where(is_mem, slot + hw["t_mem"][:, None], 0)


def run_lanes(programs: Sequence[isa.Program], prog_idx, hw: List[dict],
              mem: torch.Tensor, max_steps, profile: dict, *,
              rows: int = 4, cols: int = 4, energy_dtype=torch.float32,
              steps_per_check: int = 32) -> Dict[str, torch.Tensor]:
    """Run every lane to EXIT or its own ``max_steps``.

    programs: the programs lanes index into, each of ``rows * cols``
    PEs; prog_idx (B,); hw: one dict of ``hw.FIELDS`` a lane; mem (B, M)
    int32, updated in place; max_steps (B,).  Returns the five (B,)
    result fields.

    The lanes advance ``steps_per_check`` steps between two looks at
    whether all are done; on a CUDA device those steps replay as one
    CUDA graph of the same operations, which spares the host a launch
    an operation."""
    O = isa.OP
    dev = mem.device
    B, M = mem.shape
    P = rows * cols
    tab = pack(programs, dev, rows=rows, cols=cols)
    gi = torch.as_tensor(prog_idx, dtype=torch.long, device=dev)
    hwt = {f: torch.as_tensor(np.array([h[f] for h in hw]),
                              dtype=torch.float32 if f in FLOAT_FIELDS
                              else torch.int32, device=dev)
           for f in HW_FIELDS}
    limit = torch.as_tensor(max_steps, dtype=torch.int32, device=dev)
    prof = {k: torch.as_tensor(np.asarray(profile[k], np.float32),
                               device=dev).to(energy_dtype)
            for k in ("p_dec", "p_act", "e_src")}
    scal = {k: torch.tensor(float(profile[k]), dtype=energy_dtype,
                            device=dev)
            for k in ("p_idle", "e_sw_op", "e_sw_mux", "mulzero")}
    maps = isa.neighbour_index_maps(rows, cols)
    nbr = torch.as_tensor(np.stack([maps[k] for k in
                                    ("RCL", "RCR", "RCT", "RCB")]),
                          dtype=torch.long, device=dev)
    reg_ids = torch.arange(4, device=dev)[:, None]
    lane_len = tab["plen"][gi]
    smul_lat = hwt["smul_lat"][:, None]
    smul_scale = hwt["smul_power_scale"][:, None].to(energy_dtype)
    one = torch.ones((), dtype=energy_dtype, device=dev)
    rows = {f: t for f, t in tab.items() if f != "plen"}

    z = lambda *sh: torch.zeros(sh, dtype=torch.int32, device=dev)
    st = dict(regs=z(B, 4, P), rout=z(B, P), pc=z(B), done=z(B), t_cc=z(B),
              n_exec=z(B), prev_pc=torch.full((B,), -1, dtype=torch.int32,
                                               device=dev),
              e_acc=torch.zeros(B, dtype=energy_dtype, device=dev),
              p_ops=z(B, P), p_srcA=z(B, P), p_srcB=z(B, P), step=z(1))

    def step() -> None:
        """One instruction of every live lane; the state in place."""
        regs, rout, pc, done = st["regs"], st["rout"], st["pc"], st["done"]
        live = (done == 0) & (st["step"] < limit)
        lv = live[:, None]
        has_prev = st["prev_pc"] >= 0
        cur = {f: t[gi, pc.long()] for f, t in rows.items()}
        op, imm = cur["ops"], cur["imm"]
        srcA, srcB = cur["srcA"], cur["srcB"]
        a = _operands(srcA, imm, regs, rout, nbr)
        b = _operands(srcB, imm, regs, rout, nbr)

        # memory: loads read the image as it was before the step
        is_load, is_store = cur["is_load"], cur["is_store"]
        direct = (op == O["LWD"]) | (op == O["SWD"])
        addr = torch.remainder(torch.where(direct, imm, a), M)
        load_val = mem.gather(1, addr.long())
        _store(mem, addr, is_store & lv,
               torch.where(op == O["SWD"], a, b), load_val)

        result = torch.where(is_load, load_val, alu(op, a, b))
        writes = cur["writes_rout"]
        rout_new = torch.where(writes, result, rout)
        hit = writes[:, None] & (cur["dest"][:, None] == reg_ids)
        regs_new = torch.where(hit, result[:, None], regs)

        # timing
        is_mem = is_load | is_store
        busy = torch.where(is_mem, _mem_done(is_mem, addr, hwt, M, cols),
                           torch.where(op == O["SMUL"], smul_lat, 1))
        lat = busy.amax(1)

        # control: the lowest-index PE with a taken branch wins
        taken = (((op == O["BEQ"]) & (a == b)) | ((op == O["BNE"]) & (a != b))
                 | ((op == O["BLT"]) & (a < b))
                 | ((op == O["BGE"]) & (a >= b)) | (op == O["JUMP"]))
        first = torch.argmax(taken.to(torch.int32), dim=1, keepdim=True)
        target = imm.gather(1, first)[:, 0]
        next_pc = torch.where(taken.any(1), target, pc + 1)
        next_pc = torch.minimum(next_pc.clamp(min=0), lane_len - 1)
        exited = (op == O["EXIT"]).any(1)

        # fused case-(vi) energy of the step, summed over the PEs
        smul = op == O["SMUL"]
        scale = torch.where(smul, smul_scale, one)
        wait = (lat[:, None] - busy).clamp(min=0).to(energy_dtype)
        active = (busy - 1).clamp(min=0).to(energy_dtype)
        gate = torch.where(smul & ((a == 0) | (b == 0)), scal["mulzero"],
                           one)
        op_ch = has_prev[:, None] & (op != st["p_ops"])
        a_ch = has_prev[:, None] & (srcA != st["p_srcA"])
        b_ch = has_prev[:, None] & (srcB != st["p_srcB"])
        e_step = (prof["p_dec"][op.long()] * scale
                  + prof["p_act"][op.long()] * scale * gate * active
                  + scal["p_idle"] * wait
                  + prof["e_src"][cur["kindA"].long()]
                  + prof["e_src"][cur["kindB"].long()]
                  + op_ch * scal["e_sw_op"]
                  + (a_ch.to(energy_dtype) + b_ch.to(energy_dtype))
                  * scal["e_sw_mux"]).sum(1)

        st["regs"].copy_(torch.where(lv[:, :, None], regs_new, regs))
        st["rout"].copy_(torch.where(lv, rout_new, rout))
        st["prev_pc"].copy_(torch.where(live, pc, st["prev_pc"]))
        st["pc"].copy_(torch.where(live, next_pc, pc))
        st["done"].copy_(torch.where(live & exited, 1, done))
        st["t_cc"].copy_(torch.where(live, st["t_cc"] + lat, st["t_cc"]))
        st["e_acc"].copy_(st["e_acc"]
                          + torch.where(live, e_step, 0.0).to(energy_dtype))
        st["n_exec"].copy_(torch.where(live, st["n_exec"] + 1,
                                       st["n_exec"]))
        for k, v in (("p_ops", op), ("p_srcA", srcA), ("p_srcB", srcB)):
            st[k].copy_(torch.where(lv, v, st[k]))
        st["step"].add_(1)

    def steps() -> None:
        for _ in range(steps_per_check):
            step()

    run = steps
    if dev.type == "cuda" and B:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            steps()                 # real steps, which also warm up
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            steps()
        run = graph.replay
    top = int(limit.max()) if B else 0
    while (int(st["step"]) < top
           and not bool(((st["done"] > 0) | (st["step"] >= limit)).all())):
        run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t_clk = float(np.float32(profile["t_clk_ns"]))
    weights = torch.arange(M, dtype=torch.int64, device=dev) | 1
    checksum = ((mem.to(torch.int64) * weights).sum(1)
                & 0xFFFFFFFF).to(torch.int32)
    e_acc, t_cc = st["e_acc"], st["t_cc"]
    return {"latency_cc": t_cc, "energy_pj": e_acc * t_clk * 1e-3,
            "power_mw": e_acc / t_cc.clamp(min=1) * 1e-3,
            "checksum": checksum, "steps_executed": st["n_exec"]}

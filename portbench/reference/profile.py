"""The characterization profile, derived again by the plain reference.

The program under test derives its profile in set-up
(``characterization.default_profile``); the benchmark does not take it.
This module works it out afresh, on the host in numpy: a frozen copy of
``src/repro_torch/core/characterization.py`` (the micro-kernels and the
fit), ``src/repro_torch/core/detailed.py`` (energy components and the
power waveform), ``src/repro_torch/core/physical.py`` (the physical
model) and ``src/repro_torch/core/trace.py`` (dense trace, toggles,
switches), driven by a one-design-point simulator of its own
(``simulate``) in place of ``core/cgra.run_program``.

The characterization runs its micro-kernels on the 4x4 array, whatever
array a configuration names: the profile's per-opcode and per-source
energies are those of one PE, and apply to every PE of any array.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np

from . import isa
from .hw import BASELINE, BUS_N_TO_M
from .isa import OP, PEInstr, Program, ProgramBuilder, asm

K_REPS = 12
MEM_SIZE = 4096
MAX_STEPS = 64
ROWS = COLS = 4


def _per_op(default, **overrides) -> np.ndarray:
    t = np.full(isa.N_OPS, float(default), np.float32)
    for name, v in overrides.items():
        t[OP[name]] = v
    return t


# the physical model of src/repro_torch/core/physical.py (DEFAULT_PHYS)
PHYS = dict(
    p_dec=_per_op(100.0, NOP=60.0, EXIT=60.0, SMUL=140.0, BEQ=90.0,
                  BNE=90.0, BLT=90.0, BGE=90.0, JUMP=85.0, LWD=110.0,
                  SWD=110.0, LWI=112.0, SWI=112.0),
    p_act=_per_op(40.0, NOP=20.0, EXIT=20.0, SMUL=120.0, LWD=80.0,
                  SWD=80.0, LWI=82.0, SWI=82.0),
    p_idle=20.0, alpha_toggle=0.5, e_sw_op=25.0, e_sw_mux=8.0,
    e_src=np.array([0.0, 4.0, 8.0, 14.0], np.float32), mulzero_factor=0.3)


def _i32(x: int) -> int:
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _alu(op: int, a: int, b: int) -> int:
    O = OP
    sh = b & 31
    if op == O["SADD"]:
        return _i32(a + b)
    if op == O["SSUB"]:
        return _i32(a - b)
    if op == O["SMUL"]:
        return _i32(a * b)
    if op == O["SLL"]:
        return _i32(a << sh)
    if op == O["SRL"]:
        return _i32((a & 0xFFFFFFFF) >> sh)
    if op == O["SRA"]:
        return a >> sh
    if op == O["LAND"]:
        return _i32(a & b)
    if op == O["LOR"]:
        return _i32(a | b)
    if op == O["LXOR"]:
        return _i32(a ^ b)
    if op == O["SLT"]:
        return int(a < b)
    if op == O["MV"]:
        return a
    return 0


class Trace(NamedTuple):
    """The executed instructions, padded to ``MAX_STEPS`` rows."""
    pc: np.ndarray      # (S,) -1 past the end
    valid: np.ndarray   # (S,) bool
    a: np.ndarray       # (S, P)
    b: np.ndarray       # (S, P)
    busy: np.ndarray    # (S, P)
    lat: np.ndarray     # (S,)


def simulate(program: Program, hw: dict = BASELINE) -> Trace:
    """One design point from a zero image, one PE at a time: operands are
    sampled at the start of an instruction, loads read the image as it
    was, stores land in ascending PE order, memory requests take issue
    slots from a greedy in-order scheduler over bank ports and DMAs."""
    P = program.n_pes
    nbr = isa.neighbour_index_maps(ROWS, COLS)
    mem = np.zeros(MEM_SIZE, np.int64)
    regs = np.zeros((4, P), np.int64)
    rout = np.zeros(P, np.int64)
    S = MAX_STEPS
    tr = Trace(np.full(S, -1, np.int32), np.zeros(S, bool),
               np.zeros((S, P), np.int32), np.zeros((S, P), np.int32),
               np.zeros((S, P), np.int32), np.zeros(S, np.int32))
    nb = max(int(hw["n_banks"]), 1)
    pc = 0
    for s in range(S):
        ops, imm = program.ops[pc], program.imm[pc]

        def operand(src, p):
            name = isa.SOURCES[src]
            if name == "ZERO":
                return 0
            if name == "IMM":
                return int(imm[p])
            if name == "ROUT":
                return int(rout[p])
            if name in nbr:
                return int(rout[nbr[name][p]])
            return int(regs[int(name[1])][p])

        a = [operand(program.srcA[pc][p], p) for p in range(P)]
        b = [operand(program.srcB[pc][p], p) for p in range(P)]
        old = mem.copy()
        bank_free: Dict[int, int] = {}
        dma_free: Dict[int, int] = {}
        busy = [1] * P
        result = [0] * P
        for p in range(P):
            op = int(ops[p])
            if isa.IS_LOAD[op] or isa.IS_STORE[op]:
                direct = op in (OP["LWD"], OP["SWD"])
                addr = (int(imm[p]) if direct else a[p]) % MEM_SIZE
                if isa.IS_LOAD[op]:
                    result[p] = int(old[addr])
                else:
                    mem[addr] = a[p] if op == OP["SWD"] else b[p]
                if hw["bus"] == BUS_N_TO_M:
                    bank = (addr % nb if hw["interleaved"] else
                            min(max(addr // max(MEM_SIZE // nb, 1), 0),
                                int(hw["n_banks"]) - 1))
                else:
                    bank = 0
                dma = p if hw["dma_per_pe"] else p % COLS
                slot = max(bank_free.get(bank, 0), dma_free.get(dma, 0))
                bank_free[bank] = dma_free[dma] = slot + 1
                busy[p] = slot + int(hw["t_mem"])
            else:
                result[p] = _alu(op, a[p], b[p])
                if op == OP["SMUL"]:
                    busy[p] = int(hw["smul_lat"])
        lat = max(busy)
        taken = [p for p in range(P) if
                 (ops[p] == OP["BEQ"] and a[p] == b[p])
                 or (ops[p] == OP["BNE"] and a[p] != b[p])
                 or (ops[p] == OP["BLT"] and a[p] < b[p])
                 or (ops[p] == OP["BGE"] and a[p] >= b[p])
                 or ops[p] == OP["JUMP"]]
        for p in range(P):
            if isa.WRITES_ROUT[int(ops[p])]:
                rout[p] = result[p]
                d = int(program.dest[pc][p])
                if d != isa.DEST["ROUT"]:
                    regs[d][p] = result[p]
        tr.pc[s], tr.valid[s], tr.lat[s] = pc, True, lat
        tr.a[s], tr.b[s], tr.busy[s] = a, b, busy
        if (ops == OP["EXIT"]).any():
            break
        nxt = int(imm[taken[0]]) if taken else pc + 1
        pc = min(max(nxt, 0), program.n_instrs - 1)
    return tr


# ---- trace.py and detailed.py ------------------------------------------

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def _popcount(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros(x.shape, np.int32)
    for shift in (0, 8, 16, 24):
        out += _POP8[(u >> shift) & 0xFF]
    return out


def _changed(field: np.ndarray, valid: np.ndarray) -> np.ndarray:
    ch = field != np.roll(field, 1, axis=0)
    ch[0] = False
    return ch & valid[:, None]


def _report(program: Program, tr: Trace, hw: dict):
    """(latency_cc, per-(step, PE) energy components, dense fields)."""
    valid = tr.valid
    safe = np.where(valid, tr.pc, 0)
    ops = np.where(~valid[:, None], OP["NOP"], program.ops[safe])
    srcA, srcB = program.srcA[safe], program.srcB[safe]
    v = valid[:, None].astype(np.float32)
    busy = tr.busy.astype(np.float32)
    lat = tr.lat.astype(np.float32)[:, None]
    a_prev = np.roll(tr.a, 1, axis=0)
    a_prev[0] = 0
    b_prev = np.roll(tr.b, 1, axis=0)
    b_prev[0] = 0
    tog = ((_popcount(tr.a ^ a_prev) + _popcount(tr.b ^ b_prev)) / 64.0
           ).astype(np.float32) * valid[:, None]
    act_factor = 1.0 + PHYS["alpha_toggle"] * tog
    smul = ops == OP["SMUL"]
    smul_scale = np.where(smul, float(hw["smul_power_scale"]), 1.0)
    gate = np.where(smul & ((tr.a == 0) | (tr.b == 0)),
                    PHYS["mulzero_factor"], 1.0)
    decode = PHYS["p_dec"][ops] * smul_scale * act_factor * v
    active = (PHYS["p_act"][ops] * smul_scale * gate * act_factor
              * np.maximum(busy - 1.0, 0.0) * v)
    idle = PHYS["p_idle"] * np.maximum(lat - busy, 0.0) * v
    fetch = (PHYS["e_src"][isa.SRC_KIND[srcA]]
             + PHYS["e_src"][isa.SRC_KIND[srcB]]) * v
    switch = (_changed(ops, valid) * PHYS["e_sw_op"]
              + (_changed(srcA, valid).astype(np.float32)
                 + _changed(srcB, valid).astype(np.float32))
              * PHYS["e_sw_mux"]) * v
    parts = [x.astype(np.float32) for x in (decode, active, idle, fetch,
                                            switch)]
    return int(tr.lat.sum()), parts


def _waveform(tr: Trace, latency_cc: int, parts) -> np.ndarray:
    """Per-cycle per-PE power (total_cc, P) in uW."""
    decode, active, idle, fetch, switch = parts
    S, P = tr.busy.shape
    out = np.zeros((max(latency_cc, 1), P), np.float32)
    t = 0
    for s in range(S):
        if not tr.valid[s]:
            break
        L = int(tr.lat[s])
        if L <= 0:
            continue
        for p in range(P):
            B = max(int(tr.busy[s, p]), 1)
            out[t, p] += decode[s, p] + fetch[s, p] + switch[s, p]
            if B > 1:
                out[t + 1:t + B, p] += active[s, p] / (B - 1)
            if L > B:
                out[t + B:t + L, p] += idle[s, p] / (L - B)
        t += L
    return out


def _measure(program: Program, hw: dict):
    tr = simulate(program, hw)
    latency_cc, parts = _report(program, tr, hw)
    return latency_cc, _waveform(tr, latency_cc, parts)


# ---- characterization.py -------------------------------------------------

def _pattern(n: int, seed: int = 0x1234) -> np.ndarray:
    out, x = [], seed
    for _ in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out.append(x)
    return np.array(out, np.int64).astype(np.int32)


def _op_kernel(op, a, b, imms, *, single_pe: bool,
               prologue: Optional[Callable] = None) -> Program:
    pb = ProgramBuilder(16, f"chr_{op}_{a}_{b}")
    if prologue:
        prologue(pb)
    for k in range(K_REPS):
        slot = PEInstr.make(op, "ROUT", a, b, int(imms[k % len(imms)]))
        pb.instr({p: slot for p in ([0] if single_pe else range(16))})
    pb.exit()
    return pb.build()


def _blocks(wf: np.ndarray, offset: int, lat: int) -> np.ndarray:
    return wf[offset:offset + K_REPS * lat].reshape(K_REPS, lat, -1)


def characterize(hw: dict = BASELINE) -> dict:
    """The profile fields: p_flat, lat, t_mem, p_dec, p_act, p_idle,
    e_src, e_sw_op, e_sw_mux, mulzero, t_clk_ns."""
    pat = _pattern(K_REPS)
    pat_nz = np.abs(pat) % 1000 + 1
    addr_pat = np.abs(pat) % 64

    _, wf = _measure(_op_kernel("NOP", "ZERO", "ZERO", [0],
                                single_pe=False), hw)
    p_flat = float(wf[:K_REPS].mean())
    p_dec = np.zeros(isa.N_OPS, np.float32)
    p_act = np.zeros(isa.N_OPS, np.float32)
    lat = np.ones(isa.N_OPS, np.int32)
    p_dec[OP["NOP"]] = float(_blocks(wf, 0, 1)[1:].mean())
    p_act[OP["NOP"]] = p_dec[OP["NOP"]]

    cases = {
        "SADD": ("IMM", "IMM", pat_nz), "SSUB": ("IMM", "IMM", pat_nz),
        "SMUL": ("IMM", "IMM", pat_nz), "SLL": ("IMM", "IMM", pat_nz % 7),
        "SRL": ("IMM", "IMM", pat_nz % 7), "SRA": ("IMM", "IMM", pat_nz % 7),
        "LAND": ("IMM", "IMM", pat_nz), "LOR": ("IMM", "IMM", pat_nz),
        "LXOR": ("IMM", "IMM", pat_nz), "SLT": ("IMM", "IMM", pat_nz),
        "MV": ("IMM", "ZERO", pat_nz),
        "LWD": ("ZERO", "ZERO", addr_pat), "SWD": ("IMM", "ZERO", addr_pat),
        "LWI": ("IMM", "ZERO", addr_pat), "SWI": ("IMM", "IMM", addr_pat),
    }
    for op, (a, b, imms) in cases.items():
        latency_cc, wf = _measure(_op_kernel(op, a, b, imms,
                                             single_pe=True), hw)
        lat_op = (latency_cc - 1) // K_REPS
        lat[OP[op]] = lat_op
        blk = _blocks(wf, 0, lat_op)[1:]
        p_dec[OP[op]] = float(blk[:, 0, 0].mean())
        p_act[OP[op]] = (float(blk[:, 1:, 0].mean()) if lat_op > 1
                         else p_dec[OP[op]])
    for op in ("JUMP", "BEQ", "BNE", "BLT", "BGE"):
        pb = ProgramBuilder(16, f"chr_{op}")
        for k in range(K_REPS):
            pb.instr({0: PEInstr.make(op, "ROUT", "ZERO", "ZERO", k + 1)})
        pb.exit()
        latency_cc, wf = _measure(pb.build(), hw)
        lat[OP[op]] = (latency_cc - 1) // K_REPS
        p_dec[OP[op]] = float(_blocks(wf, 0, 1)[1:, 0, 0].mean())
        p_act[OP[op]] = p_dec[OP[op]]
    lat[OP["EXIT"]] = 1
    p_dec[OP["EXIT"]] = p_dec[OP["NOP"]]
    p_act[OP["EXIT"]] = p_act[OP["NOP"]]
    t_mem = int(lat[OP["LWD"]])

    pb = ProgramBuilder(16, "chr_idle")
    for k in range(K_REPS):
        pb.instr({0: asm("SMUL", "ROUT", "IMM", "IMM", imm=int(pat_nz[k]))})
    pb.exit()
    _, wf = _measure(pb.build(), hw)
    lat_smul = int(lat[OP["SMUL"]])
    p_idle = (float(_blocks(wf, 0, lat_smul)[1:][:, 1:, 1].mean())
              if lat_smul > 1 else p_flat)

    def set_regs(pb):
        for dest in ("R0", "R1", "ROUT"):
            pb.instr({q: asm("MV", dest, "IMM", imm=77) for q in range(16)})

    def cycle0(prog):
        return float(_blocks(_measure(prog, hw)[1], 3, 1)[1:, 0, 0].mean())

    base_imm = cycle0(_op_kernel("SADD", "IMM", "IMM", [77], single_pe=True,
                                 prologue=set_regs))
    c_zero = cycle0(_op_kernel("SADD", "ZERO", "ZERO", [0], single_pe=True,
                               prologue=set_regs))
    c_reg = cycle0(_op_kernel("SADD", "R0", "R1", [0], single_pe=True,
                              prologue=set_regs))
    c_nbr = cycle0(_op_kernel("SADD", "RCL", "RCR", [0], single_pe=True,
                              prologue=set_regs))
    e_src = np.array([(c_zero - base_imm) / 2.0, 0.0,
                      (c_reg - base_imm) / 2.0,
                      (c_nbr - base_imm) / 2.0], np.float32)

    def alt(ops_ab, srcs_a) -> float:
        pb = ProgramBuilder(16, "chr_sw")
        for k in range(K_REPS):
            pb.instr({0: PEInstr.make(ops_ab[k % 2], "ROUT", srcs_a[k % 2],
                                      "IMM", 77)})
        pb.exit()
        return float(_blocks(_measure(pb.build(), hw)[1], 0, 1)
                     [1:, 0, 0].mean())

    c_alt_op = alt(("SADD", "SSUB"), ("IMM", "IMM"))
    c_sadd = alt(("SADD", "SADD"), ("IMM", "IMM"))
    c_ssub = alt(("SSUB", "SSUB"), ("IMM", "IMM"))
    e_sw_op = max(float(c_alt_op - (c_sadd + c_ssub) / 2.0), 0.0)
    c_alt_mux = alt(("SADD", "SADD"), ("ZERO", "IMM"))
    c_zero_a = alt(("SADD", "SADD"), ("ZERO", "ZERO"))
    e_sw_mux = max(float(c_alt_mux - (c_sadd + c_zero_a) / 2.0), 0.0)

    if lat_smul > 1:
        wfz = _measure(_op_kernel("SMUL", "ZERO", "IMM", [77],
                                  single_pe=True), hw)[1]
        wfn = _measure(_op_kernel("SMUL", "IMM", "IMM", [77],
                                  single_pe=True), hw)[1]
        az = _blocks(wfz, 0, lat_smul)[1:, 1:, 0].mean()
        an = _blocks(wfn, 0, lat_smul)[1:, 1:, 0].mean()
        mulzero = float(az / an) if an > 0 else 1.0
    else:
        mulzero = 1.0
    return dict(p_flat=p_flat, lat=lat, t_mem=t_mem, p_dec=p_dec,
                p_act=p_act, p_idle=p_idle, e_src=e_src, e_sw_op=e_sw_op,
                e_sw_mux=e_sw_mux, mulzero=mulzero,
                t_clk_ns=float(hw["t_clk_ns"]))

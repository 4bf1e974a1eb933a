"""Instruction-set architecture of the modelled time-multiplexed CGRA.

The ISA follows OpenEdgeCGRA (Rodriguez Alvarez et al., CF'23), the
open-hardware CGRA validated in the paper: a 4x4 array of PEs sharing a
program counter.  One CGRA *instruction* is a vector of (op, dest, srcA,
srcB, imm) tuples -- one per PE.  All PEs advance to the next instruction
together once the slowest PE of the current instruction has finished
(lockstep, shared PC).

Operand sources: immediate values, the PE's own register file (R0..R3),
its own output register (ROUT), or the output register of one of its four
torus neighbours (RCL/RCR/RCT/RCB = left/right/top/bottom).

Assumption changes vs. the silicon (documented per DESIGN.md):
  * the array is a torus (edge PEs wrap around), matching OpenEdgeCGRA;
  * when several PEs take a branch in the same instruction, the
    lowest-indexed PE wins (the paper shows multiple BEQ/BNE per
    instruction but does not define the tie-break);
  * stores from several PEs to the same address in the same instruction
    resolve in ascending PE order (bus arbitration order), so the
    highest-indexed PE's value persists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Opcodes
# --------------------------------------------------------------------------

OPCODES: Tuple[str, ...] = (
    "NOP",    # 0  do nothing
    "EXIT",   # 1  halt the kernel
    "SADD",   # 2  rout = a + b
    "SSUB",   # 3  rout = a - b
    "SMUL",   # 4  rout = a * b           (3 cc on OpenEdgeCGRA)
    "SLL",    # 5  rout = a << (b & 31)
    "SRL",    # 6  rout = (unsigned a) >> (b & 31)
    "SRA",    # 7  rout = a >> (b & 31)   (arithmetic)
    "LAND",   # 8  rout = a & b
    "LOR",    # 9  rout = a | b
    "LXOR",   # 10 rout = a ^ b
    "SLT",    # 11 rout = (a < b) ? 1 : 0
    "MV",     # 12 rout = a
    "BEQ",    # 13 if a == b: pc = imm
    "BNE",    # 14 if a != b: pc = imm
    "BLT",    # 15 if a <  b: pc = imm
    "BGE",    # 16 if a >= b: pc = imm
    "JUMP",   # 17 pc = imm
    "LWD",    # 18 rout = mem[imm]        (load word, direct addressing)
    "SWD",    # 19 mem[imm] = a           (store word, direct addressing)
    "LWI",    # 20 rout = mem[a]          (load word, indirect: address in srcA)
    "SWI",    # 21 mem[a] = b             (store word, indirect)
)
OP: Dict[str, int] = {name: i for i, name in enumerate(OPCODES)}
N_OPS = len(OPCODES)

# Opcode classes (static masks used by the simulator / estimator).
ALU_OPS = tuple(OP[o] for o in
                ("SADD", "SSUB", "SMUL", "SLL", "SRL", "SRA",
                 "LAND", "LOR", "LXOR", "SLT", "MV"))
BRANCH_OPS = tuple(OP[o] for o in ("BEQ", "BNE", "BLT", "BGE", "JUMP"))
LOAD_OPS = (OP["LWD"], OP["LWI"])
STORE_OPS = (OP["SWD"], OP["SWI"])
MEM_OPS = LOAD_OPS + STORE_OPS

IS_LOAD = np.zeros(N_OPS, np.bool_); IS_LOAD[list(LOAD_OPS)] = True
IS_STORE = np.zeros(N_OPS, np.bool_); IS_STORE[list(STORE_OPS)] = True
IS_MEM = IS_LOAD | IS_STORE
IS_BRANCH = np.zeros(N_OPS, np.bool_); IS_BRANCH[list(BRANCH_OPS)] = True
IS_ALU = np.zeros(N_OPS, np.bool_); IS_ALU[list(ALU_OPS)] = True
# Ops whose result is written to ROUT (and optionally a register).
WRITES_ROUT = np.zeros(N_OPS, np.bool_)
WRITES_ROUT[list(ALU_OPS)] = True
WRITES_ROUT[list(LOAD_OPS)] = True

# --------------------------------------------------------------------------
# Operand sources
# --------------------------------------------------------------------------

SOURCES: Tuple[str, ...] = (
    "ZERO",   # 0 constant 0
    "IMM",    # 1 the instruction immediate
    "R0",     # 2 own register file
    "R1",     # 3
    "R2",     # 4
    "R3",     # 5
    "ROUT",   # 6 own output register
    "RCL",    # 7 left   neighbour's output register
    "RCR",    # 8 right  neighbour's output register
    "RCT",    # 9 top    neighbour's output register
    "RCB",    # 10 bottom neighbour's output register
)
SRC: Dict[str, int] = {name: i for i, name in enumerate(SOURCES)}
N_SRCS = len(SOURCES)

# Source *kind* for the value-dependent power model of case (vi):
# 0 = zero, 1 = immediate, 2 = own register (R0..R3, ROUT), 3 = neighbour.
SRC_KIND = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3], np.int32)
N_SRC_KINDS = 4

# --------------------------------------------------------------------------
# Destinations
# --------------------------------------------------------------------------

DESTS: Tuple[str, ...] = ("R0", "R1", "R2", "R3", "ROUT")
DEST: Dict[str, int] = {name: i for i, name in enumerate(DESTS)}
DEST_ROUT_ONLY = DEST["ROUT"]  # 4: write ROUT only (the default)

# --------------------------------------------------------------------------
# Grid / neighbours
# --------------------------------------------------------------------------


def neighbour_index_maps(rows: int, cols: int) -> Dict[str, np.ndarray]:
    """Torus neighbour index maps, PE indices row-major."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    return {
        "RCL": np.roll(idx, +1, axis=1).reshape(-1),
        "RCR": np.roll(idx, -1, axis=1).reshape(-1),
        "RCT": np.roll(idx, +1, axis=0).reshape(-1),
        "RCB": np.roll(idx, -1, axis=0).reshape(-1),
    }


# --------------------------------------------------------------------------
# Decoded instruction word (also the bitstream layout, see bitstream.py)
# --------------------------------------------------------------------------
#   op    : 5 bits   (22 opcodes)
#   dest  : 3 bits   (5 destinations)
#   srcA  : 4 bits   (11 sources)
#   srcB  : 4 bits   (11 sources)
#   imm   : 32 bits  (sign-extended)
# total   : 48 bits per PE per instruction.

FIELD_BITS = {"op": 5, "dest": 3, "srcA": 4, "srcB": 4, "imm": 32}
WORD_BITS = sum(FIELD_BITS.values())


@dataclasses.dataclass(frozen=True)
class PEInstr:
    """One PE's slot of a CGRA instruction (decoded form)."""
    op: int = OP["NOP"]
    dest: int = DEST_ROUT_ONLY
    srcA: int = SRC["ZERO"]
    srcB: int = SRC["ZERO"]
    imm: int = 0

    @staticmethod
    def make(op: str, dest: str = "ROUT", a: str = "ZERO", b: str = "ZERO",
             imm: int = 0) -> "PEInstr":
        return PEInstr(OP[op], DEST[dest], SRC[a], SRC[b], int(imm))


NOP_SLOT = PEInstr()


def asm(op: str, dest: str = "ROUT", a: str = "ZERO", b: str = "ZERO",
        imm: int = 0) -> PEInstr:
    """Shorthand used throughout apps/ to build PE slots."""
    return PEInstr.make(op, dest, a, b, imm)

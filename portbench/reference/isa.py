"""The CGRA's instruction set and program builder, frozen for the benchmark.

A frozen copy of ``src/repro_torch/core/isa.py`` (opcodes, operand
sources, destinations, the static opcode masks, ``PEInstr``/``asm``),
of ``ProgramBuilder`` from ``src/repro_torch/core/program.py`` and of
``KernelCase``/``fresh_mem`` from ``src/repro_torch/apps/common.py``.
It imports nothing of the program under test: the benchmark builds its
programs with it and hands the same arrays to the program and to the
plain reference (``sweep.py``).

Semantics (OpenEdgeCGRA): a torus of PEs (4x4 on the OpenEdgeCGRA,
``rows`` x ``cols`` in general) sharing one program counter; one CGRA instruction is a (op, dest, srcA, srcB, imm) slot per
PE; the instruction retires when its slowest PE is done.  When several
PEs branch in one instruction the lowest-indexed PE wins; stores from
several PEs to one address land in ascending PE order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

OPCODES: Tuple[str, ...] = (
    "NOP", "EXIT", "SADD", "SSUB", "SMUL", "SLL", "SRL", "SRA", "LAND",
    "LOR", "LXOR", "SLT", "MV", "BEQ", "BNE", "BLT", "BGE", "JUMP", "LWD",
    "SWD", "LWI", "SWI")
OP: Dict[str, int] = {name: i for i, name in enumerate(OPCODES)}
N_OPS = len(OPCODES)

ALU_OPS = tuple(OP[o] for o in ("SADD", "SSUB", "SMUL", "SLL", "SRL", "SRA",
                                "LAND", "LOR", "LXOR", "SLT", "MV"))
BRANCH_OPS = tuple(OP[o] for o in ("BEQ", "BNE", "BLT", "BGE", "JUMP"))
LOAD_OPS = (OP["LWD"], OP["LWI"])
STORE_OPS = (OP["SWD"], OP["SWI"])

IS_LOAD = np.zeros(N_OPS, np.bool_)
IS_LOAD[list(LOAD_OPS)] = True
IS_STORE = np.zeros(N_OPS, np.bool_)
IS_STORE[list(STORE_OPS)] = True
IS_BRANCH = np.zeros(N_OPS, np.bool_)
IS_BRANCH[list(BRANCH_OPS)] = True
WRITES_ROUT = np.zeros(N_OPS, np.bool_)
WRITES_ROUT[list(ALU_OPS)] = True
WRITES_ROUT[list(LOAD_OPS)] = True

SOURCES: Tuple[str, ...] = ("ZERO", "IMM", "R0", "R1", "R2", "R3", "ROUT",
                            "RCL", "RCR", "RCT", "RCB")
SRC: Dict[str, int] = {name: i for i, name in enumerate(SOURCES)}
# operand-source kind of the case-(vi) power model: zero, immediate,
# own register (R0..R3, ROUT), neighbour
SRC_KIND = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3], np.int32)

DESTS: Tuple[str, ...] = ("R0", "R1", "R2", "R3", "ROUT")
DEST: Dict[str, int] = {name: i for i, name in enumerate(DESTS)}


def neighbour_index_maps(rows: int, cols: int) -> Dict[str, np.ndarray]:
    """Torus neighbour index maps, PE indices row-major."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    return {"RCL": np.roll(idx, +1, axis=1).reshape(-1),
            "RCR": np.roll(idx, -1, axis=1).reshape(-1),
            "RCT": np.roll(idx, +1, axis=0).reshape(-1),
            "RCB": np.roll(idx, -1, axis=0).reshape(-1)}


@dataclasses.dataclass(frozen=True)
class PEInstr:
    """One PE's slot of a CGRA instruction."""
    op: int = OP["NOP"]
    dest: int = DEST["ROUT"]
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
    return PEInstr.make(op, dest, a, b, imm)


FIELDS = ("ops", "dest", "srcA", "srcB", "imm")


@dataclasses.dataclass(frozen=True)
class Program:
    """Dense array form of a kernel: ``(T, P)`` int32 per field."""
    ops: np.ndarray
    dest: np.ndarray
    srcA: np.ndarray
    srcB: np.ndarray
    imm: np.ndarray
    name: str = "kernel"

    @property
    def n_instrs(self) -> int:
        return int(self.ops.shape[0])

    @property
    def n_pes(self) -> int:
        return int(self.ops.shape[1])

    def arrays(self) -> Dict[str, np.ndarray]:
        return {f: getattr(self, f) for f in FIELDS}


class ProgramBuilder:
    """Builds a Program one CGRA instruction at a time."""

    def __init__(self, n_pes: int = 16, name: str = "kernel"):
        self.n_pes = n_pes
        self.name = name
        self._instrs: List[List[PEInstr]] = []

    def __len__(self) -> int:
        return len(self._instrs)

    def instr(self, slots: Optional[Dict[int, PEInstr]] = None) -> int:
        """Append one instruction (unnamed PEs execute NOP); returns its
        index, usable as a branch target."""
        row = [NOP_SLOT] * self.n_pes
        for pe, s in (slots or {}).items():
            if not 0 <= pe < self.n_pes:
                raise ValueError(f"PE index {pe} out of range")
            row[pe] = s
        self._instrs.append(row)
        return len(self._instrs) - 1

    def exit(self, pe: int = 0) -> int:
        return self.instr({pe: PEInstr(op=OP["EXIT"])})

    def build(self) -> Program:
        f = lambda attr: np.array(
            [[getattr(s, attr) for s in row] for row in self._instrs],
            np.int32)
        prog = Program(f("op"), f("dest"), f("srcA"), f("srcB"), f("imm"),
                       name=self.name)
        br = IS_BRANCH[prog.ops]
        if br.any() and not (0 <= prog.imm[br].min()
                             and prog.imm[br].max() < prog.n_instrs):
            raise ValueError(f"program {self.name!r}: branch target out of "
                             f"range")
        return prog


MEM_SIZE = 4096


def fresh_mem() -> np.ndarray:
    return np.zeros(MEM_SIZE, np.int32)


@dataclasses.dataclass
class KernelCase:
    """A kernel with its default data image and correctness oracle."""
    name: str
    program: Program
    mem_init: np.ndarray
    check: Callable[[np.ndarray], bool]
    expected: Optional[np.ndarray] = None
    max_steps: int = 2048
    notes: str = ""

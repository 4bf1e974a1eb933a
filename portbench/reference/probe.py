"""A seeded probe kernel for an array of any shape.

The benchmark's conv and MiBench kernels are mappings onto the 4x4
array.  The probe is a kernel for any ``rows`` x ``cols`` array that
touches what the array's shape changes: every PE reads all four
neighbours, loads and stores, direct and indirect, to addresses that
meet on banks and on DMA engines and to one address from several PEs at
once, and a loop closes by a taken branch while a higher PE's jump
loses to it.  Its values are drawn from the seed.

``emit`` writes it into any builder with ``instr``/``exit``, given the
``asm`` of the builder's instruction set: this package's (``isa``) or
another's with the same slots, so two implementations can be handed the
same program.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from . import isa

NEIGHBOURS = ("RCL", "RCR", "RCT", "RCB")
ALU = ("SADD", "SSUB", "SMUL", "SLL", "SRL", "SRA", "LAND", "LOR", "LXOR",
       "SLT", "MV")
OWN = ("R0", "R1", "R2", "ROUT", "IMM")
TRIPS = 3           # times round the loop


def emit(pb, asm: Callable, rows: int, cols: int, seed: int) -> None:
    """The probe's instructions, appended to the builder ``pb``."""
    P = rows * cols
    rng = np.random.default_rng([int(seed), rows, cols])
    pes = range(P)
    draw = lambda lo, hi: int(rng.integers(lo, hi))
    pb.instr({p: asm("SADD", "R0", "ZERO", "IMM", imm=draw(-99, 99))
              for p in pes})
    pb.instr({p: asm("SADD", "R1", "ZERO", "IMM", imm=draw(0, 4096))
              for p in pes})
    pb.instr({0: asm("SADD", "R3", "ZERO", "IMM", imm=TRIPS),
              **{p: asm("SADD", "R2", "ZERO", "IMM", imm=draw(-9, 9))
                 for p in pes if p}})
    loop = len(pb)
    for k in range(2):
        # over these four instructions every PE reads all four neighbours
        pb.instr({p: asm(ALU[draw(0, len(ALU))], "ROUT",
                         NEIGHBOURS[(p + 2 * k) % 4], OWN[draw(0, len(OWN))],
                         imm=draw(-5, 5)) for p in pes})
        pb.instr({p: asm("SADD", "R2", NEIGHBOURS[(p + 2 * k + 1) % 4],
                         "R2") for p in pes})
    # direct loads from the first 64 words (one bank when blocked, all
    # banks when interleaved), indirect ones from anywhere
    pb.instr({p: asm("LWD", "R0", imm=draw(0, 64)) if p % 2 else
              asm("LWI", "R0", "R1") for p in pes})
    # stores: several PEs to each of three words, the rest indirect
    words = [draw(64, 4096) for _ in range(3)]
    pb.instr({p: asm("SWD", a="R2", imm=words[p % 3]) if p % 2 else
              asm("SWI", a="R1", b="ROUT") for p in pes})
    pb.instr({p: asm("SADD", "R1", "R1", "R0") for p in pes})
    pb.instr({0: asm("SSUB", "R3", "R3", "IMM", imm=1)})
    after = len(pb) + 1
    pb.instr({0: asm("BNE", a="R3", b="ZERO", imm=loop),
              P - 1: asm("JUMP", imm=after)})
    pb.exit()


def probe(rows: int = 4, cols: int = 4, seed: int = 0) -> isa.KernelCase:
    """The probe built with this package's builder; no oracle of its own
    (the plain reference is one)."""
    pb = isa.ProgramBuilder(rows * cols, f"probe-{rows}x{cols}-{seed}")
    emit(pb, isa.asm, rows, cols, seed)
    return isa.KernelCase(pb.name, pb.build(), isa.fresh_mem(),
                          check=lambda mem: True)

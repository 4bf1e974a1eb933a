"""Trace utilities: static-field gather and derived per-step quantities.

A StepRecord trace (cgra.py) records only data-dependent values; everything
that is static per instruction index (opcode, operand sources, immediate)
is gathered from the Program by trace.pcs.  These helpers produce the dense
(S, P) views the detailed simulator and the estimator both consume.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from . import isa
from .program import Program


class DenseTrace(NamedTuple):
    """Host-side (numpy) dense view of an executed trace."""
    valid: np.ndarray      # (S,)  bool
    pcs: np.ndarray        # (S,)  int32
    ops: np.ndarray        # (S,P) opcode per PE
    srcA: np.ndarray       # (S,P)
    srcB: np.ndarray       # (S,P)
    a: np.ndarray          # (S,P) operand values
    b: np.ndarray          # (S,P)
    busy: np.ndarray       # (S,P) per-PE busy cycles
    lat: np.ndarray        # (S,)  instruction latency
    mem_addr: np.ndarray   # (S,P)
    n_steps: int           # number of valid steps
    total_cc: int          # true total latency


def densify(program: Program, trace) -> DenseTrace:
    """Gather static program fields along the executed pc sequence."""
    valid = np.asarray(trace.valid)
    pcs = np.asarray(trace.pc)
    safe = np.where(valid, pcs, 0)
    ops = program.ops[safe]
    srcA = program.srcA[safe]
    srcB = program.srcB[safe]
    nopify = ~valid[:, None]
    ops = np.where(nopify, isa.OP["NOP"], ops)
    return DenseTrace(
        valid=valid, pcs=pcs, ops=ops.astype(np.int32),
        srcA=srcA.astype(np.int32), srcB=srcB.astype(np.int32),
        a=np.asarray(trace.a), b=np.asarray(trace.b),
        busy=np.asarray(trace.busy), lat=np.asarray(trace.lat),
        mem_addr=np.asarray(trace.mem_addr),
        n_steps=int(valid.sum()), total_cc=int(np.asarray(trace.lat).sum()))


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def popcount(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of int32 values (as 32-bit patterns)."""
    u = x.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros(x.shape, np.int32)
    for shift in (0, 8, 16, 24):
        out += _POP8[(u >> shift) & 0xFF]
    return out


def toggle_density(dt: DenseTrace) -> np.ndarray:
    """Per (step, PE) operand toggle activity in [0, 1]: Hamming distance of
    this instruction's operands vs the PE's previous operands."""
    a_prev = np.roll(dt.a, 1, axis=0); a_prev[0] = 0
    b_prev = np.roll(dt.b, 1, axis=0); b_prev[0] = 0
    tog = (popcount(dt.a ^ a_prev) + popcount(dt.b ^ b_prev)) / 64.0
    return tog.astype(np.float32) * dt.valid[:, None]


def switch_masks(dt: DenseTrace):
    """(op_changed, srcA_changed, srcB_changed) per (step, PE) vs the
    previously *executed* instruction (datapath reconfiguration cost)."""
    def changed(field):
        prev = np.roll(field, 1, axis=0)
        ch = field != prev
        ch[0] = False  # first instruction: datapath freshly configured
        return ch & dt.valid[:, None]
    return changed(dt.ops), changed(dt.srcA), changed(dt.srcB)

"""Plain PyTorch version of the batched CGRA ALU dispatch.

The oracle of the CUDA kernel (``csrc/cgra_alu.cu``) and the path the
wrapper takes for CPU tensors.  Mirrors ``repro.kernels.cgra_step.ref``:
ops/a/b are int32 planes of any shape, results are 0 for non-ALU
opcodes.
"""
from __future__ import annotations

import torch

from ...core import isa


def alu_ref(ops: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """int32 planes -> int32 results of the same shape."""
    sh = b & 31
    a64 = a.to(torch.int64)
    table = [torch.zeros_like(a)] * isa.N_OPS
    # int32 wraparound: add, sub, mul and shl go through int64 and keep
    # the low 32 bits
    table[isa.OP["SADD"]] = (a64 + b).to(torch.int32)
    table[isa.OP["SSUB"]] = (a64 - b).to(torch.int32)
    table[isa.OP["SMUL"]] = ((a64 * b) & 0xFFFFFFFF).to(torch.int32)
    table[isa.OP["SLL"]] = ((a64 << sh) & 0xFFFFFFFF).to(torch.int32)
    # torch has no unsigned shift on int32: SRL shifts the 32-bit pattern
    table[isa.OP["SRL"]] = ((a64 & 0xFFFFFFFF) >> sh).to(torch.int32)
    table[isa.OP["SRA"]] = a >> sh
    table[isa.OP["LAND"]] = a & b
    table[isa.OP["LOR"]] = a | b
    table[isa.OP["LXOR"]] = a ^ b
    table[isa.OP["SLT"]] = (a < b).to(torch.int32)
    table[isa.OP["MV"]] = a
    stacked = torch.stack(table)                   # (N_OPS, ...)
    return torch.gather(stacked, 0, ops.long()[None])[0]

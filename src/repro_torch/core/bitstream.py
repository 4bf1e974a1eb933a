"""Bitstream encoding of CGRA programs (Figure 1, deploy arrow).

Once a kernel/hardware pair is chosen, the final instructions are encoded
into the bitstream the CGRA's configuration loader consumes.  Layout per PE
slot (48 bits, little-endian field order, see isa.FIELD_BITS):

    [ op:5 | dest:3 | srcA:4 | srcB:4 | imm:32 ]

The kernel bitstream is the row-major concatenation over (instruction, PE),
serialized as bytes.  Encode/decode round-trips exactly (tested).
"""
from __future__ import annotations

import numpy as np

from .isa import FIELD_BITS
from .program import Program


def encode(program: Program) -> bytes:
    T, P = program.ops.shape
    words = np.zeros((T, P), np.uint64)
    off = 0
    for field, bits in FIELD_BITS.items():
        vals = getattr(program, field if field != "op" else "ops")
        u = (vals.astype(np.int64) & ((1 << bits) - 1)).astype(np.uint64)
        words |= u << np.uint64(off)
        off += bits
    # 48-bit words -> 6 bytes little-endian each
    out = bytearray()
    for w in words.reshape(-1):
        out += int(w).to_bytes(6, "little")
    return bytes(out)


def decode(blob: bytes, n_pes: int = 16, name: str = "decoded") -> Program:
    n_words = len(blob) // 6
    assert n_words % n_pes == 0, "bitstream length not a multiple of array"
    T = n_words // n_pes
    words = np.array([int.from_bytes(blob[i * 6:(i + 1) * 6], "little")
                      for i in range(n_words)], np.uint64).reshape(T, n_pes)
    fields = {}
    off = 0
    for field, bits in FIELD_BITS.items():
        raw = ((words >> np.uint64(off)) & np.uint64((1 << bits) - 1))
        v = raw.astype(np.int64)
        if field == "imm":  # sign-extend 32-bit immediates
            v = np.where(v >= (1 << 31), v - (1 << 32), v)
        fields[field] = v.astype(np.int32)
        off += bits
    return Program(ops=fields["op"], dest=fields["dest"],
                   srcA=fields["srcA"], srcB=fields["srcB"],
                   imm=fields["imm"], name=name).validate()

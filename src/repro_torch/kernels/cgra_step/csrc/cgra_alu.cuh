// CGRA ISA constants and the ALU select, shared by host and device code.
//
// Replaces the ALU of the TPU kernels: `alu_select` in
// src/repro/kernels/cgra_step/kernel.py, which both the standalone
// `alu_dispatch` Pallas kernel and the fused sweep engine
// (src/repro/kernels/cgra_sweep/kernel.py) call.  Here one function,
// `cgra_alu`, serves the standalone kernel (cgra_alu.cu), the sweep
// kernel (cgra_sweep.cu) and a host-compiled test harness, so the three
// dispatch paths are one code path.
//
// Numbering must match repro_torch/core/isa.py (OPCODES, SOURCES).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace cgra {

enum Op : int32_t {
  OP_NOP = 0, OP_EXIT = 1, OP_SADD = 2, OP_SSUB = 3, OP_SMUL = 4,
  OP_SLL = 5, OP_SRL = 6, OP_SRA = 7, OP_LAND = 8, OP_LOR = 9,
  OP_LXOR = 10, OP_SLT = 11, OP_MV = 12, OP_BEQ = 13, OP_BNE = 14,
  OP_BLT = 15, OP_BGE = 16, OP_JUMP = 17, OP_LWD = 18, OP_SWD = 19,
  OP_LWI = 20, OP_SWI = 21, N_OPS = 22
};

enum Src : int32_t {
  SRC_ZERO = 0, SRC_IMM = 1, SRC_R0 = 2, SRC_R1 = 3, SRC_R2 = 4,
  SRC_R3 = 5, SRC_ROUT = 6, SRC_RCL = 7, SRC_RCR = 8, SRC_RCT = 9,
  SRC_RCB = 10
};

// Result of one PE's ALU op; 0 for every non-ALU opcode.
// Wrapping ops are computed on uint32_t: signed overflow is undefined in
// C++, int32 wraparound is what the ISA specifies.  SRL is a logical
// shift, SRA an arithmetic one; the shift amount is b & 31.
__host__ __device__ inline int32_t alu(int32_t op, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  const int sh = b & 31;
  // a chain of selects, not a switch: neighbouring elements (the PEs
  // of a warp) take different opcodes, and a switch would run its cases
  // one after another
  int32_t r = 0;
  r = op == OP_SADD ? static_cast<int32_t>(ua + ub) : r;
  r = op == OP_SSUB ? static_cast<int32_t>(ua - ub) : r;
  r = op == OP_SMUL ? static_cast<int32_t>(ua * ub) : r;
  r = op == OP_SLL ? static_cast<int32_t>(ua << sh) : r;
  r = op == OP_SRL ? static_cast<int32_t>(ua >> sh) : r;
  r = op == OP_SRA ? (a >> sh) : r;
  r = op == OP_LAND ? (a & b) : r;
  r = op == OP_LOR ? (a | b) : r;
  r = op == OP_LXOR ? (a ^ b) : r;
  r = op == OP_SLT ? (a < b ? 1 : 0) : r;
  r = op == OP_MV ? a : r;
  return r;
}

}  // namespace cgra

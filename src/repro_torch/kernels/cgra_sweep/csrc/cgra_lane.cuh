// Per-lane helpers of the sweep kernel (cgra_sweep.cu), on host and device.
//
// Everything here is plain serial C++ over one design point's P PEs, so
// a host-compiled harness (tests/test_torch_csrc_harness.py) checks it
// against the plain PyTorch version without a GPU.  The semantics are
// those of src/repro/kernels/cgra_sweep/kernel.py (`_operands`, `_dedup`,
// `_mem_completion`, the energy terms of `step`) and of
// src/repro/core/memory.py.
#pragma once

#include "cgra_alu.cuh"

namespace cgra {

enum : int32_t { BUS_N_TO_M = 1 };

// Floor modulo and division (Python / NumPy semantics) for m > 0.  C++
// `%` and `/` truncate toward zero, which differs for negative x.
__host__ __device__ inline int32_t floor_mod(int32_t x, int32_t m) {
  const int32_t r = x % m;
  return r < 0 ? r + m : r;
}

__host__ __device__ inline int32_t floor_div(int32_t x, int32_t m) {
  const int32_t q = x / m;
  return (x % m != 0 && x < 0) ? q - 1 : q;
}

// Torus neighbour of `pe` whose ROUT a source selector reads; k = 0..3
// for RCL, RCR, RCT, RCB (np.roll +1/-1 along columns, then rows, as in
// repro_torch/core/isa.py neighbour_index_maps).
__host__ __device__ inline int neighbour(int pe, int k, int rows, int cols) {
  const int r = pe / cols, c = pe % cols;
  switch (k) {
    case 0:  return r * cols + (c + cols - 1) % cols;
    case 1:  return r * cols + (c + 1) % cols;
    case 2:  return ((r + rows - 1) % rows) * cols + c;
    default: return ((r + 1) % rows) * cols + c;
  }
}

// Operand value for a source selector; ZERO and unknown selectors give 0.
__host__ __device__ inline int32_t select_operand(
    int32_t sel, int32_t imm, int32_t r0, int32_t r1, int32_t r2, int32_t r3,
    int32_t rout, int32_t rcl, int32_t rcr, int32_t rct, int32_t rcb) {
  switch (sel) {
    case SRC_IMM:  return imm;
    case SRC_R0:   return r0;
    case SRC_R1:   return r1;
    case SRC_R2:   return r2;
    case SRC_R3:   return r3;
    case SRC_ROUT: return rout;
    case SRC_RCL:  return rcl;
    case SRC_RCR:  return rcr;
    case SRC_RCT:  return rct;
    case SRC_RCB:  return rcb;
    default:       return 0;
  }
}

// Bank of an address: interleaved -> addr mod n_banks; blocked ->
// clip(addr div (M / n_banks), 0, n_banks - 1); a 1-to-M bus is bank 0.
__host__ __device__ inline int32_t bank_of(int32_t addr, int32_t bus,
                                           int32_t interleaved,
                                           int32_t n_banks, int32_t mem_size) {
  if (bus != BUS_N_TO_M) return 0;
  const int32_t nb = n_banks > 1 ? n_banks : 1;
  if (interleaved > 0) return floor_mod(addr, nb);
  int32_t bank_words = mem_size / nb;
  if (bank_words < 1) bank_words = 1;
  int32_t blk = floor_div(addr, bank_words);
  if (blk < 0) blk = 0;
  if (blk > n_banks - 1) blk = n_banks - 1;
  return blk;
}

__host__ __device__ inline int32_t dma_of(int32_t pe, int32_t dma_per_pe,
                                          int32_t cols) {
  return dma_per_pe > 0 ? pe : pe % cols;
}

// The contention model: greedy list scheduling in ascending PE order.
// Each request takes slot = max(bank_free[bank], dma_free[dma]) and
// advances both to slot + 1; it completes at slot + t_mem.  The free
// counters restart at 0 every instruction.  Banks are kept as a list of
// the <= P banks touched this instruction, so no table of n_banks width
// is needed.  `scratch` holds 3 * P ints; `out[p]` is 0 without request.
__host__ __device__ inline void mem_schedule(
    int P, int cols, const int32_t* is_mem, const int32_t* addr, int32_t bus,
    int32_t interleaved, int32_t n_banks, int32_t dma_per_pe, int32_t t_mem,
    int32_t mem_size, int32_t* scratch, int32_t* out) {
  int32_t* bank_id = scratch;
  int32_t* bank_free = scratch + P;
  int32_t* dma_free = scratch + 2 * P;
  for (int d = 0; d < P; ++d) dma_free[d] = 0;
  int n_touched = 0;
  for (int p = 0; p < P; ++p) {
    if (!is_mem[p]) {
      out[p] = 0;
      continue;
    }
    const int32_t b = bank_of(addr[p], bus, interleaved, n_banks, mem_size);
    const int32_t d = dma_of(p, dma_per_pe, cols);
    int k = 0;
    while (k < n_touched && bank_id[k] != b) ++k;
    if (k == n_touched) {
      bank_id[k] = b;
      bank_free[k] = 0;
      ++n_touched;
    }
    const int32_t slot = bank_free[k] > dma_free[d] ? bank_free[k]
                                                    : dma_free[d];
    bank_free[k] = slot + 1;
    dma_free[d] = slot + 1;
    out[p] = slot + t_mem;
  }
}

// Last writer wins: PE `pe`'s store lands unless a higher PE stores to
// the same address in the same instruction.
__host__ __device__ inline bool store_lands(int pe, int P,
                                            const int32_t* is_store,
                                            const int32_t* addr) {
  if (!is_store[pe]) return false;
  for (int q = pe + 1; q < P; ++q)
    if (is_store[q] && addr[q] == addr[pe]) return false;
  return true;
}

// One PE's case-(vi) energy for one instruction, in uW*cc, with the
// terms added in the reference's order (each op rounded on its own).
__host__ __device__ inline float pe_energy(
    float p_dec_op, float p_act_op, float scale, float gate, float active,
    float p_idle, float wait, float e_src_a, float e_src_b, bool op_ch,
    bool a_ch, bool b_ch, float e_sw_op, float e_sw_mux) {
  float e = p_dec_op * scale;
  e = e + p_act_op * scale * gate * active;
  e = e + p_idle * wait;
  e = e + e_src_a;
  e = e + e_src_b;
  e = e + (op_ch ? 1.0f : 0.0f) * e_sw_op;
  e = e + ((a_ch ? 1.0f : 0.0f) + (b_ch ? 1.0f : 0.0f)) * e_sw_mux;
  return e;
}

}  // namespace cgra

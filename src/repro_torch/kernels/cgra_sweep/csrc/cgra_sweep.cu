// Fused CGRA sweep engine: advances independent design points ("lanes")
// of a (program x hardware x data) grid through the cycle-level
// simulator with the fused case-(vi) energy estimate.
//
// Replaces the Pallas kernel of src/repro/kernels/cgra_sweep: the body
// `build_sweep_kernel` (kernel.py) driven chunk by chunk by
// `_pallas_sweep_core` / `_chunk_call` (ops.py).  It computes what that
// body computes; it is not a block-by-block copy.
//
// Design.  One group of P threads per lane, one thread per processing
// element (PE); P is a power of two <= 32, so with the 4x4 array two
// lanes share a warp and talk through width-16 shuffles and ballots.
// Registers and ROUT live in registers.  The lane's memory image stays in
// device memory and is updated in place; the fused instruction-row table
// is read-only.  Each lane loops until its own EXIT, the max_steps
// budget or the end of the chunk, so the early exit that the TPU engine
// did on the host per chunk happens per lane here; frozen lanes never
// change, so results equal the chunked reference for every chunk size.
// Per step a PE: fetches its slot of the row, reads operands (own
// registers, immediates, neighbours' ROUT by shuffle), loads from the
// pre-step image, then -- after the group has loaded -- lands its store
// if no higher PE stores to the same word; PE 0 runs the serial
// ascending-PE bank/DMA scheduler for the group; the ALU is
// cgra::alu from the shared header; latency is a max-reduction, the
// branch winner the lowest set bit of a ballot, the energy a sum.
//
// What bounds it on an H100: integer instructions.  A lane-step is a few
// hundred dependent integer operations per PE (operand select, ALU,
// address, dedup, the serial scheduler, control, energy) against a few
// words of memory traffic, so the bound is the int32 issue rate, not
// bytes.  There is no matrix product, so wgmma and TMA do not apply.
// Making it fast (images in shared memory, a parallel scheduler, fewer
// warp barriers) is later work.
#include <cuda_runtime.h>

#include "cgra_alu.cuh"
#include "cgra_lane.cuh"

namespace {

// Fused row layout (repro_torch/core/program.py ROW_FIELDS).
enum { F_OPS, F_DEST, F_SRCA, F_SRCB, F_IMM, F_ISLD, F_ISST, F_WR, F_KA,
       F_KB, NF };
// Columns of the per-lane integer hardware descriptor.
enum { H_SMUL_LAT, H_BUS, H_INTERLEAVED, H_N_BANKS, H_DMA_PER_PE, H_T_MEM,
       NH };
constexpr int kSmemPerPe = 7;   // addr, is_mem, is_store, done, scratch x3

struct SweepArgs {
  const int32_t* tab;     // (n_rows, NF, P) fused rows
  int64_t n_rows;         // G * t_max
  int32_t t_max;
  const int32_t* plen;    // (G,) true program lengths
  int32_t n_progs;
  const float* p_dec;     // (N_OPS,)
  const float* p_act;     // (N_OPS,)
  const float* e_src;     // (4,)
  float p_idle, e_sw_op, e_sw_mux, mulzero;
  const int32_t* hw_i;    // (B, NH)
  const float* hw_f;      // (B,) SMUL power scale
  const int32_t* gidx;    // (B,) program index
  int32_t* mem;           // (B, mem_size), updated in place
  int32_t mem_size;
  int32_t* regs;          // (B, 4, P)
  int32_t* rout;          // (B, P)
  int32_t* pc;            // (B,)
  int32_t* done;
  int32_t* t_cc;
  float* e_acc;
  int32_t* prev_pc;
  int32_t* n_exec;
  int64_t n_lanes;
  int32_t rows, cols, start, k_steps, max_steps, blk_b;
};

__device__ __forceinline__ int64_t clamp_row(int64_t row, int64_t n) {
  return row < 0 ? 0 : (row >= n ? n - 1 : row);
}

__global__ void sweep_kernel(SweepArgs s) {
  extern __shared__ int32_t smem[];
  const int P = s.rows * s.cols;
  const int slot_in_block = threadIdx.x / P;
  const int pe = threadIdx.x % P;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * s.blk_b +
                       slot_in_block;
  if (lane >= s.n_lanes) return;            // the whole group leaves
  if (s.done[lane]) return;                 // frozen: nothing to do
  // this lane's threads within the warp, for shuffles and ballots
  const int first = (threadIdx.x & 31) & ~(P - 1);
  const unsigned gmask = P == 32 ? 0xffffffffu
                                 : ((1u << P) - 1u) << first;
  const unsigned pe_bits = P == 32 ? 0xffffffffu : (1u << P) - 1u;

  int32_t* s_addr = smem + slot_in_block * kSmemPerPe * P;
  int32_t* s_mem = s_addr + P;
  int32_t* s_st = s_addr + 2 * P;
  int32_t* s_done = s_addr + 3 * P;
  int32_t* s_scratch = s_addr + 4 * P;

  // ---- lane state ----------------------------------------------------
  int32_t pc = s.pc[lane], t_cc = s.t_cc[lane], prev_pc = s.prev_pc[lane];
  int32_t n_exec = s.n_exec[lane];
  float e_acc = s.e_acc[lane];
  bool done = false;
  int32_t* regs = s.regs + lane * 4 * P + pe;
  int32_t r0 = regs[0], r1 = regs[P], r2 = regs[2 * P], r3 = regs[3 * P];
  int32_t rout = s.rout[lane * P + pe];
  const int32_t* hw = s.hw_i + lane * NH;
  const int32_t smul_lat = hw[H_SMUL_LAT], bus = hw[H_BUS];
  const int32_t interleaved = hw[H_INTERLEAVED], n_banks = hw[H_N_BANKS];
  const int32_t dma_per_pe = hw[H_DMA_PER_PE], t_mem = hw[H_T_MEM];
  const float smul_scale = s.hw_f[lane];
  const int32_t gi = s.gidx[lane];
  const int32_t gi_c = gi < 0 ? 0 : (gi >= s.n_progs ? s.n_progs - 1 : gi);
  const int32_t lane_len = s.plen[gi_c];
  const int64_t base = static_cast<int64_t>(gi) * s.t_max;
  int32_t* mem = s.mem + lane * s.mem_size;
  const int nbr_l = cgra::neighbour(pe, 0, s.rows, s.cols);
  const int nbr_r = cgra::neighbour(pe, 1, s.rows, s.cols);
  const int nbr_t = cgra::neighbour(pe, 2, s.rows, s.cols);
  const int nbr_b = cgra::neighbour(pe, 3, s.rows, s.cols);

  // switch-energy reference: the previous live instruction's slot
  bool has_prev = prev_pc >= 0;
  const int32_t* prow =
      s.tab + clamp_row(base + (prev_pc > 0 ? prev_pc : 0), s.n_rows) * NF * P +
      pe;
  int32_t p_ops = prow[F_OPS * P], p_srca = prow[F_SRCA * P];
  int32_t p_srcb = prow[F_SRCB * P];

  for (int k = 0; k < s.k_steps; ++k) {
    if (done || s.start + k >= s.max_steps) break;
    const int32_t* row = s.tab + clamp_row(base + pc, s.n_rows) * NF * P + pe;
    const int32_t op = row[F_OPS * P], dest = row[F_DEST * P];
    const int32_t src_a = row[F_SRCA * P], src_b = row[F_SRCB * P];
    const int32_t imm = row[F_IMM * P];
    const bool is_load = row[F_ISLD * P] > 0, is_store = row[F_ISST * P] > 0;
    const bool writes = row[F_WR * P] > 0;
    const int32_t kind_a = row[F_KA * P], kind_b = row[F_KB * P];

    // ---- operands: neighbours' ROUT from the start of the step --------
    const int32_t rcl = __shfl_sync(gmask, rout, nbr_l, P);
    const int32_t rcr = __shfl_sync(gmask, rout, nbr_r, P);
    const int32_t rct = __shfl_sync(gmask, rout, nbr_t, P);
    const int32_t rcb = __shfl_sync(gmask, rout, nbr_b, P);
    const int32_t a = cgra::select_operand(src_a, imm, r0, r1, r2, r3, rout,
                                           rcl, rcr, rct, rcb);
    const int32_t b = cgra::select_operand(src_b, imm, r0, r1, r2, r3, rout,
                                           rcl, rcr, rct, rcb);

    // ---- memory: every load reads the pre-step image -------------------
    const bool direct = op == cgra::OP_LWD || op == cgra::OP_SWD;
    const int32_t addr = cgra::floor_mod(direct ? imm : a, s.mem_size);
    const bool is_mem = is_load || is_store;
    const int32_t load_val = is_load ? mem[addr] : 0;
    s_addr[pe] = addr;
    s_mem[pe] = is_mem;
    s_st[pe] = is_store;
    __syncwarp(gmask);                      // all loaded, inputs shared
    const bool lands = cgra::store_lands(pe, P, s_st, s_addr);
    if (pe == 0)
      cgra::mem_schedule(P, s.cols, s_mem, s_addr, bus, interleaved, n_banks,
                         dma_per_pe, t_mem, s.mem_size, s_scratch, s_done);
    __syncwarp(gmask);                      // schedule published
    if (lands) mem[addr] = op == cgra::OP_SWD ? a : b;
    const int32_t mem_done = s_done[pe];

    // ---- ALU + writeback ------------------------------------------------
    const int32_t result = is_load ? load_val : cgra::alu(op, a, b);

    // ---- timing ---------------------------------------------------------
    const int32_t busy =
        is_mem ? mem_done : (op == cgra::OP_SMUL ? smul_lat : 1);
    int32_t lat = busy;
    for (int o = P / 2; o > 0; o >>= 1)
      lat = max(lat, __shfl_xor_sync(gmask, lat, o, P));

    // ---- control: the lowest-index PE with a taken branch wins ---------
    const bool taken = (op == cgra::OP_BEQ && a == b) ||
                       (op == cgra::OP_BNE && a != b) ||
                       (op == cgra::OP_BLT && a < b) ||
                       (op == cgra::OP_BGE && a >= b) || op == cgra::OP_JUMP;
    const unsigned taken_bits = (__ballot_sync(gmask, taken) >> first) &
                                pe_bits;
    const int32_t target =
        __shfl_sync(gmask, imm, taken_bits ? __ffs(taken_bits) - 1 : 0, P);
    int32_t next_pc = taken_bits ? target : pc + 1;
    next_pc = next_pc < 0 ? 0 : (next_pc > lane_len - 1 ? lane_len - 1
                                                         : next_pc);
    const bool exited =
        ((__ballot_sync(gmask, op == cgra::OP_EXIT) >> first) & pe_bits) != 0;

    // ---- fused case-(vi) energy ------------------------------------------
    const bool smul = op == cgra::OP_SMUL;
    const float scale = smul ? smul_scale : 1.0f;
    const float gate = (smul && (a == 0 || b == 0)) ? s.mulzero : 1.0f;
    const float wait = static_cast<float>(lat - busy > 0 ? lat - busy : 0);
    const float active = static_cast<float>(busy - 1 > 0 ? busy - 1 : 0);
    float e = cgra::pe_energy(
        s.p_dec[op], s.p_act[op], scale, gate, active, s.p_idle, wait,
        s.e_src[kind_a], s.e_src[kind_b], has_prev && op != p_ops,
        has_prev && src_a != p_srca, has_prev && src_b != p_srcb, s.e_sw_op,
        s.e_sw_mux);
    for (int o = P / 2; o > 0; o >>= 1)
      e += __shfl_xor_sync(gmask, e, o, P);

    // ---- advance ----------------------------------------------------------
    if (writes) {
      rout = result;
      if (dest == 0) r0 = result;
      if (dest == 1) r1 = result;
      if (dest == 2) r2 = result;
      if (dest == 3) r3 = result;
    }
    done = exited;
    t_cc += lat;
    e_acc += e;
    prev_pc = pc;
    n_exec += 1;
    pc = next_pc;
    has_prev = true;
    p_ops = op;
    p_srca = src_a;
    p_srcb = src_b;
    __syncwarp(gmask);                      // stores visible to next loads
  }

  regs[0] = r0;
  regs[P] = r1;
  regs[2 * P] = r2;
  regs[3 * P] = r3;
  s.rout[lane * P + pe] = rout;
  if (pe == 0) {
    s.pc[lane] = pc;
    s.done[lane] = done ? 1 : 0;
    s.t_cc[lane] = t_cc;
    s.e_acc[lane] = e_acc;
    s.prev_pc[lane] = prev_pc;
    s.n_exec[lane] = n_exec;
  }
}

}  // namespace

// The compiled kernel's limits on the current device: the most threads a
// block may have (registers allow fewer than 1024) and its registers per
// thread.  Returns cudaGetLastError().
extern "C" int cgra_sweep_attributes(int32_t* max_threads, int32_t* num_regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sweep_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_threads = attr.maxThreadsPerBlock;
  *num_regs = attr.numRegs;
  return 0;
}

// Runs steps [start, start + k_steps) of every lane on `stream`; lanes
// already done are left untouched.  Returns cudaGetLastError().
extern "C" int cgra_sweep_chunk(
    const int32_t* tab, int64_t n_rows, int32_t t_max, const int32_t* plen,
    int32_t n_progs, const float* p_dec, const float* p_act,
    const float* e_src, float p_idle, float e_sw_op, float e_sw_mux,
    float mulzero, const int32_t* hw_i, const float* hw_f,
    const int32_t* gidx, int32_t* mem, int32_t mem_size, int32_t* regs,
    int32_t* rout, int32_t* pc, int32_t* done, int32_t* t_cc, float* e_acc,
    int32_t* prev_pc, int32_t* n_exec, int64_t n_lanes, int32_t rows,
    int32_t cols, int32_t start, int32_t k_steps, int32_t max_steps,
    int32_t blk_b, void* stream) {
  const int P = rows * cols;
  if (P < 1 || P > 32 || (P & (P - 1)) != 0 || blk_b < 1 ||
      blk_b * P > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes <= 0) return 0;
  SweepArgs s{tab, n_rows, t_max, plen, n_progs, p_dec, p_act, e_src,
              p_idle, e_sw_op, e_sw_mux, mulzero, hw_i, hw_f, gidx, mem,
              mem_size, regs, rout, pc, done, t_cc, e_acc, prev_pc, n_exec,
              n_lanes, rows, cols, start, k_steps, max_steps, blk_b};
  const int64_t blocks = (n_lanes + blk_b - 1) / blk_b;
  const size_t smem = sizeof(int32_t) * kSmemPerPe * P * blk_b;
  sweep_kernel<<<static_cast<unsigned>(blocks), blk_b * P, smem,
                 static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

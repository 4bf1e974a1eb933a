// Standalone batched ALU dispatch: out[i] = cgra::alu(ops[i], a[i], b[i]).
//
// Replaces the Pallas kernel `alu_dispatch` (body `_alu_kernel` ->
// `alu_select`) of src/repro/kernels/cgra_step/kernel.py.
//
// What bounds it on an H100: bytes.  Each element reads three int32
// words and writes one (16 bytes) for roughly twenty integer operations,
// far below the card's operations-per-byte balance, so the kernel is a
// grid-stride elementwise pass and nothing more; the TPU version's
// (blk_b, 128-lane) tiling has no counterpart here.  No wgmma or TMA:
// there is no matrix product and no tile reuse.
#include <cuda_runtime.h>

#include "cgra_alu.cuh"

namespace {

__global__ void alu_dispatch_kernel(const int32_t* __restrict__ ops,
                                    const int32_t* __restrict__ a,
                                    const int32_t* __restrict__ b,
                                    int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = cgra::alu(ops[i], a[i], b[i]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Up
// to 256 elements (the simulator's step: one per PE) take one block of
// whole warps; more take a grid-stride grid of 256-thread blocks.
extern "C" int cgra_alu_dispatch(const int32_t* ops, const int32_t* a,
                                 const int32_t* b, int32_t* out, int64_t n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = n <= 256 ? static_cast<int>((n + 31) / 32 * 32) : 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  alu_dispatch_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ops, a, b, out,
                                                             n);
  return static_cast<int>(cudaGetLastError());
}

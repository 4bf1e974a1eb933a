// A probe for kernels that read shared memory nobody wrote: fill the
// whole dynamic shared memory of every SM with NaN, so that the next
// launch on the stream finds NaN wherever its own TMA loads and stores
// leave a word untouched.  Shared memory is not cleared between
// launches, so a read of such a word then shows as NaN in the output
// instead of as a stale value that happens to be harmless.
//
// Used by the card tests (tests/test_torch_cuda.py) before the LM
// kernels; never on a model's path.  Each block takes the largest
// dynamic shared memory a block may opt into, so at most one is resident
// an SM, and the grid has two blocks an SM, so every SM runs one.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void poison_kernel(int words) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = NAN;
  // keep the stores: a block that never reads its shared memory could
  // otherwise have them removed
  __syncthreads();
  if (threadIdx.x == 0 && !isnan(smem[words - 1])) smem[0] = 0.0f;
}

}  // namespace

// Launches the poison on `stream`; returns the bytes each block filled,
// or minus the cudaError_t of a failed query or launch.
extern "C" int smem_poison(void* stream) {
  int dev = 0, bytes = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        poison_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  poison_kernel<<<2 * sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
      bytes / static_cast<int>(sizeof(float)));
  err = cudaGetLastError();
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

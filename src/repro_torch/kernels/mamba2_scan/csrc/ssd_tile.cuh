// Per-pair arithmetic of the Mamba2 intra-chunk SSD kernel, shared by
// host and device code.  tests/test_torch_csrc_lm.py compiles this
// header with g++ and holds it against the plain PyTorch version
// (kernels/mamba2_scan/ref.py).
#pragma once

#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace ssd {

// Decay from step j to step i of a chunk for one head: exp(cum_i - cum_j)
// on and below the diagonal (j <= i), 0 above it.
__host__ __device__ inline float decay(float cum_i, float cum_j, int i,
                                       int j) {
  return j <= i ? expf(cum_i - cum_j) : 0.0f;
}

// The factor that multiplies x_j in y_i for one head:
// (C_i . B_j) * decay(i, j) * dt_j, in the plain version's order.
__host__ __device__ inline float score(float cb, float cum_i, float cum_j,
                                       float dt_j, int i, int j) {
  return cb * decay(cum_i, cum_j, i, j) * dt_j;
}

}  // namespace ssd

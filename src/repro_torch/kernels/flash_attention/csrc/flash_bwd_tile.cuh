// Per-element arithmetic of the flash-attention backward kernels
// (flash_attention_bwd.cu) and of the row log-sum-exp the forward
// kernels write for them, shared by host and device code.
// tests/test_torch_csrc_lm.py compiles this header with g++, walks both
// backward kernels' tile loops serially with it and holds the result
// against the plain backward (kernels/flash_attention/ref.py).
//
// With S = scale * Q.K^T (masked), lse_i the row's log-sum-exp and
// P = exp(S - lse), the backward of O = P.V given dO is
//   dV = P^T.dO,  dP = dO.V^T,  D_i = sum_j P_ij dP_ij,
//   dS = P * (dP - D),  dQ = scale * dS.K,  dK = scale * dS^T.Q.
#pragma once

#include <math.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#define __device__
#endif
#endif

namespace fab {

// The row log-sum-exp from the forward's running max m (natural units)
// and denominator l; +inf for a row with no key in band, so that every
// probability the backward recomputes for it is exp(-inf) = 0.
__host__ __device__ inline float lse_of(float m, float l) {
  return l > 0.0f ? m + logf(l) : INFINITY;
}

// The same from the tensor-core kernel's max in log2 units.
__host__ __device__ inline float lse_of_log2(float m2, float l) {
  return l > 0.0f ? m2 * 0.6931471805599453f + logf(l) : INFINITY;
}

// The probability of one (query, key) pair from its raw score s (before
// scaling) and the query row's log-sum-exp; 0 out of band.
__host__ __device__ inline float prob(float s, float scale, float lse,
                                      bool live) {
  const float p = expf(s * scale - lse);
  return live ? p : 0.0f;
}

// dS of one pair from its probability, dP = dO_i . V_j and the row's D.
__host__ __device__ inline float dscore(float p, float dp, float d) {
  return p * (dp - d);
}

}  // namespace fab

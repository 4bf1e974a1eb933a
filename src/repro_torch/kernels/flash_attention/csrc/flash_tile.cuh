// Per-tile arithmetic of the flash-attention kernel, shared by host and
// device code: the band mask, the k-tile skip test and the three steps
// of the online softmax.  tests/test_torch_csrc_lm.py compiles this
// header with g++ and holds it against the plain PyTorch version
// (kernels/flash_attention/ref.py).
#pragma once

#include <math.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace fa {

// The running max starts here, and a masked score takes this value, as
// in the TPU kernel: finite, so exp(m_prev - m_new) is never inf - inf.
constexpr float NEG_INF = -1e30f;

// Whether query position qi attends key position kj of a T-long key
// sequence: kj <= qi when causal, qi - kj < window when window > 0, and
// never a key past the end (the ragged last tile).
__host__ __device__ inline bool in_band(int qi, int kj, int T, bool causal,
                                        int window) {
  if (kj >= T) return false;
  if (causal && kj > qi) return false;
  if (window > 0 && qi - kj >= window) return false;
  return true;
}

// Whether any pair of the tile [q_lo, q_hi] x [k_lo, k_hi] is in band:
// the TPU kernel's `live` test, by which whole k-tiles are skipped.
__host__ __device__ inline bool tile_live(int q_lo, int q_hi, int k_lo,
                                          int k_hi, bool causal,
                                          int window) {
  if (causal && k_lo > q_hi) return false;
  if (window > 0 && q_lo - k_hi >= window) return false;
  return true;
}

// A row with running max m meets a tile whose largest (masked) score is
// tile_max: m becomes the new max, and the returned factor rescales the
// row's denominator and accumulator.
__host__ __device__ inline float online_rescale(float& m, float tile_max) {
  const float m_new = fmaxf(m, tile_max);
  const float alpha = expf(m - m_new);
  m = m_new;
  return alpha;
}

// Unnormalised probability of one score against the row's running max;
// 0 for a pair out of band, so padding never enters the sums.
__host__ __device__ inline float online_prob(float s, float m, bool live) {
  return live ? expf(s - m) : 0.0f;
}

// The output element from its accumulator and the row's denominator (a
// row with no key in band comes out 0).
__host__ __device__ inline float finalize(float acc, float l) {
  return acc / fmaxf(l, 1e-30f);
}

}  // namespace fa

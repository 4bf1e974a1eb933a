// Per-tile arithmetic of the flash-attention kernels, shared by host and
// device code: the band mask, the k-tile skip and no-mask tests, the
// three steps of the online softmax and the split of a probability into
// two bfloat16 terms.  tests/test_torch_csrc_lm.py compiles this header
// with g++ and holds it against the plain PyTorch version
// (kernels/flash_attention/ref.py) and torch's bfloat16 casts.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#else
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

// Whether every pair of the tile is in band, so that the kernel may skip
// the per-element mask.
__host__ __device__ inline bool tile_full(int q_lo, int q_hi, int k_lo,
                                          int k_hi, int T, bool causal,
                                          int window) {
  if (k_hi >= T) return false;
  if (causal && k_hi > q_lo) return false;
  if (window > 0 && q_hi - k_lo >= window) return false;
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
// 0 for a pair out of band, so padding never enters the sums.  The exp
// is taken either way and then selected: a branch on `live` would
// diverge within a warp.
__host__ __device__ inline float online_prob(float s, float m, bool live) {
  const float p = expf(s - m);
  return live ? p : 0.0f;
}

// The same two steps in log2 units, for the bf16 kernel on Hopper: with
// c = scale * log2(e) a raw score s (before scaling) gives
// p = 2^(s c - m), one FMA and exp2f per element.  exp2f and expf are
// both within 2 ulp (CUDA's table of math functions); the FMA rounds the
// exponent once where (s * scale) - m rounds twice.
constexpr float LOG2E = 1.4426950408889634f;

// The running max m (log2 units) meets a tile whose largest raw score is
// raw_max; returns the factor that rescales the row's sums.
__host__ __device__ inline float rescale_log2(float& m, float raw_max,
                                              float c) {
  const float m_new = fmaxf(m, raw_max * c);
  const float alpha = exp2f(m - m_new);
  m = m_new;
  return alpha;
}

__host__ __device__ inline float prob_log2(float s, float c, float m,
                                           bool live) {
  const float p = exp2f(fmaf(s, c, -m));
  return live ? p : 0.0f;
}

// The output element from its accumulator and the row's denominator (a
// row with no key in band comes out 0).
__host__ __device__ inline float finalize(float acc, float l) {
  return acc / fmaxf(l, 1e-30f);
}

// The bits of x rounded to bfloat16, to nearest with ties to even (x
// finite): the device's cvt.rn, and the same bits by integer arithmetic
// on the host.
__host__ __device__ inline uint16_t bf16_bits(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
#endif
}

__host__ __device__ inline float bf16_value(uint16_t bits) {
  const uint32_t u = static_cast<uint32_t>(bits) << 16;
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

// A probability as two bfloat16 terms, p = hi + lo + r with |r| <=
// 2^-17 |p|: the P.V product on the bf16 tensor cores sums both, so p
// enters it with 16 significant bits, not 8, and the output keeps the
// float32 kernel's accuracy.  p - hi is exact in float32.
__host__ __device__ inline void split_bf16(float p, uint16_t& hi,
                                           uint16_t& lo) {
  hi = bf16_bits(p);
  lo = bf16_bits(p - bf16_value(hi));
}

// Probabilities of keys 2c and 2c + 1 as packed bf16x2 registers of a
// wgmma A fragment, the lower key in the low half.
__host__ __device__ inline void split_bf16x2(float p0, float p1,
                                             uint32_t& hi, uint32_t& lo) {
#ifdef __CUDA_ARCH__
  // the same bits, two conversions an instruction
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - __low2float(h),
                                                 p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
#else
  uint16_t h0, l0, h1, l1;
  split_bf16(p0, h0, l0);
  split_bf16(p1, h1, l1);
  hi = static_cast<uint32_t>(h0) | static_cast<uint32_t>(h1) << 16;
  lo = static_cast<uint32_t>(l0) | static_cast<uint32_t>(l1) << 16;
#endif
}

}  // namespace fa

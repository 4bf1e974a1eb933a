// Per-pair arithmetic and per-tile indexing of the Mamba2 intra-chunk SSD
// kernel, shared by host and device code.  tests/test_torch_csrc_lm.py
// compiles this header with g++, holds it against the plain PyTorch
// version (kernels/mamba2_scan/ref.py) and walks the kernel's schedule
// with it on the host.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace ssd {

constexpr int MAX_L = 64;   // longest chunk
constexpr int STRIP = 16;   // rows of an m16n8k8 product tile
constexpr int KSTEP = 8;    // k of an m16n8k8 product
constexpr int BOX = 32;     // f32 columns of a 128-byte swizzled box

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

// score() for a pair known to lie on or below the diagonal, unmasked.
__host__ __device__ inline float score_below(float cb, float cum_i,
                                             float cum_j, float dt_j) {
  return cb * expf(cum_i - cum_j) * dt_j;
}

// Word offset of element (r, c) in a stack of boxes of BOX columns and
// MAX_L rows in TMA's 128-byte swizzle (box bases 1024-byte aligned): the
// 16-byte chunk c / 4 of a 128-byte row moves to chunk (c / 4) ^ (r % 8).
__host__ __device__ inline int swz(int r, int c) {
  return (c / BOX) * (MAX_L * BOX) + r * BOX +
         ((((c % BOX) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The two 16-row strips of warp w: w % 2 and 3 - w % 2, so that every
// warp walks 10 k-steps (80 columns) of a full chunk's lower triangle.
__host__ __device__ inline int warp_strip(int w, int which) {
  return which ? 3 - (w & 1) : (w & 1);
}

// k-steps of strip r of a chunk of L steps: columns j < min(16r + 16, L),
// none if the strip starts past L.
__host__ __device__ inline int strip_ksteps(int r, int L) {
  const int i0 = STRIP * r;
  if (i0 >= L) return 0;
  const int hi = i0 + STRIP < L ? i0 + STRIP : L;
  return (hi + KSTEP - 1) / KSTEP;
}

// Whether pair (i, j) lies in the diagonal 16 x 16 block of its strip,
// the only block with pairs above the diagonal (and so the mask).
__host__ __device__ inline bool diag_block(int i, int j) {
  return j >= STRIP * (i / STRIP);
}

// The (i, j) pairs whose scores the product reads -- strip r's 16 rows
// by the columns j < 16 (r + 1) -- numbered strip by strip, column by
// column: pair idx (0 <= idx < SCORE_PAIRS) is row i, column j.
constexpr int SCORE_PAIRS = 2560;
__host__ __device__ inline void score_pair(int idx, int& i, int& j) {
  const int r = idx < 256 ? 0 : idx < 768 ? 1 : idx < 1536 ? 2 : 3;
  const int rem = idx - 128 * r * (r + 1);
  j = rem / STRIP;
  i = STRIP * r + rem % STRIP;
}

// The C.B^T tiles on and below the diagonal: tile q (0 <= q < 20) is
// strip r (16 rows) by n-tile c (8 columns), c <= 2r + 1.
constexpr int CB_TILES = 20;
__host__ __device__ inline void cb_tile(int q, int& r, int& c) {
  r = q < 2 ? 0 : q < 6 ? 1 : q < 12 ? 2 : 3;
  c = q - r * (r + 1);
}

// The (chunk, head) items [lo, hi) of block b of nb, of `total` items
// numbered chunk * H + head: contiguous ranges, sizes differing by <= 1.
__host__ __device__ inline void block_items(int64_t total, int b, int nb,
                                            int64_t& lo, int64_t& hi) {
  lo = total * b / nb;
  hi = total * (b + 1) / nb;
}

// The ring slot of a block's n-th item and the parity of its fill.
__host__ __device__ inline int ring_stage(int n, int stages) {
  return n % stages;
}
__host__ __device__ inline uint32_t ring_phase(int n, int stages) {
  return static_cast<uint32_t>(n / stages) & 1u;
}

}  // namespace ssd

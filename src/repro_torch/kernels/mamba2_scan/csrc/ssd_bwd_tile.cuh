// Per-pair arithmetic and tile cover of the Mamba2 intra-chunk SSD
// backward kernel (ssd_intra_chunk_bwd.cu), shared by host and device
// code.  tests/test_torch_csrc_lm.py compiles this header with g++, walks
// the kernel serially with it and holds the result against the plain
// backward (kernels/mamba2_scan/ref.py `intra_chunk_bwd_ref`).
//
// The forward, per chunk and head: y_i = sum_{j<=i} s_ij x_j with
// s_ij = (cb_ij e_ij) dt_j, cb_ij = C_i . B_j, e_ij = exp(cum_i - cum_j).
// Given dy and ds_ij = dy_i . x_j, one pair j <= i gives
//   dx_j    += s_ij dy_i
//   ddt_j   += ds_ij (cb_ij e_ij)
//   dcum_i  += w_ij,  dcum_j -= w_ij,   w_ij = ((ds_ij dt_j) cb_ij) e_ij
//   dcb_ij  += (ds_ij dt_j) e_ij        (summed over heads)
// in the order the plain version's autograd multiplies them; a pair
// above the diagonal gives nothing.  The kernel computes every product
// and sum in double and rounds each output once: the outputs are sums of
// terms up to ~1e3 that cancel, and float32 sums there are off by ~1e-4
// (the plain version's own float32 error, which the card check allows
// it), so the kernel is kept near the exact value instead.
#pragma once

#include <math.h>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#define __device__
#endif
#endif

namespace ssdb {

// The pair's score s, ddt term v, dcum term w and dcb term, all 0 above
// the diagonal (j > i): exp is taken only below it, so a large
// cum_i - cum_j there never makes inf or NaN.  The kernels take T =
// double (every input a float, exact in double).
template <typename T>
__host__ __device__ inline void pair_grads(T cb, T cum_i, T cum_j, T dt_j,
                                           T ds, int i, int j, T& s, T& v,
                                           T& w, T& dcb) {
  if (j > i) {
    s = v = w = dcb = T(0);
    return;
  }
  const T e = exp(cum_i - cum_j);
  const T ce = cb * e;
  const T g = ds * dt_j;
  s = ce * dt_j;
  v = ds * ce;
  w = (g * cb) * e;
  dcb = g * e;
}

// The kernel's cover of a chunk's pairs j <= i is the 20 tiles of 16
// rows by 8 columns on and below the diagonal (ssd::cb_tile: strip r,
// n-tile c <= 2r + 1); tile (r, c) is computed when it starts inside a
// chunk of L steps.  Rows and columns of a computed tile past L give
// nothing (pair_grads is handed i = -1 there).
__host__ __device__ inline bool tile_in(int r, int c, int L) {
  return 16 * r < L && 8 * c < L;
}

// Column k of the pairs lies in the tiles of strips r >= first_strip(k);
// row i in the tiles of n-tiles c < row_tiles(i).
__host__ __device__ inline int first_strip(int k) { return k / 16; }
__host__ __device__ inline int row_tiles(int i) { return 2 * (i / 16) + 2; }

// k-steps of 8 of the products over i >= j (dx and dB) for the 16 rows j
// of strip r: from i = 16 r to the chunk's end.
__host__ __device__ inline int kstep_lo(int r) { return 2 * r; }
__host__ __device__ inline int ksteps(int L) { return (L + 7) / 8; }

}  // namespace ssdb

// Per-pair arithmetic of the Mamba2 intra-chunk SSD backward kernels
// (ssd_intra_chunk_bwd.cu), shared by host and device code.
// tests/test_torch_csrc_lm.py compiles this header with g++, walks both
// kernels serially with it and holds the result against the plain
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
// above the diagonal gives nothing.  The kernels compute every product
// and sum in double and round each output once: the outputs are sums of
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

}  // namespace ssdb

// Mamba2 intra-chunk SSD backward: dx, ddt, dcum, dB and dC of
//   y[g, i, h, :] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[g, j, h, :]
// given dy, float32 throughout.
//
// Replaces the gradient that JAX's autodiff takes through the reference
// model's intra-chunk term (src/repro/models/ssm.py `mamba2_forward`),
// on the path of the Pallas kernel `intra_chunk` of
// src/repro/kernels/mamba2_scan/kernel.py:56, which has no backward of
// its own.  Layout as the forward's (ssd_intra_chunk.cu): x, dy, dx
// (G, L, H, P); dt, cum, ddt, dcum (G, L, H); B, C, dB, dC (G, L, N).
//
// Two kernels, so that no float is added by two blocks (no atomics: two
// runs give the same bits):
//  - ssd_bwd_item, a block per (chunk, head) item: C.B^T and
//    ds = dy.x^T over the chunk's L x L pairs, the per-pair terms of
//    ssd_bwd_tile.cuh, then dx = s^T.dy, ddt (column sums of v) and dcum
//    (row sums minus column sums of w), and the item's share of
//    d(C.B^T) into a (G, H, L, L) scratch;
//  - ssd_bwd_chunk, a block per chunk: d(C.B^T) summed over the heads
//    in order, then dC = dCB.B and dB = dCB^T.C.
// Products: 16 x 16 threads, each a 4 x 4 register tile of the 64 x 64
// pairs, operands transposed in shared memory with a padded row
// (LD = 65), in double on the CUDA cores (ssd_bwd_tile.cuh says why);
// per-head shares of d(C.B^T) pass through the scratch as float.
//
// What bounds it on an H100: operations.  At the training shape (G 128,
// L 64, H 80, P = N = 64) the first kernel does C.B^T, ds and dx, three
// products of 64 x 64 x 64 FMAs an item, 16.1 GFLOP in all (0.48 ms at
// the f64 rate of 33.5 TFLOP/s outside the tensor cores), against
// 0.3 GB of inputs, outputs and scratch (0.09 ms at 3.35 TB/s).  The
// f64 tensor cores (as the forward uses them) and sharing C.B^T between
// the heads of a chunk are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_bwd_tile.cuh"

namespace {

constexpr int MAX_L = 64;
constexpr int LD = MAX_L + 1;   // padded row of the transposed tiles
constexpr int THREADS = 256;
constexpr int MAX_P = 128, MAX_N = 128;

// Rows 0 .. L-1 of a (L, ., width) slab (`row` the stride between rows)
// into the transposed tile t[c * LD + r], zero for rows L .. 63.
__device__ inline void load_t(float* t, const float* base, int64_t row,
                              int L, int width) {
  for (int idx = threadIdx.x; idx < MAX_L * width; idx += THREADS) {
    const int r = idx / width, c = idx % width;
    t[c * LD + r] = r < L ? base[r * row + c] : 0.0f;
  }
}

// s[a][b] = sum_d ta[d][tr + 16a] * tb[d][tc + 16b], in double.
__device__ inline void tile_dot(const float* ta, const float* tb, int depth,
                                int tr, int tc, double (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.0;
  for (int d = 0; d < depth; ++d) {
    double av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = ta[d * LD + tr + 16 * a];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = tb[d * LD + tc + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fma(av[a], bv[b], s[a][b]);
  }
}

// Shared memory: Ct, Bt (N x LD floats), dyt, xt (P x LD floats); then in
// doubles the scores s [MAX_L][LD] and three [16][MAX_L] partial sums
// (v over a thread row's 4 rows for each column, w likewise, and w over
// a thread column's 4 columns for each row); then cum and dt (floats).
template <int NP>  // NP = ceil(P / 16) columns of dx a thread
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_item(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dy,
                 float* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dcum, float* __restrict__ dcb_part,
                 int L, int H, int P, int N) {
  extern __shared__ double smem_d[];
  float* ct = reinterpret_cast<float*>(smem_d);
  float* bt = ct + N * LD;
  float* dyt = bt + N * LD;
  float* xt = dyt + P * LD;
  double* ss = reinterpret_cast<double*>(xt + P * LD);  // (2N + 2P) LD even
  double* col_v = ss + MAX_L * LD;
  double* col_w = col_v + 16 * MAX_L;
  double* row_w = col_w + 16 * MAX_L;
  float* cum_s = reinterpret_cast<float*>(row_w + 16 * MAX_L);
  float* dt_s = cum_s + MAX_L;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t xrow = static_cast<int64_t>(H) * P;     // stride of i in x
  const int64_t x_off = static_cast<int64_t>(g) * L * xrow + h * P;
  const int64_t bc_off = static_cast<int64_t>(g) * L * N;
  const int64_t t_off = static_cast<int64_t>(g) * L * H + h;  // dt, cum

  load_t(ct, Cm + bc_off, N, L, N);
  load_t(bt, Bm + bc_off, N, L, N);
  load_t(dyt, dy + x_off, xrow, L, P);
  load_t(xt, x + x_off, xrow, L, P);
  for (int r = tid; r < MAX_L; r += THREADS) {
    cum_s[r] = r < L ? cum[t_off + static_cast<int64_t>(r) * H] : 0.0f;
    dt_s[r] = r < L ? dt[t_off + static_cast<int64_t>(r) * H] : 0.0f;
  }
  __syncthreads();

  // rows i = tr + 16a, columns j = tc + 16b
  double cb[4][4], ds[4][4];
  tile_dot(ct, bt, N, tr, tc, cb);
  tile_dot(dyt, xt, P, tr, tc, ds);
  float* part = dcb_part + (static_cast<int64_t>(g) * H + h) * L * L;
  double cv[4] = {0.0, 0.0, 0.0, 0.0}, cw[4] = {0.0, 0.0, 0.0, 0.0};
  double rw[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = tr + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tc + 16 * b;
      double s, v, w, dcb;
      // rows and columns past L hold zeros and are never summed
      ssdb::pair_grads<double>(cb[a][b], cum_s[i], cum_s[j], dt_s[j],
                               ds[a][b], i, j, s, v, w, dcb);
      ss[i * LD + j] = s;
      if (i < L && j < L) {
        part[i * L + j] = static_cast<float>(dcb);
        cv[b] += v;
        cw[b] += w;
        rw[a] += w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    col_v[tr * MAX_L + tc + 16 * q] = cv[q];
    col_w[tr * MAX_L + tc + 16 * q] = cw[q];
    row_w[tc * MAX_L + tr + 16 * q] = rw[q];
  }
  __syncthreads();

  // dx_j = sum_i s_ij dy_i: rows j = tr + 16a, columns p = tc + 16c
  double acc[4][NP];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[a][c] = 0.0;
  for (int i = 0; i < L; ++i) {
    double sv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) sv[a] = ss[i * LD + tr + 16 * a];
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int p = tc + 16 * c;
      const double d = p < P ? dyt[p * LD + i] : 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = fma(sv[a], d, acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = tr + 16 * a;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int p = tc + 16 * c;
      if (p < P) dx[x_off + j * xrow + p] = static_cast<float>(acc[a][c]);
    }
  }

  // ddt_j = sum_i v_ij; dcum_k = sum_j w_kj - sum_i w_ik: the 16 partial
  // sums of each row or column, in order
  if (tid < L) {
    double v = 0.0, row = 0.0, col = 0.0;
    for (int t = 0; t < 16; ++t) {
      v += col_v[t * MAX_L + tid];
      col += col_w[t * MAX_L + tid];
      row += row_w[t * MAX_L + tid];
    }
    ddt[t_off + static_cast<int64_t>(tid) * H] = static_cast<float>(v);
    dcum[t_off + static_cast<int64_t>(tid) * H] = static_cast<float>(row - col);
  }
}

// Shared memory: dCB [MAX_L][LD] in doubles, then B and C (L x N floats).
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_chunk(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ dcb_part, float* __restrict__ dB,
                  float* __restrict__ dC, int L, int H, int N) {
  extern __shared__ double smem_d[];
  double* dcb = smem_d;
  float* bs = reinterpret_cast<float*>(dcb + MAX_L * LD);
  float* cs = bs + MAX_L * N;
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int64_t bc_off = static_cast<int64_t>(g) * L * N;
  const float* part = dcb_part + static_cast<int64_t>(g) * H * L * L;

  for (int idx = tid; idx < L * L; idx += THREADS) {
    double sum = 0.0;
    for (int h = 0; h < H; ++h)
      sum += part[static_cast<int64_t>(h) * L * L + idx];
    dcb[(idx / L) * LD + idx % L] = sum;
  }
  for (int idx = tid; idx < L * N; idx += THREADS) {
    bs[idx] = Bm[bc_off + idx];
    cs[idx] = Cm[bc_off + idx];
  }
  __syncthreads();
  // dC_i = sum_j dCB_ij B_j;  dB_j = sum_i dCB_ij C_i
  for (int idx = tid; idx < L * N; idx += THREADS) {
    const int r = idx / N, n = idx % N;
    double c_ = 0.0, b_ = 0.0;
    for (int m = 0; m < L; ++m) {
      c_ = fma(dcb[r * LD + m], static_cast<double>(bs[m * N + n]), c_);
      b_ = fma(dcb[m * LD + r], static_cast<double>(cs[m * N + n]), b_);
    }
    dC[bc_off + idx] = static_cast<float>(c_);
    dB[bc_off + idx] = static_cast<float>(b_);
  }
}

int item_smem(int P, int N) {
  return (2 * N + 2 * P) * LD * static_cast<int>(sizeof(float)) +
         (MAX_L * LD + 3 * 16 * MAX_L) * static_cast<int>(sizeof(double)) +
         2 * MAX_L * static_cast<int>(sizeof(float));
}

int chunk_smem(int N) {
  return MAX_L * LD * static_cast<int>(sizeof(double)) +
         2 * MAX_L * N * static_cast<int>(sizeof(float));
}

template <int NP>
int launch_item(const float* x, const float* dt, const float* cum,
                const float* Bm, const float* Cm, const float* dy, float* dx,
                float* ddt, float* dcum, float* part, int G, int L, int H,
                int P, int N, cudaStream_t st) {
  const int smem = item_smem(P, N);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_item<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_item<NP><<<G * H, THREADS, smem, st>>>(x, dt, cum, Bm, Cm, dy, dx,
                                                  ddt, dcum, part, L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx, ddt, dcum, dB, dC from x, dt, cum, B, C and dy (shapes above);
// `part` is (G, H, L, L) float32 scratch.  Two launches on `stream`;
// returns the first non-zero cudaError_t (0 on success).  Refuses what
// the forward refuses, and G * H beyond the grid's 2^31 - 1 blocks.
extern "C" int ssd_intra_chunk_bwd(const float* x, const float* dt,
                                   const float* cum, const float* Bm,
                                   const float* Cm, const float* dy,
                                   float* dx, float* ddt, float* dcum,
                                   float* dB, float* dC, float* part, int G,
                                   int L, int H, int P, int N,
                                   void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      H < 1 || G < 0 || static_cast<int64_t>(G) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch ((P + 15) / 16) {
#define SSD_BWD_CASE(NP)                                                   \
  case NP:                                                                 \
    err = launch_item<NP>(x, dt, cum, Bm, Cm, dy, dx, ddt, dcum, part, G, \
                          L, H, P, N, st);                                 \
    break;
    SSD_BWD_CASE(1)
    SSD_BWD_CASE(2)
    SSD_BWD_CASE(3)
    SSD_BWD_CASE(4)
    SSD_BWD_CASE(5)
    SSD_BWD_CASE(6)
    SSD_BWD_CASE(7)
    SSD_BWD_CASE(8)
#undef SSD_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int smem = chunk_smem(N);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chunk<<<G, THREADS, smem, st>>>(Bm, Cm, part, dB, dC, L, H, N);
  return static_cast<int>(cudaGetLastError());
}

// Mamba2 intra-chunk SSD: per chunk g and head h,
//   y[g, i, h, :] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[g, j, h, :]
//
// Replaces the Pallas kernel `intra_chunk` (body `_ssd_kernel`) of
// src/repro/kernels/mamba2_scan/kernel.py:56.  Layout and types are the
// wrapper's (src/repro/kernels/mamba2_scan/ops.py:14): x (G, L, H, P),
// dt and cum (G, L, H), B and C (G, L, N), all float32, contiguous;
// y (G, L, H, P) float32.
//
// What bounds it on an H100: bytes.  At the main path's prefill of a
// 2048-token prompt (G=32, L=64, H=80, P=64, N=64) it reads x and writes
// y, 84 MB, 0.025 ms at 3.35 TB/s; the products over the causal
// triangle are 0.7 GFLOP, 0.011 ms at the 67 TFLOP/s of f32 FMAs.
//
// What the design does about it: the TPU kernel takes one grid step per
// (chunk, head) and recomputes C.B^T for every head through a broadcast
// of B and C.  Here one block of 256 threads takes a chunk and a group
// of HPB heads: it computes C.B^T (L x L) once into shared memory, then
// for each head builds the decay-masked scores (`ssd::score`) beside it
// and multiplies them into that head's x tile, 4x4 register tiles a
// thread, writing y once.  Every input byte is read once per block and
// the (L, L) intermediates never leave shared memory.  All arithmetic is
// f32 FMA: the JAX tolerance is 1e-5, so no TF32 or bf16.  For L < 64 the
// rows and columns past L are never read, so every shared word a thread
// reads was written in the same launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tile.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16: rows tr + 16a, columns tc + 16c
constexpr int MAX_L = 64;
constexpr int LD = MAX_L + 1;  // padded rows of the (L, L) tiles
constexpr int HPB = 4;         // heads per block, sharing one C.B^T
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;

// Shared memory, in floats: cs[L][N], bt[N][LD] (B transposed),
// cb[MAX_L][LD], sc[MAX_L][LD], xs[L][P], cum_s[MAX_L], dt_s[MAX_L].
template <int NC>  // NC = ceil(P / 16) columns of y a thread
__global__ void __launch_bounds__(THREADS)
    ssd_intra_chunk_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ cum,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           float* __restrict__ y, int L, int H, int P,
                           int N) {
  extern __shared__ float smem[];
  float* cs = smem;
  float* bt = cs + L * N;
  float* cb = bt + N * LD;
  float* sc = cb + MAX_L * LD;
  float* xs = sc + MAX_L * LD;
  float* cum_s = xs + L * P;
  float* dt_s = cum_s + MAX_L;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int64_t g = blockIdx.x;
  const int h0 = blockIdx.y * HPB;
  const int h1 = min(h0 + HPB, H);

  const float* Cg = Cm + g * L * N;
  const float* Bg = Bm + g * L * N;
  for (int idx = tid; idx < L * N; idx += THREADS) {
    cs[idx] = Cg[idx];
    bt[(idx % N) * LD + idx / N] = Bg[idx];
  }
  __syncthreads();

  // C.B^T once for the block's heads
  {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr + 16 * a;
        cv[a] = i < L ? cs[i * N + n] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tc + 16 * c;
        bv[c] = j < L ? bt[n * LD + j] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cb[(tr + 16 * a) * LD + tc + 16 * c] = acc[a][c];
  }

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // cb is complete; the previous head's tiles are read
    const int64_t row0 = g * L;
    if (tid < L) {
      cum_s[tid] = cum[(row0 + tid) * H + h];
      dt_s[tid] = dt[(row0 + tid) * H + h];
    }
    for (int idx = tid; idx < L * P; idx += THREADS) {
      const int j = idx / P, p = idx % P;
      xs[idx] = x[((row0 + j) * H + h) * P + p];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = tr + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tc + 16 * c;
        if (i < L && j < L)
          sc[i * LD + j] = ssd::score(cb[i * LD + j], cum_s[i], cum_s[j],
                                      dt_s[j], i, j);
      }
    }
    __syncthreads();

    float acc[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;
    for (int j = 0; j < L; ++j) {
      float sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr + 16 * a;
        sv[a] = i < L ? sc[i * LD + j] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int p = tc + 16 * c;
        const float xv = p < P ? xs[j * P + p] : 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(sv[a], xv, acc[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = tr + 16 * a;
      if (i >= L) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int p = tc + 16 * c;
        if (p < P) y[((row0 + i) * H + h) * P + p] = acc[a][c];
      }
    }
  }
}

template <int NC>
int launch(const float* x, const float* dt, const float* cum,
           const float* Bm, const float* Cm, float* y, int G, int L, int H,
           int P, int N, cudaStream_t stream) {
  const int smem = (L * N + N * LD + 2 * MAX_L * LD + L * P + 2 * MAX_L) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (H + HPB - 1) / HPB);
  ssd_intra_chunk_kernel<NC><<<grid, THREADS, smem, stream>>>(
      x, dt, cum, Bm, Cm, y, L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes as above.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); refuses L outside 1..64, P outside 1..128,
// N outside 1..128 and more than 65535 head groups.
extern "C" int ssd_intra_chunk_fwd(const float* x, const float* dt,
                                   const float* cum, const float* Bm,
                                   const float* Cm, float* y, int G, int L,
                                   int H, int P, int N, void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      H < 1 || (H + HPB - 1) / HPB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((P + 15) / 16) {
    case 1: return launch<1>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 2: return launch<2>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 3: return launch<3>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 4: return launch<4>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 5: return launch<5>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 6: return launch<6>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 7: return launch<7>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
    case 8: return launch<8>(x, dt, cum, Bm, Cm, y, G, L, H, P, N, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention backward: dQ, dK and dV of the forward in
// flash_attention.cu, from q, k, v, dO and the forward's row
// log-sum-exp, with every sum in f32.
//
// Replaces the gradient that JAX's autodiff takes through the reference
// model's attention (src/repro/models/layers.py `attention_forward`), on
// the path of the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py:105, which has no backward
// of its own.  Layout as the forward's: q, dO, dQ (B, S, H, hd); k, v,
// dK, dV (B, T, KV, hd); lse and D (B, H, S) float32; float32 or
// bfloat16 inputs, gradients in the inputs' type.
//
// What bounds it on an H100: the tensor cores.  At the training shape
// (B 2, S = T = 4096, H 32, hd 80, bf16, causal) the function needs 5
// products of 2 hd FLOP a pair over the causal band (S recomputed, dP,
// dV, dQ, dK): 430 GFLOP, 0.43 ms at 989 TFLOP/s, against 0.29 GB of
// q, k, v, dO, dQ, dK, dV (0.09 ms at 3.35 TB/s).
//
// Two routes, chosen from type, shape and alignment before the launch.
// bf16 inputs with head_dim a multiple of 8 on 16-byte boundaries, given
// the forward's f32 O, take the Hopper kernels of flash_bwd_hopper.cuh:
// wgmma products, TMA tile loads into mbarrier rings, D from the f32 O,
// P and dS split into two bf16 terms (10 products a pair, 0.87 ms at
// the shape above).  float32, and bf16 that route cannot take, take the
// FMA kernels below.  `flash_attention_bwd_last_route` reports which ran.
//
// The FMA kernels, the FA2 split, so that no block adds into another's
// output (no atomics: two runs give the same bits):
//  - flash_bwd_dq, a block per (batch, head, 64-row q-tile), walks the
//    live k-tiles twice: first for D_i = sum_j P_ij dP_ij, then for
//    dS = P (dP - D) and dQ = scale dS.K.  D is taken from P and dP, as
//    the plain backward's softmax gradient takes it, not as rowsum(dO*O):
//    O rounded to bf16 would put an error of 2^-9 |dO||O| into every dS.
//    It writes D for the second kernel.
//  - flash_bwd_dkdv, a block per (batch, kv head, 64-key k-tile), walks
//    the live q-tiles of every query head of its group (GQA without
//    atomics) and sums dV = P^T.dO and dK = scale dS^T.Q.
// Both skip tiles outside the causal or window band with the forward's
// fa::tile_live and mask pairs with fa::in_band; per-pair arithmetic is
// in flash_bwd_tile.cuh.  Products: 16 x 16 threads, each a 4 x 4
// register tile of a 64 x 64 score tile (rows tr + 16i, columns
// tc + 16j), operands transposed in shared memory with a padded row
// (LD = 65), f32 FMAs on the CUDA cores: the float32 route is held to
// 1e-4 of the plain backward, which TF32 or bf16 products would not
// meet.  They do 9 products a pair (2 for D, 3 more for dQ, 4 for dK and
// dV), 773 GFLOP, 11.5 ms at the f32 rate of 67 TFLOP/s at the shape
// above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_bwd_hopper.cuh"
#include "flash_bwd_tile.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int BQ = 64;          // query rows of a q-tile
constexpr int BK = 64;          // keys of a k-tile
constexpr int LD = 65;          // padded row of the transposed tiles
constexpr int THREADS = 256;
constexpr int MAX_HD = 128;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows lo .. lo + 63 of one head of a (batch, seq, heads, hd) tensor
// (`base` at that head, `row` the stride of seq) into the transposed
// tile t[d * LD + r], zero past row n.
template <typename T>
__device__ inline void load_t(float* t, const T* base, int64_t row, int lo,
                              int n, int hd) {
  for (int idx = threadIdx.x; idx < 64 * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd, i = lo + r;
    t[d * LD + r] = i < n ? to_f32(base[i * row + d]) : 0.0f;
  }
}

// s[i][j] = sum_d a[d][tr + 16i] * b[d][tc + 16j] over transposed tiles.
__device__ inline void tile_dot(const float* a, const float* b, int hd,
                                int tr, int tc, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[d * LD + tr + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[d * LD + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Shared memory, in floats: qt, dot, kt, vt (hd x LD each, transposed)
// and ds[BQ][LD].
template <typename T, int NC>  // NC = ceil(hd / 16) output columns a thread
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dsum,
                 T* __restrict__ dq, int S, int Tk, int H, int KV, int hd,
                 float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qt = smem;
  float* dot = qt + hd * LD;
  float* kt = dot + hd * LD;
  float* vt = kt + hd * LD;
  float* ds = vt + hd * LD;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tk * KV + kvh) * hd;
  const int64_t row_off = (static_cast<int64_t>(b) * H + h) * S;

  load_t(qt, q + q_off, q_row, q_lo, S, hd);
  load_t(dot, dout + q_off, q_row, q_lo, S, hd);
  float lr[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_lo + tr + 16 * i;
    lr[i] = qi < S ? lse[row_off + qi] : INFINITY;
    D[i] = 0.0f;
  }

  const int n_kt = (Tk + BK - 1) / BK;
  float s[4][4], dp[4][4];
  // pass 1: D_i = sum_j P_ij dP_ij
  for (int t = 0; t < n_kt; ++t) {
    const int k_lo = t * BK;
    if (!fa::tile_live(q_lo, q_hi, k_lo, min(k_lo + BK, Tk) - 1, causal,
                       window))
      continue;
    __syncthreads();  // the previous tile's kt and vt are consumed
    load_t(kt, k + kv_off, kv_row, k_lo, Tk, hd);
    load_t(vt, v + kv_off, kv_row, k_lo, Tk, hd);
    __syncthreads();
    tile_dot(qt, kt, hd, tr, tc, s);
    tile_dot(dot, vt, hd, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = fa::in_band(qi, k_lo + tc + 16 * j, Tk, causal,
                                      window);
        D[i] = fmaf(fab::prob(s[i][j], scale, lr[i], live), dp[i][j], D[i]);
      }
    }
  }
  // the 16 threads of a row are lanes tc of one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      D[i] += __shfl_xor_sync(0xffffffffu, D[i], off);
    const int qi = q_lo + tr + 16 * i;
    if (tc == 0 && qi < S) dsum[row_off + qi] = D[i];
  }

  // pass 2: dS = P (dP - D), dQ = scale dS.K
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int t = 0; t < n_kt; ++t) {
    const int k_lo = t * BK;
    if (!fa::tile_live(q_lo, q_hi, k_lo, min(k_lo + BK, Tk) - 1, causal,
                       window))
      continue;
    __syncthreads();  // kt, vt and ds of the previous tile are consumed
    load_t(kt, k + kv_off, kv_row, k_lo, Tk, hd);
    load_t(vt, v + kv_off, kv_row, k_lo, Tk, hd);
    __syncthreads();
    tile_dot(qt, kt, hd, tr, tc, s);
    tile_dot(dot, vt, hd, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = fa::in_band(qi, k_lo + tc + 16 * j, Tk, causal,
                                      window);
        const float p = fab::prob(s[i][j], scale, lr[i], live);
        ds[(tr + 16 * i) * LD + tc + 16 * j] = fab::dscore(p, dp[i][j], D[i]);
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dv_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = ds[(tr + 16 * i) * LD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tc + 16 * c;
        const float kv = col < hd ? kt[col * LD + j] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dv_[i], kv, acc[i][c]);
      }
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_lo + tr + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col < hd) store(&dqb[qi * q_row + col], acc[i][c] * scale);
    }
  }
}

// Shared memory, in floats: kt, vt, qt, dot (hd x LD each, transposed),
// pt and dst[BK][LD] (P^T and dS^T of a tile), the q-tile's lse and D.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dk,
                   T* __restrict__ dv, int S, int Tk, int H, int KV, int hd,
                   float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + hd * LD;
  float* qt = vt + hd * LD;
  float* dot = qt + hd * LD;
  float* pt = dot + hd * LD;
  float* dst = pt + BK * LD;
  float* lsq = dst + BK * LD;
  float* dq_ = lsq + BQ;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int k_lo = blockIdx.x * BK;
  const int k_hi = min(k_lo + BK, Tk) - 1;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int group = H / KV;
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tk * KV + kvh) * hd;

  load_t(kt, k + kv_off, kv_row, k_lo, Tk, hd);
  load_t(vt, v + kv_off, kv_row, k_lo, Tk, hd);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.0f;

  const int n_qt = (S + BQ - 1) / BQ;
  float s[4][4], dp[4][4];
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t q_off = (static_cast<int64_t>(b) * S * H + h) * hd;
    const int64_t row_off = (static_cast<int64_t>(b) * H + h) * S;
    for (int t = 0; t < n_qt; ++t) {
      const int q_lo = t * BQ;
      if (!fa::tile_live(q_lo, min(q_lo + BQ, S) - 1, k_lo, k_hi, causal,
                         window))
        continue;
      __syncthreads();  // the previous tile's qt, dot, pt, dst consumed
      load_t(qt, q + q_off, q_row, q_lo, S, hd);
      load_t(dot, dout + q_off, q_row, q_lo, S, hd);
      for (int r = tid; r < BQ; r += THREADS) {
        const int qi = q_lo + r;
        lsq[r] = qi < S ? lse[row_off + qi] : INFINITY;
        dq_[r] = qi < S ? dsum[row_off + qi] : 0.0f;
      }
      __syncthreads();
      // rows: keys tr + 16i; columns: queries tc + 16j
      tile_dot(kt, qt, hd, tr, tc, s);
      tile_dot(vt, dot, hd, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k_lo + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          const bool live = fa::in_band(q_lo + c, kj, Tk, causal, window);
          const float p = fab::prob(s[i][j], scale, lsq[c], live);
          pt[(tr + 16 * i) * LD + c] = p;
          dst[(tr + 16 * i) * LD + c] = fab::dscore(p, dp[i][j], dq_[c]);
        }
      }
      __syncthreads();
      for (int jq = 0; jq < BQ; ++jq) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(tr + 16 * i) * LD + jq];
          sv[i] = dst[(tr + 16 * i) * LD + jq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tc + 16 * c;
          const float dov = col < hd ? dot[col * LD + jq] : 0.0f;
          const float qv = col < hd ? qt[col * LD + jq] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][c] = fmaf(pv[i], dov, adv[i][c]);
            adk[i][c] = fmaf(sv[i], qv, adk[i][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k_lo + tr + 16 * i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col >= hd) continue;
      store(&dkb[kj * kv_row + col], adk[i][c] * scale);
      store(&dvb[kj * kv_row + col], adv[i][c]);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv,
           int B, int S, int Tk, int H, int KV, int hd, int causal,
           int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const int smem_dq = (4 * hd * LD + BQ * LD) * static_cast<int>(sizeof(float));
  const int smem_kv = (4 * hd * LD + 2 * BK * LD + 2 * BQ) *
                      static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_dq<T, NC><<<dim3((S + BQ - 1) / BQ, B * H), THREADS, smem_dq,
                        stream>>>(tq, tk, tv, tdo, lse, dsum,
                                  static_cast<T*>(dq), S, Tk, H, KV, hd,
                                  scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, NC><<<dim3((Tk + BK - 1) / BK, B * KV), THREADS,
                          smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      S, Tk, H, KV, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, float* dsum, void* dq, void* dk, void* dv,
             int B, int S, int Tk, int H, int KV, int hd, int causal,
             int window, cudaStream_t st) {
#define FLASH_BWD_CASE(NC)                                                   \
  case NC:                                                                   \
    return launch<T, NC>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, Tk, H, \
                         KV, hd, causal, window, st);
  switch ((hd + 15) / 16) {
    FLASH_BWD_CASE(1)
    FLASH_BWD_CASE(2)
    FLASH_BWD_CASE(3)
    FLASH_BWD_CASE(4)
    FLASH_BWD_CASE(5)
    FLASH_BWD_CASE(6)
    FLASH_BWD_CASE(7)
    FLASH_BWD_CASE(8)
  }
#undef FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

std::atomic<int> last_route{-1};   // 1 tensor cores, 0 FMA, -1 none yet

}  // namespace

// The backward of flash_attention_fwd: q, k, v, dout and the forward's
// lse in, dq, dk, dv out (the inputs' type), D (B, H, S) float32 as
// scratch; `o32`, the forward's output in f32 (null where it was not
// kept), lets bf16 calls take the tensor-core route.  Two launches on
// `stream`, dq's kernel first; returns the first non-zero cudaError_t
// (0 on success).  Refuses what the forward refuses.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* o32, const float* lse,
                                   float* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int Tk, int H, int KV,
                                   int hd, int causal, int window, int bf16,
                                   void* stream) {
  if (hd < 1 || hd > MAX_HD || KV < 1 || H % KV != 0 || B * H > 65535 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc =
      bf16 && fa_hopper_bwd::takes(q, k, v, dout, o32, dq, dk, dv, hd);
  const int err =
      tc ? fa_hopper_bwd::dispatch(q, k, v, dout, o32, lse, dsum, dq, dk, dv,
                                   B, S, Tk, H, KV, hd, causal, window, st)
      : bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                       B, S, Tk, H, KV, hd, causal, window,
                                       st)
             : dispatch<float>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S,
                               Tk, H, KV, hd, causal, window, st);
  if (err == 0) last_route.store(tc ? 1 : 0);
  return err;
}

// The route of the latest launch in this process: 1 the tensor-core
// kernels, 0 the FMA kernels, -1 before the first.
extern "C" int flash_attention_bwd_last_route() { return last_route.load(); }

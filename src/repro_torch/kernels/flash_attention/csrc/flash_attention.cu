// Flash attention forward: online softmax over k-tiles, f32 accumulation.
//
// Replaces the Pallas kernel `flash_attention` (body `_fa_kernel`) of
// src/repro/kernels/flash_attention/kernel.py:105 and the GQA expansion
// of its wrapper (ref.py `expand_kv`): query head h reads kv head
// h / (H / KV) directly, so the repeated k/v are never materialised.
//
// Layout is the model's: q and o (B, S, H, hd), k and v (B, T, KV, hd),
// all contiguous, float32 or bfloat16; o has q's type.
//
// What bounds it on an H100: operations.  At the main path's prefill
// (B=1, S=T=2048, H=32, hd=80, bf16, causal) the causal band holds
// 4*H*hd*S(S+1)/2 = 21.5 GFLOP, 0.022 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 42 MB of q/k/v/o, 0.013 ms at 3.35 TB/s.
//
// Two routes.  bf16 inputs with head_dim a multiple of 8 on 16-byte
// boundaries (the serving path's) take the Hopper kernel of
// flash_hopper.cuh: wgmma products on the tensor cores, TMA tile loads
// into an mbarrier ring.  float32, and bf16 that TMA cannot address,
// take the FMA kernel below.
//
// The FMA kernel: on the TPU the running max, the denominator and the
// accumulator sit in VMEM scratch carried across a sequential k-block
// grid axis.  Blocks here run in no order, so one block of 256 threads
// owns a 64-row q-tile of one (batch, head) and walks the k-tiles
// itself, skipping those outside the causal or window band
// (`fa::tile_live`, the TPU kernel's `pl.when(live)`), so the causal
// kernel does half the work.  Q and K tiles sit transposed in shared
// memory and each thread computes a 4x4 register tile of scores (two
// FMAs per shared load); thread (tr, tc) owns rows tr + 16i and the 16
// threads of a row reduce its max and sum with warp shuffles, so m, l
// and the output accumulator stay in registers.  The products run as
// f32 FMAs on the CUDA cores: the float32 path must agree with the
// plain version at 2e-5, which TF32 or bf16 tensor-core products would
// not, so it is held to the 67 TFLOP/s f32 rate (0.32 ms for the shape
// above).  The ragged last q- and k-tile are masked in the kernel:
// prompts of any length reach it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_bwd_tile.cuh"
#include "flash_hopper.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int LD = BK + 1;      // padded row of the transposed tiles
constexpr int THREADS = 256;    // 16 x 16: rows tr + 16i, keys tc + 16j
constexpr int MAX_HD = 128;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory, in floats: qt[hd][LD] and kt[hd][LD] (transposed),
// vs[BK][hd], ps[BQ][LD] (the tile's probabilities).
template <typename T, int NC>  // NC = ceil(hd / 16) output columns a thread
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, float* __restrict__ o32, int S,
              int Tk, int H, int KV, int hd, float scale, int causal,
              int window) {
  extern __shared__ float smem[];
  float* qt = smem;
  float* kt = qt + hd * LD;
  float* vs = kt + hd * LD;
  float* ps = vs + BK * hd;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * hd;   // stride of s
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * Tk * KV + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * Tk * KV + kvh) * hd;
  T* ob = o + (static_cast<int64_t>(b) * S * H + h) * hd;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd, qi = q_lo + r;
    qt[d * LD + r] = qi < S ? to_f32(qb[qi * q_row + d]) : 0.0f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fa::NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = (Tk + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k_lo = t * BK;
    const int k_hi = min(k_lo + BK, Tk) - 1;
    if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window)) continue;
    __syncthreads();  // the previous tile's kt, vs and ps are consumed
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, d = idx % hd, kj = k_lo + r;
      const bool in = kj < Tk;
      kt[d * LD + r] = in ? to_f32(kb[kj * kv_row + d]) : 0.0f;
      vs[r * hd + d] = in ? to_f32(vb[kj * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * LD + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + tr + 16 * i;
      bool live[4];
      float mx = fa::NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        live[j] = fa::in_band(qi, k_lo + tc + 16 * j, Tk, causal, window);
        s[i][j] = live[j] ? s[i][j] * scale : fa::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tc of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = fa::online_rescale(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fa::online_prob(s[i][j], m[i], live[j]);
        ps[(tr + 16 * i) * LD + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr + 16 * i) * LD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tc + 16 * c;
        const float vv = col < hd ? vs[j * hd + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_lo + tr + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col >= hd) continue;
      const float out = fa::finalize(acc[i][c], l[i]);
      store(&ob[qi * q_row + col], out);
      // the f32 output for the backward's D, where asked for
      if (o32 != nullptr)
        o32[(static_cast<int64_t>(b) * S * H + h) * hd + qi * q_row + col] =
            out;
    }
    // the row's log-sum-exp for the backward kernels, where asked for
    if (lse != nullptr && tc == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qi] = fab::lse_of(m[i], l[i]);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* o32, int B, int S, int Tk, int H, int KV, int hd,
           int causal, int window, cudaStream_t stream) {
  const int smem = (2 * hd * LD + BK * hd + BQ * LD) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, o32, S, Tk, H, KV,
      hd, 1.0f / sqrtf(static_cast<float>(hd)), causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, float* o32, int B, int S, int Tk, int H, int KV,
             int hd, int causal, int window, cudaStream_t st) {
  switch ((hd + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 2: return launch<T, 2>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 3: return launch<T, 3>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 4: return launch<T, 4>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 5: return launch<T, 5>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 6: return launch<T, 6>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 7: return launch<T, 7>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 8: return launch<T, 8>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

std::atomic<int> fwd_last_route{-1};   // 1 tensor cores, 0 FMA, -1 none yet

}  // namespace

// q, k, v, o as above; `lse`, where not null, receives each query row's
// log-sum-exp of its scaled scores, (B, H, S) float32, and `o32`, where
// not null, the output before its rounding to o's type, (B, S, H, hd)
// float32, both for the backward kernels (flash_attention_bwd.cu); null
// pointers write nothing else.
// `window` <= 0 means no window; `bf16` selects bfloat16 over float32
// (and the Hopper kernel where it applies).
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success); refuses hd outside 1..128, H not a multiple of KV and more
// than 65535 (batch, head) pairs.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   float* o32, int B, int S, int Tk, int H,
                                   int KV, int hd, int causal, int window,
                                   int bf16, void* stream) {
  if (hd < 1 || hd > MAX_HD || KV < 1 || H % KV != 0 || B * H > 65535 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = bf16 && fa_hopper::takes(q, k, v, o, hd);
  const int err =
      tc ? fa_hopper::dispatch(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd,
                               causal, window, st)
      : bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, o32, B, S, Tk, H,
                                       KV, hd, causal, window, st)
             : dispatch<float>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd,
                               causal, window, st);
  if (err == 0) fwd_last_route.store(tc ? 1 : 0);
  return err;
}

// The route of the latest launch in this process: 1 the tensor-core
// kernel (flash_hopper.cuh), 0 the FMA kernel, -1 before the first.
extern "C" int flash_attention_last_route() {
  return fwd_last_route.load();
}

// Dynamic shared memory of the Hopper kernel for this head_dim, in bytes;
// 0 where bf16 calls with this head_dim take the FMA kernel.
extern "C" int flash_attention_hopper_smem(int hd) {
  if (hd < 1 || hd > MAX_HD || hd % 8 != 0) return 0;
  return fa_hopper::smem_bytes((hd + 15) / 16 * 16);
}

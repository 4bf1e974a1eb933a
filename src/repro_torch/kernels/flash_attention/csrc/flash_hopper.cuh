// Flash attention forward for bfloat16 on Hopper: wgmma products, TMA
// tile loads, an mbarrier ring.  Included by flash_attention.cu, whose
// entry point takes this route for bf16 inputs whose head_dim is a
// multiple of 8 (TMA needs 16-byte row strides) and whose tensors start
// on 16-byte boundaries; every other call takes the FMA kernel there.
//
// Same semantics as that kernel: online softmax in f32 registers, whole
// k-tiles outside the causal or window band skipped (fa::tile_live), GQA
// by index (query head h reads kv head h / (H / KV)), ragged last q- and
// k-tiles masked, hd <= 128.
//
// Design.  A block owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows and one producer warp, one block an SM
// (two would leave 96 registers a thread, and the kernel spills; three
// or four consumer warpgroups measured slower,
// scripts/hopper_kernel_variants.py).  The producer's first thread
// loads the Q tile once and then the block's live K and V tiles into a
// two-stage ring with cp.async.bulk.tensor (tensor maps built on the
// host, 4-D over (hd, heads, seq, batch), so the kv head is a
// coordinate and rows past the sequence come back as zeros).  Each stage
// has a "full" mbarrier for K and one for V, which the TMA completes by
// bytes, and an "empty" mbarrier on which each consumer warp arrives when
// it has finished with the stage.  A row of a tile is 128 bytes of d in
// the 128-byte swizzle; hd > 64 takes a second box of the next 64 d
// (zero-filled past hd), so smem is padded to 64 or 128 columns but the
// products run over hd rounded up to 16 only.
//
// Per live k-tile a consumer warpgroup computes S = Q.K^T with
// wgmma m64n64k16 (both operands K-major in shared memory), masks S in
// registers (only on tiles that fa::tile_full says need it), updates the
// row max and denominator with quad shuffles, and forms P in log2 units
// (fa::prob_log2: one FMA and exp2f an element, the scale folded in).
// P.V runs as wgmma m64nNk16 with P from registers (the accumulator
// layout of S is the A-fragment layout) and V read transposed from its
// row-major tile (N = hd rounded up to 16).  P is split into two bf16
// terms (fa::split_bf16x2) and both are multiplied into the same f32
// accumulator: a single bf16 rounding of P would put errors of 2^-9 of
// each term into the output, outside the float32 rounding bound the
// port holds this kernel to; the split leaves 2^-17, for 1.5x the
// products.  Q.K^T needs no split: bf16 products are exact in f32.
//
// What bounds it: the tensor cores.  At the serving path's prefill
// (B=1, S=T=2048, H=32, hd=80, causal) the band holds 21.5 GFLOP
// (32 GFLOP with the split), 0.022 (0.033) ms at 989 TFLOP/s, against
// 42 MB of q/k/v/o.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/hopper_async.cuh"
#include "flash_bwd_tile.cuh"
#include "flash_tile.cuh"
#include "wgmma_ops.cuh"

namespace fa_hopper {

constexpr int CONSUMERS = 2;            // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;      // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int BOX = 64;                 // d per 128-byte TMA box
constexpr int STAGES = 2;               // K/V ring depth
constexpr int THREADS = 128 * CONSUMERS + 32;
constexpr int TILE_BYTES = 64 * 128;    // one box: 64 rows of 128 bytes
constexpr int N_BARRIERS = 1 + 3 * STAGES;

__host__ __device__ constexpr int d_boxes(int hdp) {
  return (hdp + BOX - 1) / BOX;
}

// Dynamic shared memory of the kernel for hd rounded up to 16: Q, the
// K and V rings, the barriers, and slack to align the tiles to the
// 1024-byte period of the swizzle.
__host__ __device__ constexpr int smem_bytes(int hdp) {
  return 1024 + (CONSUMERS + 2 * STAGES) * d_boxes(hdp) * TILE_BYTES +
         8 * N_BARRIERS;
}

using hopper::mbar_arrive_lane0;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major tiles (Q, K) step 8-row groups by `sbo` = 1024; the N-major V
// tile steps 8-key groups by `sbo` and its 64-column boxes by `lbo`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The raw row maxima of a tile's scores s (wgmma D layout: element i of
// a thread is in its row (i / 2) % 2), over in-band elements only when
// kMasked.
template <bool kMasked>
__device__ __forceinline__ void tile_max(const float (&s)[32], uint32_t live,
                                         float (&mx)[2]) {
  mx[0] = mx[1] = fa::NEG_INF;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = !kMasked || (live >> i & 1u) ? s[i] : fa::NEG_INF;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
}

// The tile's probabilities against the rows' maxima m (log2 units, c =
// scale * log2(e)), written over the scores, and this thread's row sums.
template <bool kMasked>
__device__ __forceinline__ void tile_probs(float (&s)[32], uint32_t live,
                                           const float (&m)[2], float c,
                                           float (&sum)[2]) {
  sum[0] = sum[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fa::prob_log2(s[i], c, m[(i / 2) % 2],
                         !kMasked || (live >> i & 1u));
    sum[(i / 2) % 2] += s[i];
  }
}

// The first live k-tile of rows [q_lo, q_hi] and the number of live
// tiles: the band makes them one contiguous range.
__device__ __forceinline__ void live_range(int q_lo, int q_hi, int n_kt,
                                           int Tk, int causal, int window,
                                           int& t_lo, int& n_live) {
  t_lo = 0;
  n_live = 0;
  for (int t = 0; t < n_kt; ++t) {
    const int k_lo = t * BK;
    if (!fa::tile_live(q_lo, q_hi, k_lo, min(k_lo + BK, Tk) - 1, causal,
                       window))
      continue;
    if (n_live == 0) t_lo = t;
    n_live = t - t_lo + 1;
  }
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// HDP: head_dim rounded up to 16 (16..128), the N of the P.V product.
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ o32, int S, int Tk, int H, int KV,
                     int hd, float scale, int causal, int window) {
  constexpr int NDB = d_boxes(HDP);
  constexpr int KSTEPS = HDP / 16;        // k-steps of Q.K^T over d
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;   // [CONSUMERS][NDB] boxes
  const uint32_t sk = sq + CONSUMERS * NDB * TILE_BYTES;  // [STAGES][NDB]
  const uint32_t sv = sk + STAGES * NDB * TILE_BYTES;     // [STAGES][NDB]
  const uint32_t bars = sv + STAGES * NDB * TILE_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * STAGES + st); };

  // the longest causal rows first: they have the most live tiles
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int n_kt = (Tk + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS * 4);   // one arrival per warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index through a shuffle, so that the compiler knows it
  // is the same in every thread of a warp: branches on it are not
  // divergent, and the consumers' products stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {                   // the producer warp
    if (tid == 128 * CONSUMERS) {
      mbar_expect_tx(q_full, CONSUMERS * NDB * TILE_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int db = 0; db < NDB; ++db)
          tma_load_4d(sq + (w * NDB + db) * TILE_BYTES, &tq, q_full, db * BOX,
                   h, q_lo + 64 * w, b);
      int t_lo, n_live;
      live_range(q_lo, q_hi, n_kt, Tk, causal, window, t_lo, n_live);
      for (int j = 0; j < n_live; ++j) {
        const int k_lo = (t_lo + j) * BK;
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(st), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), NDB * TILE_BYTES);
        for (int db = 0; db < NDB; ++db)
          tma_load_4d(sk + (st * NDB + db) * TILE_BYTES, &tk, k_full(st),
                   db * BOX, kvh, k_lo, b);
        mbar_expect_tx(v_full(st), NDB * TILE_BYTES);
        for (int db = 0; db < NDB; ++db)
          tma_load_4d(sv + (st * NDB + db) * TILE_BYTES, &tv, v_full(st),
                   db * BOX, kvh, k_lo, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q_lo + 64 wg .. + 63 ---------
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wq_lo = q_lo + 64 * wg, wq_hi = min(wq_lo + 63, S - 1);
  // this thread's two rows of every accumulator (wgmma D layout)
  const int row0 = wq_lo + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_tile = sq + wg * NDB * TILE_BYTES;

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
  // row maxima m in log2 units: p = 2^(s * c - m) = e^(s * scale - m ln 2)
  float m[2] = {fa::NEG_INF, fa::NEG_INF}, l[2] = {0.0f, 0.0f};
  const float c = scale * fa::LOG2E;

  int t_lo, n_live;
  live_range(q_lo, q_hi, n_kt, Tk, causal, window, t_lo, n_live);
  // S = Q.K^T of the j-th live tile into s, asynchronously
  auto issue_qk = [&](float (&s)[32], int j) {
    const int st = j % STAGES;
    mbar_wait(k_full(st), (j / STAGES) & 1);
    __syncwarp();
    const uint32_t k_tile = sk + st * NDB * TILE_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
      mma_ss_n64(s, desc_sw128(q_tile + off, 16, 1024),
                 desc_sw128(k_tile + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    mbar_arrive_lane0(empty(j % STAGES), lane);
  };

  // Per tile: Q.K^T, the softmax, P.V, each product waited for before its
  // registers are touched; the other warpgroup, out of step, keeps the
  // tensor cores busy through the softmax.  (Issuing Q.K^T of the next
  // tile before the softmax measured slower: the compiler serializes the
  // products when their registers overlap a pipeline stage.)
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  uint32_t p_hi[16], p_lo[16];
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_live; ++j) {
    const int k_lo = (t_lo + j) * BK;
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    issue_qk(s, j);
    wg_wait<0>();
    keep(s);

    // ---- mask, online softmax in log2 units --------------------------
    const bool full =
        fa::tile_full(wq_lo, wq_hi, k_lo, k_lo + BK - 1, Tk, causal, window);
    uint32_t live = 0xffffffffu;   // bit i: element s[i] is in band
    if (!full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kj = k_lo + 8 * (i / 4) + col0 + i % 2;
        live &= ~(static_cast<uint32_t>(!fa::in_band(
                      row0 + 8 * ((i / 2) % 2), kj, Tk, causal, window))
                  << i);
      }
    }
    float mx[2];
    if (full)
      tile_max<false>(s, live, mx);
    else
      tile_max<true>(s, live, mx);
    float alpha[2], sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are lanes 4g .. 4g + 3
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fa::rescale_log2(m[r], mx[r], c);
    }
    if (full)
      tile_probs<false>(s, live, m, c, sum);
    else
      tile_probs<true>(s, live, m, c, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    // once the row maxima settle, most tiles leave every alpha at 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      fa::split_bf16x2(s[i], s[i + 1], p_hi[i / 2], p_lo[i / 2]);

    // ---- O += P.V, P in two bf16 terms ----------------------------------
    mbar_wait(v_full(st), ph);
    __syncwarp();
    const uint32_t v_tile = sv + st * NDB * TILE_BYTES;
    keep(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_tile + kk * 16 * 128, TILE_BYTES, 1024);
      mma_rs<HDP>(acc, p_hi + 4 * kk, dv);
      mma_rs<HDP>(acc, p_lo + 4 * kk, dv);
    }
    wg_commit();
    wg_wait<0>();
    keep(acc);
    release(j);
  }

  // ---- O / l, rounded to bf16 ----------------------------------------------
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t head = (static_cast<int64_t>(b) * S * H + h) * hd;
  __nv_bfloat16* ob = o + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    // the row's log-sum-exp for the backward kernels, where asked for
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qi] =
          fab::lse_of_log2(m[r], l[r]);
    // one division a row; a row with no key in band comes out 0
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + col0;   // hd even: col < hd -> col + 1 < hd
      if (col >= hd) continue;
      __nv_bfloat162 pair;
      const float2 out = make_float2(acc[4 * j + 2 * r] * inv,
                                     acc[4 * j + 2 * r + 1] * inv);
      pair.x = __float2bfloat16(out.x);
      pair.y = __float2bfloat16(out.y);
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * q_row + col) = pair;
      // the f32 output for the backward's D, where asked for
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + head + qi * q_row + col) = out;
    }
  }
}

// A 4-D tensor map over (hd, heads, seq, batch) of a contiguous
// (batch, seq, heads, hd) bf16 tensor, in boxes of 64 d x 64 rows of one
// head, 128-byte swizzled; coordinates outside the tensor read as 0.
inline CUresult make_map(CUtensorMap* map, const void* ptr, int hd,
                         int heads, int seq, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {BOX, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* o32, int B, int S, int Tk, int H, int KV, int hd,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (make_map(&tq, q, hd, H, S, B) != CUDA_SUCCESS ||
      make_map(&tk, k, hd, KV, Tk, B) != CUDA_SUCCESS ||
      make_map(&tv, v, hd, KV, Tk, B) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes(HDP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hopper<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_hopper<HDP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, o32, S, Tk, H, KV,
      hd, 1.0f / sqrtf(static_cast<float>(hd)), causal, window);
  return static_cast<int>(cudaGetLastError());
}

// Whether a call takes this route: hd a multiple of 8 and every tensor
// on a 16-byte boundary (TMA's rules for strides and base addresses).
inline bool takes(const void* q, const void* k, const void* v,
                  const void* o, int hd) {
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
         aligned(o);
}

inline int dispatch(const void* q, const void* k, const void* v, void* o,
                    float* lse, float* o32, int B, int S, int Tk, int H,
                    int KV, int hd, int causal, int window, cudaStream_t st) {
  switch ((hd + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 2: return launch<32>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 3: return launch<48>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 4: return launch<64>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 5: return launch<80>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 6: return launch<96>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 7: return launch<112>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
    case 8: return launch<128>(q, k, v, o, lse, o32, B, S, Tk, H, KV, hd, causal, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fa_hopper

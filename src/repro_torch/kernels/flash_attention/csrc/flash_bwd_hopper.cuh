// Flash attention backward for bfloat16 on Hopper: wgmma products, TMA
// tile loads, mbarrier rings.  Included by flash_attention_bwd.cu, whose
// entry point takes this route for bf16 inputs whose head_dim is a
// multiple of 8 and whose tensors start on 16-byte boundaries (the
// forward's condition, fa_hopper::takes), given the forward's f32 O;
// every other call takes the FMA kernels there.
//
// Same semantics as those kernels: dQ, dK, dV of O = softmax(scale
// Q.K^T) V from q, k, v, dO and the forward's row log-sum-exp, whole
// tiles outside the causal or window band skipped (fa::tile_live), GQA by
// index, ragged last tiles masked, hd <= 128, no atomics (two launches
// give the same bits).
//
// D_i = rowsum(dO_i * O_i) comes from the forward's O in f32 (the
// forward writes it beside lse when a gradient is wanted), so no pass
// recomputes P.dP for it; the bf16 O would put 2^-9 |dO||O| into every
// dS.  Two kernels, the FA2 split, each a block of two consumer
// warpgroups (64 rows each) and a producer warpgroup of which one warp
// issues the loads (the dK/dV kernel's producer hands its registers to
// the consumers with setmaxnreg):
//  - flash_bwd_dq_hopper, a block per (batch, head, 128 query rows):
//    D and lse of its rows (D also written for the second kernel), Q and
//    dO held in shared memory, the live K and V tiles streamed through a
//    two-stage TMA ring; per tile S = Q.K^T and dP = dO.V^T on wgmma
//    (both operands K-major), dS = P (dP - D) in registers, then
//    dQ += dS.K with dS from registers (the accumulator layout of S is
//    the A-fragment layout) and K read transposed from its row-major
//    tile, as the forward reads V;
//  - flash_bwd_dkdv_hopper, a block per (batch, kv head, 128 keys):
//    K and V held, the live q-tiles of every query head of its group
//    streamed (Q and dO by TMA, their lse and D by the producer warp's
//    lanes); per tile S^T = K.Q^T and dP^T = V.dO^T with the keys as M,
//    so that P^T and dS^T land in the A-fragment layout, then
//    dV += P^T.dO and dK += dS^T.Q with dO and Q read transposed.
// P and dS are f32 and enter the products as two bf16 terms each
// (fa::split_bf16x2) into one f32 accumulator: a single bf16 rounding
// would put 2^-9 of each term into every gradient.  S and dP need no
// split: bf16 products are exact in f32.  That is 4 products a pair in
// the first kernel and 6 in the second, against the 5 the function
// needs (S, dP, dV, dQ, dK).  Every FLUSH tiles the accumulators of dQ,
// dK and dV are added into f32 totals by round-to-nearest adds (dQ's in
// registers, dK's and dV's in shared memory), since the tensor cores'
// own long sums drift (see FLUSH).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper_async.cuh"
#include "flash_bwd_tile.cuh"
#include "flash_hopper.cuh"
#include "flash_tile.cuh"
#include "wgmma_ops.cuh"

namespace fa_hopper_bwd {

using fa_hopper::BK;
using fa_hopper::BOX;
using fa_hopper::TILE_BYTES;
using fa_hopper::d_boxes;
using fa_hopper::desc_sw128;
using fa_hopper::keep;
using fa_hopper::mma_rs;
using fa_hopper::mma_ss_n64;
using fa_hopper::wg_commit;
using fa_hopper::wg_fence;
using fa_hopper::wg_wait;
using hopper::mbar_arrive_lane0;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load_4d;

constexpr int CONSUMERS = 2;              // warpgroups of 64 rows
constexpr int ROWS = 64 * CONSUMERS;      // query rows or keys a block
constexpr int STAGES = 2;                 // ring depth
// The tensor cores' f32 sums are not rounded to nearest, so their error
// grows with the length of a chain of products into one accumulator:
// dK and dV of a GQA group at 2 x 2048 queries (1,024 k16-steps) were
// off by more than two bf16 steps of themselves in a few elements.  So
// every FLUSH tiles the kernels add their accumulators into f32 totals
// with ordinary (round-to-nearest) adds and start them again from 0.
constexpr int FLUSH = 8;
// The dK/dV kernel keeps those totals in shared memory, so for hd above
// 80 its ring has one stage (the block must fit in 227 KB).
__host__ __device__ constexpr int kv_stages(int hdp) {
  return hdp <= 80 ? STAGES : 1;
}
// the consumers and a producer warpgroup, of which one warp works: a
// whole warpgroup so that it can hand its registers to the consumers
// (setmaxnreg acts on warpgroups)
constexpr int THREADS = 128 * (CONSUMERS + 1);
// registers a thread: 168 at launch (65,536 over 384 threads), then 40
// for the producer and 232 for the consumers, whose accumulators (and
// the dQ kernel's totals), scores and split operands do not fit in 168
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  (CONSUMERS + 1) * LAUNCH_REGS,
              "the consumers ask for more registers than the block holds");

template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Dynamic shared memory of each kernel for hd rounded up to 16: the two
// held tiles of each consumer, the ring of two tiles a stage, (dK/dV:
// each consumer thread's f32 totals of dK and dV, the stages' lse and
// D), the barriers, and slack to align the tiles to the swizzle's
// 1024-byte period.
__host__ __device__ constexpr int dq_smem(int hdp) {
  return 1024 + (2 * CONSUMERS + 2 * STAGES) * d_boxes(hdp) * TILE_BYTES +
         8 * (1 + 3 * STAGES);
}
__host__ __device__ constexpr int dkdv_smem(int hdp) {
  return 1024 +
         (2 * CONSUMERS + 2 * kv_stages(hdp)) * d_boxes(hdp) * TILE_BYTES +
         CONSUMERS * 128 * hdp * 4 + 2 * kv_stages(hdp) * 64 * 4 +
         8 * (1 + 2 * kv_stages(hdp));
}

// The first live q-tile of keys [k_lo, k_hi] and the number of live
// q-tiles: the band makes them one contiguous range.
__device__ __forceinline__ void q_range(int k_lo, int k_hi, int S,
                                        int causal, int window, int& t_lo,
                                        int& n_live) {
  t_lo = 0;
  n_live = 0;
  const int n_qt = (S + 63) / 64;
  for (int t = 0; t < n_qt; ++t) {
    const int q_lo = 64 * t;
    if (!fa::tile_live(q_lo, min(q_lo + 63, S - 1), k_lo, k_hi, causal,
                       window))
      continue;
    if (n_live == 0) t_lo = t;
    n_live = t - t_lo + 1;
  }
}

// S (or dP) = A.B^T of two held or streamed tiles, both K-major over d.
template <int KSTEPS>
__device__ __forceinline__ void product_nt(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t off = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
    mma_ss_n64(d, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024),
               kk > 0);
  }
}

// acc += X.T with X (64 x 64) in registers as two bf16 terms and T a
// row-major (64 rows x hd) tile read transposed.
template <int HDP>
__device__ __forceinline__ void product_rs(float (&acc)[HDP / 2],
                                           const uint32_t (&hi)[16],
                                           const uint32_t (&lo)[16],
                                           uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dt = desc_sw128(tile + kk * 16 * 128, TILE_BYTES, 1024);
    mma_rs<HDP>(acc, hi + 4 * kk, dt);
    mma_rs<HDP>(acc, lo + 4 * kk, dt);
  }
}

// 64 x hd of f32 accumulators (wgmma D layout, rows r0 and r0 + 8 of this
// thread, columns 8 j + c0, + 1) times `mul`, as bf16 pairs into a
// (rows, hd) slab whose rows are `ld` apart; rows from `n` on are not
// written.
template <int HDP>
__device__ __forceinline__ void store_rows(const float (&acc)[HDP / 2],
                                           float mul, __nv_bfloat16* base,
                                           int64_t ld, int r0, int c0,
                                           int n, int hd) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + c0;   // hd even: col < hd -> col + 1 < hd
      if (col >= hd) continue;
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16(acc[4 * j + 2 * r] * mul);
      pair.y = __float2bfloat16(acc[4 * j + 2 * r + 1] * mul);
      *reinterpret_cast<__nv_bfloat162*>(base + row * ld + col) = pair;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ o32,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int S, int Tk, int H,
                        int KV, int hd, float scale, int causal, int window) {
  constexpr int NDB = d_boxes(HDP);
  constexpr int KSTEPS = HDP / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;             // [CONSUMERS][NDB]
  const uint32_t sdo = sq + CONSUMERS * NDB * TILE_BYTES;
  const uint32_t sk = sdo + CONSUMERS * NDB * TILE_BYTES;  // [STAGES][NDB]
  const uint32_t sv = sk + STAGES * NDB * TILE_BYTES;
  const uint32_t bars = sv + STAGES * NDB * TILE_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * STAGES + st); };

  // the longest causal rows first: they have the most live tiles
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int q_hi = min(q_lo + ROWS, S) - 1;
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

  int t_lo, n_live;
  fa_hopper::live_range(q_lo, q_hi, n_kt, Tk, causal, window, t_lo, n_live);
  // warp-uniform as far as the compiler can tell (see flash_hopper.cuh)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {                   // the producer warpgroup
    regs_release<PRODUCER_REGS>();
    if (tid == 128 * CONSUMERS) {
      mbar_expect_tx(q_full, 2 * CONSUMERS * NDB * TILE_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int db = 0; db < NDB; ++db) {
          tma_load_4d(sq + (w * NDB + db) * TILE_BYTES, &tq, q_full,
                      db * BOX, h, q_lo + 64 * w, b);
          tma_load_4d(sdo + (w * NDB + db) * TILE_BYTES, &tdo, q_full,
                      db * BOX, h, q_lo + 64 * w, b);
        }
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
  regs_take<CONSUMER_REGS>();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wq_lo = q_lo + 64 * wg, wq_hi = min(wq_lo + 63, S - 1);
  const int row0 = wq_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t q_tile = sq + wg * NDB * TILE_BYTES;
  const uint32_t do_tile = sdo + wg * NDB * TILE_BYTES;
  const float c = scale * fa::LOG2E;
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t head = (static_cast<int64_t>(b) * S * H + h) * hd;
  const int64_t rows_at = (static_cast<int64_t>(b) * H + h) * S;

  // D_i = dO_i . O_i from the forward's f32 O: the 4 threads of a row
  // take columns 8 j + col0, + 1 and sum with two shuffles (fixed order);
  // lse in log2 units, +inf past S (every probability there is 0)
  float D[2], m2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    float d = 0.0f;
    if (qi < S) {
      const __nv_bfloat16* g = dout + head + qi * q_row;
      const float* o = o32 + head + qi * q_row;
      for (int col = col0; col < hd; col += 8) {
        const float2 ov = *reinterpret_cast<const float2*>(o + col);
        const __nv_bfloat162 gv =
            *reinterpret_cast<const __nv_bfloat162*>(g + col);
        d = fmaf(__low2float(gv), ov.x, d);
        d = fmaf(__high2float(gv), ov.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    D[r] = d;
    m2[r] = qi < S ? lse[rows_at + qi] * fa::LOG2E : INFINITY;
    if (qi < S && lane % 4 == 0) dsum[rows_at + qi] = d;
  }

  float acc[HDP / 2], total[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = total[i] = 0.0f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  uint32_t hi[16], lo[16];
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_live; ++j) {
    const int k_lo = (t_lo + j) * BK;
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    mbar_wait(k_full(st), ph);
    mbar_wait(v_full(st), ph);
    __syncwarp();
    const uint32_t k_tile = sk + st * NDB * TILE_BYTES;
    const uint32_t v_tile = sv + st * NDB * TILE_BYTES;
    // ---- S = Q.K^T, dP = dO.V^T ------------------------------------
    wg_fence();
    product_nt<KSTEPS>(s, q_tile, k_tile);
    product_nt<KSTEPS>(dp, do_tile, v_tile);
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);

    // ---- dS = P (dP - D), masked where the tile needs it -------------
    const bool full =
        fa::tile_full(wq_lo, wq_hi, k_lo, k_lo + BK - 1, Tk, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const bool in = full || fa::in_band(row0 + 8 * r,
                                          k_lo + 8 * (i / 4) + col0 + i % 2,
                                          Tk, causal, window);
      s[i] = fab::dscore(fa::prob_log2(s[i], c, m2[r], in), dp[i], D[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      fa::split_bf16x2(s[i], s[i + 1], hi[i / 2], lo[i / 2]);

    // ---- dQ += dS.K, dS in two bf16 terms ------------------------------
    keep(acc);
    wg_fence();
    product_rs<HDP>(acc, hi, lo, k_tile);
    wg_commit();
    wg_wait<0>();
    keep(acc);
    __syncwarp();
    mbar_arrive_lane0(empty(st), lane);
    if ((j + 1) % FLUSH == 0) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) {
        total[i] += acc[i];
        acc[i] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = total[i] + acc[i];
  store_rows<HDP>(acc, scale, dq + head, q_row, row0, col0, S, hd);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_hopper(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, int Tk,
                          int H, int KV, int hd, float scale, int causal,
                          int window) {
  constexpr int NDB = d_boxes(HDP);
  constexpr int KSTEPS = HDP / 16;
  constexpr int STAGES = kv_stages(HDP);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;             // [CONSUMERS][NDB]
  const uint32_t sv = sk + CONSUMERS * NDB * TILE_BYTES;
  const uint32_t sq = sv + CONSUMERS * NDB * TILE_BYTES;  // [STAGES][NDB]
  const uint32_t sdo = sq + STAGES * NDB * TILE_BYTES;
  // each consumer thread's f32 totals of dK and dV: [CONSUMERS][HDP][128]
  const uint32_t tots = sdo + STAGES * NDB * TILE_BYTES;
  const uint32_t rows = tots + CONSUMERS * HDP * 128 * 4;  // [STAGES][2][64]
  float* rows_p = reinterpret_cast<float*>(smem_raw + (rows - raw));
  const uint32_t bars = rows + 2 * STAGES * 64 * 4;
  const uint32_t kv_full = bars;
  auto q_full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + STAGES + st); };

  // the first keys first: under a causal mask they meet the most q-tiles
  const int k_lo = blockIdx.x * ROWS;
  const int k_hi = min(k_lo + ROWS, Tk) - 1;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int group = H / KV;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      // the TMA's expect_tx and the 32 lanes that write lse and D
      mbar_init(q_full(st), 1 + 32);
      mbar_init(empty(st), CONSUMERS * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  int t_lo, n_live;
  q_range(k_lo, k_hi, S, causal, window, t_lo, n_live);
  const int items = group * n_live;   // (head of the group, q-tile)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMERS) {                   // the producer warpgroup
    regs_release<PRODUCER_REGS>();
    if (tid >= 128 * CONSUMERS + 32) return;   // its first warp works
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * CONSUMERS * NDB * TILE_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int db = 0; db < NDB; ++db) {
          tma_load_4d(sk + (w * NDB + db) * TILE_BYTES, &tk, kv_full,
                      db * BOX, kvh, k_lo + 64 * w, b);
          tma_load_4d(sv + (w * NDB + db) * TILE_BYTES, &tv, kv_full,
                      db * BOX, kvh, k_lo + 64 * w, b);
        }
    }
    for (int n = 0; n < items; ++n) {
      const int st = n % STAGES;
      if (n >= STAGES) mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
      const int h = kvh * group + n / n_live;
      const int q_lo = (t_lo + n % n_live) * 64;
      if (lane == 0) {
        mbar_expect_tx(q_full(st), 2 * NDB * TILE_BYTES);
        for (int db = 0; db < NDB; ++db) {
          tma_load_4d(sq + (st * NDB + db) * TILE_BYTES, &tq, q_full(st),
                      db * BOX, h, q_lo, b);
          tma_load_4d(sdo + (st * NDB + db) * TILE_BYTES, &tdo, q_full(st),
                      db * BOX, h, q_lo, b);
        }
      }
      // lse (log2 units, +inf past S) and D of the tile's 64 queries
      const int64_t rows_at = (static_cast<int64_t>(b) * H + h) * S;
      float* rs = rows_p + st * 128;
      for (int r = lane; r < 64; r += 32) {
        const int qi = q_lo + r;
        rs[r] = qi < S ? lse[rows_at + qi] * fa::LOG2E : INFINITY;
        rs[64 + r] = qi < S ? dsum[rows_at + qi] : 0.0f;
      }
      mbar_arrive_lane0(q_full(st), 0);    // every lane arrives
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k_lo + 64 wg .. + 63 ---------
  regs_take<CONSUMER_REGS>();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  // (the tile where the block's second warpgroup meets no key in band is
  // computed and masked to 0: one tile of a block's walk)
  const int wk_lo = k_lo + 64 * wg;
  const int key0 = wk_lo + 16 * warp + lane / 4;   // and key0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t k_tile = sk + wg * NDB * TILE_BYTES;
  const uint32_t v_tile = sv + wg * NDB * TILE_BYTES;
  const float c = scale * fa::LOG2E;

  float adk[HDP / 2], adv[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) adk[i] = adv[i] = 0.0f;
  // this thread's totals, dK then dV, 128 floats apart (no bank conflict)
  float* total = reinterpret_cast<float*>(smem_raw + (tots - raw)) +
                 wg * HDP * 128 + tid % 128;
#pragma unroll
  for (int i = 0; i < HDP; ++i) total[i * 128] = 0.0f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  uint32_t p_hi[16], p_lo[16], d_hi[16], d_lo[16];
  mbar_wait(kv_full, 0);
  for (int n = 0; n < items; ++n) {
    const int st = n % STAGES;
    const int q_lo = (t_lo + n % n_live) * 64;
    mbar_wait(q_full(st), (n / STAGES) & 1);
    __syncwarp();
    const uint32_t q_tile = sq + st * NDB * TILE_BYTES;
    const uint32_t do_tile = sdo + st * NDB * TILE_BYTES;
    // ---- S^T = K.Q^T, dP^T = V.dO^T (rows keys, columns queries) ----
    wg_fence();
    product_nt<KSTEPS>(s, k_tile, q_tile);
    product_nt<KSTEPS>(dp, v_tile, do_tile);
    wg_commit();
    wg_wait<0>();
    keep(s);
    keep(dp);

    // ---- P^T, dS^T = P^T (dP^T - D) ------------------------------------
    const float* rs = rows_p + st * 128;
    const bool full = fa::tile_full(q_lo, q_lo + 63, wk_lo, wk_lo + 63, Tk,
                                    causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + col0 + i % 2;   // query in the tile
      const bool in = full || fa::in_band(q_lo + qc, key0 + 8 * ((i / 2) % 2),
                                          Tk, causal, window);
      const float p = fa::prob_log2(s[i], c, rs[qc], in);
      dp[i] = fab::dscore(p, dp[i], rs[64 + qc]);
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      fa::split_bf16x2(s[i], s[i + 1], p_hi[i / 2], p_lo[i / 2]);
      fa::split_bf16x2(dp[i], dp[i + 1], d_hi[i / 2], d_lo[i / 2]);
    }

    // ---- dV += P^T.dO, dK += dS^T.Q ----------------------------------
    keep(adv);
    keep(adk);
    wg_fence();
    product_rs<HDP>(adv, p_hi, p_lo, do_tile);
    product_rs<HDP>(adk, d_hi, d_lo, q_tile);
    wg_commit();
    wg_wait<0>();
    keep(adv);
    keep(adk);
    __syncwarp();
    mbar_arrive_lane0(empty(st), lane);
    if ((n + 1) % FLUSH == 0) {
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) {
        total[i * 128] += adk[i];
        total[(HDP / 2 + i) * 128] += adv[i];
        adk[i] = adv[i] = 0.0f;
      }
    }
  }

  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tk * KV + kvh) * hd;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) {
    adk[i] = total[i * 128] + adk[i];
    adv[i] = total[(HDP / 2 + i) * 128] + adv[i];
  }
  store_rows<HDP>(adk, scale, dk + kv_off, kv_row, key0, col0, Tk, hd);
  store_rows<HDP>(adv, 1.0f, dv + kv_off, kv_row, key0, col0, Tk, hd);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* o32, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int Tk, int H, int KV, int hd,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (fa_hopper::make_map(&tq, q, hd, H, S, B) != CUDA_SUCCESS ||
      fa_hopper::make_map(&tk, k, hd, KV, Tk, B) != CUDA_SUCCESS ||
      fa_hopper::make_map(&tv, v, hd, KV, Tk, B) != CUDA_SUCCESS ||
      fa_hopper::make_map(&tdo, dout, hd, H, S, B) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem_q = dq_smem(HDP), smem_kv = dkdv_smem(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_hopper<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_hopper<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the consumers' setmaxnreg.inc waits for registers the producer
  // releases: with fewer than LAUNCH_REGS a thread at launch it would
  // wait forever, so such a build is refused instead of launched
  cudaFuncAttributes dq_attr, kv_attr;
  err = cudaFuncGetAttributes(&dq_attr, flash_bwd_dq_hopper<HDP>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&kv_attr, flash_bwd_dkdv_hopper<HDP>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dq_attr.numRegs < LAUNCH_REGS || kv_attr.numRegs < LAUNCH_REGS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  flash_bwd_dq_hopper<HDP><<<dim3((S + ROWS - 1) / ROWS, B * H), THREADS,
                             smem_q, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(dout), o32, lse,
      dsum, static_cast<__nv_bfloat16*>(dq), S, Tk, H, KV, hd, scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_hopper<HDP><<<dim3((Tk + ROWS - 1) / ROWS, B * KV),
                               THREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Tk, H, KV, hd, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

// Whether a call takes this route: the forward's condition on q, k, v
// (hd a multiple of 8, 16-byte boundaries) extended to dO, dQ, dK, dV,
// and the forward's f32 O given.
inline bool takes(const void* q, const void* k, const void* v,
                  const void* dout, const float* o32, const void* dq,
                  const void* dk, const void* dv, int hd) {
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return o32 != nullptr && aligned(o32) &&
         fa_hopper::takes(q, k, v, dout, hd) && aligned(dq) && aligned(dk) &&
         aligned(dv);
}

inline int dispatch(const void* q, const void* k, const void* v,
                    const void* dout, const float* o32, const float* lse,
                    float* dsum, void* dq, void* dk, void* dv, int B, int S,
                    int Tk, int H, int KV, int hd, int causal, int window,
                    cudaStream_t st) {
#define FLASH_BWD_HOPPER_CASE(NB)                                           \
  case NB:                                                                  \
    return launch<16 * NB>(q, k, v, dout, o32, lse, dsum, dq, dk, dv, B, S, \
                           Tk, H, KV, hd, causal, window, st);
  switch ((hd + 15) / 16) {
    FLASH_BWD_HOPPER_CASE(1)
    FLASH_BWD_HOPPER_CASE(2)
    FLASH_BWD_HOPPER_CASE(3)
    FLASH_BWD_HOPPER_CASE(4)
    FLASH_BWD_HOPPER_CASE(5)
    FLASH_BWD_HOPPER_CASE(6)
    FLASH_BWD_HOPPER_CASE(7)
    FLASH_BWD_HOPPER_CASE(8)
  }
#undef FLASH_BWD_HOPPER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fa_hopper_bwd

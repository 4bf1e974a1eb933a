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
// triangle are 0.7 GFLOP.
//
// Design.  The TPU kernel takes one grid step per (chunk, head) and
// recomputes C.B^T for every head.  Here a persistent grid of 256-thread
// blocks (as many as fit on the card at once, two an SM, but no more
// than one per MIN_ITEMS items) splits the G*H (chunk, head) items into
// contiguous ranges (`ssd::block_items`), so a block computes C.B^T once
// per chunk it meets, over the tiles on and below the diagonal only
// (`ssd::cb_tile`), into shared memory, and the grid fills the SMs
// whether G is 5 or 32.  (At G = 5, 400 items, blocks of at least two
// items measured faster than one block per item: fewer blocks compute
// C.B^T; scripts/hopper_kernel_variants.py.)  Each item's (L, P) tile of x
// comes through a ring of STAGES slots in shared memory: the next item's
// tile is in flight while one is multiplied.  Two load routes fill the
// same 128-byte-swizzled layout (`ssd::swz`, 32-column boxes, zeros past
// L and P):
// - TMA (P and N multiples of 4, tensors on 16-byte boundaries: the
//   serving path's shapes): x viewed as (G*L, H, P) and B, C as
//   (G*L, N), one cp.async.bulk.tensor per box completing on an
//   mbarrier; C and B of the block's next chunk load while it works;
// - cp.async of 4-byte words (every other shape), C and B by plain loads.
// Per item the block makes the scores its products read once, the same
// count for every thread (`ssd::score_pair`; `ssd::score`, masked only
// in the diagonal blocks, `ssd::diag_block`), into shared memory; then
// warp w multiplies the strips w % 2 and 3 - w % 2 (10 k-steps each at
// L = 64, `ssd::strip_ksteps`) into a quarter of y's columns.
//
// Products.  Both routes run both products (C.B^T and scores.x) on the
// tensor cores as mma.sync m16n8k8 in f64: the f32 operands convert
// exactly, the sums are f64, one rounding to f32 at the end.  f32 FMAs
// are shared-memory-bound at this kernel's tile sizes, and 3xTF32 leaves
// about 12 units of float32 rounding in each product, which fails the
// 2e-5 check against the plain version (scripts/hopper_kernel_variants.py
// times both as patches of this file).  y leaves from registers: 8-byte
// stores on the TMA route, one float a store on the cp.async route.
//
// Per-launch host work: the tensor maps (three cuTensorMapEncodeTiled);
// the shared-memory attribute and the occupancy query run once per
// kernel instance (and device).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "../../common/csrc/hopper_async.cuh"
#include "ssd_tile.cuh"

namespace {

using hopper::smem_u32;
using ssd::MAX_L;
using ssd::BOX;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;         // x ring depth
constexpr int MIN_ITEMS = 2;      // fewest (chunk, head) items a block
constexpr int BOX_WORDS = MAX_L * BOX;   // one 8 KB box
constexpr int CB_LD = MAX_L + 4;  // rows of C.B^T and of the scores,
constexpr int SC_LD = MAX_L + 4;  // both transposed: [j][i]
constexpr int MAX_P = 128, MAX_N = 128;
constexpr int MAX_DEVICES = 64;

// Shared memory in floats after a 1024-byte-aligned base: the x ring
// [STAGES][NBX boxes], C and B [nbn boxes] each, (C.B^T)^T
// [MAX_L][CB_LD], cum and dt [STAGES][MAX_L] each, the
// scores (transposed) [MAX_L][SC_LD], then STAGES + 1 mbarriers.
__host__ __device__ constexpr int smem_bytes(int nbx, int nbn) {
  return 1024 +
         4 * ((STAGES * nbx + 2 * nbn) * BOX_WORDS + MAX_L * CB_LD +
              2 * STAGES * MAX_L + MAX_L * SC_LD) +
         8 * (STAGES + 1);
}

// The products run on the tensor cores in f64: the f32 operands convert
// exactly, the sums are f64, one rounding to f32 at the end.
using Acc = double;

// d += a * b over one m16n8k8 tile, f64 operands and accumulators.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The A operand of one k-step (m16n8k8 layout: a0 row g, a1 row g + 8,
// a2 and a3 the same rows at k + 4).  The kernel's k order: lane t of a
// quad holds k index t (a0, a1, b0) at column k0 + 2t and k index t + 4
// (a2, a3, b1) at column k0 + 2t + 1, so that C and B fragments are one
// 8-byte load each and the x fragments fall in eight distinct 16-byte
// chunks of the swizzle.
struct FragA {
  double v[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    v[0] = a0;
    v[1] = a1;
    v[2] = a2;
    v[3] = a3;
  }
};

// d += a * b for the B fragment (b0, b1) of one k-step.
__device__ __forceinline__ void mma_step(Acc (&d)[4], const FragA& a,
                                         float b0, float b1) {
  mma_f64(d, a.v, b0, b1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One warp's C.B^T tile: rows i0 .. i0 + 15 by columns j0 .. j0 + 7 from
// the swizzled C (cs) and B (bs), into cb transposed ([j][i]).
__device__ __forceinline__ void cb_tile_product(const float* cs,
                                                const float* bs, float* cb,
                                                int i0, int j0, int N,
                                                int lane) {
  const int g8 = lane / 4, t4 = lane % 4;
  // the accumulator layout: rows g8, g8 + 8; columns 2 t4, + 1
  Acc d[4] = {};
  for (int k0 = 0; k0 < N; k0 += ssd::KSTEP) {
    const int kc = k0 + 2 * t4;
    const float2 ca = ld2(cs + ssd::swz(i0 + g8, kc));
    const float2 cc = ld2(cs + ssd::swz(i0 + g8 + 8, kc));
    const float2 bb = ld2(bs + ssd::swz(j0 + g8, kc));
    FragA fa;
    fa.set(ca.x, cc.x, ca.y, cc.y);
    mma_step(d, fa, bb.x, bb.y);
  }
  float* o = cb + (j0 + 2 * t4) * CB_LD + i0 + g8;
  o[0] = static_cast<float>(d[0]);
  o[CB_LD] = static_cast<float>(d[1]);
  o[8] = static_cast<float>(d[2]);
  o[CB_LD + 8] = static_cast<float>(d[3]);
}

// Warp w's share of one item's y: the rows of its strips w % 2 and
// 3 - w % 2 by the quarter w / 2 of the columns, from the transposed
// scores (sc) and the swizzled x tile (xs); y points at row 0 of the
// item, rows `ld` floats apart.  kVec: 8-byte stores (P % 4 == 0 and y
// on a 16-byte boundary), else one float a store.
template <int NBX, bool kVec>
__device__ __forceinline__ void item_product(const float* sc,
                                             const float* xs, float* y,
                                             int64_t ld, int L, int P,
                                             int warp, int lane) {
  const int g8 = lane / 4, t4 = lane % 4, quarter = warp >> 1;
  // the warp's NBX n-tiles of 8 columns in each of its two strips
  Acc acc[2][NBX][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int t = 0; t < NBX; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][t][e] = 0;
  // both strips in one walk over k, sharing the x fragments; a strip
  // stops after its own k-steps
  int nks[2], ia[2];
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int strip = ssd::warp_strip(warp, which);
    nks[which] = ssd::strip_ksteps(strip, L);
    ia[which] = ssd::STRIP * strip + g8;
  }
  const int nk = max(nks[0], nks[1]);
  for (int ks = 0; ks < nk; ++ks) {
    const int j = ssd::KSTEP * ks + 2 * t4;
    float b0[NBX], b1[NBX];
#pragma unroll
    for (int t = 0; t < NBX; ++t) {
      const int col = ssd::KSTEP * (quarter * NBX + t) + g8;
      b0[t] = xs[ssd::swz(j, col)];
      b1[t] = xs[ssd::swz(j + 1, col)];
    }
    const float* s0 = sc + j * SC_LD;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (ks >= nks[which]) continue;
      FragA fa;
      fa.set(s0[ia[which]], s0[ia[which] + 8], s0[SC_LD + ia[which]],
             s0[SC_LD + ia[which] + 8]);
#pragma unroll
      for (int t = 0; t < NBX; ++t) mma_step(acc[which][t], fa, b0[t], b1[t]);
    }
  }
  // y from the accumulator layout: rows ia, ia + 8; columns col, col + 1
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int i0 = ssd::STRIP * ssd::warp_strip(warp, which);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + g8 + 8 * half;
      if (i >= L) continue;
      float* yr = y + i * ld;
#pragma unroll
      for (int t = 0; t < NBX; ++t) {
        const int col = ssd::KSTEP * (quarter * NBX + t) + 2 * t4;
        const float v0 = static_cast<float>(acc[which][t][2 * half]);
        const float v1 = static_cast<float>(acc[which][t][2 * half + 1]);
        if constexpr (kVec) {
          if (col < P) *reinterpret_cast<float2*>(yr + col) =
              make_float2(v0, v1);
        } else {
          if (col < P) yr[col] = v0;
          if (col + 1 < P) yr[col + 1] = v1;
        }
      }
    }
  }
}

struct Args {
  const float* x;
  const float* dt;
  const float* cum;
  const float* Bm;
  const float* Cm;
  float* y;
  int G, L, H, P, N, nbn;
};

// NBX: 32-column boxes of x (P <= 32 NBX); kTMA: the load route.
template <int NBX, bool kTMA>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tc,
               const __grid_constant__ CUtensorMap tb, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw +
                                       (((raw + 1023) & ~1023u) - raw));
  float* cs = xs + STAGES * NBX * BOX_WORDS;
  float* bs = cs + a.nbn * BOX_WORDS;
  float* cb = bs + a.nbn * BOX_WORDS;                 // cb[j][i]
  float* cum_s = cb + MAX_L * CB_LD;
  float* dt_s = cum_s + STAGES * MAX_L;
  float* sc = dt_s + STAGES * MAX_L;                  // sc[j][i]
  const uint32_t bars = smem_u32(sc + MAX_L * SC_LD);
  auto x_full = [&](int s) { return bars + 8 * s; };
  const uint32_t cb_full = bars + 8 * STAGES;

  const int L = a.L, H = a.H, P = a.P, N = a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int64_t lo, hi;
  ssd::block_items(static_cast<int64_t>(a.G) * H, blockIdx.x, gridDim.x,
                   lo, hi);
  const int n_items = static_cast<int>(hi - lo);
  if (n_items <= 0) return;
  const int g_last = static_cast<int>((hi - 1) / H);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(x_full(s), 1);
    hopper::mbar_init(cb_full, 1);
    hopper::mbar_init_fence();
  }
  // C and B of chunk g into cs and bs
  auto load_cb = [&](int g) {
    if constexpr (kTMA) {
      if (tid == 0) {
        hopper::mbar_expect_tx(cb_full, 2 * a.nbn * BOX * L * 4);
        for (int b = 0; b < a.nbn; ++b) {
          hopper::tma_load_2d(smem_u32(cs + b * BOX_WORDS), &tc, cb_full,
                              BOX * b, g * L);
          hopper::tma_load_2d(smem_u32(bs + b * BOX_WORDS), &tb, cb_full,
                              BOX * b, g * L);
        }
      }
    } else {
      const int64_t row0 = static_cast<int64_t>(g) * L;
      for (int idx = tid; idx < L * N; idx += THREADS) {
        const int i = idx / N, n = idx % N;
        cs[ssd::swz(i, n)] = a.Cm[row0 * N + idx];
        bs[ssd::swz(i, n)] = a.Bm[row0 * N + idx];
      }
    }
  };
  // on the TMA route C and B of the first chunk load while the block
  // clears the words no copy writes: the rows past L of every box (and,
  // on the cp.async route, the columns past P and N; on the TMA route the
  // copies fill those with zeros themselves, and no word the TMA unit
  // writes is also written here); for L < 64 also C.B^T (whose tiles
  // past L are never computed), cum, dt and the scores, so that a masked
  // score is 0 * 0 * 0, never 0 * a stale infinity
  if constexpr (kTMA) load_cb(static_cast<int>(lo / H));
  {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int boxes = STAGES * NBX + 2 * a.nbn;
    const int r0 = kTMA ? L : 0, per_box = (MAX_L - r0) * BOX / 4;
    for (int i = tid; i < boxes * per_box; i += THREADS)
      reinterpret_cast<float4*>(xs + (i / per_box) * BOX_WORDS +
                                r0 * BOX)[i % per_box] = zero;
    if (L < MAX_L)
      for (int i = tid; i < (MAX_L * CB_LD + 2 * STAGES * MAX_L +
                             MAX_L * SC_LD) / 4;
           i += THREADS)
        reinterpret_cast<float4*>(cb)[i] = zero;
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if constexpr (!kTMA) {
    load_cb(static_cast<int>(lo / H));
    __syncthreads();
  }
  // the block's n-th item into its ring slot: x, cum, dt; one cp.async
  // group a thread per call, empty past the last item
  auto fill_slot = [&](int n) {
    if (n < n_items) {
      const int64_t k = lo + n;
      const int g = static_cast<int>(k / H), h = static_cast<int>(k % H);
      const int s = ssd::ring_stage(n, STAGES);
      const int64_t row0 = static_cast<int64_t>(g) * L;
      if (tid < L)
        hopper::cp_async4(smem_u32(cum_s + s * MAX_L + tid),
                          a.cum + (row0 + tid) * H + h);
      else if (tid >= MAX_L && tid - MAX_L < L)
        hopper::cp_async4(smem_u32(dt_s + s * MAX_L + tid - MAX_L),
                          a.dt + (row0 + tid - MAX_L) * H + h);
      float* xst = xs + s * NBX * BOX_WORDS;
      if constexpr (kTMA) {
        if (tid == 0) {
          hopper::mbar_expect_tx(x_full(s), NBX * BOX * L * 4);
          for (int b = 0; b < NBX; ++b)
            hopper::tma_load_3d(smem_u32(xst + b * BOX_WORDS), &tx,
                                x_full(s), BOX * b, h, g * L);
        }
      } else {
        for (int idx = tid; idx < L * P; idx += THREADS) {
          const int j = idx / P, p = idx % P;
          hopper::cp_async4(smem_u32(xst + ssd::swz(j, p)),
                            a.x + ((row0 + j) * H + h) * P + p);
        }
      }
    }
    hopper::cp_async_commit();
  };

  // C.B^T of the loaded chunk over the tiles on and below the diagonal,
  // into cb transposed
  auto chunk_cb = [&]() {
    for (int q = warp; q < ssd::CB_TILES; q += WARPS) {
      int r, c;
      ssd::cb_tile(q, r, c);
      const int i0 = ssd::STRIP * r, j0 = ssd::KSTEP * c;
      if (i0 < L && j0 < L) cb_tile_product(cs, bs, cb, i0, j0, N, lane);
    }
  };

  for (int n = 0; n < STAGES; ++n) fill_slot(n);
  uint32_t cb_phase = 0;
  int g_cur = -1;
  for (int n = 0; n < n_items; ++n) {
    const int64_t k = lo + n;
    const int g = static_cast<int>(k / H), h = static_cast<int>(k % H);
    const int s = ssd::ring_stage(n, STAGES);
    if (g != g_cur) {
      if constexpr (kTMA) {
        hopper::mbar_wait(cb_full, cb_phase);
        cb_phase ^= 1u;
      } else if (g_cur >= 0) {
        load_cb(g);
        __syncthreads();
      }
      chunk_cb();
      __syncthreads();   // C.B^T complete; cs and bs free
      if constexpr (kTMA) {
        if (g < g_last) load_cb(g + 1);
      }
      g_cur = g;
    }
    hopper::cp_async_wait<STAGES - 1>();
    __syncthreads();     // this item's cum, dt (and cp.async x) arrived
    if constexpr (kTMA)
      hopper::mbar_wait(x_full(s), ssd::ring_phase(n, STAGES));
    const float* xst = xs + s * NBX * BOX_WORDS;
    const float* cums = cum_s + s * MAX_L;
    const float* dts = dt_s + s * MAX_L;
    const int64_t row0 = static_cast<int64_t>(g) * L;

    // the scores the products read (`ssd::score_pair`), transposed, the
    // same count for every thread; the mask only on the diagonal blocks
    {   // all operands read before any score is written
      constexpr int U = ssd::SCORE_PAIRS / THREADS;
      float v[U];
      int at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int i, j;
        ssd::score_pair(tid + THREADS * u, i, j);
        at[u] = i < L && j < L ? j * SC_LD + i : -1;
        const float c = cb[j * CB_LD + i], ci = cums[i], cj = cums[j],
                    d = dts[j];
        v[u] = ssd::diag_block(i, j) ? ssd::score(c, ci, cj, d, i, j)
                                     : ssd::score_below(c, ci, cj, d);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (at[u] >= 0) sc[at[u]] = v[u];
    }
    __syncthreads();

    // y: 8-byte stores on the TMA route (P % 4 == 0, y on a 16-byte
    // boundary)
    item_product<NBX, kTMA>(sc, xst, a.y + (row0 * H + h) * P,
                            static_cast<int64_t>(H) * P, L, P, warp, lane);
    __syncthreads();     // ring slot s, cum and dt, sc free
    fill_slot(n + STAGES);
  }
}

// Sets the kernel's shared-memory limit once per device and caches its
// blocks per SM for each count of C/B boxes; returns a cudaError_t.
template <int NBX, bool kTMA>
int prepare(int nbn, int& blocks_per_sm) {
  static std::atomic<uint64_t> ready{0};   // bit d: limit set on device d
  static std::atomic<int> occ[MAX_N / BOX + 1];
  auto kernel = ssd_kernel<NBX, kTMA>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const uint64_t bit = uint64_t{1} << dev;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(NBX, MAX_N / BOX));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit);
  }
  int n = occ[nbn].load();
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, THREADS, smem_bytes(NBX, nbn));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ[nbn].store(n);
  }
  blocks_per_sm = n;
  return 0;
}

// A tensor map over a row-major f32 tensor of `rank` dims (innermost
// first), in boxes of 32 columns, 128-byte swizzled; coordinates outside
// the tensor read as 0.
CUresult make_map(CUtensorMap* map, const float* ptr, int rank,
                  const cuuint64_t* dims, const cuuint32_t* box) {
  cuuint64_t strides[2];
  cuuint64_t row = dims[0] * 4;
  for (int d = 1; d < rank; ++d) {
    strides[d - 1] = row;
    row *= dims[d];
  }
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NBX, bool kTMA>
int launch(const Args& a, cudaStream_t stream) {
  int per_sm = 0;
  int err = prepare<NBX, kTMA>(a.nbn, per_sm);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tx{}, tc{}, tb{};
  if (kTMA) {
    const cuuint64_t rows = static_cast<cuuint64_t>(a.G) * a.L;
    const cuuint64_t xd[3] = {static_cast<cuuint64_t>(a.P),
                              static_cast<cuuint64_t>(a.H), rows};
    const cuuint32_t xb[3] = {BOX, 1, static_cast<cuuint32_t>(a.L)};
    const cuuint64_t nd[2] = {static_cast<cuuint64_t>(a.N), rows};
    const cuuint32_t nb[2] = {BOX, static_cast<cuuint32_t>(a.L)};
    if (make_map(&tx, a.x, 3, xd, xb) != CUDA_SUCCESS ||
        make_map(&tc, a.Cm, 2, nd, nb) != CUDA_SUCCESS ||
        make_map(&tb, a.Bm, 2, nd, nb) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = static_cast<int64_t>(a.G) * a.H;
  int64_t blocks = static_cast<int64_t>(sms) * per_sm;
  blocks = std::min(blocks, (items + MIN_ITEMS - 1) / MIN_ITEMS);
  ssd_kernel<NBX, kTMA>
      <<<static_cast<unsigned>(blocks), THREADS,
         smem_bytes(NBX, a.nbn), stream>>>(tx, tc, tb, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTMA>
int dispatch(const Args& a, cudaStream_t st) {
  switch ((a.P + BOX - 1) / BOX) {
    case 1: return launch<1, kTMA>(a, st);
    case 2: return launch<2, kTMA>(a, st);
    case 3: return launch<3, kTMA>(a, st);
    case 4: return launch<4, kTMA>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

std::atomic<int> last_route{-1};   // 1 TMA, 0 cp.async, -1 no launch yet

}  // namespace

// Whether shapes with this P and N take the TMA route; the others take
// the cp.async route.  Tensors off 16-byte boundaries take the cp.async
// route too.
extern "C" int ssd_intra_chunk_route(int P, int N) {
  return P % 4 == 0 && N % 4 == 0;
}

// The route of the latest launch in this process, from its shape and
// its tensors' addresses: 1 TMA, 0 cp.async, -1 before the first.
extern "C" int ssd_intra_chunk_last_route() { return last_route.load(); }

// Dynamic shared memory of one block for this P and N, in bytes (0
// outside the shapes the kernel takes).
extern "C" int ssd_intra_chunk_smem(int P, int N) {
  if (P < 1 || P > MAX_P || N < 1 || N > MAX_N) return 0;
  return smem_bytes((P + BOX - 1) / BOX, (N + BOX - 1) / BOX);
}

// Shapes as above.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); refuses L outside 1..64, P outside 1..128,
// N outside 1..128.
extern "C" int ssd_intra_chunk_fwd(const float* x, const float* dt,
                                   const float* cum, const float* Bm,
                                   const float* Cm, float* y, int G, int L,
                                   int H, int P, int N, void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      H < 1 || G < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const Args a{x, dt, cum, Bm, Cm, y, G, L, H, P, N, (N + BOX - 1) / BOX};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = ssd_intra_chunk_route(P, N) && aligned16(x) &&
                   aligned16(Bm) && aligned16(Cm) && aligned16(y);
  const int err = tma ? dispatch<true>(a, st) : dispatch<false>(a, st);
  if (err == 0) last_route.store(tma ? 1 : 0);
  return err;
}

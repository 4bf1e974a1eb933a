// Mamba2 intra-chunk SSD backward: dx, ddt, dcum, dB and dC of
//   y[g, i, h, :] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[g, j, h, :]
// given dy, float32 in and out, every product and sum in double.
//
// Replaces the gradient that JAX's autodiff takes through the reference
// model's intra-chunk term (src/repro/models/ssm.py `mamba2_forward`),
// on the path of the Pallas kernel `intra_chunk` of
// src/repro/kernels/mamba2_scan/kernel.py:56, which has no backward of
// its own.  Layout as the forward's (ssd_intra_chunk.cu): x, dy, dx
// (G, L, H, P); dt, cum, ddt, dcum (G, L, H); B, C, dB, dC (G, L, N).
//
// What bounds it on an H100: bytes.  At the training shape (G 128, L 64,
// H 80, P = N = 64) its inputs and outputs are 0.52 GB, nearly all of it
// x, dy and dx (0.16 ms at 3.35 TB/s); its products over the lower triangle (C.B^T, dC and dB
// once a chunk; ds = dy.x^T and dx = s^T.dy a head) are 7 GFLOP, 0.1 ms
// at the 67 TFLOP/s of the f64 tensor cores.
//
// Design.  One block of 16 warps per chunk walks the chunk's heads in
// order, so that what the heads share is made and summed in the block,
// with no atomics and no scratch in device memory (two launches give the
// same bits):
//  - C.B^T once per chunk, on the 20 tiles of 16 x 8 on and below the
//    diagonal (ssd::cb_tile), each warp keeping its tiles' values in
//    registers for every head;
//  - per head, ds = dy.x^T on the same tiles, the per-pair terms of
//    ssd_bwd_tile.cuh in registers (ssdb::pair_grads), the head's share of
//    d(C.B^T) added to the warp's registers in head order, s^T into shared
//    memory, the column and row sums of ddt's and dcum's terms reduced
//    in each tile by shuffles and then summed over the tiles in a fixed
//    order; then dx = s^T.dy over i >= j (ssdb::kstep_lo);
//  - after the last head, dC = dCB.B and dB = dCB^T.C.
// x and dy of each head come through a ring of shared-memory slots
// (two, one when P > 64) in the forward's 128-byte swizzled layout
// (ssd::swz), so the next head's tiles load while one is multiplied; as
// in the forward, TMA fills them (P and N multiples of 4, tensors on
// 16-byte boundaries: the training path's shapes) and 4-byte cp.async
// every other shape.  Every product runs on the tensor cores as
// mma.sync m16n8k8 in f64: the f32 operands convert exactly, the sums are
// f64, one rounding to f32 at the end, as ssd_bwd_tile.cuh requires (f32
// sums fail 1e-4 at G 128, and 3xTF32 failed the forward's 2e-5).  At
// G = 128 the grid is one block on each of 128 of the card's 132 SMs.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/hopper_async.cuh"
#include "ssd_bwd_tile.cuh"
#include "ssd_tile.cuh"

namespace {

using hopper::smem_u32;
using ssd::BOX;
using ssd::MAX_L;

// 16 warps, one block an SM: the products and the double exps of a head
// are short chains, and the warps take turns hiding their latency
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
// ds tiles a warp: q = warp + WARPS t
constexpr int TILES = (ssd::CB_TILES + WARPS - 1) / WARPS;
constexpr int BOX_WORDS = MAX_L * BOX;   // one 8 KB box
// doubles a row of s^T (and of dCB at the end): 16-byte fragment loads
// of the eight rows of a quarter-warp fall in distinct banks
constexpr int SLD = MAX_L + 8;
constexpr int MAX_P = 128, MAX_N = 128;

// Ring slots: two, or one where the x and dy tiles are 16 KB each or
// more (P > 64), so that P = N = 128 fits in shared memory.
__host__ __device__ constexpr int stages(int nbx) { return nbx <= 2 ? 2 : 1; }

// Shared memory in bytes after a 1024-byte-aligned base: the x and dy
// ring [stages][nbx boxes] each, C and B [nbn boxes] each, s^T [MAX_L][SLD]
// doubles, the tiles' column and row sums [16][MAX_L] doubles, cum and dt
// [stages][MAX_L] floats each, then stages + 1 mbarriers.
__host__ __device__ constexpr int smem_bytes(int nbx, int nbn) {
  return 1024 + 4 * (2 * stages(nbx) * nbx + 2 * nbn) * BOX_WORDS +
         8 * (MAX_L * SLD + 16 * MAX_L) + 4 * 2 * stages(nbx) * MAX_L +
         8 * (stages(nbx) + 1);
}

// d += a * b over one m16n8k8 tile, f64 operands and accumulators (the
// forward's mma_f64; the k order of its FragA: lane t of a quad holds k
// index t at column k0 + 2t and k index t + 4 at column k0 + 2t + 1).
__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1,
                                        double a2, double a3, double b0,
                                        double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ double2 ldd2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// A warp's ds tiles: tile t is strip r[t] by n-tile c[t] of the cover
// (ssd::cb_tile), computed where on[t].
struct WarpTiles {
  int r[TILES], c[TILES];
  bool on[TILES];
};

// The 16 x 8 tiles of A.B^T of a warp over `depth` (<= 8 KS) columns of
// two swizzled tiles (rows 16 r .. + 15 of a, rows 8 c .. + 7 of b):
// C.B^T and ds.  Unrolled, with the warp's tiles and the even and odd
// k-steps in separate sums, so that independent products and the next
// k-step's loads overlap each product's latency.
template <int KS>
__device__ __forceinline__ void tiles_nt(const float* a, const float* b,
                                         const WarpTiles& wt, int depth,
                                         int lane, double (&d)[TILES][4]) {
  const int g8 = lane / 4, t4 = lane % 4;
  double odd[TILES][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] = odd[t][e] = 0.0;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ssd::KSTEP * ks >= depth) break;
    const int kc = ssd::KSTEP * ks + 2 * t4;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      if (!wt.on[t]) continue;
      const int i0 = ssd::STRIP * wt.r[t], j0 = ssd::KSTEP * wt.c[t];
      const float2 a_lo = ld2(a + ssd::swz(i0 + g8, kc));
      const float2 a_hi = ld2(a + ssd::swz(i0 + g8 + 8, kc));
      const float2 bb = ld2(b + ssd::swz(j0 + g8, kc));
      mma_f64(ks % 2 ? odd[t] : d[t], a_lo.x, a_hi.x, a_lo.y, a_hi.y, bb.x,
              bb.y);
    }
  }
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[t][e] += odd[t][e];
}

struct Args {
  const float* x;
  const float* dt;
  const float* cum;
  const float* Bm;
  const float* Cm;
  const float* dy;
  float* dx;
  float* ddt;
  float* dcum;
  float* dB;
  float* dC;
  int G, L, H, P, N, nbn;
};

// NBX: 32-column boxes of x and dy (P <= 32 NBX); kTMA: the load route.
template <int NBX, bool kTMA>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tdy,
                   const __grid_constant__ CUtensorMap tc,
                   const __grid_constant__ CUtensorMap tb, const Args a) {
  constexpr int ST = stages(NBX);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw +
                                       (((raw + 1023) & ~1023u) - raw));
  float* dys = xs + ST * NBX * BOX_WORDS;
  float* cs = dys + ST * NBX * BOX_WORDS;
  float* bs = cs + a.nbn * BOX_WORDS;
  double* sT = reinterpret_cast<double*>(bs + a.nbn * BOX_WORDS);
  double* colv = sT + MAX_L * SLD;     // [strip][column]: sums of v
  double* colw = colv + 4 * MAX_L;     // [strip][column]: sums of w
  double* roww = colw + 4 * MAX_L;     // [n-tile][row]: sums of w
  float* cum_s = reinterpret_cast<float*>(roww + 8 * MAX_L);
  float* dt_s = cum_s + ST * MAX_L;
  const uint32_t bars = smem_u32(dt_s + ST * MAX_L);
  auto full = [&](int s) { return bars + 8 * s; };
  const uint32_t cb_full = bars + 8 * ST;

  const int L = a.L, H = a.H, P = a.P, N = a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int g = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(g) * L;
  const int K = ssdb::ksteps(L);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) hopper::mbar_init(full(s), 1);
    hopper::mbar_init(cb_full, 1);
    hopper::mbar_init_fence();
    if constexpr (kTMA) {   // C and B load while the block clears
      hopper::mbar_expect_tx(cb_full, 2 * a.nbn * BOX * L * 4);
      for (int b = 0; b < a.nbn; ++b) {
        hopper::tma_load_2d(smem_u32(cs + b * BOX_WORDS), &tc, cb_full,
                            BOX * b, g * L);
        hopper::tma_load_2d(smem_u32(bs + b * BOX_WORDS), &tb, cb_full,
                            BOX * b, g * L);
      }
    }
  }
  // the words no copy writes: the rows past L of every box (on the
  // cp.async route every word: the columns past P and N too; the TMA
  // fills those with zeros itself, and writes no word cleared here)
  {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int boxes = 2 * ST * NBX + 2 * a.nbn;
    const int r0 = kTMA ? L : 0, per_box = (MAX_L - r0) * BOX / 4;
    for (int i = tid; i < boxes * per_box; i += THREADS)
      reinterpret_cast<float4*>(xs + (i / per_box) * BOX_WORDS +
                                r0 * BOX)[i % per_box] = zero;
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if constexpr (!kTMA) {
    for (int idx = tid; idx < L * N; idx += THREADS) {
      const int i = idx / N, n = idx % N;
      cs[ssd::swz(i, n)] = a.Cm[row0 * N + idx];
      bs[ssd::swz(i, n)] = a.Bm[row0 * N + idx];
    }
  }
  // head n's x, dy, cum and dt into ring slot n % ST; one cp.async group
  // a thread per call, empty past the last head
  auto fill_slot = [&](int n) {
    if (n < H) {
      const int s = n % ST;
      if (tid < L)
        hopper::cp_async4(smem_u32(cum_s + s * MAX_L + tid),
                          a.cum + (row0 + tid) * H + n);
      else if (tid >= MAX_L && tid - MAX_L < L)
        hopper::cp_async4(smem_u32(dt_s + s * MAX_L + tid - MAX_L),
                          a.dt + (row0 + tid - MAX_L) * H + n);
      float* xst = xs + s * NBX * BOX_WORDS;
      float* dyst = dys + s * NBX * BOX_WORDS;
      if constexpr (kTMA) {
        if (tid == 0) {
          hopper::mbar_expect_tx(full(s), 2 * NBX * BOX * L * 4);
          for (int b = 0; b < NBX; ++b) {
            hopper::tma_load_3d(smem_u32(xst + b * BOX_WORDS), &tx, full(s),
                                BOX * b, n, g * L);
            hopper::tma_load_3d(smem_u32(dyst + b * BOX_WORDS), &tdy,
                                full(s), BOX * b, n, g * L);
          }
        }
      } else {
        for (int idx = tid; idx < L * P; idx += THREADS) {
          const int j = idx / P, p = idx % P;
          const int64_t at = ((row0 + j) * H + n) * P + p;
          hopper::cp_async4(smem_u32(xst + ssd::swz(j, p)), a.x + at);
          hopper::cp_async4(smem_u32(dyst + ssd::swz(j, p)), a.dy + at);
        }
      }
    }
    hopper::cp_async_commit();
  };
  for (int n = 0; n < ST; ++n) fill_slot(n);
  if constexpr (kTMA)
    hopper::mbar_wait(cb_full, 0);
  else
    __syncthreads();

  // this warp's tiles: q = warp + WARPS t of the cover
  WarpTiles wt;
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int q = warp + WARPS * t;
    wt.r[t] = wt.c[t] = 0;
    if (q < ssd::CB_TILES) ssd::cb_tile(q, wt.r[t], wt.c[t]);
    wt.on[t] = q < ssd::CB_TILES && ssdb::tile_in(wt.r[t], wt.c[t], L);
  }
  // C.B^T on this warp's tiles, kept for every head; d(C.B^T) summed
  // over the heads in head order beside it
  double cb[TILES][4], dcb[TILES][4];
  tiles_nt<MAX_N / ssd::KSTEP>(cs, bs, wt, N, lane, cb);
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dcb[t][e] = 0.0;

  // the n-tiles of 8 columns of dx, dC and dB this warp computes:
  // ntile, ntile + WARPS / 2, ... (NTW of them for dx)
  constexpr int NTW = (4 * NBX + WARPS / 2 - 1) / (WARPS / 2);
  const int ntile = warp >> 1;
  for (int n = 0; n < H; ++n) {
    const int s = n % ST;
    hopper::cp_async_wait<ST - 1>();
    __syncthreads();     // this head's cum, dt (and cp.async x, dy) arrived
    if constexpr (kTMA) hopper::mbar_wait(full(s), (n / ST) & 1);
    const float* xst = xs + s * NBX * BOX_WORDS;
    const float* dyst = dys + s * NBX * BOX_WORDS;
    const float* cums = cum_s + s * MAX_L;
    const float* dts = dt_s + s * MAX_L;

    // ---- ds = dy.x^T and the pair terms on this warp's tiles -----------
    double ds[TILES][4];
    tiles_nt<4 * NBX>(dyst, xst, wt, P, lane, ds);
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      if (!wt.on[t]) continue;
      const int r = wt.r[t], c = wt.c[t];
      const int i0 = ssd::STRIP * r, j0 = ssd::KSTEP * c;
      double vc[2] = {0.0, 0.0}, wc[2] = {0.0, 0.0}, wr[2] = {0.0, 0.0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g8 + 8 * (e / 2), j = j0 + 2 * t4 + e % 2;
        double sv, v, w, dc;
        ssdb::pair_grads<double>(cb[t][e], cums[i], cums[j], dts[j],
                                 ds[t][e], i < L ? i : -1, j, sv, v, w, dc);
        sT[j * SLD + i] = sv;
        dcb[t][e] += dc;
        vc[e % 2] += v;
        wc[e % 2] += w;
        wr[e / 2] += w;
      }
      // the tile's column sums (over the lanes of one t4) and row sums
      // (over a quad), in a fixed order
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          vc[e] += __shfl_xor_sync(0xffffffffu, vc[e], off);
          wc[e] += __shfl_xor_sync(0xffffffffu, wc[e], off);
        }
        wr[e] += __shfl_xor_sync(0xffffffffu, wr[e], 1);
        wr[e] += __shfl_xor_sync(0xffffffffu, wr[e], 2);
      }
      if (g8 == 0) {
        for (int e = 0; e < 2; ++e) {
          colv[r * MAX_L + j0 + 2 * t4 + e] = vc[e];
          colw[r * MAX_L + j0 + 2 * t4 + e] = wc[e];
        }
      }
      if (t4 == 0) {
        for (int e = 0; e < 2; ++e) roww[c * MAX_L + i0 + g8 + 8 * e] = wr[e];
      }
    }
    __syncthreads();     // s^T and the tiles' sums complete

    // ---- dx_j = sum_{i >= j} s_ij dy_i: strips warp_strip(w, 0/1), the
    // n-tiles of 8 columns w / 2, w / 2 + WARPS / 2, ...; both strips share
    // the dy fragments (a warp whose columns start past P has none)
    if (ssd::KSTEP * ntile < P) {
      double acc[2][NTW][4];
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int t = 0; t < NTW; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][t][e] = 0.0;
      int strip[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) strip[w] = ssd::warp_strip(warp, w);
#pragma unroll
      for (int ks = 0; ks < MAX_L / ssd::KSTEP; ++ks) {
        if (ks >= K) break;
        if (ks < ssdb::kstep_lo(strip[0])) continue;
        const int kr = ssd::KSTEP * ks + 2 * t4;
        float b0[NTW], b1[NTW];
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          const int col = ssd::KSTEP * (ntile + WARPS / 2 * t) + g8;
          b0[t] = dyst[ssd::swz(kr, col)];
          b1[t] = dyst[ssd::swz(kr + 1, col)];
        }
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (ks < ssdb::kstep_lo(strip[w]) || ssd::STRIP * strip[w] >= L)
            continue;
          const double* row = sT + (ssd::STRIP * strip[w] + g8) * SLD + kr;
          const double2 lo = ldd2(row), hi = ldd2(row + 8 * SLD);
#pragma unroll
          for (int t = 0; t < NTW; ++t)
            mma_f64(acc[w][t], lo.x, hi.x, lo.y, hi.y, b0[t], b1[t]);
        }
      }
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = ssd::STRIP * strip[w] + g8 + 8 * half;
          if (j >= L) continue;
          float* out = a.dx + ((row0 + j) * H + n) * P;
#pragma unroll
          for (int t = 0; t < NTW; ++t) {
            const int col = ssd::KSTEP * (ntile + WARPS / 2 * t) + 2 * t4;
            const float v0 = static_cast<float>(acc[w][t][2 * half]);
            const float v1 = static_cast<float>(acc[w][t][2 * half + 1]);
            if constexpr (kTMA) {   // P % 4 == 0, dx on a 16-byte boundary
              if (col < P)
                *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
            } else {
              if (col < P) out[col] = v0;
              if (col + 1 < P) out[col + 1] = v1;
            }
          }
        }
    }

    // ---- ddt_k = sum_i v_ik; dcum_k = sum_j w_kj - sum_i w_ik: the
    // tiles' sums in order, by warps 4 and 5 (warps 0-3 have two ds tiles)
    if (tid >= 128 && tid - 128 < L) {
      const int k = tid - 128;
      double v = 0.0, col = 0.0, row = 0.0;
      for (int r = ssdb::first_strip(k); r < 4 && ssd::STRIP * r < L; ++r) {
        v += colv[r * MAX_L + k];
        col += colw[r * MAX_L + k];
      }
      for (int c = 0; c < ssdb::row_tiles(k) && ssd::KSTEP * c < L; ++c)
        row += roww[c * MAX_L + k];
      a.ddt[(row0 + k) * H + n] = static_cast<float>(v);
      a.dcum[(row0 + k) * H + n] = static_cast<float>(row - col);
    }
    __syncthreads();     // ring slot s, cum and dt, s^T and the sums free
    fill_slot(n + ST);
  }

  // ---- dC = dCB.B over j <= i, dB = dCB^T.C over i >= j ------------------
  double* dcbs = sT;     // dCB [i][j], in s^T's place
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    if (!wt.on[t]) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dcbs[(ssd::STRIP * wt.r[t] + g8 + 8 * (e / 2)) * SLD +
           ssd::KSTEP * wt.c[t] + 2 * t4 + e % 2] = dcb[t][e];
  }
  __syncthreads();
  for (int nt = ntile; ssd::KSTEP * nt < N; nt += WARPS / 2) {
    const int n0 = ssd::KSTEP * nt;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int r = ssd::warp_strip(warp, w);
      const int i0 = ssd::STRIP * r;
      if (i0 >= L) continue;
      double dc[4] = {0.0, 0.0, 0.0, 0.0}, db[4] = {0.0, 0.0, 0.0, 0.0};
      for (int ks = 0; ks < ssd::strip_ksteps(r, L); ++ks) {
        const int kr = ssd::KSTEP * ks + 2 * t4;
        const double* row = dcbs + (i0 + g8) * SLD + kr;
        const double2 lo = ldd2(row), hi = ldd2(row + 8 * SLD);
        mma_f64(dc, lo.x, hi.x, lo.y, hi.y, bs[ssd::swz(kr, n0 + g8)],
                bs[ssd::swz(kr + 1, n0 + g8)]);
      }
      for (int ks = ssdb::kstep_lo(r); ks < K; ++ks) {
        const int kr = ssd::KSTEP * ks + 2 * t4;
        const double* col = dcbs + kr * SLD + i0 + g8;
        mma_f64(db, col[0], col[8], col[SLD], col[SLD + 8],
                cs[ssd::swz(kr, n0 + g8)], cs[ssd::swz(kr + 1, n0 + g8)]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g8 + 8 * (e / 2), n = n0 + 2 * t4 + e % 2;
        if (i < L && n < N) {
          a.dC[(row0 + i) * N + n] = static_cast<float>(dc[e]);
          a.dB[(row0 + i) * N + n] = static_cast<float>(db[e]);
        }
      }
    }
  }
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
  const int smem = smem_bytes(NBX, a.nbn);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<NBX, kTMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tx{}, tdy{}, tc{}, tb{};
  if (kTMA) {
    const cuuint64_t rows = static_cast<cuuint64_t>(a.G) * a.L;
    const cuuint64_t xd[3] = {static_cast<cuuint64_t>(a.P),
                              static_cast<cuuint64_t>(a.H), rows};
    const cuuint32_t xb[3] = {BOX, 1, static_cast<cuuint32_t>(a.L)};
    const cuuint64_t nd[2] = {static_cast<cuuint64_t>(a.N), rows};
    const cuuint32_t nb[2] = {BOX, static_cast<cuuint32_t>(a.L)};
    if (make_map(&tx, a.x, 3, xd, xb) != CUDA_SUCCESS ||
        make_map(&tdy, a.dy, 3, xd, xb) != CUDA_SUCCESS ||
        make_map(&tc, a.Cm, 2, nd, nb) != CUDA_SUCCESS ||
        make_map(&tb, a.Bm, 2, nd, nb) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_bwd_kernel<NBX, kTMA><<<a.G, THREADS, smem, stream>>>(tx, tdy, tc, tb,
                                                             a);
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

}  // namespace

// dx, ddt, dcum, dB, dC from x, dt, cum, B, C and dy (shapes above).  One
// launch on `stream`; returns its cudaError_t (0 on success).  Refuses
// what the forward refuses.
extern "C" int ssd_intra_chunk_bwd(const float* x, const float* dt,
                                   const float* cum, const float* Bm,
                                   const float* Cm, const float* dy,
                                   float* dx, float* ddt, float* dcum,
                                   float* dB, float* dC, int G, int L, int H,
                                   int P, int N, void* stream) {
  if (L < 1 || L > MAX_L || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      H < 1 || G < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const Args a{x, dt, cum, Bm, Cm, dy, dx, ddt, dcum, dB, dC,
               G, L, H, P, N, (N + BOX - 1) / BOX};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = P % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(Bm) && aligned16(Cm) &&
                   aligned16(dx);
  return tma ? dispatch<true>(a, st) : dispatch<false>(a, st);
}

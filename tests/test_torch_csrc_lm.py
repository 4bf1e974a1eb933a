"""The per-tile arithmetic of the language-model kernels, compiled for
the host with g++ and held against the port's plain PyTorch versions.

``flash_tile.cuh`` (band mask, k-tile skip and no-mask tests,
online-softmax steps, the split of a probability into two bfloat16
terms) and ``ssd_tile.cuh`` (decay and score of one (i, j) pair; the SSD
kernel's triangle walk, score pairs, C.B^T tiles, persistent item ranges,
ring slots and swizzled layout) are the __host__ __device__
functions the CUDA kernels call.  The shim below
runs the kernels' algorithms serially with them -- the flash kernel's
q-tile / k-tile walk with its skipped tiles and ragged edges, the SSD
kernel's C.B^T-then-scores product, and the Hopper SSD kernel's walk
(C.B^T over its tiles, the scores of its score pairs, the products over
each strip's k-steps, in f64 sums as its tensor cores take them) -- so a wrong mask, a skipped live tile or a mis-scaled online
update shows here, before any GPU runs it.
The bf16 walk is the Hopper kernel's arithmetic: bf16 q, k, v, scores
in f32, the no-mask shortcut on full tiles, the softmax in log2 units
(exp2f of one FMA), P split into two bf16 terms for the P.V product.  Tolerances are the JAX tests': 2e-5 for attention,
1e-5 for SSD; the bf16 walk's output is held to two bf16 steps of each
element, as chip_smoke.py holds the kernel.
"""
import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.mamba2_scan.ref import intra_chunk_ref  # noqa: E402

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels"
_spec = importlib.util.spec_from_file_location(
    "stress_lm_kernels",
    Path(__file__).resolve().parents[1] / "scripts" / "stress_lm_kernels.py")
stress = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stress)

SHIM = r"""
#include <stdint.h>
#include <algorithm>
#include <vector>
#include "flash_tile.cuh"
#include "ssd_tile.cuh"
extern "C" {
// one head: q (S, hd), k/v (T, hd), o (S, hd); q-tiles of bq, k-tiles of bk
void h_flash(const float* q, const float* k, const float* v, float* o,
             int S, int T, int hd, int causal, int window, int bq, int bk) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  std::vector<float> s(bk), p(bk), acc(hd);
  std::vector<char> live(bk);
  for (int q_lo = 0; q_lo < S; q_lo += bq) {
    const int q_hi = std::min(q_lo + bq, S) - 1;
    for (int qi = q_lo; qi <= q_hi; ++qi) {
      float m = fa::NEG_INF, l = 0.0f;
      std::fill(acc.begin(), acc.end(), 0.0f);
      for (int k_lo = 0; k_lo < T; k_lo += bk) {
        const int k_hi = std::min(k_lo + bk, T) - 1;
        if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window)) continue;
        float mx = fa::NEG_INF;
        for (int j = 0; j < bk; ++j) {
          const int kj = k_lo + j;
          live[j] = fa::in_band(qi, kj, T, causal, window);
          float dot = 0.0f;
          if (kj < T)
            for (int d = 0; d < hd; ++d) dot += q[qi * hd + d] * k[kj * hd + d];
          s[j] = live[j] ? dot * scale : fa::NEG_INF;
          mx = std::max(mx, s[j]);
        }
        const float alpha = fa::online_rescale(m, mx);
        float sum = 0.0f;
        for (int j = 0; j < bk; ++j) {
          p[j] = fa::online_prob(s[j], m, live[j]);
          sum += p[j];
        }
        l = l * alpha + sum;
        for (int d = 0; d < hd; ++d) {
          float a = acc[d] * alpha;
          for (int j = 0; j < bk && k_lo + j < T; ++j)
            a += p[j] * v[(k_lo + j) * hd + d];
          acc[d] = a;
        }
      }
      for (int d = 0; d < hd; ++d) o[qi * hd + d] = fa::finalize(acc[d], l);
    }
  }
}
// The Hopper kernel's walk for one head: q, k, v hold bf16 values (as
// f32), q-tiles of bq, k-tiles of bk, masks skipped on full tiles, P.V
// over the two bf16 terms of each probability; o in f32.
void h_flash_split(const float* q, const float* k, const float* v, float* o,
                   int S, int T, int hd, int causal, int window, int bq,
                   int bk) {
  const float c = fa::LOG2E / sqrtf(static_cast<float>(hd));
  std::vector<float> s(bk), p_hi(bk), p_lo(bk), acc(hd);
  std::vector<char> live(bk);
  for (int q_lo = 0; q_lo < S; q_lo += bq) {
    const int q_hi = std::min(q_lo + bq, S) - 1;
    for (int qi = q_lo; qi <= q_hi; ++qi) {
      float m = fa::NEG_INF, l = 0.0f;
      std::fill(acc.begin(), acc.end(), 0.0f);
      for (int k_lo = 0; k_lo < T; k_lo += bk) {
        const int k_hi = std::min(k_lo + bk, T) - 1;
        if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window)) continue;
        const bool full =
            fa::tile_full(q_lo, q_hi, k_lo, k_lo + bk - 1, T, causal, window);
        float mx = fa::NEG_INF;
        for (int j = 0; j < bk; ++j) {
          const int kj = k_lo + j;
          live[j] = full || fa::in_band(qi, kj, T, causal, window);
          float dot = 0.0f;
          if (kj < T)
            for (int d = 0; d < hd; ++d) dot += q[qi * hd + d] * k[kj * hd + d];
          s[j] = dot;                   // raw: the scale is in c
          if (live[j]) mx = std::max(mx, s[j]);
        }
        const float alpha = fa::rescale_log2(m, mx, c);
        float sum = 0.0f;
        for (int j = 0; j < bk; j += 2) {
          const float p0 = fa::prob_log2(s[j], c, m, live[j]);
          const float p1 = fa::prob_log2(s[j + 1], c, m, live[j + 1]);
          sum += p0 + p1;
          uint32_t hi, lo;
          fa::split_bf16x2(p0, p1, hi, lo);
          p_hi[j] = fa::bf16_value(hi & 0xffff);
          p_hi[j + 1] = fa::bf16_value(hi >> 16);
          p_lo[j] = fa::bf16_value(lo & 0xffff);
          p_lo[j + 1] = fa::bf16_value(lo >> 16);
        }
        l = l * alpha + sum;
        for (int d = 0; d < hd; ++d) {
          float a = acc[d] * alpha;
          for (int j = 0; j < bk && k_lo + j < T; ++j)
            a += p_hi[j] * v[(k_lo + j) * hd + d] +
                 p_lo[j] * v[(k_lo + j) * hd + d];
          acc[d] = a;
        }
      }
      for (int d = 0; d < hd; ++d) o[qi * hd + d] = fa::finalize(acc[d], l);
    }
  }
}
void h_bf16_split(const float* x, uint16_t* bits, uint16_t* hi,
                  uint16_t* lo, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    bits[i] = fa::bf16_bits(x[i]);
    fa::split_bf16(x[i], hi[i], lo[i]);
  }
}
// rows of t: q_lo, q_hi, k_lo, k_hi
void h_tile_full(const int32_t* t, int T, int causal, int window,
                 int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = fa::tile_full(t[4 * i], t[4 * i + 1], t[4 * i + 2],
                           t[4 * i + 3], T, causal, window);
}
// rows of t: q_lo, q_hi, k_lo, k_hi
void h_tile_live(const int32_t* t, int causal, int window, int32_t* out,
                 int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = fa::tile_live(t[4 * i], t[4 * i + 1], t[4 * i + 2],
                           t[4 * i + 3], causal, window);
}
// one chunk, one head: x (L, P), dt/cum (L), B/C (L, N) -> y (L, P)
void h_ssd(const float* x, const float* dt, const float* cum,
           const float* B, const float* C, float* y, int L, int P, int N) {
  for (int i = 0; i < L; ++i)
    for (int p = 0; p < P; ++p) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) {
        float cb = 0.0f;
        for (int n = 0; n < N; ++n) cb += C[i * N + n] * B[j * N + n];
        acc += ssd::score(cb, cum[i], cum[j], dt[j], i, j) * x[j * P + p];
      }
      y[i * P + p] = acc;
    }
}
void h_decay(const float* cum, float* out, int L) {
  for (int i = 0; i < L; ++i)
    for (int j = 0; j < L; ++j) out[i * L + j] = ssd::decay(cum[i], cum[j], i, j);
}
// rows: i, j of score pair idx
void h_score_pairs(int32_t* ij) {
  for (int idx = 0; idx < ssd::SCORE_PAIRS; ++idx)
    ssd::score_pair(idx, ij[2 * idx], ij[2 * idx + 1]);
}
// rows: strip and k-steps of warp w (of 8), strip `which`
void h_warp_walk(int L, int32_t* out) {
  for (int w = 0; w < 8; ++w)
    for (int which = 0; which < 2; ++which) {
      const int strip = ssd::warp_strip(w, which);
      out[4 * w + 2 * which] = strip;
      out[4 * w + 2 * which + 1] = ssd::strip_ksteps(strip, L);
    }
}
void h_diag_block(int32_t* out) {
  for (int i = 0; i < ssd::MAX_L; ++i)
    for (int j = 0; j < ssd::MAX_L; ++j)
      out[i * ssd::MAX_L + j] = ssd::diag_block(i, j);
}
void h_cb_tiles(int32_t* rc) {
  for (int q = 0; q < ssd::CB_TILES; ++q) ssd::cb_tile(q, rc[2 * q], rc[2 * q + 1]);
}
void h_block_items(int64_t total, int nb, int64_t* lohi) {
  for (int b = 0; b < nb; ++b) ssd::block_items(total, b, nb, lohi[2 * b], lohi[2 * b + 1]);
}
void h_ring(int n, int stages, int32_t* out) {
  for (int k = 0; k < n; ++k) {
    out[2 * k] = ssd::ring_stage(k, stages);
    out[2 * k + 1] = static_cast<int32_t>(ssd::ring_phase(k, stages));
  }
}
void h_swz(int32_t* out) {   // rows < 64 by columns < 128
  for (int r = 0; r < ssd::MAX_L; ++r)
    for (int c = 0; c < 128; ++c) out[r * 128 + c] = ssd::swz(r, c);
}
// the Hopper SSD kernel's walk for one chunk and one head: C.B^T over
// its tiles, the scores of its pairs (mask on the diagonal blocks only),
// the product over each strip's k-steps; sums in f64 rounded once, as
// the tensor cores' f64 products do
void h_ssd_walk(const float* x, const float* dt, const float* cum,
                const float* B, const float* C, float* y, int L, int P,
                int N) {
  const int M = ssd::MAX_L;
  std::vector<float> cb(M * M, 0.0f), sc(M * M, 0.0f);
  for (int q = 0; q < ssd::CB_TILES; ++q) {
    int r, c;
    ssd::cb_tile(q, r, c);
    const int i0 = ssd::STRIP * r, j0 = ssd::KSTEP * c;
    if (i0 >= L || j0 >= L) continue;
    for (int i = i0; i < i0 + ssd::STRIP; ++i)
      for (int j = j0; j < j0 + ssd::KSTEP; ++j) {
        double d = 0.0;
        for (int n = 0; n < N; ++n) {
          const float cv = i < L ? C[i * N + n] : 0.0f;
          const float bv = j < L ? B[j * N + n] : 0.0f;
          d += static_cast<double>(cv) * bv;
        }
        cb[j * M + i] = static_cast<float>(d);
      }
  }
  for (int idx = 0; idx < ssd::SCORE_PAIRS; ++idx) {
    int i, j;
    ssd::score_pair(idx, i, j);
    if (i < L && j < L)
      sc[j * M + i] = ssd::diag_block(i, j)
                          ? ssd::score(cb[j * M + i], cum[i], cum[j], dt[j], i, j)
                          : ssd::score_below(cb[j * M + i], cum[i], cum[j], dt[j]);
  }
  for (int r = 0; r < 4; ++r) {
    const int nks = ssd::strip_ksteps(r, L);
    for (int i = ssd::STRIP * r; i < ssd::STRIP * (r + 1) && i < L; ++i)
      for (int p = 0; p < P; ++p) {
        double d = 0.0;
        for (int j = 0; j < ssd::KSTEP * nks; ++j) {
          const float xv = j < L ? x[j * P + p] : 0.0f;
          d += static_cast<double>(sc[j * M + i]) * xv;
        }
        y[i * P + p] = static_cast<float>(d);
      }
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    d = tmp_path_factory.mktemp("csrc_lm")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror",
                    "-I", str(KERNELS / "flash_attention" / "csrc"),
                    "-I", str(KERNELS / "mamba2_scan" / "csrc"),
                    str(d / "shim.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("S,T,hd,causal,window,bq,bk", [
    (128, 128, 16, True, None, 64, 64),
    (100, 100, 80, True, None, 64, 64),     # ragged q and k tiles
    (100, 100, 16, False, None, 64, 64),
    (200, 200, 16, True, 48, 64, 64),       # skipped tiles on both sides
    (90, 130, 24, False, 32, 32, 64),
    (70, 70, 128, True, 7, 16, 16),
])
def test_flash_tile_walk_matches_plain(lib, S, T, hd, causal, window, bq,
                                       bk):
    rng = np.random.default_rng(S * T + hd)
    q, k, v = (rng.standard_normal((n, hd)).astype(np.float32)
               for n in (S, T, T))
    out = np.empty_like(q)
    lib.h_flash(_p(q), _p(k), _p(v), _p(out), S, T, hd, int(causal),
                window or 0, bq, bk)
    want = attention_ref(*(torch.from_numpy(a)[None, None]
                           for a in (q, k, v)),
                         causal=causal, window=window)[0, 0]
    np.testing.assert_allclose(out, want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 16),
                                           (True, 5), (True, 64)])
def test_tile_live_is_exact(lib, causal, window):
    """A tile is skipped exactly when no pair in it is in band."""
    rng = np.random.default_rng(window)
    n = 3000
    q_lo = rng.integers(0, 300, n)
    k_lo = rng.integers(0, 300, n)
    tiles = np.stack([q_lo, q_lo + rng.integers(0, 40, n), k_lo,
                      k_lo + rng.integers(0, 40, n)], 1).astype(np.int32)
    out = np.empty(n, np.int32)
    lib.h_tile_live(_p(tiles), int(causal), window, _p(out), n)
    for (a, b, c, d), got in zip(tiles, out):
        qi = np.arange(a, b + 1)[:, None]
        kj = np.arange(c, d + 1)[None, :]
        band = np.ones((qi.size, kj.size), bool)
        if causal:
            band &= kj <= qi
        if window:
            band &= qi - kj < window
        assert bool(got) == bool(band.any()), (a, b, c, d)


@pytest.mark.parametrize("L,P,N", [(64, 16, 8), (40, 8, 16), (17, 5, 3)])
def test_ssd_score_matches_plain(lib, L, P, N):
    rng = np.random.default_rng(L + P + N)
    x = rng.standard_normal((L, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(L))).astype(np.float32)
    cum = np.cumsum(-np.log1p(np.exp(rng.standard_normal(L)))).astype(
        np.float32)
    B, C = (rng.standard_normal((L, N)).astype(np.float32) for _ in "BC")
    y = np.empty_like(x)
    lib.h_ssd(_p(x), _p(dt), _p(cum), _p(B), _p(C), _p(y), L, P, N)
    want = intra_chunk_ref(torch.from_numpy(x)[None, :, None],
                           torch.from_numpy(dt)[None, :, None],
                           torch.from_numpy(cum)[None, :, None],
                           torch.from_numpy(B)[None],
                           torch.from_numpy(C)[None])[0, :, 0]
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-5)
    dec = np.empty((L, L), np.float32)
    lib.h_decay(_p(cum), _p(dec), L)
    c = torch.from_numpy(cum)
    np.testing.assert_allclose(
        dec, torch.tril(torch.exp(c[:, None] - c[None, :])).numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("causal,window,T", [(True, 0, 400), (False, 16, 250),
                                             (True, 5, 300), (False, 0, 90)])
def test_tile_full_is_exact(lib, causal, window, T):
    """The mask is skipped exactly when every pair of the tile is in
    band, the key past the sequence's end included."""
    rng = np.random.default_rng(window + T)
    n = 3000
    q_lo = rng.integers(0, 300, n)
    k_lo = rng.integers(0, 300, n)
    tiles = np.stack([q_lo, q_lo + rng.integers(0, 40, n), k_lo,
                      k_lo + rng.integers(0, 40, n)], 1).astype(np.int32)
    out = np.empty(n, np.int32)
    lib.h_tile_full(_p(tiles), T, int(causal), window, _p(out), n)
    for (a, b, c, d), got in zip(tiles, out):
        qi = np.arange(a, b + 1)[:, None]
        kj = np.arange(c, d + 1)[None, :]
        band = np.broadcast_to(kj < T, (qi.size, kj.size)).copy()
        if causal:
            band &= kj <= qi
        if window:
            band &= qi - kj < window
        assert bool(got) == bool(band.all()), (a, b, c, d)


def test_bf16_rounding_and_split_match_torch(lib):
    """bf16_bits rounds as torch's float32 -> bfloat16 cast (to nearest,
    ties to even, subnormals included); hi + lo carries 16 significant
    bits: |p - hi - lo| <= 2^-17 |p|."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.random(20000), np.exp(-rng.uniform(0, 100, 20000)),
        rng.standard_normal(20000) * 1e3,
        np.array([0.0, 1.0, 0.5, 1e-40, 3e-39, 1.00390625, 1.01171875,
                  np.nextafter(1.0, 2.0)])]).astype(np.float32)
    # ties: bit patterns with the low half exactly 0x8000
    ties = (rng.integers(0x3F00, 0x4100, 2000).astype(np.uint32) << 16
            | 0x8000).view(np.float32)
    x = np.ascontiguousarray(np.concatenate([x, ties]))
    n = x.size
    bits, hi, lo = (np.empty(n, np.uint16) for _ in range(3))
    lib.h_bf16_split(_p(x), _p(bits), _p(hi), _p(lo), ctypes.c_int64(n))
    t = torch.from_numpy(x)
    want = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, want)
    np.testing.assert_array_equal(hi, want)
    hi_f = torch.from_numpy(hi.view(np.int16)).view(torch.bfloat16).float()
    lo_f = torch.from_numpy(lo.view(np.int16)).view(torch.bfloat16).float()
    np.testing.assert_array_equal(
        lo_f.numpy(), (t - hi_f).to(torch.bfloat16).float().numpy())
    p = t.double()
    resid = (p - hi_f.double() - lo_f.double()).abs()
    normal = p.abs() > 1e-30     # the split's bound is relative
    assert bool((resid[normal] <= 2.0 ** -17 * p.abs()[normal]).all())


@pytest.mark.parametrize("S,T,hd,causal,window,bq,bk", [
    (200, 200, 80, True, None, 128, 64),    # ragged, diagonal tiles
    (130, 130, 24, False, None, 128, 64),   # hd not a multiple of 16
    (300, 300, 64, True, 70, 128, 64),      # window band, skipped tiles
    (100, 260, 128, False, None, 128, 64),
])
def test_flash_bf16_split_walk_matches_plain(lib, S, T, hd, causal, window,
                                             bq, bk):
    """The Hopper kernel's bf16 arithmetic on the host, against the
    plain version on the same bf16 inputs: 2e-2, and within two bf16
    steps of each element once rounded to bf16 as the kernel's output
    is."""
    rng = np.random.default_rng(S + T + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, hd)).astype(
        np.float32)).to(torch.bfloat16) for n in (S, T, T))
    qf, kf, vf = (np.ascontiguousarray(t.float().numpy()) for t in (q, k, v))
    out = np.empty_like(qf)
    lib.h_flash_split(_p(qf), _p(kf), _p(vf), _p(out), S, T, hd,
                      int(causal), window or 0, bq, bk)
    want = attention_ref(*(t[None, None] for t in (q, k, v)), causal=causal,
                         window=window)[0, 0].float()
    got = torch.from_numpy(out).to(torch.bfloat16).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, want, rtol=2.0 ** -6, atol=1e-5)


# ---- the Hopper SSD kernel's schedule and arithmetic ------------------

def _i32(n):
    return np.zeros(n, np.int32)


def test_ssd_score_pairs_cover_every_strip_once(lib):
    """Pair idx < 2560 runs over each strip's rows by the columns
    j < 16 (strip + 1), each exactly once: the scores the products read."""
    ij = _i32(2 * 2560)
    lib.h_score_pairs(_p(ij))
    got = sorted(map(tuple, ij.reshape(-1, 2).tolist()))
    want = sorted((i, j) for i in range(64) for j in range(16 * (i // 16 + 1)))
    assert got == want


@pytest.mark.parametrize("L", [1, 8, 17, 40, 63, 64])
def test_ssd_warp_walk_covers_the_triangle(lib, L):
    """Each of the 8 warps takes strips w % 2 and 3 - w % 2; a strip's
    k-steps reach every j <= i of its rows below L; at L = 64 every warp
    walks 10 k-steps; the pairs above the diagonal are all in diagonal
    blocks."""
    walk = _i32(32)
    lib.h_warp_walk(L, _p(walk))
    walk = walk.reshape(8, 2, 2)
    for w in range(8):
        assert sorted(walk[w, :, 0]) == sorted([w % 2, 3 - w % 2])
        for strip, nks in walk[w]:
            rows = [i for i in range(16 * strip, 16 * strip + 16) if i < L]
            need = max(rows, default=-1) + 1      # columns j <= i of them
            assert 8 * nks >= need and 8 * (nks - 1) < max(need, 1)
    if L == 64:
        assert (walk[:, :, 1].sum(1) == 10).all()
    diag = _i32(64 * 64)
    lib.h_diag_block(_p(diag))
    diag = diag.reshape(64, 64).astype(bool)
    i, j = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    assert (diag == (j >= 16 * (i // 16))).all()
    assert diag[j > i].all()


def test_ssd_cb_tiles_are_the_lower_triangle(lib):
    """The 20 C.B^T tiles (16 rows by 8 columns, c <= 2r + 1) are
    distinct and cover every pair the scores read."""
    rc = _i32(40)
    lib.h_cb_tiles(_p(rc))
    tiles = list(map(tuple, rc.reshape(-1, 2).tolist()))
    assert len(set(tiles)) == 20
    assert all(0 <= r < 4 and 0 <= c <= 2 * r + 1 for r, c in tiles)
    covered = {(i, j) for r, c in tiles for i in range(16 * r, 16 * r + 16)
               for j in range(8 * c, 8 * c + 8)}
    assert covered == {(i, j) for i in range(64)
                       for j in range(16 * (i // 16 + 1))}


@pytest.mark.parametrize("total,nb", [(2560, 264), (400, 264), (48, 48),
                                      (7, 3), (91, 264)])
def test_ssd_block_items_partition_the_items(lib, total, nb):
    lohi = np.zeros(2 * nb, np.int64)
    lib.h_block_items(ctypes.c_int64(total), nb, _p(lohi))
    lo, hi = lohi[0::2], lohi[1::2]
    assert lo[0] == 0 and hi[-1] == total and (lo[1:] == hi[:-1]).all()
    sizes = hi - lo
    assert sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("stages", [2, 3])
def test_ssd_ring_slots_and_phases(lib, stages):
    """Item n fills slot n % stages; its wait parity is the number of
    earlier fills of that slot, mod 2 (an mbarrier's phase)."""
    n = 40
    out = _i32(2 * n)
    lib.h_ring(n, stages, _p(out))
    fills = {}
    for k, (stage, phase) in enumerate(out.reshape(-1, 2).tolist()):
        assert stage == k % stages
        assert phase == fills.get(stage, 0) % 2
        fills[stage] = fills.get(stage, 0) + 1


def test_ssd_swizzle_is_the_tma_128_byte_layout(lib):
    """swz(r, c) is the word TMA's 128-byte swizzle puts element (r, c)
    of a stack of 32-column boxes of 64 rows at: byte address bits
    [4:6] XOR bits [7:9], within each 8 KB box; a bijection."""
    got = _i32(64 * 128)
    lib.h_swz(_p(got))
    r, c = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    byte = (c // 32) * 8192 + r * 128 + (c % 32) * 4
    byte = byte ^ (((byte >> 7) & 7) << 4)
    np.testing.assert_array_equal(got.reshape(64, 128), byte // 4)
    assert len(np.unique(got)) == got.size


def _ssd_case(seed, L, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(L))).astype(np.float32)
    cum = np.cumsum(-np.log1p(np.exp(rng.standard_normal(L)))).astype(
        np.float32)
    B, C = (rng.standard_normal((L, N)).astype(np.float32) for _ in "BC")
    return x, dt, cum, B, C


def _as_chunk(x, dt, cum, B, C):
    """One chunk, one head, in the wrapper's (G, L, H, P) layout."""
    x, dt, cum, B, C = map(torch.from_numpy, (x, dt, cum, B, C))
    return (x[None, :, None], dt[None, :, None], cum[None, :, None], B[None],
            C[None])


@pytest.mark.parametrize("L,P,N", [(64, 64, 64), (64, 16, 8), (40, 8, 16),
                                   (17, 5, 3), (1, 4, 4), (51, 12, 70),
                                   (64, 128, 128), (33, 7, 5)])
def test_ssd_kernel_walk_matches_plain(lib, L, P, N):
    """The kernel's walk with f64 sums (its tensor-core products, on
    both routes) against the plain version at the card tests' 2e-5, and inside the float32
    rounding bound of scripts/stress_lm_kernels.py."""
    x, dt, cum, B, C = _ssd_case(L * P + N, L, P, N)
    y = np.empty_like(x)
    lib.h_ssd_walk(_p(x), _p(dt), _p(cum), _p(B), _p(C), _p(y), L, P, N)
    args = _as_chunk(x, dt, cum, B, C)
    want = intra_chunk_ref(*args)[0, :, 0]
    np.testing.assert_allclose(y, want.numpy(), rtol=2e-5, atol=2e-5)
    exact, err = stress.ssd_error_bound(*args)
    assert not stress.over_bound(torch.from_numpy(y)[None, :, None], exact,
                                 err, torch.float32).any()


@pytest.mark.parametrize("L,P,N", [(64, 64, 64), (40, 8, 16)])
def test_ssd_f64_walk_is_nearer_the_oracle_than_plain(lib, L, P, N):
    """Summing both products in f64 and rounding once puts the kernel's
    walk nearer the float64 oracle of scripts/stress_lm_kernels.py than
    the plain version's f32 sums, in the mean over a whole tile."""
    x, dt, cum, B, C = _ssd_case(7 + L, L, P, N)
    y = np.empty_like(x)
    lib.h_ssd_walk(_p(x), _p(dt), _p(cum), _p(B), _p(C), _p(y), L, P, N)
    args = _as_chunk(x, dt, cum, B, C)
    exact = stress.ssd_error_bound(*args)[0][0, :, 0].numpy()
    plain = intra_chunk_ref(*args)[0, :, 0].numpy()
    assert np.abs(y - exact).mean() < np.abs(plain - exact).mean()


# ---------------------------------------------------------------------------
# The backward kernels' per-element arithmetic (flash_bwd_tile.cuh,
# ssd_bwd_tile.cuh), walked serially in the kernels' tile order
# ---------------------------------------------------------------------------

BWD_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <algorithm>
#include <vector>
#include "flash_tile.cuh"
#include "flash_bwd_tile.cuh"
#include "ssd_bwd_tile.cuh"
#include "ssd_tile.cuh"
extern "C" {
// One batch: q, dout (S, H, hd); k, v (T, KV, hd); lse (H, S).  The
// forward's row log-sum-exp as its kernels write it.
void h_flash_lse(const float* q, const float* k, float* lse, int S, int T,
                 int H, int KV, int hd, int causal, int window, int log2) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int h = 0; h < H; ++h) {
    const int kvh = h / (H / KV);
    for (int i = 0; i < S; ++i) {
      float m = fa::NEG_INF, l = 0.0f;
      for (int j = 0; j < T; ++j) {
        if (!fa::in_band(i, j, T, causal, window)) continue;
        float s = 0.0f;
        for (int d = 0; d < hd; ++d)
          s = fmaf(q[(i * H + h) * hd + d], k[(j * KV + kvh) * hd + d], s);
        const float alpha = fa::online_rescale(m, s * scale);
        l = l * alpha + expf(s * scale - m);
      }
      lse[h * S + i] = log2 ? fab::lse_of_log2(m * fa::LOG2E, l)
                            : fab::lse_of(m, l);
    }
  }
}

static float dot_rows(const float* a, const float* b, int hd) {
  float s = 0.0f;
  for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// The two kernels' walks: dQ over (head, q-tile) blocks and their live
// k-tiles (pass 1 for D, pass 2 for dS and dQ), dK/dV over (kv head,
// k-tile) blocks, the group's heads and their live q-tiles.
void h_flash_bwd(const float* q, const float* k, const float* v,
                 const float* dout, const float* lse, float* dq, float* dk,
                 float* dv, float* dsum, int S, int T, int H, int KV, int hd,
                 int causal, int window, int bq, int bk) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const int group = H / KV;
  auto qr = [&](const float* t, int i, int h) { return t + (i * H + h) * hd; };
  auto kr = [&](const float* t, int j, int h) { return t + (j * KV + h) * hd; };
  for (int h = 0; h < H; ++h) {
    const int kvh = h / group;
    for (int q_lo = 0; q_lo < S; q_lo += bq) {
      const int q_hi = std::min(q_lo + bq, S) - 1;
      for (int i = q_lo; i <= q_hi; ++i) {
        float D = 0.0f;
        for (int k_lo = 0; k_lo < T; k_lo += bk) {
          const int k_hi = std::min(k_lo + bk, T) - 1;
          if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window)) continue;
          for (int j = k_lo; j < k_lo + bk; ++j) {
            const bool live = fa::in_band(i, j, T, causal, window);
            if (j >= T) continue;
            const float s = dot_rows(qr(q, i, h), kr(k, j, kvh), hd);
            const float dp = dot_rows(qr(dout, i, h), kr(v, j, kvh), hd);
            D = fmaf(fab::prob(s, scale, lse[h * S + i], live), dp, D);
          }
        }
        dsum[h * S + i] = D;
        std::vector<float> acc(hd, 0.0f);
        for (int k_lo = 0; k_lo < T; k_lo += bk) {
          const int k_hi = std::min(k_lo + bk, T) - 1;
          if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window)) continue;
          for (int j = k_lo; j <= k_hi; ++j) {
            const bool live = fa::in_band(i, j, T, causal, window);
            const float s = dot_rows(qr(q, i, h), kr(k, j, kvh), hd);
            const float dp = dot_rows(qr(dout, i, h), kr(v, j, kvh), hd);
            const float ds = fab::dscore(
                fab::prob(s, scale, lse[h * S + i], live), dp, D);
            for (int d = 0; d < hd; ++d)
              acc[d] = fmaf(ds, kr(k, j, kvh)[d], acc[d]);
          }
        }
        for (int d = 0; d < hd; ++d) dq[(i * H + h) * hd + d] = acc[d] * scale;
      }
    }
  }
  for (int kvh = 0; kvh < KV; ++kvh)
    for (int k_lo = 0; k_lo < T; k_lo += bk) {
      const int k_hi = std::min(k_lo + bk, T) - 1;
      for (int j = k_lo; j <= k_hi; ++j) {
        std::vector<float> ak(hd, 0.0f), av(hd, 0.0f);
        for (int g = 0; g < group; ++g) {
          const int h = kvh * group + g;
          for (int q_lo = 0; q_lo < S; q_lo += bq) {
            const int q_hi = std::min(q_lo + bq, S) - 1;
            if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window))
              continue;
            for (int i = q_lo; i <= q_hi; ++i) {
              const bool live = fa::in_band(i, j, T, causal, window);
              const float s = dot_rows(qr(q, i, h), kr(k, j, kvh), hd);
              const float dp = dot_rows(qr(dout, i, h), kr(v, j, kvh), hd);
              const float p = fab::prob(s, scale, lse[h * S + i], live);
              const float ds = fab::dscore(p, dp, dsum[h * S + i]);
              for (int d = 0; d < hd; ++d) {
                av[d] = fmaf(p, qr(dout, i, h)[d], av[d]);
                ak[d] = fmaf(ds, qr(q, i, h)[d], ak[d]);
              }
            }
          }
        }
        for (int d = 0; d < hd; ++d) {
          dk[(j * KV + kvh) * hd + d] = ak[d] * scale;
          dv[(j * KV + kvh) * hd + d] = av[d];
        }
      }
    }
}

// bf16 terms of x: the values the tensor cores multiply
static void split_terms(float x, float& hi, float& lo) {
  uint16_t h, l;
  fa::split_bf16(x, h, l);
  hi = fa::bf16_value(h);
  lo = fa::bf16_value(l);
}

// The tensor-core route's walk (flash_bwd_hopper.cuh) for bf16 inputs
// (given as floats): O in f32 from lse, D_i = dO_i . O_i summed as the
// kernel's four lanes of a row do, then the dQ kernel over blocks of bq
// query rows and their live k-tiles of 64 and the dK/dV kernel over
// blocks of bk keys, the group's heads and their live q-tiles of 64;
// probabilities in log2 units against lse, P and dS as two bf16 terms
// into f32 sums.
void h_flash_bwd_split(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, float* dq,
                       float* dk, float* dv, float* dsum, int S, int T, int H,
                       int KV, int hd, int causal, int window, int bq,
                       int bk) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const float c = scale * fa::LOG2E;
  const int group = H / KV;
  auto qr = [&](const float* t, int i, int h) { return t + (i * H + h) * hd; };
  auto kr = [&](const float* t, int j, int h) { return t + (j * KV + h) * hd; };
  auto prob = [&](int i, int j, int h, float m2) {
    const float s = dot_rows(qr(q, i, h), kr(k, j, h / group), hd);
    return fa::prob_log2(s, c, m2, fa::in_band(i, j, T, causal, window));
  };
  std::vector<float> o(hd);
  for (int h = 0; h < H; ++h)
    for (int i = 0; i < S; ++i) {
      const float m2 = lse[h * S + i] * fa::LOG2E;
      std::fill(o.begin(), o.end(), 0.0f);
      for (int j = 0; j < T; ++j) {
        const float p = prob(i, j, h, m2);
        for (int d = 0; d < hd; ++d)
          o[d] = fmaf(p, kr(v, j, h / group)[d], o[d]);
      }
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int t = 0; t < 4; ++t)
        for (int col = 2 * t; col < hd; col += 8) {
          part[t] = fmaf(qr(dout, i, h)[col], o[col], part[t]);
          part[t] = fmaf(qr(dout, i, h)[col + 1], o[col + 1], part[t]);
        }
      dsum[h * S + i] = (part[0] + part[1]) + (part[2] + part[3]);
    }
  for (int h = 0; h < H; ++h)
    for (int q_lo = 0; q_lo < S; q_lo += bq) {
      const int q_hi = std::min(q_lo + bq, S) - 1;
      for (int i = q_lo; i <= q_hi; ++i) {
        const float m2 = lse[h * S + i] * fa::LOG2E;
        std::vector<float> acc(hd, 0.0f);
        for (int k_lo = 0; k_lo < T; k_lo += 64) {
          if (!fa::tile_live(q_lo, q_hi, k_lo, std::min(k_lo + 64, T) - 1,
                             causal, window))
            continue;
          for (int j = k_lo; j < std::min(k_lo + 64, T); ++j) {
            const float dp = dot_rows(qr(dout, i, h), kr(v, j, h / group), hd);
            float hi, lo;
            split_terms(fab::dscore(prob(i, j, h, m2), dp, dsum[h * S + i]),
                        hi, lo);
            for (int d = 0; d < hd; ++d) {
              acc[d] = fmaf(hi, kr(k, j, h / group)[d], acc[d]);
              acc[d] = fmaf(lo, kr(k, j, h / group)[d], acc[d]);
            }
          }
        }
        for (int d = 0; d < hd; ++d) dq[(i * H + h) * hd + d] = acc[d] * scale;
      }
    }
  for (int kvh = 0; kvh < KV; ++kvh)
    for (int k_lo = 0; k_lo < T; k_lo += bk) {
      const int k_hi = std::min(k_lo + bk, T) - 1;
      for (int j = k_lo; j <= k_hi; ++j) {
        std::vector<float> ak(hd, 0.0f), av(hd, 0.0f);
        for (int g = 0; g < group; ++g) {
          const int h = kvh * group + g;
          for (int q_lo = 0; q_lo < S; q_lo += 64) {
            const int q_hi = std::min(q_lo + 64, S) - 1;
            if (!fa::tile_live(q_lo, q_hi, k_lo, k_hi, causal, window))
              continue;
            for (int i = q_lo; i <= q_hi; ++i) {
              const float p = prob(i, j, h, lse[h * S + i] * fa::LOG2E);
              const float dp = dot_rows(qr(dout, i, h), kr(v, j, kvh), hd);
              float p_hi, p_lo, s_hi, s_lo;
              split_terms(p, p_hi, p_lo);
              split_terms(fab::dscore(p, dp, dsum[h * S + i]), s_hi, s_lo);
              for (int d = 0; d < hd; ++d) {
                av[d] = fmaf(p_hi, qr(dout, i, h)[d], av[d]);
                av[d] = fmaf(p_lo, qr(dout, i, h)[d], av[d]);
                ak[d] = fmaf(s_hi, qr(q, i, h)[d], ak[d]);
                ak[d] = fmaf(s_lo, qr(q, i, h)[d], ak[d]);
              }
            }
          }
        }
        for (int d = 0; d < hd; ++d) {
          dk[(j * KV + kvh) * hd + d] = ak[d] * scale;
          dv[(j * KV + kvh) * hd + d] = av[d];
        }
      }
    }
}

// One chunk: x, dy (L, H, P); dt, cum (L, H); B, C (L, N).  The kernel's
// walk (ssd_intra_chunk_bwd.cu): C.B^T once on its tile cover, then per
// head in order ds on the same tiles, the pair terms, s^T, d(C.B^T)
// added per pair, the tiles' column and row sums and their sums in the
// kernel's order, dx over i >= j from each strip's first k-step; after
// the last head dC and dB over the kernel's k-ranges.  Every sum in
// double, rows past L read as 0.
void h_ssd_bwd(const float* x, const float* dt, const float* cum,
               const float* B, const float* C, const float* dy, float* dx,
               float* ddt, float* dcum, float* dB, float* dC, int L, int H,
               int P, int N) {
  const int M = ssd::MAX_L, K = ssdb::ksteps(L);
  auto row = [&](const float* t, int i, int h, int width, int stride, int e) {
    return i < L ? double(t[(i * stride + h) * width + e]) : 0.0;
  };
  std::vector<double> cb(M * M, 0.0), dcb(M * M, 0.0);
  for (int q = 0; q < ssd::CB_TILES; ++q) {
    int r, c;
    ssd::cb_tile(q, r, c);
    if (!ssdb::tile_in(r, c, L)) continue;
    for (int i = 16 * r; i < 16 * r + 16; ++i)
      for (int j = 8 * c; j < 8 * c + 8; ++j)
        for (int n = 0; n < N; ++n)
          cb[i * M + j] = fma(row(C, i, 0, N, 1, n), row(B, j, 0, N, 1, n),
                              cb[i * M + j]);
  }
  for (int h = 0; h < H; ++h) {
    std::vector<double> sT(M * M, 0.0), colv(4 * M, 0.0), colw(4 * M, 0.0),
        roww(8 * M, 0.0);
    auto tval = [&](const float* t, int i) {
      return i < L ? double(t[i * H + h]) : 0.0;
    };
    for (int q = 0; q < ssd::CB_TILES; ++q) {
      int r, c;
      ssd::cb_tile(q, r, c);
      if (!ssdb::tile_in(r, c, L)) continue;
      for (int i = 16 * r; i < 16 * r + 16; ++i)
        for (int j = 8 * c; j < 8 * c + 8; ++j) {
          double ds = 0.0;
          for (int p = 0; p < P; ++p)
            ds = fma(row(dy, i, h, P, H, p), row(x, j, h, P, H, p), ds);
          double sv, v, w, d;
          ssdb::pair_grads<double>(cb[i * M + j], tval(cum, i), tval(cum, j),
                                   tval(dt, j), ds, i < L ? i : -1, j, sv, v,
                                   w, d);
          sT[j * M + i] = sv;
          dcb[i * M + j] += d;
          colv[r * M + j] += v;
          colw[r * M + j] += w;
          roww[c * M + i] += w;
        }
    }
    for (int r = 0; r < 4 && 16 * r < L; ++r)
      for (int j = 16 * r; j < std::min(16 * r + 16, L); ++j)
        for (int p = 0; p < P; ++p) {
          double a = 0.0;
          for (int i = 8 * ssdb::kstep_lo(r); i < 8 * K; ++i)
            a = fma(sT[j * M + i], row(dy, i, h, P, H, p), a);
          dx[(j * H + h) * P + p] = static_cast<float>(a);
        }
    for (int k = 0; k < L; ++k) {
      double vs = 0.0, col = 0.0, rw = 0.0;
      for (int r = ssdb::first_strip(k); r < 4 && 16 * r < L; ++r) {
        vs += colv[r * M + k];
        col += colw[r * M + k];
      }
      for (int c = 0; c < ssdb::row_tiles(k) && 8 * c < L; ++c)
        rw += roww[c * M + k];
      ddt[k * H + h] = static_cast<float>(vs);
      dcum[k * H + h] = static_cast<float>(rw - col);
    }
  }
  for (int r = 0; r < 4 && 16 * r < L; ++r)
    for (int i = 16 * r; i < std::min(16 * r + 16, L); ++i)
      for (int n = 0; n < N; ++n) {
        double c_ = 0.0, b_ = 0.0;
        for (int j = 0; j < 8 * ssd::strip_ksteps(r, L); ++j)
          c_ = fma(dcb[i * M + j], row(B, j, 0, N, 1, n), c_);
        for (int m = 8 * ssdb::kstep_lo(r); m < 8 * K; ++m)
          b_ = fma(dcb[m * M + i], row(C, m, 0, N, 1, n), b_);
        dC[i * N + n] = static_cast<float>(c_);
        dB[i * N + n] = static_cast<float>(b_);
      }
}
}
"""


@pytest.fixture(scope="module")
def bwd_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    d = tmp_path_factory.mktemp("csrc_lm_bwd")
    (d / "shim.cpp").write_text(BWD_SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror",
                    "-I", str(KERNELS / "flash_attention" / "csrc"),
                    "-I", str(KERNELS / "mamba2_scan" / "csrc"),
                    str(d / "shim.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _plain_lse(q, k, causal, window):
    """(H, S) log-sum-exp of the scaled, masked scores, float64."""
    from repro_torch.kernels.flash_attention.ref import expand_kv
    qt = torch.from_numpy(q).double()[None].transpose(1, 2)
    kt = expand_kv(torch.from_numpy(k).double()[None], q.shape[1])
    logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) / np.sqrt(q.shape[-1])
    S, T = logits.shape[-2:]
    i, j = np.arange(S)[:, None], np.arange(T)[None]
    band = (j <= i if causal else np.ones((S, T), bool)) & (
        (i - j) < window if window else True)
    logits = logits.masked_fill(~torch.from_numpy(band), float("-inf"))
    return torch.logsumexp(logits, -1)[0].numpy()


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,bq,bk", [
    (100, 100, 2, 2, 16, True, None, 64, 64),    # ragged q and k tiles
    (90, 90, 4, 2, 24, False, None, 32, 64),     # GQA
    (200, 200, 2, 1, 8, True, 48, 64, 64),       # skipped tiles both sides
    (40, 100, 2, 2, 16, False, 30, 16, 32),      # S < T
    (70, 70, 1, 1, 80, True, 7, 16, 16),
])
def test_flash_bwd_walk_matches_plain(bwd_lib, S, T, H, KV, hd, causal,
                                      window, bq, bk):
    rng = np.random.default_rng(S + T + hd)
    q, dout = (rng.standard_normal((S, H, hd)).astype(np.float32)
               for _ in "qo")
    k, v = (rng.standard_normal((T, KV, hd)).astype(np.float32) for _ in "kv")
    lse = np.empty((H, S), np.float32)
    bwd_lib.h_flash_lse(_p(q), _p(k), _p(lse), S, T, H, KV, hd, int(causal),
                        window or 0, 0)
    np.testing.assert_allclose(lse, _plain_lse(q, k, causal, window),
                               rtol=2e-6, atol=2e-6)
    lse2 = np.empty_like(lse)
    bwd_lib.h_flash_lse(_p(q), _p(k), _p(lse2), S, T, H, KV, hd,
                        int(causal), window or 0, 1)
    np.testing.assert_allclose(lse2, lse, rtol=2e-6, atol=2e-6)
    dq, dsum = np.empty_like(q), np.empty((H, S), np.float32)
    dk, dv = np.empty_like(k), np.empty_like(v)
    bwd_lib.h_flash_bwd(_p(q), _p(k), _p(v), _p(dout), _p(lse), _p(dq),
                        _p(dk), _p(dv), _p(dsum), S, T, H, KV, hd,
                        int(causal), window or 0, bq, bk)
    want = attention_bwd_ref(*(torch.from_numpy(a)[None]
                               for a in (q, k, v, dout)),
                             causal=causal, window=window)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got, w[0].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,bq,bk", [
    (200, 200, 2, 2, 80, True, None, 128, 128),  # ragged, two d boxes
    (130, 130, 4, 2, 24, False, None, 128, 128),  # GQA, hd not 16k
    (300, 300, 2, 1, 64, True, 70, 128, 128),   # window, skipped tiles
    (100, 260, 2, 2, 16, False, 40, 128, 128),  # S < T
])
def test_flash_bf16_bwd_walk_matches_plain(bwd_lib, S, T, H, KV, hd, causal,
                                           window, bq, bk):
    """The tensor-core backward's arithmetic on the host (D from an f32
    O, P and dS as two bf16 terms each, probabilities in log2 units)
    against the plain backward on the same bf16 inputs, at the card's
    bounds: 2e-2, and two bf16 steps of each element once rounded to
    bf16 as the kernel's gradients are."""
    rng = np.random.default_rng(S + T + hd + 1)
    q, dout = (torch.from_numpy(rng.standard_normal((S, H, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in "qo")
    k, v = (torch.from_numpy(rng.standard_normal((T, KV, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in "kv")
    qf, kf, vf, of = (np.ascontiguousarray(t.float().numpy())
                      for t in (q, k, v, dout))
    lse = np.ascontiguousarray(_plain_lse(qf, kf, causal, window)
                               .astype(np.float32))
    dq, dk, dv = np.empty_like(qf), np.empty_like(kf), np.empty_like(vf)
    dsum = np.empty((H, S), np.float32)
    bwd_lib.h_flash_bwd_split(_p(qf), _p(kf), _p(vf), _p(of), _p(lse),
                              _p(dq), _p(dk), _p(dv), _p(dsum), S, T, H, KV,
                              hd, int(causal), window or 0, bq, bk)
    want = attention_bwd_ref(*(t[None] for t in (q, k, v, dout)),
                             causal=causal, window=window)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        got = torch.from_numpy(got).to(torch.bfloat16).float()
        w = w[0].float()
        torch.testing.assert_close(got, w, rtol=2e-2, atol=2e-2, msg=name)
        torch.testing.assert_close(got, w, rtol=2.0 ** -6, atol=1e-5,
                                   msg=name)


def test_flash_lse_marks_rows_without_keys(bwd_lib):
    """A row with no key in band gets lse = +inf, so that every
    probability the backward recomputes for it is 0."""
    q = np.ones((4, 1, 8), np.float32)
    k = np.ones((4, 1, 8), np.float32)
    lse = np.empty((1, 4), np.float32)
    bwd_lib.h_flash_lse(_p(q), _p(k), _p(lse), 4, 2, 1, 1, 8, 0, 0, 0)
    assert np.isfinite(lse).all()
    # window 1, keys 0..1: rows 2 and 3 see none
    bwd_lib.h_flash_lse(_p(q), _p(k), _p(lse), 4, 2, 1, 1, 8, 0, 1, 0)
    assert np.isfinite(lse[0, :2]).all() and np.isposinf(lse[0, 2:]).all()


@pytest.mark.parametrize("L,H,P,N", [(64, 3, 16, 8), (40, 2, 8, 16),
                                     (17, 4, 5, 3), (1, 2, 4, 4),
                                     (64, 2, 32, 32), (64, 5, 24, 40),
                                     (33, 3, 7, 5), (48, 2, 50, 70)])
def test_ssd_bwd_walk_matches_plain(bwd_lib, L, H, P, N):
    """The kernel's walk (its lower-triangle tile cover, d(C.B^T) summed
    over the heads in order, double sums) against the plain backward at
    1e-5 and against its float64 run at 1e-6: the walk is the nearer."""
    from repro_torch.kernels.mamba2_scan.ref import intra_chunk_bwd_ref
    rng = np.random.default_rng(L * H + P)
    x, dy = (rng.standard_normal((L, H, P)).astype(np.float32) for _ in "xy")
    dt = np.log1p(np.exp(rng.standard_normal((L, H)))).astype(np.float32)
    cum = np.cumsum(-np.log1p(np.exp(rng.standard_normal((L, H)))),
                    0).astype(np.float32)
    B, C = (rng.standard_normal((L, N)).astype(np.float32) for _ in "BC")
    outs = [np.empty_like(a) for a in (x, dt, cum, B, C)]
    bwd_lib.h_ssd_bwd(_p(x), _p(dt), _p(cum), _p(B), _p(C), _p(dy),
                      *map(_p, outs), L, H, P, N)
    args = [torch.from_numpy(a)[None] for a in (x, dt, cum, B, C, dy)]
    want = intra_chunk_bwd_ref(*args)
    exact = intra_chunk_bwd_ref(*(a.double() for a in args))
    for name, got, w, e in zip(("dx", "ddt", "dcum", "dB", "dC"), outs,
                               want, exact):
        np.testing.assert_allclose(got, w[0].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got, e[0].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)

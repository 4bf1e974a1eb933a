"""The CUDA kernels' shared C++ (cgra_alu.cuh, cgra_lane.cuh) compiled
for the host with g++ and held against the port's plain PyTorch version.

The sweep kernel's per-lane arithmetic -- the ALU, floor modulo, bank
and DMA mapping, the ascending-PE bank/DMA scheduler, last-writer-wins
store arbitration, operand selection over the torus and the per-PE
energy term -- lives in those headers as __host__ __device__ functions,
so the C++ traps (truncating %, signed overflow, logical shifts, the
scheduler order) show here, before any GPU runs them.  The kernel's
warp-parallel scheduler and match-based store arbitration run here too:
the shim builds the masks that __ballot_sync and __match_any_sync give
the kernel, for a lane group at any offset in its warp, and relaxes the
slots in rounds with the header's slot_start / slot_relax.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.core import cgra, hwconfig, isa, memory  # noqa: E402
from repro_torch.kernels.cgra_step.ref import alu_ref  # noqa: E402

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels"
I32_MIN, I32_MAX = -2**31, 2**31 - 1

SHIM = r"""
#include <stdint.h>
#include "cgra_lane.cuh"
using namespace cgra;
extern "C" {
void h_alu(const int32_t* op, const int32_t* a, const int32_t* b,
           int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = alu(op[i], a[i], b[i]);
}
void h_floor_mod(const int32_t* x, int32_t m, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = floor_mod(x[i], m);
}
// hw rows: smul_lat, bus, interleaved, n_banks, dma_per_pe, t_mem
void h_mem_schedule(int P, int cols, const int32_t* is_mem,
                    const int32_t* addr, const int32_t* hw, int32_t M,
                    int32_t* out, int64_t n) {
  int32_t scratch[3 * 32];
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* h = hw + 6 * i;
    mem_schedule(P, cols, is_mem + P * i, addr + P * i, h[1], h[2], h[3],
                 h[4], h[5], M, scratch, out + P * i);
  }
}
void h_bank_dma(int P, int cols, const int32_t* addr, const int32_t* hw,
                int32_t M, int32_t* bank, int32_t* dma, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    for (int p = 0; p < P; ++p) {
      const int32_t* h = hw + 6 * i;
      bank[P * i + p] = bank_of(addr[P * i + p], h[1], h[2], h[3], M);
      dma[P * i + p] = dma_of(p, h[4], cols);
    }
}
// the kernel's per-step forms: bank_by and mod_by with precomputed
// divisors, beside bank_of and floor_mod
void h_bank_by(const int32_t* addr, const int32_t* hw, int32_t M,
               int32_t* bank, int32_t* wrapped, int64_t n) {
  const int32_t mem_shift = pow2_shift(M);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* h = hw + 6 * i;
    const int32_t div = bank_divisor(h[2], h[3], M);
    bank[i] = bank_by(addr[i], h[1], h[2], h[3], div, pow2_shift(div));
    wrapped[i] = mod_by(addr[i], M, mem_shift);
  }
}
void h_store_lands(int P, const int32_t* is_store, const int32_t* addr,
                   int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    for (int p = 0; p < P; ++p)
      out[P * i + p] = store_lands(p, P, is_store + P * i, addr + P * i);
}
// The kernel's warp-parallel forms, one lane group per instance at warp
// offset (i % (32 / P)) * P: masks as __ballot_sync / __match_any_sync
// build them, then the kernel's relaxation rounds.  rounds[i] counts
// them, the last (no change) included.
void h_mem_schedule_warp(int P, int cols, const int32_t* is_mem,
                         const int32_t* addr, const int32_t* hw, int32_t M,
                         int32_t* out, int32_t* rounds, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int first = static_cast<int>(i % (32 / P)) * P;
    const int32_t* h = hw + 6 * i;
    const int32_t* req = is_mem + P * i;
    const int32_t* ad = addr + P * i;
    int32_t bank[32];
    unsigned mem_lanes = 0;
    for (int p = 0; p < P; ++p) {
      bank[p] = bank_of(ad[p], h[1], h[2], h[3], M);
      if (req[p]) mem_lanes |= 1u << (first + p);
    }
    unsigned pb[32], pd[32];
    int32_t slot[32], next[32];
    for (int p = 0; p < P; ++p) {
      unsigned same_bank = 0, cols_lanes = 0;
      for (int q = 0; q < P; ++q) {
        if (bank[q] == bank[p]) same_bank |= 1u << (first + q);
        if (q % cols == p % cols) cols_lanes |= 1u << (first + q);
      }
      const unsigned dma_lanes = h[4] > 0 ? 1u << (first + p) : cols_lanes;
      const unsigned below = lanes_below(first + p);
      pb[p] = req[p] ? same_bank & mem_lanes & below : 0u;
      pd[p] = req[p] ? dma_lanes & mem_lanes & below : 0u;
      slot[p] = slot_start(pb[p], pd[p]);
    }
    int r = 0;
    for (bool changed = true; changed;) {
      changed = false;
      for (int p = 0; p < P; ++p) {
        const int sb = pb[p] ? top_lane(pb[p]) - first : p;
        const int sd = pd[p] ? top_lane(pd[p]) - first : p;
        next[p] = slot_relax(pb[p], pd[p], slot[sb], slot[sd]);
        changed = changed || next[p] != slot[p];
      }
      for (int p = 0; p < P; ++p) slot[p] = next[p];
      ++r;
    }
    for (int p = 0; p < P; ++p) out[P * i + p] = req[p] ? slot[p] + h[5] : 0;
    rounds[i] = r;
  }
}
void h_store_lands_warp(int P, const int32_t* is_store, const int32_t* addr,
                        int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int first = static_cast<int>(i % (32 / P)) * P;
    const int32_t* st = is_store + P * i;
    const int32_t* ad = addr + P * i;
    unsigned st_lanes = 0;
    for (int p = 0; p < P; ++p)
      if (st[p]) st_lanes |= 1u << (first + p);
    for (int p = 0; p < P; ++p) {
      unsigned same = 0;
      for (int q = 0; q < P; ++q)
        if (ad[q] == ad[p]) same |= 1u << (first + q);
      out[P * i + p] = lands_by_match(st[p] != 0, same & st_lanes, first + p);
    }
  }
}
void h_lane_masks(int lane, uint32_t* below, uint32_t* above, int32_t* top,
                  uint32_t m) {
  *below = lanes_below(lane);
  *above = lanes_above(lane);
  *top = m ? top_lane(m) : -1;
}
// regs (n, 4, P), rout (n, P)
void h_operands(int rows, int cols, const int32_t* sel, const int32_t* imm,
                const int32_t* regs, const int32_t* rout, int32_t* out,
                int64_t n) {
  const int P = rows * cols;
  for (int64_t i = 0; i < n; ++i)
    for (int p = 0; p < P; ++p) {
      const int32_t* r = regs + 4 * P * i;
      const int32_t* o = rout + P * i;
      out[P * i + p] = select_operand(
          sel[P * i + p], imm[P * i + p], r[p], r[P + p], r[2 * P + p],
          r[3 * P + p], o[p], o[neighbour(p, 0, rows, cols)],
          o[neighbour(p, 1, rows, cols)], o[neighbour(p, 2, rows, cols)],
          o[neighbour(p, 3, rows, cols)]);
    }
}
// f: (n, 12) p_dec, p_act, scale, gate, active, p_idle, wait, esA, esB,
//    e_sw_op, e_sw_mux, unused; flags: (n, 3) op_ch, a_ch, b_ch
void h_energy(const float* f, const int32_t* flags, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const float* x = f + 12 * i;
    const int32_t* c = flags + 3 * i;
    out[i] = pe_energy(x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8],
                       c[0], c[1], c[2], x[9], x[10]);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    d = tmp_path_factory.mktemp("csrc")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", str(KERNELS / "cgra_step" / "csrc"),
                    "-I", str(KERNELS / "cgra_sweep" / "csrc"),
                    str(d / "shim.cpp"), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _p(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def test_alu_matches_plain_version(lib):
    rng = np.random.default_rng(0)
    n = 20000
    ops = rng.integers(0, isa.N_OPS, n).astype(np.int32)
    edge = np.array([I32_MIN, I32_MAX, -1, 0, 1, 31, 32, -33], np.int64)
    a = np.where(rng.random(n) < 0.3, rng.choice(edge, n),
                 rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64))
    b = np.where(rng.random(n) < 0.3, rng.choice(edge, n),
                 rng.integers(-64, 64, n))
    a, b = _i32(a), _i32(b)
    out = np.empty(n, np.int32)
    lib.h_alu(_p(ops), _p(a), _p(b), _p(out), ctypes.c_int64(n))
    want = alu_ref(*map(torch.as_tensor, (ops, a, b))).numpy()
    np.testing.assert_array_equal(out, want)


def test_floor_mod_matches_torch_remainder(lib):
    x = _i32(np.concatenate([np.arange(-9000, 9000, 7),
                             [I32_MIN, I32_MAX, -1, -4096, 4096]]))
    for m in (1, 3, 256, 4096):
        out = np.empty_like(x)
        lib.h_floor_mod(_p(x), ctypes.c_int32(m), _p(out),
                        ctypes.c_int64(x.size))
        np.testing.assert_array_equal(
            out, torch.remainder(torch.as_tensor(x), m).numpy())


def _hw_rows(rng, n):
    cfgs = [hwconfig.TOPOLOGIES[t]() for t in sorted(hwconfig.TOPOLOGIES)]
    cfgs += [hwconfig.HwConfig(bus=1, interleaved=i, n_banks=nb,
                               dma_per_pe=d, t_mem=tm)
             for i in (0, 1) for nb in (1, 2, 3, 8, 16, 32)
             for d in (0, 1) for tm in (1, 4)]
    pick = [cfgs[i] for i in rng.integers(0, len(cfgs), n)]
    hw = hwconfig.stack_configs(pick)
    rows = np.stack([getattr(hw, f).numpy() for f in
                     ("smul_lat", "bus", "interleaved", "n_banks",
                      "dma_per_pe", "t_mem")], axis=1)
    return hw, _i32(rows)


def _requests(rng, n, P, M):
    is_mem = rng.random((n, P)) < rng.random((n, 1))
    addr = (rng.integers(0, M, (n, 1)) + rng.integers(0, 48, (n, P))) % M
    return is_mem, _i32(addr)


@pytest.mark.parametrize("rows,cols", [(4, 4), (2, 4), (1, 2), (4, 8)])
def test_scheduler_matches_mem_completion_times(lib, rows, cols):
    rng = np.random.default_rng(rows * 10 + cols)
    n, P, M = 3000, rows * cols, 4096
    hw, hw_rows = _hw_rows(rng, n)
    is_mem, addr = _requests(rng, n, P, M)
    out = np.empty((n, P), np.int32)
    lib.h_mem_schedule(P, cols, _p(_i32(is_mem)), _p(addr), _p(hw_rows),
                       ctypes.c_int32(M), _p(out), ctypes.c_int64(n))
    want = memory.mem_completion_times(torch.as_tensor(is_mem),
                                       torch.as_tensor(addr), hw, M, cols)
    np.testing.assert_array_equal(out, want.numpy())


def test_bank_and_dma_mapping(lib):
    rng = np.random.default_rng(11)
    n, P, cols, M = 2000, 16, 4, 4096
    hw, hw_rows = _hw_rows(rng, n)
    addr = _i32(rng.integers(0, M, (n, P)))
    bank, dma = np.empty((n, P), np.int32), np.empty((n, P), np.int32)
    lib.h_bank_dma(P, cols, _p(addr), _p(hw_rows), ctypes.c_int32(M),
                   _p(bank), _p(dma), ctypes.c_int64(n))
    np.testing.assert_array_equal(
        bank, memory.bank_of(torch.as_tensor(addr), hw, M).numpy())
    pe = np.arange(P)
    np.testing.assert_array_equal(
        dma, np.where(hw_rows[:, 4:5] > 0, pe, pe % cols))


@pytest.mark.parametrize("M", [4096, 4000, 1, 64, 96])
def test_bank_by_equals_bank_of(lib, M):
    """The kernel's mask-and-shift forms equal bank_of and floor_mod on
    every address, in range or not, for power-of-two sizes and others."""
    rng = np.random.default_rng(M)
    n = 20000
    hw, hw_rows = _hw_rows(rng, n)
    addr = _i32(np.concatenate([rng.integers(I32_MIN, I32_MAX, n // 2),
                                rng.integers(-2 * M, 2 * M, n - n // 2)]))
    bank, wrapped = np.empty(n, np.int32), np.empty(n, np.int32)
    lib.h_bank_by(_p(addr), _p(hw_rows), ctypes.c_int32(M), _p(bank),
                  _p(wrapped), ctypes.c_int64(n))
    np.testing.assert_array_equal(
        bank, memory.bank_of(torch.as_tensor(addr)[:, None], hw,
                             M).numpy()[:, 0])
    np.testing.assert_array_equal(
        wrapped, torch.remainder(torch.as_tensor(addr), M).numpy())


def test_last_writer_wins(lib):
    rng = np.random.default_rng(5)
    n, P = 500, 16
    is_store = rng.random((n, P)) < 0.5
    addr = _i32(rng.integers(0, 6, (n, P)))
    val = _i32(rng.integers(-1000, 1000, (n, P)))
    lands = np.empty((n, P), np.int32)
    lib.h_store_lands(P, _p(_i32(is_store)), _p(addr), _p(lands),
                      ctypes.c_int64(n))
    assert not (lands.astype(bool) & ~is_store).any()
    mem = torch.as_tensor(_i32(rng.integers(-9, 9, (n, 8))))
    want = mem.clone()
    cgra.apply_stores(want, torch.as_tensor(addr), torch.as_tensor(is_store),
                      torch.as_tensor(val),
                      want.gather(1, torch.as_tensor(addr).long()))
    got = mem.numpy().copy()
    for i in range(n):
        for p in np.flatnonzero(lands[i]):
            got[i, addr[i, p]] = val[i, p]
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("rows,cols", [(4, 4), (2, 8), (1, 4)])
def test_operand_select_matches_gather_operands(lib, rows, cols):
    rng = np.random.default_rng(rows + cols)
    n, P = 400, rows * cols
    sel = _i32(rng.integers(0, isa.N_SRCS + 2, (n, P)))   # + unknown ones
    imm, rout = (_i32(rng.integers(-999, 999, (n, P))) for _ in range(2))
    regs = _i32(rng.integers(-999, 999, (n, 4, P)))
    out = np.empty((n, P), np.int32)
    lib.h_operands(rows, cols, _p(sel), _p(imm), _p(regs), _p(rout),
                   _p(out), ctypes.c_int64(n))
    known = sel < isa.N_SRCS
    want = cgra.gather_operands(
        torch.as_tensor(np.where(known, sel, 0)), torch.as_tensor(imm),
        torch.as_tensor(regs), torch.as_tensor(rout),
        cgra.neighbour_tables(rows, cols, "cpu")).numpy()
    np.testing.assert_array_equal(out, np.where(known, want, 0))


def test_pe_energy_rounds_like_the_plain_version(lib):
    rng = np.random.default_rng(9)
    n = 5000
    f = rng.uniform(0.0, 400.0, (n, 12)).astype(np.float32)
    f[:, 3] = np.where(rng.random(n) < 0.5, f[:, 3], 1.0)
    f[:, 4] = rng.integers(0, 4, n)
    f[:, 6] = rng.integers(0, 6, n)
    f[:, 7:9] -= 200.0                          # source deltas are signed
    flags = _i32(rng.random((n, 3)) < 0.5)
    out = np.empty(n, np.float32)
    lib.h_energy(_p(f), _p(flags), _p(out), ctypes.c_int64(n))
    t = torch.as_tensor(f)
    c = torch.as_tensor(flags).bool()
    want = (t[:, 0] * t[:, 2] + t[:, 1] * t[:, 2] * t[:, 3] * t[:, 4]
            + t[:, 5] * t[:, 6] + t[:, 7] + t[:, 8] + c[:, 0] * t[:, 9]
            + (c[:, 1].float() + c[:, 2].float()) * t[:, 10])
    np.testing.assert_array_equal(out, want.numpy())


def _serial_and_warp(lib, P, cols, is_mem, addr, hw_rows, M):
    n = is_mem.shape[0]
    serial, warp = (np.empty((n, P), np.int32) for _ in range(2))
    rounds = np.empty(n, np.int32)
    lib.h_mem_schedule(P, cols, _p(_i32(is_mem)), _p(addr), _p(hw_rows),
                       ctypes.c_int32(M), _p(serial), ctypes.c_int64(n))
    lib.h_mem_schedule_warp(P, cols, _p(_i32(is_mem)), _p(addr),
                            _p(hw_rows), ctypes.c_int32(M), _p(warp),
                            _p(rounds), ctypes.c_int64(n))
    return serial, warp, rounds


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       shape=st.sampled_from([(4, 4), (2, 4), (1, 2), (4, 8), (2, 2),
                              (1, 1), (2, 8), (8, 4)]),
       bus=st.sampled_from([0, 1]), interleaved=st.booleans(),
       n_banks=st.sampled_from([1, 2, 3, 4, 8, 16, 32, 256]),
       dma_per_pe=st.booleans(), t_mem=st.integers(1, 5),
       density=st.floats(0.0, 1.0),
       spread=st.sampled_from([1, 3, 16, 48, 4096]))
def test_warp_parallel_scheduler_equals_serial(lib, seed, shape, bus,
                                               interleaved, n_banks,
                                               dma_per_pe, t_mem, density,
                                               spread):
    """The kernel's relaxation, run on the masks the warp intrinsics
    give, equals the serial greedy schedule and the plain version's
    completion times bit for bit, in at most P + 1 rounds."""
    rows, cols = shape
    P, M, n = rows * cols, 4096, 300
    rng = np.random.default_rng(seed)
    hw = hwconfig.stack_configs([hwconfig.HwConfig(
        bus=bus, interleaved=int(interleaved), n_banks=n_banks,
        dma_per_pe=int(dma_per_pe), t_mem=t_mem)] * n)
    hw_rows = _i32(np.stack([getattr(hw, f).numpy() for f in
                             ("smul_lat", "bus", "interleaved", "n_banks",
                              "dma_per_pe", "t_mem")], axis=1))
    is_mem = rng.random((n, P)) < density
    addr = _i32((rng.integers(-M, M, (n, 1))
                 + rng.integers(0, spread, (n, P))) % M)
    serial, warp, rounds = _serial_and_warp(lib, P, cols, is_mem, addr,
                                            hw_rows, M)
    np.testing.assert_array_equal(warp, serial)
    want = memory.mem_completion_times(torch.as_tensor(is_mem),
                                       torch.as_tensor(addr), hw, M, cols)
    np.testing.assert_array_equal(warp, want.numpy())
    assert rounds.min() >= 1 and rounds.max() <= P + 1


def test_warp_parallel_scheduler_on_the_topologies(lib):
    """Every topology and bank count of the test above's table of
    configurations, many requests to few banks (deep queues)."""
    rng = np.random.default_rng(21)
    n, P, cols, M = 4000, 16, 4, 4096
    hw, hw_rows = _hw_rows(rng, n)
    is_mem = rng.random((n, P)) < 0.8
    addr = _i32(rng.integers(0, 8, (n, P)) * rng.integers(1, 600, (n, 1)))
    serial, warp, rounds = _serial_and_warp(lib, P, cols, is_mem, addr,
                                            hw_rows, M)
    np.testing.assert_array_equal(warp, serial)
    # the start from each request's queue ranks settles most instructions
    # in the first round, which only confirms them
    assert np.mean(rounds <= 2) > 0.5


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       P=st.sampled_from([1, 2, 4, 8, 16, 32]),
       n_addr=st.sampled_from([1, 2, 6, 4096]), density=st.floats(0.0, 1.0))
def test_store_arbitration_by_match_equals_serial(lib, seed, P, n_addr,
                                                  density):
    rng = np.random.default_rng(seed)
    n = 400
    is_store = _i32(rng.random((n, P)) < density)
    addr = _i32(rng.integers(0, n_addr, (n, P)))
    serial, warp = (np.empty((n, P), np.int32) for _ in range(2))
    lib.h_store_lands(P, _p(is_store), _p(addr), _p(serial),
                      ctypes.c_int64(n))
    lib.h_store_lands_warp(P, _p(is_store), _p(addr), _p(warp),
                           ctypes.c_int64(n))
    np.testing.assert_array_equal(warp, serial)


def test_lane_masks(lib):
    below, above = ctypes.c_uint32(), ctypes.c_uint32()
    top = ctypes.c_int32()
    for lane in range(32):
        for m in (0, 1, 1 << lane, 0xFFFFFFFF, 0x80000000 | (1 << lane)):
            lib.h_lane_masks(lane, ctypes.byref(below), ctypes.byref(above),
                             ctypes.byref(top), ctypes.c_uint32(m))
            assert below.value == (1 << lane) - 1
            assert above.value == 0xFFFFFFFF & ~((2 << lane) - 1)
            assert top.value == (m.bit_length() - 1 if m else -1)

"""Frozen copy of src/repro_torch/apps/mibench.py for the benchmark: only
its imports differ (the benchmark's own program builder, ``isa.py``).

Five MiBench-inspired benchmark kernels mapped to the 4x4 CGRA.

The paper validates on "five kernels from the MiBench benchmark suite" but
does not list them; we pick five representative inner loops across the
suite's categories (assumption change, DESIGN.md):

  bitcnt         automotive/bitcount  -- per-PE popcount + neighbour-tree sum
  crc32          telecomm/CRC32       -- bit-serial CRC on a single PE
  susan_thresh   automotive/susan     -- |x - c| > t thresholding, 16-wide
  dijkstra_relax network/dijkstra     -- relaxation sweep, 16 nodes in parallel
  sha_mix        security/sha         -- rotate/xor/add mixing rounds, 16-wide

Each kernel returns a KernelCase whose ``check`` validates the CGRA's final
memory against a numpy oracle.  The set intentionally spans execution
profiles: serial vs parallel, ALU-bound vs memory-bound, data-dependent vs
fixed control flow -- so the Figure-2 error ladder is exercised across
regimes.

Register conventions are per-kernel; PE indices are row-major on the 4x4
torus.  Branch semantics note: a shared-PC branch is taken if *any* PE's
condition fires, so data-dependent loops iterate until the slowest PE is
done (all kernels below are written to be idempotent in the extra
iterations, e.g. popcount of an already-zero word).
"""
from __future__ import annotations

import numpy as np

from .isa import MEM_SIZE, KernelCase, ProgramBuilder, asm, fresh_mem

_ALL = list(range(16))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# 1. bitcnt
# ---------------------------------------------------------------------------

def bitcnt(n_words: int = 64, seed: int = 1) -> KernelCase:
    """Sum of popcounts of n_words 16-bit values at A=0 -> mem[1024].

    Each PE p handles words p, p+16, ...; a data-dependent inner loop
    shifts its word until zero; the 16 per-PE accumulators are reduced over
    the torus (columns to row 3, then along the row to PE15)."""
    assert n_words % 16 == 0
    A, OUT = 0, 1024
    per_pe = n_words // 16
    rng = _rng(seed)
    words = rng.integers(0, 1 << 16, n_words).astype(np.int32)

    pb = ProgramBuilder(16, "bitcnt")
    # R0 = ptr, R1 = acc, R2 = outer counter
    pb.instr({p: asm("MV", "R0", "IMM", imm=A + p) for p in _ALL})
    pb.instr({p: asm("MV", "R2", "IMM", imm=per_pe) for p in _ALL})
    outer = pb.instr({p: asm("LWI", "R3", "R0") for p in _ALL})
    bit = pb.instr({p: asm("LAND", "ROUT", "R3", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("SADD", "R1", "R1", "ROUT") for p in _ALL})
    pb.instr({p: asm("SRL", "R3", "R3", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("BNE", a="R3", b="ZERO", imm=bit) for p in _ALL})
    pb.instr({p: asm("SADD", "R0", "R0", "IMM", imm=16) for p in _ALL})
    pb.instr({p: asm("SSUB", "R2", "R2", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("BNE", a="R2", b="ZERO", imm=outer) for p in _ALL})
    # Tree reduction: expose accs, fold rows downward, then along row 3.
    pb.instr({p: asm("MV", "ROUT", "R1") for p in _ALL})
    pb.instr({p: asm("SADD", "ROUT", "ROUT", "RCT") for p in (4, 5, 6, 7)})
    pb.instr({p: asm("SADD", "ROUT", "ROUT", "RCT") for p in (8, 9, 10, 11)})
    pb.instr({p: asm("SADD", "ROUT", "ROUT", "RCT") for p in (12, 13, 14, 15)})
    pb.instr({13: asm("SADD", "ROUT", "ROUT", "RCL")})
    pb.instr({14: asm("SADD", "ROUT", "ROUT", "RCL")})
    pb.instr({15: asm("SADD", "ROUT", "ROUT", "RCL")})
    pb.instr({15: asm("SWD", a="ROUT", imm=OUT)})
    pb.exit()

    mem = fresh_mem()
    mem[A:A + n_words] = words
    expect = int(sum(bin(w & 0xFFFF).count("1") for w in words))

    def check(final_mem: np.ndarray) -> bool:
        return int(final_mem[OUT]) == expect

    return KernelCase("bitcnt", pb.build(), mem, check,
                      np.array([expect]), max_steps=1024,
                      notes=f"{n_words} words, popcount sum={expect}")


# ---------------------------------------------------------------------------
# 2. crc32
# ---------------------------------------------------------------------------

POLY = 0xEDB88320


def crc32(n_words: int = 6, seed: int = 2) -> KernelCase:
    """Bit-serial CRC-32 (reflected poly) over n_words at A=0 -> mem[1100].

    Entirely serial on PE0 (15 PEs idle): the pathological case for idle
    power (estimator case (v)) and the paper's observation that long
    instructions amortize decode power."""
    A, OUT = 0, 1100
    rng = _rng(seed)
    words = rng.integers(0, 1 << 31, n_words).astype(np.int32)

    pb = ProgramBuilder(16, "crc32")
    # PE0: R0 = scratch/mask, R1 = crc (init ~0), R2 = word ctr (down),
    # R3 = bit ctr.  The word pointer is recomputed from R2 (A == 0), which
    # frees R0 for the poly mask -- every ALU op writes ROUT, so the mask
    # must survive in a register across the SRL.
    pb.instr({0: asm("SSUB", "R1", "ZERO", "IMM", imm=1)})   # crc = -1
    pb.instr({0: asm("MV", "R2", "IMM", imm=n_words)})
    word = pb.instr({0: asm("SSUB", "ROUT", "IMM", "R2", imm=n_words)})
    pb.instr({0: asm("LWI", "ROUT", "ROUT")})                 # w = mem[idx]
    pb.instr({0: asm("LXOR", "R1", "R1", "ROUT")})
    pb.instr({0: asm("MV", "R3", "IMM", imm=32)})
    bit = pb.instr({0: asm("SLL", "R0", "R1", "IMM", imm=31)})  # bit<<31
    pb.instr({0: asm("SRA", "R0", "R0", "IMM", imm=31)})      # mask = -bit
    pb.instr({0: asm("LAND", "R0", "R0", "IMM", imm=POLY - (1 << 32))})
    pb.instr({0: asm("SRL", "R1", "R1", "IMM", imm=1)})
    pb.instr({0: asm("LXOR", "R1", "R1", "R0")})
    pb.instr({0: asm("SSUB", "R3", "R3", "IMM", imm=1)})
    pb.instr({0: asm("BNE", a="R3", b="ZERO", imm=bit)})
    pb.instr({0: asm("SSUB", "R2", "R2", "IMM", imm=1)})
    pb.instr({0: asm("BNE", a="R2", b="ZERO", imm=word)})
    pb.instr({0: asm("SWD", a="R1", imm=OUT)})
    pb.exit()

    mem = fresh_mem()
    mem[A:A + n_words] = words

    crc = 0xFFFFFFFF
    for w in words.astype(np.int64) & 0xFFFFFFFF:
        crc ^= int(w)
        for _ in range(32):
            crc = (crc >> 1) ^ (POLY if crc & 1 else 0)
    expect = np.int32(crc - (1 << 32) if crc >= (1 << 31) else crc)

    def check(final_mem: np.ndarray) -> bool:
        return np.int32(final_mem[OUT]) == expect

    return KernelCase("crc32", pb.build(), mem, check,
                      np.array([expect]), max_steps=1600,
                      notes=f"{n_words} words, serial on PE0")


# ---------------------------------------------------------------------------
# 3. susan_thresh
# ---------------------------------------------------------------------------

def susan_thresh(n_pixels: int = 64, thresh: int = 20,
                 seed: int = 3) -> KernelCase:
    """USAN thresholding: out[i] = (|x[i] - c| > t), 16 pixels per sweep.

    Image at A=0, centre pixel value at C=512, output at OUT=1536.
    Memory-bound: 16 parallel loads + 16 parallel stores per sweep."""
    assert n_pixels % 16 == 0
    A, C, OUT = 0, 512, 1536
    per_pe = n_pixels // 16
    rng = _rng(seed)
    img = rng.integers(0, 256, n_pixels).astype(np.int32)
    centre = int(rng.integers(0, 256))

    pb = ProgramBuilder(16, "susan_thresh")
    # |d| > t  <=>  (t < d) | (d < -t): avoids the two-temp abs sequence
    # (every ALU op writes ROUT, so a sign mask cannot live there).  The
    # centre pixel is re-loaded each sweep (R1 doubles as scratch), adding
    # a same-address 16-way load -- a bus-contention stress by design.
    pb.instr({p: asm("MV", "R0", "IMM", imm=A + p) for p in _ALL})
    pb.instr({p: asm("MV", "R2", "IMM", imm=per_pe) for p in _ALL})
    loop = pb.instr({p: asm("LWI", "R3", "R0") for p in _ALL})     # x
    pb.instr({p: asm("LWD", "R1", imm=C) for p in _ALL})           # centre
    pb.instr({p: asm("SSUB", "R3", "R3", "R1") for p in _ALL})     # d
    pb.instr({p: asm("SLT", "R1", "IMM", "R3", imm=thresh) for p in _ALL})
    pb.instr({p: asm("SLT", "R3", "R3", "IMM", imm=-thresh) for p in _ALL})
    pb.instr({p: asm("LOR", "R3", "R1", "R3") for p in _ALL})      # |d|>t
    pb.instr({p: asm("SADD", "ROUT", "R0", "IMM", imm=OUT - A) for p in _ALL})
    pb.instr({p: asm("SWI", a="ROUT", b="R3") for p in _ALL})
    pb.instr({p: asm("SADD", "R0", "R0", "IMM", imm=16) for p in _ALL})
    pb.instr({p: asm("SSUB", "R2", "R2", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("BNE", a="R2", b="ZERO", imm=loop) for p in _ALL})
    pb.exit()

    mem = fresh_mem()
    mem[A:A + n_pixels] = img
    mem[C] = centre
    expect = (np.abs(img - centre) > thresh).astype(np.int32)

    def check(final_mem: np.ndarray) -> bool:
        return bool((final_mem[OUT:OUT + n_pixels] == expect).all())

    return KernelCase("susan_thresh", pb.build(), mem, check, expect,
                      max_steps=512, notes=f"{n_pixels} px, t={thresh}")


# ---------------------------------------------------------------------------
# 4. dijkstra_relax
# ---------------------------------------------------------------------------

def dijkstra_relax(seed: int = 4) -> KernelCase:
    """One full relaxation pass over a 16-node complete graph.

    dist[] at D=0 (16 words), weight matrix W[u, j] at WM=16 (row-major
    16x16).  For u = 0..15: dist[j] = min(dist[j], dist[u] + W[u, j]) with
    PE j handling node j.  The repeated same-address load of dist[u] by all
    16 PEs is the bus-contention stress case."""
    D, WM = 0, 16
    rng = _rng(seed)
    w = rng.integers(1, 50, (16, 16)).astype(np.int32)
    np.fill_diagonal(w, 0)
    dist0 = rng.integers(0, 200, 16).astype(np.int32)

    pb = ProgramBuilder(16, "dijkstra_relax")
    # R0 = u (loop var); R1/R2/R3 are dead across iterations, so R1 doubles
    # as the loop-condition temp (a branch immediate is the *target*, so
    # "u != 16" needs an SLT into a register first).
    # min(x, y) = y ^ ((x ^ y) & -(x < y)); the x^y temp is computed first
    # so the -(x<y) mask can live in ROUT (last writer before LAND).
    pb.instr({p: asm("MV", "R0", "IMM", imm=0) for p in _ALL})
    loop = pb.instr({p: asm("LWI", "R1", "R0") for p in _ALL})     # dist[u]
    # W row address: WM + u*16 + j
    pb.instr({p: asm("SLL", "ROUT", "R0", "IMM", imm=4) for p in _ALL})
    pb.instr({p: asm("SADD", "ROUT", "ROUT", "IMM", imm=WM + p) for p in _ALL})
    pb.instr({p: asm("LWI", "R2", "ROUT") for p in _ALL})          # W[u,j]
    pb.instr({p: asm("SADD", "R2", "R1", "R2") for p in _ALL})     # cand
    pb.instr({p: asm("LWD", "R3", imm=D + p) for p in _ALL})       # dist[j]
    pb.instr({p: asm("LXOR", "R1", "R2", "R3") for p in _ALL})     # x^y
    pb.instr({p: asm("SLT", "ROUT", "R2", "R3") for p in _ALL})    # cand<dj
    pb.instr({p: asm("SSUB", "ROUT", "ZERO", "ROUT") for p in _ALL})  # mask
    pb.instr({p: asm("LAND", "R1", "R1", "ROUT") for p in _ALL})
    pb.instr({p: asm("LXOR", "R1", "R1", "R3") for p in _ALL})     # min
    pb.instr({p: asm("SWD", a="R1", imm=D + p) for p in _ALL})
    pb.instr({p: asm("SADD", "R0", "R0", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("SLT", "R1", "R0", "IMM", imm=16) for p in _ALL})
    pb.instr({p: asm("BNE", a="R1", b="ZERO", imm=loop) for p in _ALL})
    pb.exit()
    prog = pb.build()

    mem = fresh_mem()
    mem[D:D + 16] = dist0
    mem[WM:WM + 256] = w.reshape(-1)

    dist = dist0.copy()
    for u in range(16):
        dist = np.minimum(dist, dist[u] + w[u])
    expect = dist

    def check(final_mem: np.ndarray) -> bool:
        return bool((final_mem[D:D + 16] == expect).all())

    return KernelCase("dijkstra_relax", prog, mem, check, expect,
                      max_steps=512, notes="16-node complete graph")


# ---------------------------------------------------------------------------
# 5. sha_mix
# ---------------------------------------------------------------------------

def sha_mix(rounds: int = 24, seed: int = 5) -> KernelCase:
    """SHA-style mixing: 16 words of state, one per PE; each round
    x = rotl(x, 5) ^ left_neighbour + 0x5A827999 (wrapping int32).

    Pure-ALU, zero memory traffic inside the loop: the compute-bound
    extreme of the benchmark set."""
    A, OUT = 0, 2048
    rng = _rng(seed)
    state0 = rng.integers(0, 1 << 31, 16).astype(np.int32)
    K = 0x5A827999

    pb = ProgramBuilder(16, "sha_mix")
    # ROUT discipline: every ALU op writes ROUT, so the loop is ordered so
    # that the *last* ROUT writer of an iteration is the new state (SADD
    # R1; the branch writes nothing) -- each PE then snapshots its left
    # neighbour's exposed state into R0 in the first loop instruction
    # (neighbour ROUTs are sampled at instruction start, so all PEs see the
    # pre-clobber value).
    pb.instr({p: asm("MV", "R2", "IMM", imm=rounds) for p in _ALL})
    pb.instr({p: asm("LWD", "R1", imm=A + p) for p in _ALL})  # also exposes
    loop = pb.instr({p: asm("MV", "R0", "RCL") for p in _ALL})     # left x
    pb.instr({p: asm("SLL", "R3", "R1", "IMM", imm=5) for p in _ALL})
    pb.instr({p: asm("SRL", "ROUT", "R1", "IMM", imm=27) for p in _ALL})
    pb.instr({p: asm("LOR", "R3", "R3", "ROUT") for p in _ALL})    # rotl5
    pb.instr({p: asm("LXOR", "R3", "R3", "R0") for p in _ALL})     # ^ left
    pb.instr({p: asm("SSUB", "R2", "R2", "IMM", imm=1) for p in _ALL})
    pb.instr({p: asm("SADD", "R1", "R3", "IMM", imm=K) for p in _ALL})
    pb.instr({p: asm("BNE", a="R2", b="ZERO", imm=loop) for p in _ALL})
    pb.instr({p: asm("SWD", a="R1", imm=OUT + p) for p in _ALL})
    pb.exit()

    mem = fresh_mem()
    mem[A:A + 16] = state0

    s = state0.astype(np.uint32)
    for _ in range(rounds):
        rot = ((s << np.uint32(5)) | (s >> np.uint32(27))) & np.uint32(
            0xFFFFFFFF)
        left = np.roll(s, 1)  # PE p's RCL is PE (p-1) in the same row? torus
        # torus rows of 4: left neighbour of PE p (row r, col c) is
        # (r, (c-1) % 4)
        idx = np.arange(16)
        r, c = idx // 4, idx % 4
        left = s[r * 4 + (c - 1) % 4]
        s = (rot ^ left) + np.uint32(K)
    expect = s.astype(np.int32)

    def check(final_mem: np.ndarray) -> bool:
        return bool((final_mem[OUT:OUT + 16].astype(np.int32)
                     == expect).all())

    return KernelCase("sha_mix", pb.build(), mem, check, expect,
                      max_steps=512, notes=f"{rounds} rounds, ALU-bound")


def all_kernels():
    return [bitcnt(), crc32(), susan_thresh(), dijkstra_relax(), sha_mix()]

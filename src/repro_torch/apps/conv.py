"""The four convolution mappings of the paper's Section 3.1 (Fig. 3/4).

From Carpentieri et al. [16], "Performance evaluation of acceleration of
convolutional layers on OpenEdgeCGRA":

  conv-WP    Weight Parallelism: the 9 taps of a 3x3 filter live in the
             registers of a 3x3 PE sub-grid; products are tree-reduced over
             the torus; one output pixel is accumulated per inner-loop pass.
             Its 11-instruction loop mirrors the paper's Fig. 4 structure
             (one SMUL-heavy instruction, SADD-tree instructions, one
             LWI/SWI + pointer instruction).
  Im2col-IP  Input-channel Parallelism over an im2col patch matrix: phase 1
             materializes the (n_px, C_in*9) patch matrix in memory (the
             im2col cost is real data movement, which is the point of the
             comparison); phase 2 maps PE columns to input-channel slices
             and PE rows to output pixels, reducing across the row.
  Im2col-OP  Output-channel Parallelism over the same patch matrix: PE rows
             are output channels, PE columns are output pixels; each PE
             owns a full 36-element dot product, no cross-PE reduction.
  conv-OP    Channel-Output (spatial) Parallelism, direct convolution: all
             16 PEs compute 16 different output pixels of one output
             channel; every PE loads the *same* weight word each MAC step
             (broadcast -> worst-case 1-to-M bus contention).

All four compute the identical layer and are checked against one numpy
oracle:   C_in = C_out = 4, 10x10 inputs, 3x3 valid conv -> 8x8 outputs.

Register discipline (every ALU/load op also writes ROUT -- see isa.py):
values that must survive a neighbour read or an intermediate op live in
R0..R3; reduction trees are scheduled so the producer's ROUT is consumed
before any other op on that PE clobbers it.

Memory map (words):
  XB=0     x[ci, i, j]          at XB + ci*100 + i*10 + j      (400 words)
  WB=512   w[co, ci, r, c]      at WB + co*36 + ci*9 + r*3 + c (144 words)
  OB=1024  out[co, p]           at OB + co*64 + p, p = i*8 + j (256 words)
  IM=1536  im2col M[p, m]       at IM + p*36 + m               (2304 words)
  CNT=4000 scratch loop counter (mappings whose PEs have no spare register)
"""
from __future__ import annotations

import numpy as np

from ..core.isa import asm
from ..core.program import ProgramBuilder
from .common import MEM_SIZE, KernelCase, fresh_mem

# Layer geometry.
C_IN, C_OUT, H, W, K = 4, 4, 10, 10, 3
OH, OW = H - K + 1, W - K + 1          # 8 x 8
N_PX = OH * OW                          # 64

XB, WB, OB, IM, CNT = 0, 512, 1024, 1536, 4000

_ALL = list(range(16))
# The 3x3 compute sub-grid used by conv-WP (row-major on the 4x4 array).
_GRID9 = [(r, c) for r in range(3) for c in range(3)]
_PE9 = [r * 4 + c for r, c in _GRID9]


# Input-channel placement stride.  The default packs channels contiguously
# (all of x lands in SRAM bank 0 under the blocked 4-bank mapping); the
# bank-aware variant (see conv_wp(ci_stride=1024), benchmarks/fig5) puts
# one channel per bank so the N-to-M bus can actually parallelize loads --
# the data-placement/bus-type coupling the DSE tool exists to surface.
_CI_STRIDE = H * W


def _x_addr(ci: int, i: int, j: int, ci_stride: int = _CI_STRIDE,
            x_base: int = XB) -> int:
    return x_base + ci * ci_stride + i * W + j


def _w_addr(co: int, ci: int, r: int, c: int) -> int:
    return WB + co * (C_IN * K * K) + ci * (K * K) + r * K + c


def _o_addr(co: int, p: int) -> int:
    return OB + co * N_PX + p


def layer_data(seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, (C_IN, H, W)).astype(np.int32)
    w = rng.integers(-4, 4, (C_OUT, C_IN, K, K)).astype(np.int32)
    return x, w


def conv_oracle(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(C_OUT, OH, OW) int32 valid convolution (cross-correlation)."""
    out = np.zeros((C_OUT, OH, OW), np.int64)
    for co in range(C_OUT):
        for ci in range(C_IN):
            for r in range(K):
                for c in range(K):
                    out[co] += (x[ci, r:r + OH, c:c + OW].astype(np.int64)
                                * int(w[co, ci, r, c]))
    return out.astype(np.int32)


def _layer_mem(x: np.ndarray, w: np.ndarray,
               ci_stride: int = _CI_STRIDE, x_base: int = XB) -> np.ndarray:
    mem = fresh_mem()
    for ci in range(C_IN):
        lo = x_base + ci * ci_stride
        mem[lo:lo + H * W] = x[ci].reshape(-1)
    mem[WB:WB + C_OUT * C_IN * K * K] = w.reshape(-1)
    return mem


def _case(name: str, pb: ProgramBuilder, x, w, max_steps: int,
          notes: str, ci_stride: int = _CI_STRIDE,
          x_base: int = XB) -> KernelCase:
    expect = conv_oracle(x, w).reshape(C_OUT, N_PX)

    def check(final_mem: np.ndarray) -> bool:
        got = final_mem[OB:OB + C_OUT * N_PX].reshape(C_OUT, N_PX)
        return bool((got == expect).all())

    return KernelCase(name, pb.build(),
                      _layer_mem(x, w, ci_stride, x_base), check, expect,
                      max_steps=max_steps, notes=notes)


# ---------------------------------------------------------------------------
# conv-WP: weight parallelism (the paper's Fig. 4 mapping)
# ---------------------------------------------------------------------------

def conv_wp(seed: int = 7, *, ci_stride: int = _CI_STRIDE,
            x_base: int = XB) -> KernelCase:
    """9 filter taps in parallel; tree reduction to the centre PE (5).

    Per (co, ci) segment: taps w[co,ci,:,:] are pinned in R0 of the 3x3
    sub-grid; the inner loop slides over the 64 output pixels accumulating
    into out[co, p] in memory (so the ci loop accumulates across segments).
    PE5: R0=w R1=in-ptr R2=sum R3=out-ptr; PE12 runs the (i, j) counters.
    """
    x, w = layer_data(seed)
    pb = ProgramBuilder(16, "conv_wp")
    for co in range(C_OUT):
        for ci in range(C_IN):
            # -- prologue: load taps, reset pointers -----------------------
            pb.instr({r * 4 + c: asm("LWD", "R0", imm=_w_addr(co, ci, r, c))
                      for r, c in _GRID9})
            pb.instr({r * 4 + c: asm("MV", "R1", "IMM",
                                     imm=_x_addr(ci, r, c, ci_stride,
                                                 x_base))
                      for r, c in _GRID9})
            pb.instr({5: asm("MV", "R3", "IMM", imm=_o_addr(co, 0)),
                      12: asm("MV", "R1", "IMM", imm=OH)})
            iloop = pb.instr({12: asm("MV", "R0", "IMM", imm=OW)})
            # -- inner loop: one output pixel per pass ---------------------
            jloop = pb.instr({p: asm("LWI", "R2", "R1") for p in _PE9})
            pb.instr({**{p: asm("SMUL", "R2", "R2", "R0") for p in _PE9},
                      12: asm("SSUB", "R0", "R0", "IMM", imm=1)})
            pb.instr({p: asm("SADD", "R2", "R2", "RCT") for p in (4, 5, 6)})
            pb.instr({p: asm("SADD", "R2", "R2", "RCB") for p in (4, 5, 6)})
            pb.instr({**{5: asm("SADD", "R2", "R2", "RCL")},
                      **{p: asm("SADD", "R1", "R1", "IMM", imm=1)
                         for p in (0, 1, 2, 8, 9, 10)}})
            pb.instr({5: asm("SADD", "R2", "R2", "RCR"),
                      4: asm("SADD", "R1", "R1", "IMM", imm=1)})
            pb.instr({5: asm("LWI", "ROUT", "R3"),
                      6: asm("SADD", "R1", "R1", "IMM", imm=1)})
            pb.instr({5: asm("SADD", "ROUT", "R2", "ROUT")})
            pb.instr({5: asm("SWI", a="R3", b="ROUT")})
            pb.instr({5: asm("SADD", "R3", "R3", "IMM", imm=1)})
            pb.instr({5: asm("SADD", "R1", "R1", "IMM", imm=1),
                      12: asm("BNE", a="R0", b="ZERO", imm=jloop)})
            # -- row end: skip the K-1 rightmost input columns -------------
            pb.instr({**{p: asm("SADD", "R1", "R1", "IMM", imm=K - 1)
                         for p in _PE9},
                      12: asm("SSUB", "R1", "R1", "IMM", imm=1)})
            pb.instr({12: asm("BNE", a="R1", b="ZERO", imm=iloop)})
    pb.exit()
    return _case("conv-WP", pb, x, w, max_steps=13000,
                 notes="9-tap weight parallelism, Fig.4-style loop",
                 ci_stride=ci_stride, x_base=x_base)


def conv_wp_bank_spread(seed: int = 7) -> KernelCase:
    """conv-WP with one input channel per SRAM bank (x_base=700,
    stride 1024): under the *blocked* N-to-M bus (mod b) the 9-tap loads
    now split across banks -- the data-placement/bus-type coupling study
    of benchmarks/fig5."""
    k = conv_wp(seed, ci_stride=1024, x_base=700)
    return KernelCase("conv-WP/bank-spread", k.program, k.mem_init,
                      k.check, k.expected, max_steps=k.max_steps,
                      notes="channel-per-bank placement")


# ---------------------------------------------------------------------------
# im2col phase 1 (shared by Im2col-IP / Im2col-OP)
# ---------------------------------------------------------------------------

def _emit_im2col(pb: ProgramBuilder) -> None:
    """Materialize M[p, m] = x[ci, i+r, j+c] (m = ci*9 + r*3 + c).

    16 PEs own 16 pixels per group; 4 groups cover the 64 pixels.  Per PE:
    R1 = own pixel base (i*10+j), R2 = own patch row base, R3 = loaded word.
    PE15 keeps the group counter in R0 (its only spare register).
    """
    pb.instr({p: asm("MV", "R1", "IMM", imm=(p // OW) * W + (p % OW))
              for p in _ALL})
    pb.instr({p: asm("MV", "R2", "IMM", imm=IM + p * (C_IN * K * K))
              for p in _ALL})
    pb.instr({15: asm("MV", "R0", "IMM", imm=N_PX // 16)})
    gloop = pb.instr({15: asm("SSUB", "R0", "R0", "IMM", imm=1)})
    for ci in range(C_IN):
        for r in range(K):
            for c in range(K):
                m = ci * K * K + r * K + c
                off = XB + ci * (H * W) + r * W + c
                pb.instr({p: asm("SADD", "ROUT", "R1", "IMM", imm=off)
                          for p in _ALL})
                pb.instr({p: asm("LWI", "R3", "ROUT") for p in _ALL})
                pb.instr({p: asm("SADD", "ROUT", "R2", "IMM", imm=m)
                          for p in _ALL})
                pb.instr({p: asm("SWI", a="ROUT", b="R3") for p in _ALL})

    # 16 pixels per group = 2 full output rows -> input base += 2*W.
    pb.instr({p: asm("SADD", "R1", "R1", "IMM", imm=2 * W) for p in _ALL})
    pb.instr({p: asm("SADD", "R2", "R2", "IMM", imm=16 * C_IN * K * K)
              for p in _ALL})
    pb.instr({15: asm("BNE", a="R0", b="ZERO", imm=gloop)})


# ---------------------------------------------------------------------------
# Im2col-IP: input-channel parallelism
# ---------------------------------------------------------------------------

def im2col_ip(seed: int = 7) -> KernelCase:
    """PE columns = input-channel slices of the patch row, PE rows = 4
    consecutive output pixels; serial ripple-add across each row; column-3
    PEs store.  Weight loads hit 4 distinct addresses (one per slice).

    Per PE (row rr, col ci): R1 = M-row ptr + ci*9, R2 = scratch, R3 = acc;
    col-3 PEs: R0 = out ptr; PE12 (col 0): R0 = group counter."""
    x, w = layer_data(seed)
    pb = ProgramBuilder(16, "im2col_ip")
    _emit_im2col(pb)
    n_g = N_PX // 4
    for co in range(C_OUT):
        pb.instr({rr * 4 + ci: asm("MV", "R1", "IMM",
                                   imm=IM + rr * (C_IN * K * K) + ci * K * K)
                  for rr in range(4) for ci in range(C_IN)})
        pb.instr({rr * 4 + 3: asm("MV", "R0", "IMM", imm=_o_addr(co, rr))
                  for rr in range(4)})
        pb.instr({12: asm("MV", "R0", "IMM", imm=n_g)})
        gloop = pb.instr({p: asm("MV", "R3", "ZERO") for p in _ALL})
        for k in range(K * K):
            pb.instr({rr * 4 + ci: asm("SADD", "ROUT", "R1", "IMM", imm=k)
                      for rr in range(4) for ci in range(C_IN)})
            pb.instr({p: asm("LWI", "ROUT", "ROUT") for p in _ALL})
            pb.instr({rr * 4 + ci: asm("SMUL", "R2", "ROUT", "IMM",
                                       imm=int(w.reshape(C_OUT, -1)
                                               [co, ci * K * K + k]))
                      for rr in range(4) for ci in range(C_IN)})
            pb.instr({p: asm("SADD", "R3", "R3", "R2") for p in _ALL})
        # ripple reduction: col1 += col0, col2 += col1, col3 += col2
        pb.instr({p: asm("MV", "ROUT", "R3") for p in _ALL})
        for cc in (1, 2, 3):
            pb.instr({rr * 4 + cc: asm("SADD", "ROUT", "ROUT", "RCL")
                      for rr in range(4)})
        pb.instr({**{rr * 4 + 3: asm("SWI", a="R0", b="ROUT")
                     for rr in range(4)},
                  12: asm("SSUB", "R0", "R0", "IMM", imm=1)})
        pb.instr({p: asm("SADD", "R1", "R1", "IMM", imm=4 * C_IN * K * K)
                  for p in _ALL})
        pb.instr({rr * 4 + 3: asm("SADD", "R0", "R0", "IMM", imm=4)
                  for rr in range(4)})
        pb.instr({12: asm("BNE", a="R0", b="ZERO", imm=gloop)})
    pb.exit()
    return _case("Im2col-IP", pb, x, w, max_steps=9000,
                 notes="im2col build + input-channel-parallel matmul; "
                       "weights folded as immediates (4 px/row tile)")


# ---------------------------------------------------------------------------
# Im2col-OP: output-channel parallelism
# ---------------------------------------------------------------------------

def im2col_op(seed: int = 7) -> KernelCase:
    """PE rows = output channels, PE columns = 4 consecutive pixels; each PE
    owns a full 36-MAC dot product (no reduction).  All four registers are
    live (R0 out-ptr, R1 M-ptr, R2 scratch, R3 acc), so the group counter
    lives in memory at CNT, serviced by PE15 during the store instruction.
    """
    x, w = layer_data(seed)
    pb = ProgramBuilder(16, "im2col_op")
    _emit_im2col(pb)
    n_g = N_PX // 4
    pb.instr({co * 4 + cc: asm("MV", "R1", "IMM", imm=IM + cc * (C_IN * K * K))
              for co in range(C_OUT) for cc in range(4)})
    pb.instr({co * 4 + cc: asm("MV", "R0", "IMM", imm=_o_addr(co, cc))
              for co in range(C_OUT) for cc in range(4)})
    pb.instr({15: asm("MV", "R2", "IMM", imm=n_g)})
    pb.instr({15: asm("SWD", a="R2", imm=CNT)})
    gloop = pb.instr({p: asm("MV", "R3", "ZERO") for p in _ALL})
    for m in range(C_IN * K * K):
        pb.instr({p: asm("SADD", "ROUT", "R1", "IMM", imm=m) for p in _ALL})
        pb.instr({p: asm("LWI", "R2", "ROUT") for p in _ALL})
        # weight lands in ROUT only (a LWD with a register dest would
        # clobber the x just loaded into ROUT's write-through twin R2).
        pb.instr({co * 4 + cc: asm("LWD", "ROUT", imm=WB + co * 36 + m)
                  for co in range(C_OUT) for cc in range(4)})
        pb.instr({p: asm("SMUL", "R2", "R2", "ROUT") for p in _ALL})
        pb.instr({p: asm("SADD", "R3", "R3", "R2") for p in _ALL})
    pb.instr({p: asm("SWI", a="R0", b="R3") for p in _ALL})
    pb.instr({**{p: asm("SADD", "R1", "R1", "IMM", imm=4 * C_IN * K * K)
                 for p in (q for q in _ALL if q != 15)},
              15: asm("LWD", "R2", imm=CNT)})
    pb.instr({**{p: asm("SADD", "R0", "R0", "IMM", imm=4)
                 for p in (q for q in _ALL if q != 15)},
              15: asm("SSUB", "R2", "R2", "IMM", imm=1)})
    pb.instr({15: asm("SWD", a="R2", imm=CNT)})
    pb.instr({15: asm("SADD", "R1", "R1", "IMM", imm=4 * C_IN * K * K)})
    pb.instr({15: asm("SADD", "R0", "R0", "IMM", imm=4)})
    pb.instr({15: asm("BNE", a="R2", b="ZERO", imm=gloop)})
    pb.exit()
    return _case("Im2col-OP", pb, x, w, max_steps=9000,
                 notes="im2col build + output-channel-parallel dot products")


# ---------------------------------------------------------------------------
# conv-OP: spatial (channel-output) parallelism, direct convolution
# ---------------------------------------------------------------------------

def conv_op(seed: int = 7) -> KernelCase:
    """All 16 PEs = 16 output pixels of one output channel; output channels
    processed sequentially (unrolled).  Every MAC step broadcasts one weight
    word to all 16 PEs -- the 1-to-M bus serializes the 16 identical loads,
    making this the bus-contention extreme of the four mappings.

    Per PE: R0 = out ptr, R1 = own pixel base (i*10+j), R2 = scratch,
    R3 = acc; group counter in memory (CNT), serviced by PE15."""
    x, w = layer_data(seed)
    pb = ProgramBuilder(16, "conv_op")
    n_g = N_PX // 16
    for co in range(C_OUT):
        pb.instr({p: asm("MV", "R1", "IMM", imm=(p // OW) * W + (p % OW))
                  for p in _ALL})
        pb.instr({p: asm("MV", "R0", "IMM", imm=_o_addr(co, p))
                  for p in _ALL})
        pb.instr({15: asm("MV", "R2", "IMM", imm=n_g)})
        pb.instr({15: asm("SWD", a="R2", imm=CNT)})
        gloop = pb.instr({p: asm("MV", "R3", "ZERO") for p in _ALL})
        for ci in range(C_IN):
            for r in range(K):
                for c in range(K):
                    off = XB + ci * (H * W) + r * W + c
                    pb.instr({p: asm("SADD", "ROUT", "R1", "IMM", imm=off)
                              for p in _ALL})
                    pb.instr({p: asm("LWI", "R2", "ROUT") for p in _ALL})
                    # broadcast weight into ROUT only (see Im2col-OP note)
                    pb.instr({p: asm("LWD", "ROUT",
                                     imm=_w_addr(co, ci, r, c))
                              for p in _ALL})
                    pb.instr({p: asm("SMUL", "R2", "R2", "ROUT")
                              for p in _ALL})
                    pb.instr({p: asm("SADD", "R3", "R3", "R2")
                              for p in _ALL})
        pb.instr({p: asm("SWI", a="R0", b="R3") for p in _ALL})
        pb.instr({**{p: asm("SADD", "R1", "R1", "IMM", imm=2 * W)
                     for p in (q for q in _ALL if q != 15)},
                  15: asm("LWD", "R2", imm=CNT)})
        pb.instr({**{p: asm("SADD", "R0", "R0", "IMM", imm=16)
                     for p in (q for q in _ALL if q != 15)},
                  15: asm("SSUB", "R2", "R2", "IMM", imm=1)})
        pb.instr({15: asm("SWD", a="R2", imm=CNT)})
        pb.instr({15: asm("SADD", "R1", "R1", "IMM", imm=2 * W)})
        pb.instr({15: asm("SADD", "R0", "R0", "IMM", imm=16)})
        pb.instr({15: asm("BNE", a="R2", b="ZERO", imm=gloop)})
    pb.exit()
    return _case("conv-OP", pb, x, w, max_steps=9000,
                 notes="spatially-parallel direct conv; weight broadcast "
                       "stresses the 1-to-M bus")


MAPPINGS = {
    "conv-WP": conv_wp,
    "Im2col-IP": im2col_ip,
    "Im2col-OP": im2col_op,
    "conv-OP": conv_op,
}


def all_mappings(seed: int = 7):
    return [f(seed) for f in MAPPINGS.values()]

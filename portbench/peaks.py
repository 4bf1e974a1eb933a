"""The yardstick's work count and the H100's peaks, frozen.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's H100 data
sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores (an FMA counted as 2).  The int32 rate is NOT in the data sheet:
it is derived.  An SM of the H100 has 64 INT32 lanes beside its 128
FP32 lanes; an FMA counts 2 float32 operations, an int32 operation 1, so
at the same clock the int32 rate is 67e12 / 2 (half the lanes) / 2 (one
operation a lane-cycle, not two) = 67e12 / 4 operations a second.

Work of one executed CGRA instruction on one PE (a "PE-step") of an
array of P PEs, counted from the arithmetic of the plain reference
(``reference/sweep.py``'s ``step``), P = 16 on the 4x4 array:

- int32 (``i32_ops_per_pe_step``) -- operand select 2 (``_operands``, A
  and B); address 4; store arbitration P // 2 (``_store`` compares each
  PE's address with every later PE's, P (P - 1) / 2 comparisons an
  instruction: half the PEs a PE); ALU 2; writeback 2; contention
  2 + R(P) (``_mem_done``: the request's bank and its DMA engine, then
  one relaxation of its slot in each of the closure's R(P) =
  (P - 2).bit_length() max-plus rounds, 4 at P = 16); latency 2;
  control 5.  At 16 PEs: 2 + 4 + 8 + 2 + 2 + 6 + 2 + 5 = 31.  Like the
  count it generalises, it leaves out the (P, P) relations the plain
  version builds to find a PE's rivals, and counts their least work.
- float32 -- the energy term's 13 multiplies and adds, plus the PE's
  share of the sum over PEs, (P - 1) / P adds, counted as 1: 14 at any
  P.

Bytes: each lane's memory image read once and written once.

The least time of a sweep is the largest of the int32, the float32 and
the byte bound; over several cards, that over their number.  The
executed lane-steps come from the reference's ``steps_executed`` for the
campaign's inputs, never from the program's output.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = 67e12 / 4

PES = 16
F32_OPS_PER_PE_STEP = 14


def i32_ops_per_pe_step(pes: int) -> int:
    """int32 operations of one PE-step on an array of ``pes`` PEs (the
    module's docstring derives each term): 31 at 16."""
    relax_rounds = max(pes - 2, 0).bit_length()
    return 2 + 4 + pes // 2 + 2 + 2 + (2 + relax_rounds) + 2 + 5


def least_seconds(lane_steps: int, lanes: int, mem_words: int,
                  chips: int = 1, pes: int = PES) -> float:
    """The least time ``chips`` H100s need for ``lane_steps`` executed
    lane-steps of an array of ``pes`` PEs over ``lanes`` lanes of
    ``mem_words``-word images: one card's least time over ``chips``, each
    card doing its share of the work at its own peaks."""
    pe_steps = float(lane_steps) * pes
    return max(pe_steps * i32_ops_per_pe_step(pes) / I32_OPS_PER_S,
               pe_steps * F32_OPS_PER_PE_STEP / F32_OPS_PER_S,
               2.0 * lanes * mem_words * 4 / HBM_BYTES_PER_S) / chips

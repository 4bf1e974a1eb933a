"""The yardstick's work count and the H100's peaks, frozen.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's H100 data
sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores (an FMA counted as 2).  The int32 rate is NOT in the data sheet:
it is derived.  An SM of the H100 has 64 INT32 lanes beside its 128
FP32 lanes; an FMA counts 2 float32 operations, an int32 operation 1, so
at the same clock the int32 rate is 67e12 / 2 (half the lanes) / 2 (one
operation a lane-cycle, not two) = 67e12 / 4 operations a second.

Work of one executed CGRA instruction on one PE (a "PE-step"), counted
from the arithmetic of the plain reference (``reference/sweep.py``):
int32 -- operand select 2, address 4, store arbitration 8 (half the PEs
compared), ALU 2, writeback 2, contention 6, latency 2, control 5: 31;
float32 -- the energy term's 13 multiplies and adds plus its share of
the sum over PEs: 14.  Bytes: each lane's memory image read once and
written once.

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
I32_OPS_PER_PE_STEP = 31
F32_OPS_PER_PE_STEP = 14


def least_seconds(lane_steps: int, lanes: int, mem_words: int,
                  chips: int = 1) -> float:
    """The least time ``chips`` H100s need for ``lane_steps`` executed
    lane-steps over ``lanes`` lanes of ``mem_words``-word images: one
    card's least time over ``chips``, each card doing its share of the
    work at its own peaks."""
    pe_steps = float(lane_steps) * PES
    return max(pe_steps * I32_OPS_PER_PE_STEP / I32_OPS_PER_S,
               pe_steps * F32_OPS_PER_PE_STEP / F32_OPS_PER_S,
               2.0 * lanes * mem_words * 4 / HBM_BYTES_PER_S) / chips

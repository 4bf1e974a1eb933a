"""The "silicon truth" physical model behind the detailed reference
simulator (detailed.py).

This stands in for the TSMC-65nm post-synthesis flow of the paper, which
this container cannot run (assumption change, DESIGN.md Section 2).  The
estimator NEVER reads these parameters: it only sees what the
characterization pass (characterization.py) can observe on detailed-sim
"waveforms" (per-PE per-cycle power + cycle counts), exactly like the
paper's red profiling box in Figure 1.

Effects modelled (superset of the estimator's case (vi)):
  * per-op decode power (cycle 0) and steady active power (cycles 1..);
  * idle power of a PE waiting for the slowest PE of the instruction;
  * operand-fetch energy by source kind (zero/imm/register/neighbour);
  * datapath switching energy when op or operand muxes change between
    consecutive instructions;
  * multiply-by-zero clock-gating discount;
  * **data-dependent toggling** (operand Hamming activity), the component
    the characterization-based estimator can only capture on average --
    this is what leaves the paper's ~22% residual power error.

Calibration targets paper Figure 4: 100 MHz clock, per-PE powers in the
35-145 uW range, instruction powers ~1-1.7 mW, energies tens of pJ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import isa


def _per_op(default, **overrides) -> np.ndarray:
    t = np.full(isa.N_OPS, float(default), np.float32)
    for name, v in overrides.items():
        t[isa.OP[name]] = v
    return t


@dataclasses.dataclass(frozen=True)
class PhysicalModel:
    """All powers in uW @ 100 MHz; switch/fetch terms in uW*cc (energy)."""
    # Decode + first execute cycle power, per opcode.
    p_dec: np.ndarray = dataclasses.field(default_factory=lambda: _per_op(
        100.0, NOP=60.0, EXIT=60.0, SMUL=140.0,
        BEQ=90.0, BNE=90.0, BLT=90.0, BGE=90.0, JUMP=85.0,
        LWD=110.0, SWD=110.0, LWI=112.0, SWI=112.0))
    # Steady active power for cycles 1..busy-1, per opcode.
    p_act: np.ndarray = dataclasses.field(default_factory=lambda: _per_op(
        40.0, NOP=20.0, EXIT=20.0, SMUL=120.0,
        LWD=80.0, SWD=80.0, LWI=82.0, SWI=82.0))
    p_idle: float = 20.0          # waiting for slower PEs
    alpha_toggle: float = 0.5     # data-activity coefficient (estimator-blind)
    e_sw_op: float = 25.0         # op change between consecutive instructions
    e_sw_mux: float = 8.0         # per changed operand-source mux
    # Operand fetch energy by source kind: zero / immediate / register /
    # neighbour (paper case (vi): "if the arguments are fetched from an
    # immediate, a register or a neighbouring PE").
    e_src: np.ndarray = dataclasses.field(default_factory=lambda: np.array(
        [0.0, 4.0, 8.0, 14.0], np.float32))
    mulzero_factor: float = 0.3   # SMUL with a zero operand (clock gating)

    def with_toggle(self, alpha: float) -> "PhysicalModel":
        return dataclasses.replace(self, alpha_toggle=alpha)


DEFAULT_PHYS = PhysicalModel()

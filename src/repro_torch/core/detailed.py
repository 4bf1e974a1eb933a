"""Detailed reference simulation: the post-synthesis stand-in.

Produces, for an executed trace, the "measured" power/latency that the
paper obtains from slow post-synthesis simulations of OpenEdgeCGRA in
TSMC 65nm.  Latency comes from the behavioral simulator's true timing
(bus/bank/DMA-accurate, memory.py); power comes from the PhysicalModel
including its data-dependent toggling term.

Also exposes the per-PE per-cycle power *waveform* -- the observable a
characterization pass would extract from post-synthesis VCD traces -- used
by characterization.py and by the Figure-4 heatmap benchmark.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from . import isa
from .hwconfig import HwConfig
from .physical import DEFAULT_PHYS, PhysicalModel
from .program import Program
from .trace import DenseTrace, densify, switch_masks, toggle_density


class EnergyBreakdown(NamedTuple):
    decode: np.ndarray   # (S,P) uW*cc
    active: np.ndarray   # (S,P)
    idle: np.ndarray     # (S,P)
    fetch: np.ndarray    # (S,P)
    switch: np.ndarray   # (S,P)

    @property
    def total(self) -> np.ndarray:
        return self.decode + self.active + self.idle + self.fetch + self.switch


class DetailedReport(NamedTuple):
    latency_cc: int
    energy_pj: float
    power_mw: float                 # average power over the execution
    e_step_pe: np.ndarray           # (S,P) uW*cc
    e_step: np.ndarray              # (S,)  uW*cc
    p_instr_mw: np.ndarray          # (S,)  per-instruction average power
    breakdown: EnergyBreakdown
    dt: DenseTrace


def _f(hw_field) -> float:
    return float(np.asarray(hw_field))


def energy_components(dt: DenseTrace, hw: HwConfig,
                      phys: PhysicalModel) -> EnergyBreakdown:
    """Per-(step, PE) energy in uW*cc, by component."""
    S, P = dt.ops.shape
    v = dt.valid[:, None].astype(np.float32)
    ops = dt.ops
    busy = dt.busy.astype(np.float32)
    lat = dt.lat.astype(np.float32)[:, None]

    tog = toggle_density(dt)                       # (S,P) in [0,1]
    act_factor = 1.0 + phys.alpha_toggle * tog     # estimator-blind term

    smul = ops == isa.OP["SMUL"]
    smul_scale = np.where(smul, _f(hw.smul_power_scale), 1.0)
    mulzero = smul & ((dt.a == 0) | (dt.b == 0))
    gate = np.where(mulzero, phys.mulzero_factor, 1.0)

    p_dec = phys.p_dec[ops] * smul_scale * act_factor
    decode = p_dec * v                              # 1 cycle each instr
    active_cycles = np.maximum(busy - 1.0, 0.0)
    active = (phys.p_act[ops] * smul_scale * gate * act_factor
              * active_cycles * v)
    idle = phys.p_idle * np.maximum(lat - busy, 0.0) * v

    kindA = isa.SRC_KIND[dt.srcA]
    kindB = isa.SRC_KIND[dt.srcB]
    fetch = (phys.e_src[kindA] + phys.e_src[kindB]) * v

    op_ch, a_ch, b_ch = switch_masks(dt)
    switch = (op_ch * phys.e_sw_op
              + (a_ch.astype(np.float32) + b_ch.astype(np.float32))
              * phys.e_sw_mux) * v
    return EnergyBreakdown(decode.astype(np.float32),
                           active.astype(np.float32),
                           idle.astype(np.float32),
                           fetch.astype(np.float32),
                           switch.astype(np.float32))


def report(program: Program, trace, hw: HwConfig,
           phys: PhysicalModel = DEFAULT_PHYS) -> DetailedReport:
    dt = densify(program, trace)
    br = energy_components(dt, hw, phys)
    e_step_pe = br.total                            # (S,P)
    e_step = e_step_pe.sum(axis=1)                  # (S,)
    t_clk = _f(hw.t_clk_ns)
    lat_cc = dt.total_cc
    energy_pj = float(e_step.sum()) * t_clk * 1e-3  # uW*cc*ns -> pJ
    power_mw = (float(e_step.sum()) / max(lat_cc, 1)) * 1e-3
    with np.errstate(divide="ignore", invalid="ignore"):
        p_instr = np.where(dt.lat > 0, e_step / np.maximum(dt.lat, 1), 0.0)
    return DetailedReport(lat_cc, energy_pj, power_mw, e_step_pe, e_step,
                          (p_instr * 1e-3).astype(np.float32), br, dt)


def power_waveform(rep: DetailedReport) -> np.ndarray:
    """Expand a report into the per-cycle per-PE power matrix (total_cc, P)
    in uW -- the "VCD waveform" view used for characterization and for
    checking effects like 'NOP power decays over a long instruction'
    (paper Figure 4 discussion).

    Within one instruction of latency L, a PE with busy time B sees:
      cycle 0:        decode power (+ fetch & switch energy, impulsive)
      cycles 1..B-1:  active power
      cycles B..L-1:  idle power
    """
    dt = rep.dt
    br = rep.breakdown
    S, P = dt.ops.shape
    out = np.zeros((max(rep.latency_cc, 1), P), np.float32)
    t = 0
    for s in range(S):
        if not dt.valid[s]:
            break
        L = int(dt.lat[s])
        if L <= 0:
            continue
        for p in range(P):
            B = max(int(dt.busy[s, p]), 1)
            out[t, p] += br.decode[s, p] + br.fetch[s, p] + br.switch[s, p]
            if B > 1:
                out[t + 1:t + B, p] += br.active[s, p] / (B - 1)
            if L > B:
                out[t + B:t + L, p] += br.idle[s, p] / (L - B)
        t += L
    return out

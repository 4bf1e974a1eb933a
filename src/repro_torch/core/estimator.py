"""The power/latency estimator: incremental non-idealities (i)-(vi).

Given (a) a behavioral execution trace, (b) a characterization Profile and
(c) a hardware description (HwConfig, a dataclass of tensors on any
device), estimates kernel latency, energy and
average power at any precision case of the paper's Table 1:

  case (i)    1 cc per operation            | fixed power (of a NOP)
  case (ii)   per-op duration               | fixed power (of a NOP)
  case (iii)  + memory-access latency       | fixed power (of a NOP)
  case (iv)   (iii latency)                 | fixed power per operation
  case (v)    (iii latency)                 | + idle power
  case (vi)   (iii latency)                 | + datapath switching and
                                              operand-source/value costs

The estimator never consults the PhysicalModel: its only inputs are the
characterization file, the user-declared hardware topology and the
behavioral trace (the tool *leverages run-time information*, unlike
data-agnostic predecessors such as CGRA-EAM -- paper Section 1).

The case-(iii) contention model intentionally mirrors the architectural
model in memory.py (re-implemented here in numpy as an independent code
path); the paper reports latency error reaching ~0 once memory effects are
characterized, which this equality reproduces.  Tests assert it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np

from . import isa
from .characterization import Profile
from .hwconfig import BUS_N_TO_M, HwConfig
from .program import Program
from .trace import DenseTrace, densify, switch_masks

CASES = ("i", "ii", "iii", "iv", "v", "vi")


class Estimate(NamedTuple):
    case: str
    latency_cc: int
    energy_pj: float
    power_mw: float
    # case-(vi) detail (None for other cases): per (step, PE) energy uW*cc
    e_step_pe: Optional[np.ndarray] = None
    lat_step: Optional[np.ndarray] = None


def _hwf(x) -> float:
    return float(x.item())


def _hwi(x) -> int:
    return int(x.item())


def _host_trace(trace):
    """The trace's fields as host numpy arrays, from any device."""
    return type(trace)(*(t.cpu().numpy() if hasattr(t, "cpu")
                         else np.asarray(t) for t in trace))


def _mem_banks_dmas(is_mem: np.ndarray, addr: np.ndarray, hw: HwConfig,
                    mem_size: int, cols: int):
    """Shared bank/DMA resource-id planes of the contention model."""
    S, P = is_mem.shape
    pe = np.arange(P)
    col = pe % cols
    n_banks = max(_hwi(hw.n_banks), 1)
    if _hwi(hw.bus) == BUS_N_TO_M:
        if _hwi(hw.interleaved):
            bank = addr % n_banks
        else:
            bank_words = max(mem_size // n_banks, 1)
            bank = np.clip(addr // bank_words, 0, n_banks - 1)
    else:
        bank = np.zeros_like(addr)
        n_banks = 1
    dma = np.broadcast_to(pe if _hwi(hw.dma_per_pe) else col, (S, P))
    return bank, dma, n_banks, _hwi(hw.t_mem)


def mem_completion_np(is_mem: np.ndarray, addr: np.ndarray, hw: HwConfig,
                      mem_size: int, cols: int) -> np.ndarray:
    """Numpy re-implementation of the pipelined-issue contention model
    (greedy in-order list scheduler), vectorized over the step axis.

    Every step starts with fresh scoreboards, so steps are independent:
    the greedy PE-order arbitration is the only sequential dimension.  The
    loop below therefore runs over at most P PEs (vector ops of length S
    inside), not the former S x P Python double loop -- same results,
    orders of magnitude faster on long traces (see BENCH_sim_throughput)."""
    S, P = is_mem.shape
    bank, dma, n_banks, t_mem = _mem_banks_dmas(is_mem, addr, hw,
                                                mem_size, cols)
    rows = np.arange(S)
    bank_free = np.zeros((S, n_banks), np.int64)
    dma_free = np.zeros((S, P), np.int64)
    done = np.zeros((S, P), np.int64)
    for p in range(P):
        req = is_mem[:, p]
        b = bank[:, p]
        d = dma[:, p]
        cur_b = bank_free[rows, b]
        cur_d = dma_free[rows, d]
        slot = np.maximum(cur_b, cur_d)
        # each row appears exactly once per PE iteration, so plain fancy
        # assignment is a race-free scatter
        bank_free[rows, b] = np.where(req, slot + 1, cur_b)
        dma_free[rows, d] = np.where(req, slot + 1, cur_d)
        done[:, p] = np.where(req, slot + t_mem, 0)
    return done


def mem_completion_np_loop(is_mem: np.ndarray, addr: np.ndarray,
                           hw: HwConfig, mem_size: int,
                           cols: int) -> np.ndarray:
    """The seed's interpreted S x P double loop, kept as the reference
    oracle for property tests and as the benchmark baseline the vectorized
    scheduler is measured against."""
    S, P = is_mem.shape
    bank, dma, _, t_mem = _mem_banks_dmas(is_mem, addr, hw, mem_size, cols)
    done = np.zeros((S, P), np.int64)
    for s in range(S):
        bank_free: Dict[int, int] = {}
        dma_free: Dict[int, int] = {}
        for p in range(P):
            if not is_mem[s, p]:
                continue
            b, d = int(bank[s, p]), int(dma[s, p])
            slot = max(bank_free.get(b, 0), dma_free.get(d, 0))
            bank_free[b] = slot + 1
            dma_free[d] = slot + 1
            done[s, p] = slot + t_mem
    return done


def _latency_tables(profile: Profile, hw: HwConfig) -> np.ndarray:
    """Per-op latency table adjusted for the declared hardware (hardware
    exploration edits e.g. smul_lat without re-characterizing)."""
    lat = profile.lat.astype(np.int64).copy()
    lat[isa.OP["SMUL"]] = _hwi(hw.smul_lat)
    return lat


def estimate(program: Program, trace, profile: Profile, hw: HwConfig,
             case: str = "vi", *, mem_size: int = 4096,
             cols: int = 4) -> Estimate:
    """Estimate latency/energy/power of an executed kernel at `case`.

    ``trace`` is ``cgra.run_program``'s record, on any device; it is
    copied to the host once and the estimate runs in numpy."""
    assert case in CASES, case
    dt = densify(program, _host_trace(trace))
    S, P = dt.ops.shape
    v = dt.valid
    ops = dt.ops
    n_steps = dt.n_steps
    t_clk = profile.t_clk_ns

    lat_table = _latency_tables(profile, hw)
    is_mem = isa.IS_MEM[ops] & v[:, None]

    # ---------------- latency ladder ----------------
    if case == "i":
        busy = np.where(v[:, None], 1, 0).astype(np.int64)
        lat_step = v.astype(np.int64)
    elif case == "ii":
        per_op = lat_table[ops]
        per_op = np.where(is_mem, profile.t_mem, per_op)
        busy = per_op * v[:, None]
        lat_step = busy.max(axis=1)
    else:  # iii and above: + memory contention
        done = mem_completion_np(is_mem, dt.mem_addr, hw, mem_size, cols)
        alu = lat_table[ops] * v[:, None]
        busy = np.where(is_mem, done, alu)
        lat_step = busy.max(axis=1)
    latency = int(lat_step.sum())

    # ---------------- power ladder ----------------
    smul = ops == isa.OP["SMUL"]
    smul_scale = np.where(smul, _hwf(hw.smul_power_scale), 1.0)

    if case in ("i", "ii", "iii"):
        # fixed power: every PE burns the NOP-average power every cycle
        energy_uwcc = profile.p_flat * P * latency
        e_step_pe = None
    elif case == "iv":
        # fixed power per op over its busy time; waiting costs nothing
        lat_nom = np.maximum(lat_table[ops], 1)
        lat_nom = np.where(is_mem, np.maximum(profile.t_mem, 1), lat_nom)
        p_op_avg = ((profile.p_dec[ops]
                     + profile.p_act[ops] * (lat_nom - 1)) / lat_nom)
        e_step_pe = p_op_avg * smul_scale * busy * v[:, None]
        energy_uwcc = float(e_step_pe.sum())
    else:  # v, vi
        wait = np.maximum(lat_step[:, None] - busy, 0) * v[:, None]
        active_cc = np.maximum(busy - 1, 0)
        if case == "v":
            lat_nom = np.maximum(lat_table[ops], 1)
            lat_nom = np.where(is_mem, np.maximum(profile.t_mem, 1), lat_nom)
            p_op_avg = ((profile.p_dec[ops]
                         + profile.p_act[ops] * (lat_nom - 1)) / lat_nom)
            e_step_pe = (p_op_avg * smul_scale * busy
                         + profile.p_idle * wait) * v[:, None]
        else:  # vi: decode/active split + value & datapath awareness
            mulzero = smul & ((dt.a == 0) | (dt.b == 0))
            gate = np.where(mulzero, profile.mulzero, 1.0)
            kindA = isa.SRC_KIND[dt.srcA]
            kindB = isa.SRC_KIND[dt.srcB]
            op_ch, a_ch, b_ch = switch_masks(dt)
            e_step_pe = (profile.p_dec[ops] * smul_scale
                         + profile.p_act[ops] * smul_scale * gate * active_cc
                         + profile.p_idle * wait
                         + profile.e_src[kindA] + profile.e_src[kindB]
                         + op_ch * profile.e_sw_op
                         + (a_ch.astype(np.float32)
                            + b_ch.astype(np.float32)) * profile.e_sw_mux
                         ) * v[:, None]
        energy_uwcc = float(e_step_pe.sum())

    energy_pj = energy_uwcc * t_clk * 1e-3
    power_mw = (energy_uwcc / max(latency, 1)) * 1e-3
    return Estimate(case, latency, energy_pj, power_mw, e_step_pe, lat_step)


def estimate_all_cases(program: Program, trace, profile: Profile,
                       hw: HwConfig, **kw) -> Dict[str, Estimate]:
    return {c: estimate(program, trace, profile, hw, c, **kw) for c in CASES}


def errors_vs_detailed(est: Estimate, detailed_rep) -> Dict[str, float]:
    """Relative |error| of an estimate against the detailed reference
    (the paper's Figure-2 metric)."""
    lat_err = abs(est.latency_cc - detailed_rep.latency_cc) / max(
        detailed_rep.latency_cc, 1)
    pow_err = abs(est.power_mw - detailed_rep.power_mw) / max(
        detailed_rep.power_mw, 1e-12)
    return {"latency_err": float(lat_err), "power_err": float(pow_err)}

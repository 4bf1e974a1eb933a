"""Hardware configurations and the benchmark's hardware grid, frozen.

A frozen copy of the paper's Table 2 topologies from
``src/repro_torch/core/hwconfig.py`` (fields and defaults), as plain
dicts, and of the grid that ``chip_smoke.py``'s phase 4 sweeps: every
named topology, in sorted order, with each listed ``smul_lat`` and
``n_banks`` substituted (topology-major, then ``smul_lat``, then
``n_banks``).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

BUS_ONE_TO_M, BUS_N_TO_M = 0, 1

FIELDS = ("smul_lat", "smul_power_scale", "bus", "interleaved", "n_banks",
          "dma_per_pe", "t_mem", "t_clk_ns")
FLOAT_FIELDS = ("smul_power_scale", "t_clk_ns")

BASELINE = dict(smul_lat=3, smul_power_scale=1.0, bus=BUS_ONE_TO_M,
                interleaved=0, n_banks=4, dma_per_pe=0, t_mem=2,
                t_clk_ns=10.0)

TOPOLOGIES: Dict[str, Dict[str, float]] = {
    "baseline": {},
    "a_fast_mul": dict(smul_lat=1, smul_power_scale=3.0),
    "b_n_to_m": dict(bus=BUS_N_TO_M, interleaved=0),
    "c_interleaved": dict(bus=BUS_N_TO_M, interleaved=1),
    "d_dma_per_pe": dict(bus=BUS_N_TO_M, interleaved=1, dma_per_pe=1),
}


def topology(name: str, **overrides) -> Dict[str, float]:
    return {**BASELINE, **TOPOLOGIES[name], **overrides}


def grid(spec: dict) -> List[Dict[str, float]]:
    """The hardware configs of a configuration file's ``hardware`` entry:
    ``{"topologies": [...], "smul_lat": [...], "n_banks": [...]}``."""
    names: Sequence[str] = sorted(spec["topologies"])
    return [topology(t, smul_lat=s, n_banks=b) for t, s, b in
            itertools.product(names, spec["smul_lat"], spec["n_banks"])]

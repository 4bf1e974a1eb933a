"""Hardware topology description of the CGRA and its memory subsystem.

The paper's Table 2 made explicit: the estimator can be pointed at a
different hardware configuration (bus type, bank interleaving, DMA
placement, accelerated multiplier) without any RTL rebuild.

``HwConfig`` is a dataclass of tensors: 0-d for one configuration,
``(H,)`` for a stacked batch (``stack_configs``).  ``smul_power_scale``
and ``t_clk_ns`` are float32; every other field is int32, as in the
reference.  ``hw_table`` reads H configurations into one host table, so
a batch is built without a tensor operation per configuration or field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

# Bus types.
BUS_ONE_TO_M = 0   # single memory port; all requests serialize globally
BUS_N_TO_M = 1     # banked; requests to different banks proceed in parallel

FLOAT_FIELDS = ("smul_power_scale", "t_clk_ns")


def _field_tensor(name: str, value) -> torch.Tensor:
    dtype = torch.float32 if name in FLOAT_FIELDS else torch.int32
    if isinstance(value, torch.Tensor):
        return value if value.dtype == dtype else value.to(dtype)
    return torch.as_tensor(value, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class HwConfig:
    """CGRA + system topology.

    Fields
    ------
    smul_lat:         multiplier latency in cc (3 baseline, 1 for mod (a))
    smul_power_scale: active-power scale of SMUL (3.0 for mod (a))
    bus:              BUS_ONE_TO_M | BUS_N_TO_M
    interleaved:      0 = blocked bank mapping (addr // bank_words),
                      1 = word-interleaved (addr % n_banks)
    n_banks:          number of SRAM banks (only meaningful for N-to-M)
    dma_per_pe:       0 = one DMA per column (baseline), 1 = one per PE
    t_mem:            uncontended memory access latency in cc
    t_clk_ns:         clock period (100 MHz -> 10 ns)
    """

    smul_lat: Any = 3
    smul_power_scale: Any = 1.0
    bus: Any = BUS_ONE_TO_M
    interleaved: Any = 0
    n_banks: Any = 4
    dma_per_pe: Any = 0
    t_mem: Any = 2
    t_clk_ns: Any = 10.0

    FIELDS = ("smul_lat", "smul_power_scale", "bus", "interleaved",
              "n_banks", "dma_per_pe", "t_mem", "t_clk_ns")

    def __post_init__(self):
        for f in self.FIELDS:
            object.__setattr__(self, f, _field_tensor(f, getattr(self, f)))

    def replace(self, **kw) -> "HwConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in self.FIELDS}

    def to(self, device) -> "HwConfig":
        return HwConfig(**{f: v.to(device) for f, v in self.as_dict().items()})

    def map(self, fn) -> "HwConfig":
        """Apply ``fn`` to every field (e.g. index or repeat a batch)."""
        return HwConfig(**{f: fn(v) for f, v in self.as_dict().items()})

    def host_row(self) -> np.ndarray:
        """The configuration's 8 values as one (8,) int32 host row in
        ``FIELDS`` order, each float32 field as its bit pattern.  Read
        once and kept: the dataclass is frozen, so its tensors are not
        to be changed in place."""
        row = self.__dict__.get("_host_row")
        if row is None:
            vals = [getattr(self, f).detach().cpu().numpy().reshape(-1)
                    for f in self.FIELDS]
            if any(v.size != 1 for v in vals):
                raise ValueError("a host row needs one value a field, got "
                                 f"{[v.size for v in vals]}")
            row = np.concatenate([v.view(np.int32) for v in vals])
            object.__setattr__(self, "_host_row", row)
        return row


# --------------------------------------------------------------------------
# The paper's topologies (Table 2).
# --------------------------------------------------------------------------

def baseline() -> HwConfig:
    """OpenEdgeCGRA as integrated in its host MCU: 1-to-M bus, one DMA per
    column, 3-cc multiplier."""
    return HwConfig()


def mod_a_fast_mul() -> HwConfig:
    """(a) accelerated SMUL: 1 cc instead of 3, at 3x the power."""
    return baseline().replace(smul_lat=1, smul_power_scale=3.0)


def mod_b_n_to_m() -> HwConfig:
    """(b) N-to-M bus: parallel accesses to distinct (blocked) banks."""
    return baseline().replace(bus=BUS_N_TO_M, interleaved=0)


def mod_c_interleaved() -> HwConfig:
    """(c) N-to-M bus with word-interleaved banks (consecutive addresses
    land in different banks)."""
    return baseline().replace(bus=BUS_N_TO_M, interleaved=1)


def mod_d_dma_per_pe() -> HwConfig:
    """(d) one DMA per PE (instead of per column) + N-to-M interleaved bus
    -- the bus type must be N-to-M for the extra ports to pay off (paper
    Section 3.2)."""
    return baseline().replace(bus=BUS_N_TO_M, interleaved=1, dma_per_pe=1)


TOPOLOGIES = {
    "baseline": baseline,
    "a_fast_mul": mod_a_fast_mul,
    "b_n_to_m": mod_b_n_to_m,
    "c_interleaved": mod_c_interleaved,
    "d_dma_per_pe": mod_d_dma_per_pe,
}


def hw_table(configs: Sequence[HwConfig]) -> np.ndarray:
    """The configurations as one (8, H) int32 host table: row i is field
    ``HwConfig.FIELDS[i]`` of every configuration, a float32 field as
    its bit pattern (``.view(np.float32)`` reads it back)."""
    return np.stack([c.host_row() for c in configs], axis=1)


def stack_configs(configs: Sequence[HwConfig]) -> HwConfig:
    """Stack configurations into one batched HwConfig (leading axis)."""
    table = hw_table(configs)
    fields = {f: torch.from_numpy(table[i].view(np.float32)
                                  if f in FLOAT_FIELDS else table[i])
              for i, f in enumerate(HwConfig.FIELDS)}
    device = getattr(configs[0], HwConfig.FIELDS[0]).device
    if device.type != "cpu":
        fields = {f: v.to(device) for f, v in fields.items()}
    return HwConfig(**fields)

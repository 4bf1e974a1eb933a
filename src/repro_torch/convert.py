"""Carry the reference's inputs across to the port.

The estimator has no weights; the state two runs must share is the
characterization profile, the programs and the hardware configurations.
Each function takes the reference object's fields as plain numpy /
Python values (``dataclasses.asdict`` of a ``Profile`` or ``Program``,
``HwConfig.as_dict()``) and builds the port's object, so a test feeds
both packages identical inputs without this package importing the
reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .core.characterization import Profile
from .core.hwconfig import HwConfig
from .core.program import Program

_INT_FIELDS = ("lat", "t_mem")


def profile_from_numpy(fields: Dict[str, Any]) -> Profile:
    """Reference ``Profile`` fields -> the port's ``Profile`` (same values,
    same numpy dtypes)."""
    kw = {}
    for name, value in fields.items():
        if isinstance(value, np.ndarray):
            kw[name] = value.astype(np.int32 if name in _INT_FIELDS
                                    else np.float32)
        else:
            kw[name] = int(value) if name in _INT_FIELDS else float(value)
    return Profile(**kw)


def program_from_numpy(fields: Dict[str, Any]) -> Program:
    """Reference ``Program`` fields -> the port's validated ``Program``."""
    arrays = {k: np.asarray(fields[k], np.int32)
              for k in ("ops", "dest", "srcA", "srcB", "imm")}
    return Program(name=str(fields.get("name", "kernel")),
                   **arrays).validate()


def hwconfig_from_numpy(fields: Dict[str, Any]) -> HwConfig:
    """Reference ``HwConfig.as_dict()`` (scalars or stacked arrays) -> the
    port's ``HwConfig`` (int32 / float32 tensors of the same shape)."""
    return HwConfig(**{f: np.array(fields[f]) for f in HwConfig.FIELDS})

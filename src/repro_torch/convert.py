"""Carry the reference's inputs across to the port.

For the CGRA estimator the state two runs must share is the
characterization profile, the programs and the hardware configurations;
for the served model it is the weights.  Each function takes the
reference object's fields as plain numpy / Python values
(``dataclasses.asdict`` of a ``Profile`` or ``Program``,
``HwConfig.as_dict()``, the parameter pytree as numpy arrays) and builds
the port's object, so a test feeds both packages identical inputs
without this package importing the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

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


def _flat(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def model_params_from_jax(cfg, params: Mapping,
                          into: Optional[torch.nn.Module] = None):
    """The reference's hybrid-model parameter pytree (nested dicts of
    numpy arrays, mamba leaves stacked (G, per, ...)) -> the port's state
    dict of ``HybridLM`` (float32 CPU tensors), or, with ``into``, that
    model with the weights loaded (on its own device).  Names and shapes
    match one for one: ``mamba.<leaf>[g, i]`` becomes
    ``layers.<g * per + i>.<leaf>``."""
    from .models.hybrid import groups

    G, per = groups(cfg)
    state: Dict[str, torch.Tensor] = {}
    for name, a in _flat(params):
        if name.startswith("mamba."):
            if a.shape[:2] != (G, per):
                raise ValueError(f"{name}: leading dims {a.shape[:2]} are "
                                 f"not (groups, per_group) = {(G, per)}")
            for g in range(G):
                for i in range(per):
                    state[f"layers.{g * per + i}.{name[6:]}"] = \
                        torch.from_numpy(np.array(a[g, i], np.float32))
        else:
            state[name] = torch.from_numpy(np.array(a, np.float32))
    if into is None:
        return state
    into.load_state_dict(state, strict=True)
    return into

"""Parameter initialisation from a ``torch.Generator``.

The distributions of ``repro.models.initlib`` and ``repro.models.ssm``:
a truncated normal (+-2 sigma) scaled by 1/sqrt(fan_in), ones, zeros,
and Mamba2's ``A_log`` / ``dt_bias``.  The numbers differ from
``jax.random``'s for the same seed; the distributions do not.  Tests
that compare the two packages carry the reference's weights across with
``repro_torch.convert`` instead.

Each module names its own parameters' logical axes when it builds them
(a ``logical_axes`` dict, as the reference's ``dense_init`` takes its
``axes``); ``param_axes`` collects them for a whole model.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

Axes = Tuple[Optional[str], ...]


def trunc_normal(shape: Sequence[int], scale: float,
                 generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], float32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def dense_init(shape: Sequence[int], generator: torch.Generator,
               device: torch.device, *,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Fan-in scaled truncated normal; the fan-in defaults to the product
    of every dimension but the last."""
    fan = fan_in if fan_in is not None else math.prod(shape[:-1])
    return trunc_normal(shape, 1.0 / math.sqrt(max(fan, 1)), generator,
                        device)


def zeros_init(shape: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def ones_init(shape: Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


def a_log_init(n_heads: int, device: torch.device) -> torch.Tensor:
    """log of A in [1, 16], spaced evenly over the heads (Mamba2's
    default A in -[1, 16])."""
    return torch.linspace(math.log(1.0), math.log(16.0), n_heads,
                          dtype=torch.float32, device=device)


def dt_bias_init(n_heads: int, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Inverse softplus of dt ~ U[1e-3, 1e-1], clipped below at 1e-4."""
    dt = torch.empty(n_heads, dtype=torch.float32, device=device)
    dt.uniform_(1e-3, 1e-1, generator=generator)
    return torch.log(torch.expm1(dt.clamp_min(1e-4)))


def param_axes(module: nn.Module) -> Dict[str, Axes]:
    """``{parameter name: logical axes}`` of every parameter of
    ``module``, in ``named_parameters`` order, from the ``logical_axes``
    each submodule declares for its own parameters.  A parameter of a
    per-layer stack carries its layer's axes (the reference's stacked
    leaf has a leading None more per stacked dim).  A parameter without
    axes raises."""
    found: Dict[str, Axes] = {}
    for prefix, m in module.named_modules():
        for name, ax in getattr(m, "logical_axes", {}).items():
            if getattr(m, name) is not None:
                found[f"{prefix}.{name}" if prefix else name] = tuple(ax)
    names = [n for n, _ in module.named_parameters()]
    missing = [n for n in names if n not in found]
    if missing:
        raise ValueError(f"parameters without logical axes: {missing[:8]}")
    return {n: found[n] for n in names}

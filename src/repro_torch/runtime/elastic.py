"""Elastic re-planning after node loss.

SPMD training cannot run with holes in the mesh; the recovery path is
(1) detect failure, (2) re-plan the mesh from surviving slices, (3)
restore the latest checkpoint resharded onto the new mesh (see
checkpoint.restore_resharded), (4) scale batch/accumulation to keep the
global batch constant.

Planning policy: drop to the largest (pods x data x model) grid that the
survivors can form while *preserving the model axis* (TP size is baked
into layer shardings and kernel block shapes; DP shrinks instead --
the standard production choice).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grad_accum_factor: int     # multiply microbatching by this
    dropped_nodes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n


def plan_downscale(n_alive: int, *, model: int = 16,
                   data: int = 16, pods: int = 2,
                   dropped=()) -> Optional[ElasticPlan]:
    """Largest surviving mesh keeping the TP (model) axis intact.

    Returns None when fewer than one TP group survives."""
    if n_alive < model:
        return None
    full_dp = pods * data
    # largest power-of-two DP width that fits the survivors
    dp = 1
    while dp * 2 * model <= n_alive and dp * 2 <= full_dp:
        dp *= 2
    accum = max(full_dp // dp, 1)
    if dp >= data and dp % data == 0 and dp // data > 1:
        shape = (dp // data, data, model)
        names = ("pod", "data", "model")
    else:
        shape = (dp, model)
        names = ("data", "model")
    return ElasticPlan(mesh_shape=shape, axis_names=names,
                       grad_accum_factor=accum,
                       dropped_nodes=tuple(dropped))

"""Plain per-program Pareto fronts and top-k sets, for the benchmark's
control.

A frozen copy of the ParetoFront branch of ``reduce_oracle`` in
``src/repro_torch/analysis/pareto.py``: a lane dominates another when it
is no worse on both axes (compared as float32) and better on one; exact
duplicates of a front point stay on the front; the front is ordered by
(axis 0, axis 1, flat index) and cut to ``max_points`` (``clipped``
counts what the cut dropped).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

FIELDS = ("latency_cc", "energy_pj", "power_mw", "checksum",
          "steps_executed")
DTYPES = dict(latency_cc=np.int32, energy_pj=np.float32,
              power_mw=np.float32, checksum=np.int32,
              steps_executed=np.int32)


class Front(NamedTuple):
    indices: np.ndarray         # (G, K) flat grid index, -1 empty
    latency_cc: np.ndarray
    energy_pj: np.ndarray
    power_mw: np.ndarray
    checksum: np.ndarray
    steps_executed: np.ndarray
    count: np.ndarray           # (G,)
    clipped: np.ndarray         # (G,)


def pareto_fronts(fields: dict, block: int, axes, max_points: int) -> Front:
    """Fronts of the (G * block,) lanes in canonical order, program g
    owning lanes ``[g * block, (g + 1) * block)``."""
    n = len(fields["latency_cc"])
    G, K = n // block, int(max_points)
    out = {f: np.zeros((G, K), DTYPES[f]) for f in FIELDS}
    idx = np.full((G, K), -1, np.int32)
    count = np.zeros(G, np.int32)
    clipped = np.zeros(G, np.int32)
    for g in range(G):
        lanes = np.arange(g * block, (g + 1) * block)
        a = np.asarray(fields[axes[0]], np.float32)[lanes]
        b = np.asarray(fields[axes[1]], np.float32)[lanes]
        order = np.lexsort((lanes, b, a))
        a, b, lanes = a[order], b[order], lanes[order]
        # after the sort a lane is dominated iff a lane of a smaller a has
        # b <= its b, or the first lane of its own a-run has a smaller b
        best = np.minimum.accumulate(b)
        run_start = np.r_[0, np.flatnonzero(a[1:] != a[:-1]) + 1]
        starts = np.repeat(run_start, np.diff(np.r_[run_start, len(a)]))
        prev_run = np.where(starts > 0, np.concatenate(
            [[np.inf], best])[starts], np.inf)
        dominated = (prev_run <= b) | (b[starts] < b)
        front = lanes[~dominated]
        clipped[g] = max(0, front.size - K)
        chosen = front[:K]
        count[g] = chosen.size
        idx[g, :chosen.size] = chosen
        for f in FIELDS:
            out[f][g, :chosen.size] = np.asarray(fields[f])[chosen]
    return Front(indices=idx, count=count, clipped=clipped, **out)


def top_k(fields: dict, block: int, k: int) -> Front:
    """The ``k`` lanes of least energy-delay product (``energy_pj *
    latency_cc`` in float32) of each program, ties by flat index: the
    TopK branch of the same oracle."""
    n = len(fields["latency_cc"])
    G = n // block
    edp = (np.asarray(fields["energy_pj"], np.float32)
           * np.asarray(fields["latency_cc"]).astype(np.float32))
    out = {f: np.zeros((G, k), DTYPES[f]) for f in FIELDS}
    idx = np.full((G, k), -1, np.int32)
    count = np.zeros(G, np.int32)
    for g in range(G):
        lanes = np.arange(g * block, (g + 1) * block)
        chosen = lanes[np.lexsort((lanes, edp[lanes]))][:k]
        count[g] = chosen.size
        idx[g, :chosen.size] = chosen
        for f in FIELDS:
            out[f][g, :chosen.size] = np.asarray(fields[f])[chosen]
    return Front(indices=idx, count=count, clipped=np.zeros(G, np.int32),
                 **out)

"""Straggler detection & mitigation policy.

Detection: robust z-score of per-node step times against the fleet
median (MAD-based, so one slow node cannot poison the threshold).
Mitigation policy (returned as actions, applied by the launcher):
  * "rebalance": shift input-pipeline grains away from a mildly slow node
    (helps data-loader or host-side stalls);
  * "replace": persistent stragglers (k consecutive flags) are treated as
    failing hardware -> same path as a failure (elastic re-plan), because
    a lockstep SPMD step runs at the speed of the slowest participant.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    z_threshold: float = 4.0
    persistent_k: int = 3
    min_samples: int = 5


class StragglerDetector:
    def __init__(self, nodes: List[str],
                 policy: Optional[StragglerPolicy] = None):
        self.nodes = list(nodes)
        # None -> a fresh policy per detector.  (A `StragglerPolicy()`
        # default argument would be evaluated once at def time and shared
        # by every detector -- tuning one would silently retune them all.)
        self.policy = StragglerPolicy() if policy is None else policy
        self.history: Dict[str, Deque[float]] = {
            n: collections.deque(maxlen=32) for n in self.nodes}
        self.flags: Dict[str, int] = {n: 0 for n in self.nodes}

    def remove(self, node: str):
        """Drop an evicted/replaced node from the fleet being watched."""
        if node in self.nodes:
            self.nodes.remove(node)
        self.history.pop(node, None)
        self.flags.pop(node, None)

    def record_step(self, times: Dict[str, float]):
        for n, t in times.items():
            if n in self.history:       # evicted nodes may still report
                self.history[n].append(t)

    def _latest(self) -> Dict[str, float]:
        return {n: h[-1] for n, h in self.history.items() if h}

    def stragglers(self) -> List[str]:
        latest = self._latest()
        if len(latest) < self.policy.min_samples:
            return []
        vals = np.array(list(latest.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = []
        for n, t in latest.items():
            z = 0.6745 * (t - med) / mad
            if z > self.policy.z_threshold:
                out.append(n)
        return out

    def step(self, times: Dict[str, float]) -> Dict[str, str]:
        """Record one step; returns {node: action} for flagged nodes."""
        self.record_step(times)
        actions: Dict[str, str] = {}
        flagged = set(self.stragglers())
        for n in self.nodes:
            if n in flagged:
                self.flags[n] += 1
                if self.flags[n] >= self.policy.persistent_k:
                    actions[n] = "replace"
                else:
                    actions[n] = "rebalance"
            else:
                self.flags[n] = 0
        return actions

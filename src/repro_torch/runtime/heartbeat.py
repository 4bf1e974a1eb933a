"""Failure detection via heartbeats (transport-abstracted).

On a real cluster the bus is the coordination service (e.g. the JAX
distributed KV store or a sidecar agent); here it is an in-process
object so the detector logic -- the part that must be correct -- is
testable: phi-style timeout accrual, suspicion, confirmation, and
recovery of flapping nodes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set


class HeartbeatBus:
    """In-memory heartbeat transport: node -> last beat timestamp."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.last: Dict[str, float] = {}

    def beat(self, node: str, at: Optional[float] = None):
        self.last[node] = self.clock() if at is None else at

    def register(self, node: str, at: Optional[float] = None):
        """Record the node's existence without a beat: age counts from
        registration, so a fresh fleet gets the full timeout as startup
        grace instead of being born with age == inf."""
        self.last.setdefault(node, self.clock() if at is None else at)

    def age(self, node: str) -> float:
        if node not in self.last:
            return float("inf")
        return self.clock() - self.last[node]


@dataclasses.dataclass
class FailureDetector:
    """Declares a node failed after `timeout` without a heartbeat, with a
    `suspect_factor * timeout` grace period in between (suspect state lets
    the scheduler drain work before eviction).  Nodes are registered on
    the bus at construction: a node that has not beaten yet ages from
    registration time, not from -inf, so a whole fleet that is still
    starting up is not evicted at t=0 (it still fails after `timeout` if
    it never comes up)."""
    bus: HeartbeatBus
    nodes: List[str]
    timeout: float = 10.0
    suspect_factor: float = 0.5

    def __post_init__(self):
        for n in self.nodes:
            self.bus.register(n)

    def remove(self, node: str):
        """Drop an evicted node from the watch list (elastic downscale)."""
        if node in self.nodes:
            self.nodes.remove(node)

    def status(self, node: str) -> str:
        age = self.bus.age(node)
        if age >= self.timeout:
            return "failed"
        if age >= self.timeout * self.suspect_factor:
            return "suspect"
        return "healthy"

    def failed(self) -> Set[str]:
        return {n for n in self.nodes if self.status(n) == "failed"}

    def healthy(self) -> List[str]:
        return [n for n in self.nodes if self.status(n) == "healthy"]

    def should_restart(self) -> bool:
        """Restart (with elastic downscale) once any node is confirmed
        failed -- lockstep SPMD cannot proceed with holes in the mesh."""
        return bool(self.failed())
